// Issue-rate probe: what one SM sustains on f32 dependency chains.
//
// Replaces the Pallas TPU kernel of tools/vpu_issue_bench.py:_build
// (pl.pallas_call at :100), which measured the v5e vector unit's issue
// rate. Each thread carries CHAINS independent f32 recurrences in registers
// through trips x 32 unrolled rounds:
//   fma       x = x * a + b          (one FFMA, 2 operations)
//   add       x = x + b              (1 operation)
//   exp       x = exp(-0.5 x) + 0.25 (multiply, ex2.approx on the SFU, add)
//   sqrt_div  x = a / sqrt(x + b)    (IEEE sqrt and divide, as the physics
//                                     megakernel's Cholesky pivots use them)
// The TPU tool's `col` and `narrow` variants asked about vreg shapes and
// have no meaning here; the card's own question is how many resident warps
// hide a chain's latency, so the launch takes blocks and threads per block
// (one block per SM, 1 to 32 warps) beside the number of chains.
//
// What bounds it: by design nothing but the issue rate. It reads and writes
// 4 bytes per chain and thread; all work is register arithmetic. Every
// chain's last value is stored, and a, b come from memory, so the compiler
// can neither drop nor fold the loop. Thread 0 of each block also stores the
// SM clock cycles its loop took (clock64), so operations per clock need no
// assumed frequency.
//
// Build (tools/issue_bench.py does it at first use, through cuda_build):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libissue_probe.so issue_probe.cu
#include <cuda_runtime.h>

#define PROBE_ROUNDS 32

enum { PROBE_FMA = 0, PROBE_ADD = 1, PROBE_EXP = 2, PROBE_SQRT_DIV = 3 };

template <int V>
__device__ __forceinline__ float probe_round(float x, float a, float b) {
  if (V == PROBE_FMA) return fmaf(x, a, b);
  if (V == PROBE_ADD) return x + b;
  if (V == PROBE_EXP) return __expf(-0.5f * x) + 0.25f;
  return a / sqrtf(x + b);
}

// in, out: (C, threads) f32, chain-major so a warp's loads are contiguous.
// ab: (2, C) f32, the a then the b of each chain. cycles: (blocks,).
template <int V, int C>
__global__ void probe_kernel(const float* __restrict__ in, const float* __restrict__ ab,
                             float* __restrict__ out, long long* __restrict__ cycles, int trips) {
  const int n = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  float x[C], a[C], b[C];
#pragma unroll
  for (int c = 0; c < C; c++) {
    x[c] = in[c * n + tid];
    a[c] = ab[c];
    b[c] = ab[C + c];
  }
  long long t0 = clock64();
  for (int t = 0; t < trips; t++) {
#pragma unroll
    for (int r = 0; r < PROBE_ROUNDS; r++) {
#pragma unroll
      for (int c = 0; c < C; c++) x[c] = probe_round<V>(x[c], a[c], b[c]);
    }
  }
  long long t1 = clock64();
#pragma unroll
  for (int c = 0; c < C; c++) out[c * n + tid] = x[c];
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int V>
static int launch_chains(int chains, const float* in, const float* ab, float* out,
                         long long* cycles, int trips, int blocks, int threads, cudaStream_t s) {
  switch (chains) {
    case 1: probe_kernel<V, 1><<<blocks, threads, 0, s>>>(in, ab, out, cycles, trips); break;
    case 2: probe_kernel<V, 2><<<blocks, threads, 0, s>>>(in, ab, out, cycles, trips); break;
    case 4: probe_kernel<V, 4><<<blocks, threads, 0, s>>>(in, ab, out, cycles, trips); break;
    case 8: probe_kernel<V, 8><<<blocks, threads, 0, s>>>(in, ab, out, cycles, trips); break;
    case 16: probe_kernel<V, 16><<<blocks, threads, 0, s>>>(in, ab, out, cycles, trips); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" {

int probe_rounds() { return PROBE_ROUNDS; }

// Launches on `stream`; returns cudaGetLastError() of the launch, or -1 for
// a variant or chain count that was not built.
int probe_run(int variant, int chains, const float* in, const float* ab, float* out,
              long long* cycles, int trips, int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case PROBE_FMA: return launch_chains<PROBE_FMA>(chains, in, ab, out, cycles, trips, blocks, threads, s);
    case PROBE_ADD: return launch_chains<PROBE_ADD>(chains, in, ab, out, cycles, trips, blocks, threads, s);
    case PROBE_EXP: return launch_chains<PROBE_EXP>(chains, in, ab, out, cycles, trips, blocks, threads, s);
    case PROBE_SQRT_DIV:
      return launch_chains<PROBE_SQRT_DIV>(chains, in, ab, out, cycles, trips, blocks, threads, s);
    default: return -1;
  }
}

}  // extern "C"
