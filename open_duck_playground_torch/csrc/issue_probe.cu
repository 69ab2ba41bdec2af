// Issue-rate probe: what one SM sustains on f32 dependency chains.
//
// Replaces the Pallas TPU kernel of tools/vpu_issue_bench.py:_build
// (pl.pallas_call at :100), which measured the v5e vector unit's issue
// rate. Each thread carries CHAINS independent f32 recurrences in registers
// through trips x 32 unrolled rounds, the TPU tool's variants with their
// values, and one of the card's own:
//   fma       x = x * a + b          (one FFMA, 2 operations), a, b per chain
//   add       x = x + b              (one FADD, 1 operation)
//   exp       x = exp(-0.5 x) + 0.25 (multiply, ex2.approx on the SFU, add)
//   col       fma with ONE a = 0.9997, b = 1.3e-4 shared by every chain: on
//             the TPU one op over a (chains, 8, 128) stack; here the chains'
//             FFMAs read the same two registers, which tests operand reuse
//   narrow    fma on 4 of each warp's 32 lanes, the rest idle: on the TPU
//             a (1, 128) op, 1/8 of a vreg; here the state of the physics
//             megakernel's serial stages (the root's 6 dofs, the elimination
//             steps), where most lanes of an env's warp wait
//   sqrt_div  x = a / sqrt(x + b)    (IEEE sqrt and divide, as the physics
//                                     megakernel's Cholesky pivots use them)
// `operands` places a and b: PROBE_OPERANDS_REGISTERS has each lane load its
// own copy from device memory, so they are per-lane values and an FFMA
// reads three registers, as the megakernel's FMAs on per-lane data do;
// PROBE_OPERANDS_CONSTANT passes them as a kernel parameter, which the
// compiler keeps in uniform registers, so an FFMA reads two registers and
// one uniform register. Both give the same values. On the H100 an FFMA
// whose three sources are registers, none held by the operand reuse cache,
// issues every other cycle; with one source in a uniform register it issues
// every cycle. So one chain per thread at 16 warps per SM reaches half the
// FP32 rate with `registers` and the full rate with `constant`, which the
// wrapper takes by default (PERF.md, section 6).
//
// What bounds it: by design nothing but the issue rate (issue slots, not
// bytes). It reads and writes 4 bytes per chain and element; all work is
// register arithmetic, and every chain's last value is stored so that the
// compiler can drop nothing. What the design does about the rest:
//  - One block per SM, checked: every launch reserves PROBE_SMEM_BYTES of
//    shared memory, more than half of an SM's, so no two blocks can share an
//    SM, and "warps per SM" is the block's warps. Thread 0 stores the block's
//    %smid, and the wrapper's `measure` refuses a result in which two blocks
//    of a one-block-per-SM launch met on one SM.
//  - Clocks read in the kernel: thread 0 stores clock64 and %globaltimer at
//    the block's barriers before and after the loop, so SM cycles need no
//    assumed frequency and the SM clock comes from the kernel's own timers as
//    well as from the CUDA events' slope.
//  - No host synchronisation: the launch allocates nothing and copies
//    nothing; the wrapper caches the constants on the device and the timer
//    scratch, so back-to-back launches keep the card busy.
//
// Build (tools/issue_bench.py does it at first use, through cuda_build):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libissue_probe.so issue_probe.cu
// Its machine code: cuobjdump -sass build/kernels/libissue_probe_*.so
// (tools/issue_bench.py --sass counts each loop's instructions per trip).
#include <cuda_runtime.h>
#include <string.h>

#define PROBE_ROUNDS 32
#define PROBE_MAX_CHAINS 16
#define PROBE_NARROW_LANES 4
// 128 KB + the 1 KB the hardware keeps per block: two blocks need more than
// an SM's 228 KB, so each block is alone on its SM
#define PROBE_SMEM_BYTES (128 * 1024)
#define PROBE_TIMERS 5  // per block: %smid, clock64 start, end, %globaltimer start, end

// The order of tools/issue_bench.py:VARIANTS and OPERANDS
enum { PROBE_FMA = 0, PROBE_ADD, PROBE_EXP, PROBE_COL, PROBE_NARROW, PROBE_SQRT_DIV };
enum { PROBE_OPERANDS_REGISTERS = 0, PROBE_OPERANDS_CONSTANT = 1 };

struct ProbeAB {
  float a[PROBE_MAX_CHAINS];
  float b[PROBE_MAX_CHAINS];
};

template <int V>
__device__ __forceinline__ float probe_round(float x, float a, float b) {
  if (V == PROBE_ADD) return x + b;
  if (V == PROBE_EXP) return __expf(-0.5f * x) + 0.25f;
  if (V == PROBE_SQRT_DIV) return a / sqrtf(x + b);
  return fmaf(x, a, b);  // fma, col, narrow
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// in, out: (C, n) f32, chain-major so a warp's loads are contiguous; n is
// the elements of the launch: a thread each, or for `narrow` 4 per warp.
// ab_mem: (2, C, 32) f32 on the device, the a then the b of each chain, a
// copy for each lane; ab_par: the same values by value, once.
// timers: (blocks, PROBE_TIMERS).
template <int V, int C, int O>
__global__ void probe_kernel(const float* __restrict__ in, const float* __restrict__ ab_mem,
                             const ProbeAB ab_par, float* __restrict__ out,
                             long long* __restrict__ timers, int trips) {
  constexpr bool narrow = V == PROBE_NARROW;
  const int lane = threadIdx.x & 31;
  const bool busy = !narrow || lane < PROBE_NARROW_LANES;
  const int per_block = narrow ? (blockDim.x >> 5) * PROBE_NARROW_LANES : blockDim.x;
  const int n = gridDim.x * per_block;
  const int e = blockIdx.x * per_block +
                (narrow ? (threadIdx.x >> 5) * PROBE_NARROW_LANES + lane : threadIdx.x);
  float x[C], a[C], b[C];
#pragma unroll
  for (int c = 0; c < C; c++) {
    const int k = V == PROBE_COL ? 0 : c;  // col: one a, b for every chain
    a[c] = O == PROBE_OPERANDS_CONSTANT ? ab_par.a[k] : ab_mem[k * 32 + lane];
    b[c] = O == PROBE_OPERANDS_CONSTANT ? ab_par.b[k] : ab_mem[(C + k) * 32 + lane];
    x[c] = busy ? in[c * n + e] : 0.f;
  }
  __syncthreads();
  const long long c0 = clock64(), g0 = global_ns();
  if (busy) {
    for (int t = 0; t < trips; t++) {
#pragma unroll
      for (int r = 0; r < PROBE_ROUNDS; r++) {
#pragma unroll
        for (int c = 0; c < C; c++) x[c] = probe_round<V>(x[c], a[c], b[c]);
      }
    }
  }
  __syncthreads();
  const long long c1 = clock64(), g1 = global_ns();
  if (busy) {
#pragma unroll
    for (int c = 0; c < C; c++) out[c * n + e] = x[c];
  }
  if (threadIdx.x == 0) {
    long long* t = timers + PROBE_TIMERS * blockIdx.x;
    t[0] = sm_id();
    t[1] = c0;
    t[2] = c1;
    t[3] = g0;
    t[4] = g1;
  }
}

struct ProbeLaunch {
  const float* in;
  const float* ab_mem;
  ProbeAB ab_par;
  float* out;
  long long* timers;
  int trips, blocks, threads;
  cudaStream_t stream;
};

template <int V, int C, int O>
static int launch(const ProbeLaunch& p, int dev) {
  // the shared-memory reservation above 48 KB is opted into once per kernel and device
  static unsigned long long ready = 0;
  cudaError_t err;
  if (!(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(probe_kernel<V, C, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               PROBE_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    ready |= 1ull << dev;
  }
  probe_kernel<V, C, O><<<p.blocks, p.threads, PROBE_SMEM_BYTES, p.stream>>>(
      p.in, p.ab_mem, p.ab_par, p.out, p.timers, p.trips);
  return (int)cudaGetLastError();
}

template <int V, int O>
static int by_chains(int chains, const ProbeLaunch& p, int dev) {
  switch (chains) {
    case 1: return launch<V, 1, O>(p, dev);
    case 2: return launch<V, 2, O>(p, dev);
    case 4: return launch<V, 4, O>(p, dev);
    case 8: return launch<V, 8, O>(p, dev);
    case 16: return launch<V, 16, O>(p, dev);
    default: return -1;
  }
}

template <int V>
static int by_operands(int operands, int chains, const ProbeLaunch& p, int dev) {
  switch (operands) {
    case PROBE_OPERANDS_REGISTERS: return by_chains<V, PROBE_OPERANDS_REGISTERS>(chains, p, dev);
    case PROBE_OPERANDS_CONSTANT: return by_chains<V, PROBE_OPERANDS_CONSTANT>(chains, p, dev);
    default: return -1;
  }
}

static int by_variant(int variant, int operands, int chains, const ProbeLaunch& p, int dev) {
  switch (variant) {
    case PROBE_FMA: return by_operands<PROBE_FMA>(operands, chains, p, dev);
    case PROBE_ADD: return by_operands<PROBE_ADD>(operands, chains, p, dev);
    case PROBE_EXP: return by_operands<PROBE_EXP>(operands, chains, p, dev);
    case PROBE_COL: return by_operands<PROBE_COL>(operands, chains, p, dev);
    case PROBE_NARROW: return by_operands<PROBE_NARROW>(operands, chains, p, dev);
    case PROBE_SQRT_DIV: return by_operands<PROBE_SQRT_DIV>(operands, chains, p, dev);
    default: return -1;
  }
}

extern "C" {

int probe_rounds() { return PROBE_ROUNDS; }
int probe_narrow_lanes() { return PROBE_NARROW_LANES; }
int probe_timers() { return PROBE_TIMERS; }
int probe_smem_bytes() { return PROBE_SMEM_BYTES; }

// Launches on `stream` of card `device` (the calling thread's current card
// is left as it was); returns cudaGetLastError() of the launch, or -1 for a
// variant, operand placement or chain count that was not built. ab_dev:
// the (2, chains, 32) constants on the device; ab_host: (2, chains) on the
// host, copied into the launch's parameters.
int probe_run(int variant, int chains, int operands, int device, const float* in,
              const float* ab_dev, const float* ab_host, float* out, long long* timers, int trips,
              int blocks, int threads, void* stream) {
  if (chains < 1 || chains > PROBE_MAX_CHAINS || device < 0 || device > 63) return -1;
  ProbeLaunch p;
  p.in = in;
  p.ab_mem = ab_dev;
  memset(&p.ab_par, 0, sizeof(p.ab_par));
  memcpy(p.ab_par.a, ab_host, sizeof(float) * chains);
  memcpy(p.ab_par.b, ab_host + chains, sizeof(float) * chains);
  p.out = out;
  p.timers = timers;
  p.trips = trips;
  p.blocks = blocks;
  p.threads = threads;
  p.stream = (cudaStream_t)stream;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int res = by_variant(variant, operands, chains, p, device);
  if (prev != device) cudaSetDevice(prev);
  return res;
}

}  // extern "C"
