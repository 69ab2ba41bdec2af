// CUDA entry points of the training wrapper's step (body in
// wrapper_step.cuh): `wr_pre` before the task's step, `wr_post` after its
// last action repeat, one block per env.
//
// Replaces no TPU kernel: the JAX package's wrapper is plain jnp, fused by
// XLA. These two launches take the place of the ~133 PyTorch launches of
// the port's eager wrapper body (envs/wrappers.py, its plain version): each
// moves a few kB, so launch gaps, not work, set their time. What bounds the
// kernels themselves on an H100: the latency of an env's loads and stores.
// So each env has a block whose warps take the rows' chunks of 32 elements
// (coalesced), WR_UNROLL chunks a warp and round with every load of a round
// issued before its first store; the post launch's finite flag is a block
// reduction (`__syncthreads_and`) closed before any selection is written.
// At the eval's 128 envs that is 128 blocks on 132 SMs, of 512 threads, so
// that an env's chunks take fewer rounds; at the rollout's 8192 a full grid
// of blocks of 128 (`wr_threads`: on an H100, the two launches at 128 /
// 8192 envs took 10.1 / 67.9 us in blocks of 128 threads, 7.2 us at 128 in
// blocks of 256, 6.1 / 93.8 us in blocks of 512).
//
// The table of leaves (`WrArgs`, under 4 KB) is a __grid_constant__
// parameter: the warps index it without a copy to local memory, and a
// CUDA graph captures it with the launch.
//
// Built with -fmad=false: the eager body rounds after every product.
//
// Build (envs/wrapper_kernel.py does it at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -o libwrapper_step.so wrapper_step.cu
#include <cuda_runtime.h>

#include "wrapper_step.cuh"

#define WR_MIN_THREADS 128
#define WR_MAX_THREADS 512
#define WR_UNROLL 4

// Every chunk's elements of env `e`, `flag` choosing as in wr_load.
__device__ __forceinline__ void wr_chunks(const WrArgs& a, int e, bool flag) {
  const int lane = threadIdx.x % WR_LANES, warp = threadIdx.x / WR_LANES, warps = blockDim.x / WR_LANES;
  for (int base = warp; base < a.nchunks; base += warps * WR_UNROLL) {
    uint32_t v[WR_UNROLL];
    bool has[WR_UNROLL];
#pragma unroll
    for (int u = 0; u < WR_UNROLL; u++) {
      const int c = base + u * warps;
      has[u] = c < a.nchunks && wr_load(a, e, c, lane, flag, &v[u]);
    }
#pragma unroll
    for (int u = 0; u < WR_UNROLL; u++)
      if (has[u]) wr_store(a, e, base + u * warps, lane, v[u]);
  }
}

__global__ void __launch_bounds__(WR_MAX_THREADS) wr_pre_kernel(const __grid_constant__ WrArgs a) {
  const int e = blockIdx.x;
  const bool done_prev = a.done[e] > 0.0f;
  if (threadIdx.x == 0) wr_pre_env(a, e, done_prev);
  wr_chunks(a, e, done_prev);
}

__global__ void __launch_bounds__(WR_MAX_THREADS) wr_post_kernel(const __grid_constant__ WrArgs a) {
  const int e = blockIdx.x;
  const int lane = threadIdx.x % WR_LANES, warp = threadIdx.x / WR_LANES, warps = blockDim.x / WR_LANES;
  bool ok = true;
#pragma unroll 4
  for (int c = warp; c < a.nfinite; c += warps) ok = wr_finite(a, e, c, lane) && ok;
  const bool bad = !__syncthreads_and(ok);
  if (threadIdx.x < a.nscalars) wr_scalar(a, e, threadIdx.x, bad);
  if (threadIdx.x == blockDim.x - 1) wr_post_env(a, e, bad);
  wr_chunks(a, e, bad);
}

static_assert(WR_MAX_SCALARS < WR_MIN_THREADS, "a thread per scalar leaf, and one for the env's own");

// Threads per block for `batch` envs on the current device: the most, from
// WR_MIN_THREADS to WR_MAX_THREADS, with which every block is resident at
// once (one wave).
static int wr_threads(int batch) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  int t = WR_MAX_THREADS;
  while (t > WR_MIN_THREADS && (long long)batch * t > (long long)sms * per_sm) t /= 2;
  return t;
}

extern "C" {

int wr_layout(int32_t* out) { return wr_layout_fill(out); }

// a: the launch's table in host memory (copied into the kernel's
// parameters). Launch on `stream` and return the launch's error.
int wr_pre(const WrArgs* a, void* stream) {
  if (a->batch > 0) wr_pre_kernel<<<a->batch, wr_threads(a->batch), 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int wr_post(const WrArgs* a, void* stream) {
  if (a->batch > 0) wr_post_kernel<<<a->batch, wr_threads(a->batch), 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
