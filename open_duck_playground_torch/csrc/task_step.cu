// CUDA entry points of the joystick task's step around the physics launch
// (body in task_step.cuh): `tk_pre` before the megakernel, `tk_post` after
// it, one thread per env. The standing task inherits the step; its build
// (-DTK_STANDING=1) computes its own reward terms.
//
// Replaces no TPU kernel: the JAX package's `envs/joystick.py` step is
// plain jnp, fused by XLA. These two launches take the place of the ~240
// PyTorch launches of the port's eager `Joystick.step` (envs/joystick.py,
// its plain version): each moves a few kB, so launch gaps, not work, set
// their time. What bounds the kernels themselves on an H100: the latency of
// one env's chain of loads, transcendental calls and stores (under 3 KB
// per env and control step, in rows of ~100 floats that one thread writes,
// so a warp's store touches as many lines as it has envs). So the envs
// spread over the SMs (`tk_threads`): at the eval's 128 envs one per
// block, each block on an SM of its own; at the rollout's 8192, blocks of 64.
//
// Built with -fmad=false: the eager step rounds after every product, and
// the kernel follows its order of operations (task_step.cuh).
//
// Build (envs/task_kernel.py does it at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -DTK_NQ=... -o libtask_step.so task_step.cu
#include <cuda_runtime.h>

#include "task_step.cuh"

#define TK_BLOCK 64  // the most threads a block takes

__global__ void __launch_bounds__(TK_BLOCK) tk_pre_kernel(TkPre a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.batch) tk_pre_env(*a.rec, a, e);
}

__global__ void __launch_bounds__(TK_BLOCK) tk_post_kernel(TkPost a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < a.batch) tk_post_env(*a.rec, a, e);
}

// Threads per block for `batch` envs on the current device: the envs
// spread evenly over its SMs, a power of two from 1 to TK_BLOCK.
static int tk_threads(int batch) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = sms > 0 ? sms : 1;
  const int per_sm = (batch + sms - 1) / sms;
  int t = 1;
  while (t < per_sm && t < TK_BLOCK) t *= 2;
  return t;
}

extern "C" {

int tk_record_size() { return (int)sizeof(TkRecord); }

// out: the widths of the observations `state` and `privileged_state`.
void tk_obs_sizes(int* out) {
  out[0] = TK_NSTATE;
  out[1] = TK_NPRIV;
}

// rec: the env's record (one TkRecord) in device memory; ptrs: the launch's
// device pointers in TkPre / TkPost order. Launch on `stream` and return
// the launch's error.
int tk_pre(const TkRecord* rec, const void* const* ptrs, int batch, void* stream) {
  const int t = tk_threads(batch);
  tk_pre_kernel<<<(batch + t - 1) / t, t, 0, (cudaStream_t)stream>>>(tk_pre_args(rec, ptrs, batch));
  return (int)cudaGetLastError();
}

int tk_post(const TkRecord* rec, const void* const* ptrs, int batch, void* stream) {
  const int t = tk_threads(batch);
  tk_post_kernel<<<(batch + t - 1) / t, t, 0, (cudaStream_t)stream>>>(tk_post_args(rec, ptrs, batch));
  return (int)cudaGetLastError();
}

}  // extern "C"
