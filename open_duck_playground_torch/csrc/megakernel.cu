// CUDA entry points of the physics megakernel (body in megakernel.cuh).
//
// Replaces open_duck_playground_tpu/physics/megakernel.py:
// megakernel_step_batched (pl.pallas_call at :2178), the only TPU kernel on
// the training rollout. One thread steps one env through all substeps of a
// control step; blocks of MK_BLOCK threads, the ragged last block masked.
// With -DMK_HFIELD=1 the floor is a heightfield (the TPU kernel's IS_HFIELD
// branch, :1098): the launch carries one more pointer, the height table.
//
// What bounds it on an H100: neither HBM bytes (~2.3 KB per env and control
// step) nor f32 operations at the 67 TFLOP/s peak, but latency: each thread
// walks a long chain of dependent steps through ~23 KB of thread-local
// storage (dense mass matrix and factor, 32x30 contact Jacobian; 168
// registers), and 8192 envs give only ~62 threads per SM to hide it. This
// first kernel accepts that for simplicity; more threads per env (a warp
// per env) and the block-arrow forms of structure.dof_chain_blocks are the
// tools of a later pass.
//
// Build (physics/megakernel.py does it at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DMK_NQ=... -o libmegakernel.so megakernel.cu
#include <cuda_runtime.h>

#include "megakernel.cuh"

#ifndef MK_BLOCK
#define MK_BLOCK 64
#endif

__constant__ MkModel c_model;

__global__ void __launch_bounds__(MK_BLOCK) mk_kernel(MkArgs a) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.batch) return;
  mk_env_step(c_model, a, e);
}

extern "C" {

int mk_model_size() { return (int)sizeof(MkModel); }

int mk_block_size() { return MK_BLOCK; }

// Copy the structure tables into constant memory (synchronous).
int mk_set_model(const MkModel* host) {
  return (int)cudaMemcpyToSymbol(c_model, host, sizeof(MkModel));
}

// ptrs: MK_NPTR device pointers in MkArgs order. Launches on `stream` and
// returns cudaGetLastError() of the launch.
int mk_step(const void* const* ptrs, int batch, int n_substeps, void* stream) {
  MkArgs a = mk_args(ptrs, batch, n_substeps);
  int grid = (batch + MK_BLOCK - 1) / MK_BLOCK;
  mk_kernel<<<grid, MK_BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out: local bytes per thread, registers per thread, max threads per block,
// resident blocks per SM at MK_BLOCK threads, SM count.
int mk_kernel_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mk_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mk_kernel, MK_BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = (int)attr.localSizeBytes;
  out[1] = attr.numRegs;
  out[2] = attr.maxThreadsPerBlock;
  out[3] = blocks;
  out[4] = sms;
  return 0;
}

}  // extern "C"
