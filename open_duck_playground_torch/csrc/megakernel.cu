// CUDA entry points of the physics megakernel (body in megakernel.cuh).
//
// Replaces open_duck_playground_tpu/physics/megakernel.py:
// megakernel_step_batched (pl.pallas_call at :2178), the only TPU kernel on
// the training rollout. With -DMK_HFIELD=1 the floor is a heightfield (the
// TPU kernel's IS_HFIELD branch, :1098): the launch carries one more
// pointer, the height table.
//
// What bounds it on an H100: neither HBM bytes (~2.3 KB per env and control
// step) nor f32 operations at the 67 TFLOP/s peak, but the latency of one
// env's chain of short dependent stages (a tree walk, two factorizations,
// a linesearch): the time of a launch is inversely proportional to the envs
// an SM holds at once, with issue slots to spare. What the design does
// about it: MK_LANES lanes step one env together through all substeps of a
// control step, with the env's working set in shared memory (one MkShared,
// ~13 KB on the duck, sized by sizeof and reported by mk_kernel_info) and
// warp-level barriers only, so the envs of a block drift freely and an SM
// hides one env's stalls behind the others'. Inside a stage, loads leave
// together ahead of the arithmetic (unrolled, predicated loops) wherever a
// loop would otherwise pay one shared-memory latency per step. The
// block-arrow forms and the shared-memory layout are described in
// megakernel.cuh. No tensor cores, TMA or clusters: see megakernel.cuh.
//
// Filling the card: a block holds MK_BLOCK_ENVS envs (MK_BLOCK_ENVS *
// MK_LANES threads) and one copy of the structure tables (8 KB, copied from
// the model's record once before the first step, behind the kernel's only
// block-wide barrier; lanes read different entries at once, which constant
// memory would serialize).
// 8 envs per block put two blocks, 16 envs, on an SM: shared memory, not
// the block shape, is the limit. The grid has one block per MK_BLOCK_ENVS
// envs and the hardware hands an SM its next block as soon as one ends:
// 8192 envs on 132 SMs are 1024 blocks on 264 slots, 3.9 fills of the card,
// and since envs cost nearly the same the last, partial fill ends within
// one block's time of the ideal. Persistent blocks would gain nothing: no
// state outlives an env's control step.
//
// MK_LANES is a constant of this source: 32, 16 or 8 (a warp, or an
// aligned half or quarter of one through a lane mask).
// tools/lanes_bench.py times copies of this source with the three values;
// the fastest at 8192 envs is committed here.
//
// Build (physics/megakernel.py does it at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DMK_NQ=... -o libmegakernel.so megakernel.cu
#include <cuda_runtime.h>

#include "megakernel.cuh"

#define MK_LANES 32
#define MK_BLOCK_ENVS 8
#define MK_THREADS (MK_BLOCK_ENVS * MK_LANES)
static_assert(MK_LANES == 32 || MK_LANES == 16 || MK_LANES == 8, "a warp or an aligned part of one");

// The lanes of one env: an aligned group of MK_LANES threads of a warp.
struct MkLanes {
  static constexpr int N = MK_LANES;
  int lane;
  unsigned int mask;

  // (__host__ too, with empty host bodies, because the body that calls
  // them is a __host__ __device__ template)
  MK_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }

  // Sum over the env's lanes by an xor butterfly: a + b == b + a bit for
  // bit, so every lane ends with the same value.
  MK_HD float sum(float v) const {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
#endif
    return v;
  }

  // Index of the least value over the lanes (idx < 0: the lane has none),
  // the lowest index on ties; the first lane's answer goes to all, so the
  // lanes agree even where a NaN makes the comparison order-dependent.
  MK_HD int argmin(float v, int idx) const {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int o = N / 2; o > 0; o >>= 1) {
      float v2 = __shfl_xor_sync(mask, v, o);
      int i2 = __shfl_xor_sync(mask, idx, o);
      if (idx < 0 || (i2 >= 0 && (v2 < v || (v2 == v && i2 < idx)))) {
        v = v2;
        idx = i2;
      }
    }
    idx = __shfl_sync(mask, idx, 0, N);
#endif
    return idx;
  }
};

#define MK_MODEL_WORDS ((sizeof(MkModel) + 15) / 16 * 4)  // 4-byte words, a multiple of 4

__global__ void __launch_bounds__(MK_THREADS) mk_kernel(MkArgs a) {
  extern __shared__ float4 mk_smem[];
  // the block's copy of the structure tables, then its envs' working sets
  int* tables = reinterpret_cast<int*>(mk_smem);
  MkShared* envs = reinterpret_cast<MkShared*>(tables + MK_MODEL_WORDS);
  const int* src = reinterpret_cast<const int*>(a.model);
  for (int i = threadIdx.x; i < (int)(sizeof(MkModel) / 4); i += MK_THREADS) tables[i] = src[i];
  __syncthreads();  // the only block-wide barrier, before the first step
  const int slot = threadIdx.x / MK_LANES;
  const int e = blockIdx.x * MK_BLOCK_ENVS + slot;
  if (e >= a.batch) return;  // whole lane groups leave: the ragged last block
  MkLanes cx;
  cx.lane = threadIdx.x % MK_LANES;
  cx.mask = (0xffffffffu >> (32 - MK_LANES)) << ((threadIdx.x % 32) / MK_LANES * MK_LANES);
  mk_env_step(*reinterpret_cast<const MkModel*>(tables), a, e, envs[slot], cx);
}

static size_t mk_smem_bytes() { return 4 * MK_MODEL_WORDS + MK_BLOCK_ENVS * sizeof(MkShared); }

extern "C" {

int mk_model_size() { return (int)sizeof(MkModel); }

int mk_shared_size() { return (int)sizeof(MkShared); }

// The kernel's attributes on the current device, constants of the build:
// more than 48 KB of dynamic shared memory needs the attribute; the
// carve-out is asked for in full so that shared memory alone limits the
// resident blocks. Once per device before its first launch.
int mk_configure() {
  cudaError_t err = cudaFuncSetAttribute(mk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)mk_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(mk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
}

// model: the model's record (one MkModel) in device memory; ptrs: MK_NPTR
// device pointers in MkArgs order. Launches on `stream` and returns the
// launch's error (a refused launch shows in cudaGetLastError()).
int mk_step(const MkModel* model, const void* const* ptrs, int batch, int n_substeps, void* stream) {
  MkArgs a = mk_args(model, ptrs, batch, n_substeps);
  int grid = (batch + MK_BLOCK_ENVS - 1) / MK_BLOCK_ENVS;
  mk_kernel<<<grid, MK_THREADS, mk_smem_bytes(), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out: local bytes per thread, registers per thread, max threads per block,
// resident blocks per SM, SM count, dynamic shared bytes per block, lanes
// per env, threads per block, bytes of one env's working set.
int mk_kernel_info(int* out) {
  cudaError_t err = (cudaError_t)mk_configure();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, mk_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mk_kernel, MK_THREADS, mk_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = (int)attr.localSizeBytes;
  out[1] = attr.numRegs;
  out[2] = attr.maxThreadsPerBlock;
  out[3] = blocks;
  out[4] = sms;
  out[5] = (int)mk_smem_bytes();
  out[6] = MK_LANES;
  out[7] = MK_THREADS;
  out[8] = (int)sizeof(MkShared);
  return 0;
}

}  // extern "C"
