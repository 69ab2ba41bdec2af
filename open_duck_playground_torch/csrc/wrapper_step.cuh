// The training wrapper's per-step bookkeeping (envs/wrappers.py,
// `TrainingEnv.eager_step`), for ONE env and one element at a time:
// `wr_pre` runs before the task's step, `wr_post` after its last action
// repeat.
//
//   pre:  every Data field and observation leaf from the cached reset state
//         where the env was done on the previous step (the autoreset), else
//         the state's own row; the step count zeroed there;
//   post: the env's finite flag over its observation leaves, qpos and qvel;
//         where it is not finite, every Data field and observation leaf from
//         the cached reset state (the quarantine), the reward 0, done 1, and
//         every float leaf of `info` and `metrics` through nan_to_num; then
//         the step count, the episode limit, done and truncation; with the
//         evaluator's sums (`eval_metrics`), the episode reward, length,
//         done and every metric's sum, frozen after the env's first done.
//
// Replaces no TPU kernel: the JAX package's wrapper is jnp under vmap that
// XLA fuses. The port's eager body launches ~133 PyTorch kernels a step, a
// few kB each. What bounds the two launches on an H100: neither bytes (~5 KB
// in and out per env and launch) nor operations, but the latency of one
// env's loads and stores: one block per env, its threads walk the leaves'
// rows in chunks of 32 elements (a warp's lanes, so the loads are
// coalesced), every load of a round of chunks before its first store.
//
// The tree's leaves differ by task and layout, so they come as a table
// (`WrArgs`: pointers, row widths, kinds, and the chunk list the wrapper
// derives from the widths) that a launch passes by value in the kernel's
// parameters: a CUDA graph captures it, and an eager launch uploads
// nothing.
//
// Arithmetic: each PyTorch operation of the eager body rounds once, so
// products are not fused into sums (the card's build takes -fmad=false, the
// host harness -ffp-contract=off) and the order is the eager body's
// (`acc + alive * x`: a product, then a sum). Selections copy bits. Every
// output is the eager body's bit for bit. The element functions are
// __host__ __device__, so the same text compiles with a host C++ compiler
// (wrapper_step_host.cpp, a test harness that loops over the envs).
#pragma once

#include <float.h>
#include <stdint.h>

#ifdef __CUDACC__
#define WR_HD __host__ __device__ __forceinline__
#else
#define WR_HD inline
#endif

#define WR_LANES 32         // elements of a chunk: a warp's lanes
#define WR_MAX_ROWS 48      // leaves of rows wider than one element
#define WR_MAX_SCALARS 32   // float leaves of one element per env
#define WR_MAX_CHUNKS 160

// WrRow.kind: a selection (between `first` and `src` by the env's flag) or,
// with WR_SANITIZE, `src` through nan_to_num where the env is bad (float32
// only); WR_BYTE1: 1-byte elements (bool), else 4-byte ones; WR_FINITE: the
// post launch checks `src` for finite values (float32 only).
#define WR_SANITIZE 1
#define WR_BYTE1 2
#define WR_FINITE 4

struct WrRow {
  const void* first;  // a selection's choice where the env's flag is set
  const void* src;
  void* out;
  int32_t width;  // elements per env
  int32_t kind;
};

// A float leaf of one element per env: `out` is `src`, through nan_to_num
// where the env is bad; with `acc`, `acc_out` is the evaluator's sum
// `acc + alive * out`.
struct WrScalar {
  const float* src;
  float* out;
  const float* acc;
  float* acc_out;
};

struct WrArgs {
  // pre: done (the previous step's), steps in, steps_out. post: the task's
  // reward and done, steps (the pre launch's steps_out) in, and every
  // *_out; ep_*: the evaluator's sums, null without them.
  const float* done;
  const float* reward;
  const float* steps;
  const float* ep_reward;
  const float* ep_length;
  const float* ep_done;
  float* done_out;
  float* reward_out;
  float* steps_out;
  float* truncation_out;
  float* ep_reward_out;
  float* ep_length_out;
  float* ep_done_out;
  int32_t batch;
  int32_t nrows;
  int32_t nscalars;
  int32_t nchunks;
  int32_t nfinite;  // the leading chunks, those of the rows the post launch checks
  float repeat;     // the action repeat
  float limit;      // the episode length
  WrRow rows[WR_MAX_ROWS];
  WrScalar scalars[WR_MAX_SCALARS];
  uint8_t chunk_row[WR_MAX_CHUNKS];   // the chunk's row
  uint8_t chunk_part[WR_MAX_CHUNKS];  // its first element over WR_LANES
};

// The table's format, which envs/wrapper_kernel.py mirrors with ctypes and
// checks when it loads a library (`wr_layout`): sizeof(WrArgs), the sizes
// above and the kinds.
#define WR_LAYOUT_LEN 8
inline int wr_layout_fill(int32_t* out) {
  const int32_t layout[WR_LAYOUT_LEN] = {(int32_t)sizeof(WrArgs), WR_LANES,    WR_MAX_ROWS, WR_MAX_SCALARS,
                                         WR_MAX_CHUNKS,           WR_SANITIZE, WR_BYTE1,    WR_FINITE};
  for (int i = 0; i < WR_LAYOUT_LEN; i++) out[i] = layout[i];
  return WR_LAYOUT_LEN;
}

// the traditional limit of a kernel's parameters
static_assert(sizeof(WrArgs) <= 4096, "WrArgs must fit a kernel's 4 KB of parameters");

// torch.nan_to_num: NaN to 0, +-inf to +-FLT_MAX.
WR_HD float wr_nan_to_num(float x) {
  if (x != x) return 0.0f;
  if (x > FLT_MAX) return FLT_MAX;
  if (x < -FLT_MAX) return -FLT_MAX;
  return x;
}

// torch.maximum: NaN if either is NaN.
WR_HD float wr_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

WR_HD bool wr_finite_bits(uint32_t bits) { return (bits & 0x7f800000u) != 0x7f800000u; }

WR_HD float wr_float(uint32_t bits) {
  union {
    uint32_t u;
    float f;
  } v;
  v.u = bits;
  return v.f;
}

WR_HD uint32_t wr_bits(float x) {
  union {
    float f;
    uint32_t u;
  } v;
  v.f = x;
  return v.u;
}

// Element `lane` of chunk `c` for env `e`: its index in the row's tensor, or
// -1 past the row's end.
WR_HD int64_t wr_index(const WrArgs& a, int e, int c, int lane) {
  const WrRow& r = a.rows[a.chunk_row[c]];
  const int j = a.chunk_part[c] * WR_LANES + lane;
  return j < r.width ? (int64_t)e * r.width + j : -1;
}

// Whether that element is finite (true past the end and in a row that is
// not WR_FINITE: an integer or bool leaf).
WR_HD bool wr_finite(const WrArgs& a, int e, int c, int lane) {
  const int64_t i = wr_index(a, e, c, lane);
  const WrRow& r = a.rows[a.chunk_row[c]];
  return i < 0 || !(r.kind & WR_FINITE) || wr_finite_bits(((const uint32_t*)r.src)[i]);
}

// The value (its bits) that element takes: a selection's `first` where
// `flag`, else `src`; a sanitized row's `src`, through nan_to_num where
// `flag` (the env is bad). False past the row's end.
WR_HD bool wr_load(const WrArgs& a, int e, int c, int lane, bool flag, uint32_t* v) {
  const int64_t i = wr_index(a, e, c, lane);
  if (i < 0) return false;
  const WrRow& r = a.rows[a.chunk_row[c]];
  if (r.kind & WR_SANITIZE) {
    const uint32_t x = ((const uint32_t*)r.src)[i];
    *v = flag ? wr_bits(wr_nan_to_num(wr_float(x))) : x;
  } else if (r.kind & WR_BYTE1) {
    *v = ((const uint8_t*)(flag ? r.first : r.src))[i];
  } else {
    *v = ((const uint32_t*)(flag ? r.first : r.src))[i];
  }
  return true;
}

WR_HD void wr_store(const WrArgs& a, int e, int c, int lane, uint32_t v) {
  const int64_t i = wr_index(a, e, c, lane);
  const WrRow& r = a.rows[a.chunk_row[c]];
  if (r.kind & WR_BYTE1)
    ((uint8_t*)r.out)[i] = (uint8_t)v;
  else
    ((uint32_t*)r.out)[i] = v;
}

// pre, per env: the step count, zeroed where the env was done.
WR_HD void wr_pre_env(const WrArgs& a, int e, bool done_prev) {
  a.steps_out[e] = done_prev ? 0.0f : a.steps[e];
}

// post, per env: reward and done quarantined, then the step count, the
// limit, done and truncation; with the sums, the episode's reward, length
// and done (`alive` from the done before this step).
WR_HD void wr_post_env(const WrArgs& a, int e, bool bad) {
  const float reward = bad ? 0.0f : a.reward[e];
  const float done_q = bad ? 1.0f : a.done[e];
  const float steps = a.steps[e] + a.repeat;
  const bool at_limit = steps >= a.limit;
  const float done = at_limit ? 1.0f : done_q;
  a.reward_out[e] = reward;
  a.steps_out[e] = steps;
  a.done_out[e] = done;
  a.truncation_out[e] = (at_limit ? 1.0f : 0.0f) * (1.0f - done_q);
  if (a.ep_done) {
    const float ep_done = a.ep_done[e];
    const float alive = 1.0f - ep_done;
    a.ep_reward_out[e] = a.ep_reward[e] + alive * reward;
    a.ep_length_out[e] = a.ep_length[e] + alive;
    a.ep_done_out[e] = wr_maximum(ep_done, done);
  }
}

// post, per env: scalar leaf `s`.
WR_HD void wr_scalar(const WrArgs& a, int e, int s, bool bad) {
  const WrScalar& r = a.scalars[s];
  const float x = bad ? wr_nan_to_num(r.src[e]) : r.src[e];
  r.out[e] = x;
  if (r.acc) r.acc_out[e] = r.acc[e] + (1.0f - a.ep_done[e]) * x;
}
