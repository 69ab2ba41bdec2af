// Test harness only, never a path of the port: the wrapper step's body
// (wrapper_step.cuh) compiled by a host C++ compiler and looped over the
// envs, chunks and lanes, so that the CPU tests hold its arithmetic against
// the eager `TrainingEnv.eager_step` on a machine without a card. Same C
// interface as wrapper_step.cu (the stream is not read); the table and the
// tensors are in host memory.
//
//   g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off
//       -o libwrapper_step_host.so wrapper_step_host.cpp
#include "wrapper_step.cuh"

static void wr_host_chunks(const WrArgs& a, int e, bool flag) {
  for (int c = 0; c < a.nchunks; c++)
    for (int lane = 0; lane < WR_LANES; lane++) {
      uint32_t v;
      if (wr_load(a, e, c, lane, flag, &v)) wr_store(a, e, c, lane, v);
    }
}

extern "C" {

int wr_layout(int32_t* out) { return wr_layout_fill(out); }

int wr_pre(const WrArgs* a, void*) {
  for (int e = 0; e < a->batch; e++) {
    const bool done_prev = a->done[e] > 0.0f;
    wr_pre_env(*a, e, done_prev);
    wr_host_chunks(*a, e, done_prev);
  }
  return 0;
}

int wr_post(const WrArgs* a, void*) {
  for (int e = 0; e < a->batch; e++) {
    bool ok = true;
    for (int c = 0; c < a->nfinite; c++)
      for (int lane = 0; lane < WR_LANES; lane++) ok = wr_finite(*a, e, c, lane) && ok;
    for (int s = 0; s < a->nscalars; s++) wr_scalar(*a, e, s, !ok);
    wr_post_env(*a, e, !ok);
    wr_host_chunks(*a, e, !ok);
  }
  return 0;
}

}  // extern "C"
