// Test harness only, never a path of the port: the task step's body
// (task_step.cuh) compiled by a host C++ compiler and looped over the envs,
// so that the CPU tests hold its arithmetic against the eager
// `Joystick.step` on a machine without a card. Same C interface as
// task_step.cu (the stream is not read); the record and the tensors are in
// host memory.
//
//   g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off -DTK_NQ=...
//       -o libtask_step_host.so task_step_host.cpp
#include "task_step.cuh"

extern "C" {

int tk_record_size() { return (int)sizeof(TkRecord); }

// out: the widths of the observations `state` and `privileged_state`.
void tk_obs_sizes(int* out) {
  out[0] = TK_NSTATE;
  out[1] = TK_NPRIV;
}

int tk_pre(const TkRecord* rec, const void* const* ptrs, int batch, void*) {
  const TkPre a = tk_pre_args(rec, ptrs, batch);
  for (int e = 0; e < batch; e++) tk_pre_env(*rec, a, e);
  return 0;
}

int tk_post(const TkRecord* rec, const void* const* ptrs, int batch, void*) {
  const TkPost a = tk_post_args(rec, ptrs, batch);
  for (int e = 0; e < batch; e++) tk_post_env(*rec, a, e);
  return 0;
}

}  // extern "C"
