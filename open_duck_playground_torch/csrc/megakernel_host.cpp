// Test harness only, never a path of the port: the megakernel body
// (megakernel.cuh) compiled by a host C++ compiler and looped over envs, so
// the CPU tests can hold the kernel's arithmetic against the torch engine on
// a machine without a card. Same C interface as megakernel.cu, with the
// model passed by pointer instead of through constant memory.
//
//   g++ -O2 -std=c++17 -shared -fPIC -DMK_NQ=... -o libmk_host.so megakernel_host.cpp
#include "megakernel.cuh"

extern "C" {

int mk_model_size() { return (int)sizeof(MkModel); }

int mk_host_step(const MkModel* model, const void* const* ptrs, int batch, int n_substeps) {
  MkArgs a = mk_args(ptrs, batch, n_substeps);
  for (int e = 0; e < batch; e++) mk_env_step(*model, a, e);
  return 0;
}

}  // extern "C"
