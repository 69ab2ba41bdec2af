// Test harness only, never a path of the port: the megakernel body
// (megakernel.cuh) compiled by a host C++ compiler and looped over envs, so
// the CPU tests can hold the kernel's arithmetic against the torch engine on
// a machine without a card. Same C interface as megakernel.cu: the launch
// carries a pointer to the model's record in MkArgs, here in host memory.
//
// mk_host_step gives the body one lane (MkOneLane): every strided loop
// covers its whole range, the reductions are the identity and the env's
// working set is a plain local. Built with -DMK_HOST_LANES=n (2 to 32, a
// power of two), mk_host_step_lanes gives it n lanes, one host thread
// each, that meet at a pthread barrier where the card's lanes meet at a
// warp barrier and reduce in the card's butterfly order:
// it shows what one lane cannot, a value that only one lane holds, and,
// built with -fsanitize=thread, a missing barrier or two lanes writing one
// entry (the sanitizer knows the barrier and reports every access it does
// not order).
//
//   g++ -O2 -std=c++17 -shared -fPIC -pthread -DMK_NQ=... [-DMK_HOST_LANES=8]
//       -o libmk_host.so megakernel_host.cpp
//
// With -DMK_HOST_MAIN it is a program instead (the sanitizer cannot be
// loaded into a running Python): `mk_host <in> <out>` reads one launch from
// a file of 4-byte words, runs it on MK_HOST_LANES lanes and writes the
// outputs. The file holds batch, n_substeps, 0, then sizeof(MkModel) and the model, then for
// each of the MK_NPTR tensors its length in floats and, for an input, its
// values.
#include <cstdio>
#include <vector>

#include "megakernel.cuh"

#ifdef MK_HOST_LANES
#include <pthread.h>

#include <thread>

namespace {

template <int NLANES>
struct Team {
  pthread_barrier_t barrier;
  float fbuf[NLANES];
  int ibuf[NLANES];
};

// N host threads as the lanes of one env.
template <int NLANES>
struct ThreadLanes {
  static constexpr int N = NLANES;
  int lane;
  Team<NLANES>* team;

  void sync() const { pthread_barrier_wait(&team->barrier); }

  float sum(float v) const {
    for (int o = N / 2; o > 0; o >>= 1) {
      team->fbuf[lane] = v;
      sync();
      float w = team->fbuf[lane ^ o];
      sync();
      v += w;
    }
    return v;
  }

  int argmin(float v, int idx) const {
    for (int o = N / 2; o > 0; o >>= 1) {
      team->fbuf[lane] = v;
      team->ibuf[lane] = idx;
      sync();
      float v2 = team->fbuf[lane ^ o];
      int i2 = team->ibuf[lane ^ o];
      sync();
      if (idx < 0 || (i2 >= 0 && (v2 < v || (v2 == v && i2 < idx)))) {
        v = v2;
        idx = i2;
      }
    }
    team->ibuf[lane] = idx;
    sync();
    idx = team->ibuf[0];
    sync();
    return idx;
  }
};

template <int NLANES>
void run_lanes(const MkArgs& a) {
  static MkShared env;  // one env at a time, shared by the lanes
  static Team<NLANES> team;
  pthread_barrier_init(&team.barrier, nullptr, NLANES);
  std::vector<std::thread> lanes;
  for (int l = 0; l < NLANES; l++)
    lanes.emplace_back([&a, l] {
      ThreadLanes<NLANES> cx{l, &team};
      for (int e = 0; e < a.batch; e++) {
        mk_env_step(*a.model, a, e, env, cx);
        cx.sync();  // the next env reuses the working set
      }
    });
  for (auto& t : lanes) t.join();
  pthread_barrier_destroy(&team.barrier);
}

}  // namespace
#endif

namespace {

void step_one_lane(const MkArgs& a) {
  MkShared env;
  MkOneLane one;
  for (int e = 0; e < a.batch; e++) mk_env_step(*a.model, a, e, env, one);
}

}  // namespace

extern "C" {

int mk_model_size() { return (int)sizeof(MkModel); }

int mk_shared_size() { return (int)sizeof(MkShared); }

int mk_host_step(const MkModel* model, const void* const* ptrs, int batch, int n_substeps) {
  step_one_lane(mk_args(model, ptrs, batch, n_substeps));
  return 0;
}

#ifdef MK_HOST_LANES
// The same launch on MK_HOST_LANES lanes. Not reentrant.
int mk_host_step_lanes(const MkModel* model, const void* const* ptrs, int batch, int n_substeps) {
  run_lanes<MK_HOST_LANES>(mk_args(model, ptrs, batch, n_substeps));
  return 0;
}
#endif

}  // extern "C"

#ifdef MK_HOST_MAIN
int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* in = fopen(argv[1], "rb");
  if (!in) return 2;
  int head[4];
  static MkModel model;
  if (fread(head, 4, 4, in) != 4 || head[3] != (int)sizeof(MkModel)) return 3;
  if (fread(&model, sizeof(MkModel), 1, in) != 1) return 3;
  const int n_in = 14 + MK_HFIELD;
  std::vector<std::vector<float>> bufs(MK_NPTR);
  const void* ptrs[MK_NPTR];
  for (int i = 0; i < MK_NPTR; i++) {
    int n = 0;
    if (fread(&n, 4, 1, in) != 1) return 3;
    bufs[i].assign(n, 0.0f);
    if (i < n_in && fread(bufs[i].data(), 4, n, in) != (size_t)n) return 3;
    ptrs[i] = bufs[i].data();
  }
  fclose(in);
#ifdef MK_HOST_LANES
  run_lanes<MK_HOST_LANES>(mk_args(&model, ptrs, head[0], head[1]));
#else
  step_one_lane(mk_args(&model, ptrs, head[0], head[1]));
#endif
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 2;
  for (int i = n_in; i < MK_NPTR; i++) fwrite(bufs[i].data(), 4, bufs[i].size(), out);
  fclose(out);
  return 0;
}
#endif
