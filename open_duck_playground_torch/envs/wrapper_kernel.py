"""The training wrapper's step on the card as two hand-written CUDA kernels
around the task's step (`csrc/wrapper_step.cu`, body in `wrapper_step.cuh`).

`TrainingEnv._step` on CUDA tensors (and so `EvalEnv`'s, which a CUDA graph
replays) calls `step` here: one launch (`wr_pre`) takes the autoreset, the
task steps `action_repeat` times, and one launch (`wr_post`) takes the
finite check, the quarantine, nan_to_num of the bad envs' `info` and
`metrics`, the step count, the episode limit, done and truncation, and,
where the state carries the evaluator's sums (`info["eval_metrics"]`),
those sums. `TrainingEnv.eager_step` is the plain version: the CPU's path
and the reference of the tests; every output here is its bit for bit.

One library serves every task and layout: the tree's leaves reach the
kernels as a table (`WrArgs`: each leaf's pointers, row width and kind, and
the chunks of 32 elements the rows split into) passed by value in the
kernel's parameters, so a CUDA graph captures it and an eager launch
uploads nothing and synchronizes nothing. Integer and bool leaves are
selected or passed through, never sanitized, as in the eager body. The
library is built with nvcc at first use into `build/kernels/` and bound
with ctypes; a launch runs on the tensors' current stream, and the
outputs are allocated here with torch.empty.

Counters: `launches`, fused wrapper steps (one per `wr_post` launch, and
one per replay of a CUDA graph that captured one); `eager_steps`, eager
wrapper bodies on CUDA tensors (`count_eager_step`), counted the same way.
`reset_counts` zeroes both.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional

import torch

from open_duck_playground_torch import cuda_build
from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.physics.types import Data

SOURCE, HEADERS = "wrapper_step.cu", ("wrapper_step.cuh",)
TPU_KERNEL = "none: the JAX package's envs/wrappers.py step, fused by XLA"

# wrapper_step.cuh's sizes and WrRow kinds (`WrapperLibrary` checks them
# against the library's `wr_layout`)
LANES, MAX_ROWS, MAX_SCALARS, MAX_CHUNKS = 32, 48, 32, 160
SANITIZE, BYTE1, FINITE = 1, 2, 4

launches = 0
eager_steps = 0


def reset_counts() -> None:
    global launches, eager_steps
    launches = 0
    eager_steps = 0


def _count_fused() -> None:
    global launches
    launches += 1


def _count_eager() -> None:
    global eager_steps
    eager_steps += 1


def count_eager_step() -> None:
    """Count an eager wrapper body on CUDA tensors (inside a CUDA graph's
    capture: once per replay)."""
    MK.launched(_count_eager)


# ------------------------------------------------------------ the table
class WrRow(ctypes.Structure):
    _fields_ = [("first", ctypes.c_void_p), ("src", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("width", ctypes.c_int32), ("kind", ctypes.c_int32)]


class WrScalar(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("src", "out", "acc", "acc_out")]


HEAD = ("done", "reward", "steps", "ep_reward", "ep_length", "ep_done", "done_out", "reward_out", "steps_out",
        "truncation_out", "ep_reward_out", "ep_length_out", "ep_done_out")


class WrArgs(ctypes.Structure):
    _fields_ = [*((name, ctypes.c_void_p) for name in HEAD),
                *((name, ctypes.c_int32) for name in ("batch", "nrows", "nscalars", "nchunks", "nfinite")),
                ("repeat", ctypes.c_float), ("limit", ctypes.c_float),
                ("rows", WrRow * MAX_ROWS), ("scalars", WrScalar * MAX_SCALARS),
                ("chunk_row", ctypes.c_uint8 * MAX_CHUNKS), ("chunk_part", ctypes.c_uint8 * MAX_CHUNKS)]


class _Table:
    """One launch's WrArgs being filled, and the tensors whose addresses it
    holds (a CUDA graph that captures the launch keeps them)."""

    def __init__(self, batch: int, dev: torch.device, repeat: int = 0, limit: int = 0):
        self.args = WrArgs(batch=batch, repeat=repeat, limit=limit)
        self.batch, self.dev = batch, dev
        self.held: List[torch.Tensor] = []

    def _input(self, name: str, t) -> torch.Tensor:
        if not isinstance(t, torch.Tensor) or t.device != self.dev or t.dim() == 0 or t.shape[0] != self.batch:
            raise TypeError(f"{name}: the wrapper kernels take tensors of {self.batch} rows on {self.dev}, got "
                            f"{type(t).__name__} {tuple(getattr(t, 'shape', ()))} on {getattr(t, 'device', None)}")
        t = t.contiguous()
        self.held.append(t)
        return t

    def _new(self, like: torch.Tensor) -> torch.Tensor:
        out = torch.empty(like.shape, dtype=like.dtype, device=self.dev)
        self.held.append(out)
        return out

    def head(self, inputs: dict, outputs) -> dict:
        """Point the table at the per-env float32 `inputs` and at new
        tensors for `outputs` (HEAD names); returns the new ones by name."""
        for name, t in inputs.items():
            t = self._input(name, t)
            if t.dtype != torch.float32 or t.dim() != 1:
                raise TypeError(f"{name}: the wrapper kernels take float32 ({self.batch},), got {t.dtype} "
                                f"{tuple(t.shape)}")
            setattr(self.args, name, t.data_ptr())
        outs = {}
        for name in outputs:
            outs[name] = torch.empty(self.batch, dtype=torch.float32, device=self.dev)
            self.held.append(outs[name])
            setattr(self.args, name, outs[name].data_ptr())
        return outs

    def row(self, name: str, first: Optional[torch.Tensor], src: torch.Tensor, kind: int = 0) -> torch.Tensor:
        """A new output of `src`'s shape: the selection between `first` and
        `src`, or (`kind` SANITIZE, `first` None) `src` sanitized where bad;
        FINITE asks the post launch to check `src`."""
        src = self._input(name, src)
        if first is not None:
            first = self._input(name, first)
            if first.shape != src.shape or first.dtype != src.dtype:
                raise TypeError(f"{name}: the cached reset leaf is {first.dtype} {tuple(first.shape)}, the state's "
                                f"{src.dtype} {tuple(src.shape)}")
        size = src.element_size()
        if ((kind & (SANITIZE | FINITE)) and src.dtype != torch.float32) or size not in (1, 4):
            raise TypeError(f"{name}: the wrapper kernels take float32, 4-byte and 1-byte leaves, got {src.dtype}")
        out = self._new(src)
        width = src[0].numel()
        if width == 0:
            return out
        a = self.args
        if a.nrows == MAX_ROWS or a.nchunks + -(-width // LANES) > MAX_CHUNKS or width > 256 * LANES:
            raise NotImplementedError(f"the wrapper kernels take {MAX_ROWS} rows of {MAX_CHUNKS} chunks of {LANES}")
        a.rows[a.nrows] = WrRow(None if first is None else first.data_ptr(), src.data_ptr(), out.data_ptr(),
                                width, kind | (BYTE1 if size == 1 else 0))
        for part in range(-(-width // LANES)):
            a.chunk_row[a.nchunks], a.chunk_part[a.nchunks] = a.nrows, part
            a.nchunks += 1
        a.nrows += 1
        return out

    def sanitized(self, name: str, v, acc: Optional[torch.Tensor] = None):
        """`v` as the post launch leaves it: a float32 tensor sanitized where
        the env is bad, anything else as it is; with `acc`, also the sum
        `acc + alive * v` (the evaluator's). Returns (leaf, sum or None)."""
        if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
            if acc is not None:
                raise TypeError(f"{name}: the evaluator sums float leaves")
            return v, None
        v = self._input(name, v)
        if v[0].numel() != 1:
            if acc is not None:
                raise TypeError(f"{name}: the evaluator sums leaves of one value per env")
            return self.row(name, None, v, SANITIZE), None
        if v.dtype != torch.float32:
            raise TypeError(f"{name}: the wrapper kernels sanitize float32 leaves, got {v.dtype}")
        a = self.args
        if a.nscalars == MAX_SCALARS:
            raise NotImplementedError(f"the wrapper kernels take {MAX_SCALARS} leaves of one value per env")
        out, acc_out = self._new(v), None
        if acc is not None:
            acc = self._input(name, acc)
            if acc.dtype != torch.float32 or acc.shape != v.shape:
                raise TypeError(f"{name}: the evaluator's sum is {acc.dtype} {tuple(acc.shape)}")
            acc_out = self._new(acc)
        a.scalars[a.nscalars] = WrScalar(v.data_ptr(), out.data_ptr(), None if acc is None else acc.data_ptr(),
                                         None if acc_out is None else acc_out.data_ptr())
        a.nscalars += 1
        return out, acc_out


# ------------------------------------------------------------ build and bind
def layout() -> tuple:
    """The table's format as this module builds it, in `wr_layout`'s order."""
    return ctypes.sizeof(WrArgs), LANES, MAX_ROWS, MAX_SCALARS, MAX_CHUNKS, SANITIZE, BYTE1, FINITE


class WrapperLibrary:
    """One built library of the two kernels: `library` builds the card's
    with nvcc; the CPU tests build the host harness
    (`csrc/wrapper_step_host.cpp`), which has the same interface."""

    def __init__(self, built: cuda_build.Library):
        lib = built.lib
        for fn in (lib.wr_pre, lib.wr_post):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.wr_layout.argtypes = [ctypes.c_void_p]
        lib.wr_layout.restype = ctypes.c_int
        got = (ctypes.c_int32 * 16)()
        self.layout = tuple(got[:lib.wr_layout(got)])
        if self.layout != layout():
            raise RuntimeError(f"the library's table format {self.layout} is not the wrapper's {layout()} "
                               "(size of WrArgs, lanes, rows, scalars, chunks, kinds)")
        self.built, self.lib = built, lib

    def launch(self, fn: str, table: _Table) -> None:
        """`fn` (wr_pre or wr_post) on the current stream of the table's
        device."""
        dev = table.dev
        stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
        err = getattr(self.lib, fn)(ctypes.byref(table.args), stream)
        if err:
            raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


_LIBRARY: List[WrapperLibrary] = []


def library() -> WrapperLibrary:
    """The card's library, built at first use."""
    if not _LIBRARY:
        built = cuda_build.build(SOURCE, [f"-I{cuda_build.CSRC}", "-fmad=false"], headers=HEADERS)
        _LIBRARY.append(WrapperLibrary(built))
    return _LIBRARY[0]


# -------------------------------------------------------------------- step
def step(task_steps: Callable, state: State, action: torch.Tensor, draws, repeat: int, limit: int,
         lib: Optional[WrapperLibrary] = None) -> State:
    """The wrapper's step (`TrainingEnv.eager_step`, with the evaluator's
    sums where the state carries them) through the two kernels around
    `task_steps(state, action, draws)`, the task's step `repeat` times, for
    episodes of `limit` steps; `lib` is the card's library unless given
    (the CPU tests give the host harness's)."""
    lib = library() if lib is None else lib
    dev, B = state.done.device, state.done.shape[0]
    info = dict(state.info)
    em = info.pop("eval_metrics", None)
    first_data, first_obs = info.pop("first_data"), info.pop("first_obs")
    steps = info.pop("steps")
    info.pop("truncation")

    # the autoreset: the cached reset state where done was reported
    pre = _Table(B, dev)
    steps_prev = pre.head({"done": state.done, "steps": steps}, ["steps_out"])["steps_out"]
    data = Data(**{k: pre.row(k, v, getattr(state.data, k)) for k, v in first_data.fields()})
    obs = {k: pre.row(k, v, state.obs[k]) for k, v in first_obs.items()}
    lib.launch("wr_pre", pre)
    nstate = task_steps(state.replace(data=data, obs=obs, info=info), action, draws)

    # the quarantine of non-finite envs, the step count and the sums
    if set(nstate.obs) != set(first_obs):
        raise ValueError(f"the step's observations {list(nstate.obs)}, the reset's {list(first_obs)}")
    post = _Table(B, dev, repeat, limit)
    checked = {("data", "qpos"): (first_data.qpos, nstate.data.qpos),
               ("data", "qvel"): (first_data.qvel, nstate.data.qvel),
               **{("obs", k): (v, nstate.obs[k]) for k, v in first_obs.items()}}
    selected = {key: post.row(key[1], first, src, FINITE if src.dtype == torch.float32 else 0)
                for key, (first, src) in checked.items()}
    post.args.nfinite = post.args.nchunks
    data = Data(**{k: selected[("data", k)] if ("data", k) in selected else post.row(k, v, getattr(nstate.data, k))
                   for k, v in first_data.fields()})
    obs = {k: selected[("obs", k)] for k in first_obs}
    ninfo = {k: post.sanitized(k, v)[0] for k, v in nstate.info.items()}
    sums = {} if em is None else em["episode_metrics"]
    missing = set(sums) - set(nstate.metrics)
    if missing:
        raise KeyError(f"the evaluator sums metrics the step does not give: {sorted(missing)}")
    metrics, metric_sums = {}, {}
    for k, v in nstate.metrics.items():
        metrics[k], metric_sums[k] = post.sanitized(k, v, sums.get(k))
    ep = {} if em is None else {"ep_reward": em["episode_reward"], "ep_length": em["episode_length"],
                                "ep_done": em["episode_done"]}
    outs = post.head({"done": nstate.done, "reward": nstate.reward, "steps": steps_prev, **ep},
                     ["done_out", "reward_out", "steps_out", "truncation_out", *(f"{k}_out" for k in ep)])
    lib.launch("wr_post", post)
    MK.launched(_count_fused, pre.held + post.held)

    ninfo["steps"] = outs["steps_out"]
    ninfo["truncation"] = outs["truncation_out"]
    ninfo["first_data"] = first_data
    ninfo["first_obs"] = first_obs
    if em is not None:
        ninfo["eval_metrics"] = {
            "episode_reward": outs["ep_reward_out"],
            "episode_length": outs["ep_length_out"],
            "episode_done": outs["ep_done_out"],
            "episode_metrics": {k: metric_sums[k] for k in sums},
        }
    return nstate.replace(data=data, obs=obs, reward=outs["reward_out"], done=outs["done_out"], info=ninfo,
                          metrics=metrics)
