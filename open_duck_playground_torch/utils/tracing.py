"""Host-time spans at the port's layer boundaries.

    with tracing.span("env.task"):
        ...

A span measures the host seconds of its block on `time.perf_counter_ns`
and keeps, per name, in memory:

- `calls`: how many times it closed;
- `self_s`: its seconds less those its child spans cover (the spans opened
  inside it on the same thread);
- `first_self_s`: the self seconds of its first call alone, so that a
  cold start (lazy CUDA module loads, the first launch of each kernel)
  stays apart from the steady mean, (self_s - first_self_s) / (calls - 1).

A span opened inside an open span of the same name counts once: the inner
one is transparent (`EvalEnv.step` calls `TrainingEnv.step`, both
`env.wrapper`). A span neither launches device work nor synchronizes, so
on the card its seconds are the host's: where the host waits on the
device (a host synchronization), the span in which it waits holds that
wait.

While `torch.profiler` records, a span also opens the profiler range
`odp::<name>`, on the same clock as the device events, and adds nothing to
the aggregates: a traced stretch neither inflates the untraced means nor
loses its ranges.

The spans of the port, where the work happens:

| span | site | per |
|---|---|---|
| `policy` | `ppo.make_policy`'s policy; `ppo.generate_unroll`'s logits, sample and log-prob; in `run_eval` on the card only the warm-up and capture of `act.graph` | control step |
| `env.draws` | `ppo.eval_draws` (`run_eval`, as `policy`); `ppo.unroll_draws` in `training_step` | control step; training step |
| `act.graph` | `ppo.eval_actor` replaying its CUDA graph of the draws and the policy (`run_eval` on the card): copy-in, replay, copy-out | replay |
| `env.wrapper` | `TrainingEnv.step`, `EvalEnv.step`: autoreset, quarantine, episode sums | control step |
| `env.graph` | `EvalEnv.step` replaying its CUDA graph (`envs/step_graph.py`): copy-in, replay, copy-out | replay |
| `env.task` | `Joystick.step` (`Standing` inherits it) less the physics; under the graph only its warm-up and capture | control step |
| `env.physics` | `physics/forward.py:step`: the megakernel's packing, launch and unpacking, or the plain engine; as `env.task` | control step |
| `env.reset` | `TrainingEnv.reset`, `EvalEnv.reset` | reset |
| `ppo.init` | `ppo.init_training_state`: networks and Adam | run |
| `sgd.minibatch`, `sgd.loss`, `sgd.backward`, `sgd.optimizer` | `ppo.training_step`'s SGD step: the gather; `zero_grad` and `loss_fn`; `backward` (and the gradient all-reduce under a mesh); `apply_gradients` and the metrics kept | SGD step |

`snapshot()` returns the aggregates of every thread; `reset()` clears
them. The CLI writes their per-period differences to `metrics.jsonl`
(`host_s`); `tools/profile_step.py` reads them and their profiler ranges.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "odp::"

_perf_ns = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_totals: List[Dict[str, List[int]]] = []  # every thread's totals


class _State:
    """One thread's innermost open span and its totals per name:
    [calls, self_ns, first_self_ns]."""

    __slots__ = ("current", "totals")

    def __init__(self):
        self.current: Optional[span] = None
        self.totals: Dict[str, List[int]] = {}
        with _lock:
            _totals.append(self.totals)


class _Local(threading.local):
    def __init__(self):
        self.state = _State()


_local = _Local()


class span:
    """A context manager that times its block as the span `name`."""

    __slots__ = ("name", "state", "parent", "start", "child", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        state = _local.state
        parent = open_ = state.current
        name = self.name
        while open_ is not None:
            if open_.name == name:
                self.state = None  # a re-entry: its time stays with the spans around it
                return self
            open_ = open_.parent
        self.state, self.parent, self.child, self.annotation = state, parent, 0, None
        if _profiling():
            self.annotation = torch.profiler.record_function(PREFIX + name)
            self.annotation.__enter__()
        state.current = self
        self.start = _perf_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = _perf_ns()
        state = self.state
        if state is None:
            return False
        parent = state.current = self.parent
        elapsed = end - self.start
        if parent is not None:
            parent.child += elapsed
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
            return False
        own = elapsed - self.child
        total = state.totals.get(self.name)
        if total is None:
            state.totals[self.name] = [1, own, own]
        else:
            total[0] += 1
            total[1] += own
        return False


def snapshot() -> Dict[str, Dict[str, float]]:
    """{name: {"calls", "self_s", "first_self_s"}} over every thread (the
    first call of the thread that first closed the span)."""
    out: Dict[str, Dict[str, float]] = {}
    with _lock:
        tables = [dict(t) for t in _totals]
    for table in tables:
        for name, (calls, own, first) in table.items():
            if name in out:
                out[name]["calls"] += calls
                out[name]["self_s"] += own / 1e9
            else:
                out[name] = {"calls": calls, "self_s": own / 1e9, "first_self_s": first / 1e9}
    return out


def reset() -> None:
    """Clears the aggregates of every thread (open spans stay open)."""
    with _lock:
        for table in _totals:
            table.clear()
