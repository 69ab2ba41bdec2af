"""CUDA graphs of the evaluator's control step.

`EvalEnv.step` on CUDA tensors under `torch.no_grad()` replays its whole
body (the wrapper, the task and the physics launch, ~385 kernels) as one
CUDA graph instead of launching it kernel by kernel from Python; in front
of it `ppo.run_eval` replays a second graph, of the step's random draws
and the policy (`ppo.eval_actor`, ~90 kernels). `StepGraphs` keys the
graphs on what the input shows: the structure of the arguments (for the
env step: state, action, draws) with each tensor's shape, dtype and
device, and what the caller names besides: the model the body computes
with (the robot's; the policy's network) and the generator it draws
from, by identity, and hashable values. For one key:

1. the first call runs the body eagerly on a side stream, the warm-up that
   `torch.cuda.graphs` asks for (cuBLAS makes a stream's workspace at its
   first product, the gravity observation's `torch.matmul`);
2. the second captures the body on that stream, then replays it;
3. every later call copies its arguments into the graph's static buffers
   (one `torch._foreach_copy_` per dtype), replays the graph and clones
   the output out: one flat buffer per dtype, whose views are the leaves
   it returns. An output leaf that is an argument's leaf itself (the body
   passes `first_data`, `first_obs` and the action through) is returned as
   the caller's own argument, as the eager body returns it.

No leaf of a returned state aliases a static buffer, so a state held
across later steps does not change under its holder. A CPU tensor, grad
enabled or a leaf that is not a tensor runs the body eagerly.

A body that draws from a CUDA generator of its own names it: the graph
registers the generator's state (`CUDAGraph.register_generator_state`),
so each replay draws what the eager body would from the generator's state
at that moment, and advances the state as far, whatever was drawn or
seeded between replays.

The physics launch inside a graph: `megakernel.capture` records it with
the tensors whose addresses it baked in, the model's record among them
(made in the warm-up: a launch carries its model by pointer), and each
replay counts it in `megakernel.launches` (`Captured.count_replay`). A
span (`utils/tracing.py`; `env.graph` for the env step, `act.graph` for
the draws and the policy) covers the copy-in, the replay and the
copy-out: its calls are the replays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.utils import tracing

# the spec head of a tensor; a container's head is its type
_TENSOR = object()
_FIELDS: Dict[type, Tuple[str, ...]] = {}
# what a key holds before its graph: its arguments run the body eagerly
# for good (not all on one card), or its warm-up ran
_EAGER, _WARM = object(), object()


class _Unsupported(Exception):
    """A leaf that is not a tensor."""


def flatten(tree, leaves: List[torch.Tensor]):
    """A hashable spec of `tree` (dicts, lists, tuples and dataclasses of
    tensors), with each tensor's shape, dtype and device index (-1 on the
    CPU); the tensors are appended to `leaves` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (_TENSOR, tree.shape, tree.dtype, tree.get_device())
    if isinstance(tree, dict):
        return (dict, tuple(tree), tuple([flatten(v, leaves) for v in tree.values()]))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple([flatten(v, leaves) for v in tree]))
    cls = type(tree)
    names = _FIELDS.get(cls)
    if names is None:
        if not dataclasses.is_dataclass(tree):
            raise _Unsupported(cls.__name__)
        names = _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(tree))
    return (cls, names, tuple([flatten(getattr(tree, n), leaves) for n in names]))


def unflatten(spec, leaves):
    """The tree of `spec` with the tensors taken from the iterator
    `leaves` in order."""
    head = spec[0]
    if head is _TENSOR:
        return next(leaves)
    if head is dict:
        return dict(zip(spec[1], [unflatten(s, leaves) for s in spec[2]]))
    if head is list or head is tuple:
        return head([unflatten(s, leaves) for s in spec[1]])
    return head(**dict(zip(spec[1], [unflatten(s, leaves) for s in spec[2]])))


def _by_dtype(tensors) -> List[List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


@contextlib.contextmanager
def _gc_paused():
    """No garbage collection inside the block: a CUDA graph collected
    inside a capture would be destroyed inside it, which CUDA refuses, and
    the capture would fail."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    # per input dtype: the static buffers and the arguments' leaf indices
    inputs: List[Tuple[List[torch.Tensor], List[int]]]
    # per output dtype: the flat static buffer, the output leaf indices and
    # the captured leaves (their shapes)
    outputs: List[Tuple[torch.Tensor, List[int], List[torch.Tensor]]]
    # (output leaf, argument leaf) of the leaves the body passes through
    passed: List[Tuple[int, int]]
    n_out: int
    output_spec: tuple
    captured: MK.Captured
    held: tuple  # the model and the generator: the key holds their ids


class StepGraphs:
    """The CUDA graphs of one body, by key (module docstring); each replay
    opens the span `span`. The warm-ups and captures run on a side stream
    per device, from `streams` when given: graphs that share them share
    cuBLAS's workspace of each stream (32 MiB on an H100)."""

    def __init__(self, span: str = "env.graph", streams: Optional[Dict[int, torch.cuda.Stream]] = None):
        self._span = span
        self._graphs: Dict[tuple, object] = {}  # a _Graph, _WARM or _EAGER
        self.streams: Dict[int, torch.cuda.Stream] = {} if streams is None else streams

    def __len__(self) -> int:
        """The graphs captured."""
        return sum(isinstance(g, _Graph) for g in self._graphs.values())

    def __call__(self, body: Callable, args: tuple, model, values: tuple = (),
                 generator: Optional[torch.Generator] = None):
        """`body(*args)`: eager, or through the graph of its key, which holds
        the arguments' spec, the identity of `model` and of `generator` (the
        CUDA generator the body draws from, if any; the graph keeps both)
        and `values`."""
        if torch.is_grad_enabled():
            return body(*args)
        leaves: List[torch.Tensor] = []
        try:
            spec = flatten(args, leaves)
        except _Unsupported:
            return body(*args)
        key = (spec, id(model), id(generator), values)
        graph = self._graphs.get(key)
        if isinstance(graph, _Graph):
            return self._replay(graph, leaves)
        if graph is _EAGER:
            return body(*args)
        devices = {t.get_device() for t in leaves}
        if generator is not None and generator.device.type != "cuda":
            devices.add(-1)  # (a CUDA generator made for "cuda" names no index)
        dev = devices.pop() if len(devices) == 1 else -1
        if dev < 0:
            self._graphs[key] = _EAGER
            return body(*args)
        if graph is None:
            self._graphs[key] = _WARM
            return self._warm_up(body, args, dev)
        graph = self._graphs[key] = self._capture(body, spec, leaves, dev, model, generator)
        return self._replay(graph, leaves)

    def _stream(self, dev: int) -> torch.cuda.Stream:
        if dev not in self.streams:
            self.streams[dev] = torch.cuda.Stream(dev)
        return self.streams[dev]

    def _warm_up(self, body: Callable, args: tuple, dev: int):
        stream, current = self._stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = body(*args)
        current.wait_stream(stream)
        return out

    def _capture(self, body: Callable, spec, leaves, dev: int, model,
                 generator: Optional[torch.Generator]) -> _Graph:
        static = [t.clone(memory_format=torch.contiguous_format) for t in leaves]
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with _gc_paused(), MK.capture() as captured, torch.cuda.graph(graph, stream=self._stream(dev)):
            out = body(*unflatten(spec, iter(static)))
            out_leaves: List[torch.Tensor] = []
            output_spec = flatten(out, out_leaves)
            position = {id(t): i for i, t in enumerate(static)}
            passed = [(j, position[id(t)]) for j, t in enumerate(out_leaves) if id(t) in position]
            made = [j for j, t in enumerate(out_leaves) if id(t) not in position]
            outputs = []
            for group in _by_dtype([out_leaves[j] for j in made]):
                idx = [made[k] for k in group]
                refs = [out_leaves[j] for j in idx]
                outputs.append((_flatten_dense_tensors(refs), idx, refs))
        inputs = [([static[i] for i in idx], idx) for idx in _by_dtype(static)]
        return _Graph(graph, inputs, outputs, passed, len(out_leaves), output_spec, captured,
                      (model, generator))

    def _replay(self, g: _Graph, leaves: List[torch.Tensor]):
        with tracing.span(self._span):
            g.captured.count_replay()
            # inference mode skips the autograd bookkeeping of the copies and
            # of the views; the clones, made outside it, are normal tensors,
            # and so are views of them
            with torch.inference_mode():
                for static, idx in g.inputs:
                    torch._foreach_copy_(static, [leaves[i] for i in idx])
            g.graph.replay()
            clones = [flat.clone() for flat, _, _ in g.outputs]
            out: List[Optional[torch.Tensor]] = [None] * g.n_out
            with torch.inference_mode():
                for clone, (_, idx, refs) in zip(clones, g.outputs):
                    for j, t in zip(idx, _unflatten_dense_tensors(clone, refs)):
                        out[j] = t
            for j, i in g.passed:
                out[j] = leaves[i]
            return unflatten(g.output_spec, iter(out))
