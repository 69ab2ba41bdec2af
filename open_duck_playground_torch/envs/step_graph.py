"""CUDA graphs of the evaluator's env step.

`EvalEnv.step` on CUDA tensors under `torch.no_grad()` replays its whole
body (the wrapper, the task and the physics launch, ~385 kernels) as one
CUDA graph instead of launching it kernel by kernel from Python.
`StepGraphs` keys the graphs on what the input shows: the structure of
the arguments (state, action, draws) with each tensor's shape, dtype and
device, and the model object. For one key:

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

The physics launch inside a graph: `megakernel.capture` records it, and
before each replay `Captured.before_replay` uploads the model's structure
tables as an eager launch does and counts the launch in
`megakernel.launches`. The span `env.graph` (`utils/tracing.py`) covers
the copy-in, the replay and the copy-out: its calls are the replays.
"""

from __future__ import annotations

import dataclasses
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
    model: object  # the key holds its id


class StepGraphs:
    """The CUDA graphs of one env's step body, by key (module docstring)."""

    def __init__(self):
        self._graphs: Dict[tuple, object] = {}  # a _Graph, _WARM or _EAGER
        self._streams: Dict[int, torch.cuda.Stream] = {}

    def __len__(self) -> int:
        """The graphs captured."""
        return sum(isinstance(g, _Graph) for g in self._graphs.values())

    def __call__(self, body: Callable, args: tuple, model):
        """`body(*args)`: eager, or through the graph of its key."""
        if torch.is_grad_enabled():
            return body(*args)
        leaves: List[torch.Tensor] = []
        try:
            spec = flatten(args, leaves)
        except _Unsupported:
            return body(*args)
        key = (spec, id(model))
        graph = self._graphs.get(key)
        if isinstance(graph, _Graph):
            return self._replay(graph, leaves)
        if graph is _EAGER:
            return body(*args)
        devices = {t.get_device() for t in leaves}
        dev = devices.pop() if len(devices) == 1 else -1
        if dev < 0:
            self._graphs[key] = _EAGER
            return body(*args)
        if graph is None:
            self._graphs[key] = _WARM
            return self._warm_up(body, args, dev)
        graph = self._graphs[key] = self._capture(body, spec, leaves, dev, model)
        return self._replay(graph, leaves)

    def _stream(self, dev: int) -> torch.cuda.Stream:
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def _warm_up(self, body: Callable, args: tuple, dev: int):
        stream, current = self._stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = body(*args)
        current.wait_stream(stream)
        return out

    def _capture(self, body: Callable, spec, leaves, dev: int, model) -> _Graph:
        static = [t.clone(memory_format=torch.contiguous_format) for t in leaves]
        graph = torch.cuda.CUDAGraph()
        with MK.capture() as captured, torch.cuda.graph(graph, stream=self._stream(dev)):
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
        return _Graph(graph, inputs, outputs, passed, len(out_leaves), output_spec, captured, model)

    @staticmethod
    def _replay(g: _Graph, leaves: List[torch.Tensor]):
        with tracing.span("env.graph"):
            g.captured.before_replay()
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
