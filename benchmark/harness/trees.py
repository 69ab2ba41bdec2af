"""Nested states and draws (dataclasses, dicts, lists of tensors): map a
function over their tensors, take some envs' rows, and move an instance
to another module's class of the same name (the port's draws from the
benchmark's, the reference's state from the port's)."""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict

import torch


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], x, classes: Dict[str, type] = None):
    """`fn` on every tensor of `x`; a dataclass instance is rebuilt as the
    class of its name in `classes` where that has one, else as its own."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = (classes or {}).get(type(x).__name__, type(x))
        return cls(**{f.name: tree_map(fn, getattr(x, f.name), classes)
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: tree_map(fn, v, classes) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v, classes) for v in x)
    return x


def recast(x, classes: Dict[str, type]):
    """`x` with each dataclass instance as the same-named class of
    `classes`; the tensors are shared."""
    return tree_map(lambda t: t, x, classes)


def rows(x, index: torch.Tensor):
    """The rows `index` of every tensor's leading (env) axis."""
    return tree_map(lambda t: t.index_select(0, index.to(t.device)), x)


def to(x, device, classes: Dict[str, type] = None):
    return tree_map(lambda t: t.to(device), x, classes)


def classes_of(*modules) -> Dict[str, type]:
    """The dataclasses defined in `modules`, by name."""
    out = {}
    for mod in modules:
        for name, obj in vars(mod).items():
            if isinstance(obj, type) and dataclasses.is_dataclass(obj) and obj.__module__ == mod.__name__:
                out[name] = obj
    return out


def package_classes(package: str) -> Dict[str, type]:
    """The dataclasses of every module of `package` imported so far, by
    name (no two of one package share a name)."""
    return classes_of(*[mod for name, mod in list(sys.modules.items())
                        if mod is not None and (name == package or name.startswith(package + "."))])


def cat(xs):
    """The trees `xs` (of one structure) joined along the env axis."""
    x = xs[0]
    if isinstance(x, torch.Tensor):
        return torch.cat(xs, 0)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: cat([getattr(y, f.name) for y in xs]) for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: cat([y[k] for y in xs]) for k in x}
    if isinstance(x, (list, tuple)):
        return type(x)(cat(list(ys)) for ys in zip(*xs))
    return x


def split(x, n: int):
    """`x` cut into `n` equal blocks of envs (the inverse of `cat`)."""
    size = next(tensors(x)).shape[0] // n
    return [tree_map(lambda t, a=i * size: t[a : a + size], x) for i in range(n)]


def tensors(x):
    """The tensors of `x`, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from tensors(getattr(x, f.name))
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from tensors(v)
