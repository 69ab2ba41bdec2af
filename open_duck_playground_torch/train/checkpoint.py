"""Checkpoints of the trainer, torch-native. Counterpart of
`open_duck_playground_tpu/train/checkpoint.py` with the same path layout
(`<out>/<YYYY_MM_DD_HHMMSS>_<step>`, a directory) and the same two layouts:

- the full training state (`save_training_state`): the normalizer, the
  network's parameters, Adam's moments and step, `env_steps` and the
  training generator's state, so a resumed run continues exactly;
- the legacy `(normalizer, params)` pair (`save`), from which a resume
  starts Adam afresh and counts steps from zero.

The directory holds one file, `STATE_FILE`, written by `torch.save` and read
with `weights_only=True`: tensors, numbers, strings and containers only.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Tuple

import torch

from open_duck_playground_torch.train import running_stats as RS

STATE_FILE = "state.pt"


def to_host(x):
    """A CPU copy of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def _normalizer_dict(n: RS.RunningStats) -> dict:
    return to_host({"count": n.count, "mean": n.mean, "summed_var": n.summed_var, "std": n.std})


def _normalizer(d: dict, device) -> RS.RunningStats:
    to = lambda x: x.to(device)
    return RS.RunningStats(count=to(d["count"]), mean={k: to(v) for k, v in d["mean"].items()},
                           summed_var={k: to(v) for k, v in d["summed_var"].items()},
                           std={k: to(v) for k, v in d["std"].items()})


def _write(path, obj) -> None:
    path = pathlib.Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path / STATE_FILE)


def restore(path):
    """The raw content of a checkpoint directory, on the CPU."""
    return torch.load(pathlib.Path(path).absolute() / STATE_FILE, map_location="cpu",
                      weights_only=True)


def save(path, variables) -> None:
    """The legacy layout: `variables` = (normalizer, net)."""
    normalizer, net = variables
    _write(path, (_normalizer_dict(normalizer), to_host(net.state_dict())))


def save_training_state(path, training_state, generator_state: torch.Tensor) -> None:
    """The full layout: everything `restore_training_state` needs to resume
    (`training_state` is a `ppo.TrainingState`)."""
    ts = training_state
    _write(path, {
        "normalizer": _normalizer_dict(ts.normalizer),
        "params": to_host(ts.net.state_dict()),
        "opt_state": to_host(ts.optimizer.state_dict()),
        "env_steps": int(ts.env_steps),
        "generator": to_host(generator_state),
    })


def restore_training_state(path, training_state) -> Tuple[object, Optional[torch.Tensor]]:
    """Load a checkpoint into `training_state` (its network and optimizer
    in place). Returns (training_state, generator state or None). The full
    layout continues Adam's moments and step and `env_steps`; the legacy
    layout loads the normalizer and parameters, re-initializes Adam and
    zeroes the steps."""
    ts = training_state
    device = next(ts.net.parameters()).device
    raw = restore(path)
    if isinstance(raw, dict) and "opt_state" in raw:
        ts.net.load_state_dict(raw["params"])
        ts.optimizer.load_state_dict(raw["opt_state"])
        ts.normalizer = _normalizer(raw["normalizer"], device)
        ts.env_steps = int(raw["env_steps"])
        return ts, raw["generator"]
    normalizer, params = raw
    ts.net.load_state_dict(params)
    ts.optimizer.state.clear()
    ts.normalizer = _normalizer(normalizer, device)
    ts.env_steps = 0
    return ts, None
