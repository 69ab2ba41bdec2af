"""The env State, batched over a leading env axis.
Counterpart of `open_duck_playground_tpu/envs/env_types.py`."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch

from benchmark.reference.physics.types import Data

Observation = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class State:
    data: Data
    obs: Observation  # each (B, size)
    reward: torch.Tensor  # (B,)
    done: torch.Tensor  # (B,) float
    metrics: Dict[str, torch.Tensor]  # each (B,)
    info: Dict[str, Any]

    def replace(self, **updates) -> "State":
        return dataclasses.replace(self, **updates)
