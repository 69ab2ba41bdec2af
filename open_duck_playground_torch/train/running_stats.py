"""Running observation normalization state: init and normalize.
Counterpart of `open_duck_playground_tpu/train/running_stats.py`; the
update (merge_moments) comes with the PPO update."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class RunningStats:
    count: torch.Tensor  # ()
    mean: Dict[str, torch.Tensor]
    summed_var: Dict[str, torch.Tensor]  # sum of squared deviations
    std: Dict[str, torch.Tensor]


def init(obs_sizes: Dict[str, int], device="cuda", dtype=torch.float32) -> RunningStats:
    z = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return RunningStats(
        count=torch.zeros((), dtype=dtype, device=device),
        mean={k: z(v) for k, v in obs_sizes.items()},
        summed_var={k: z(v) for k, v in obs_sizes.items()},
        std={k: torch.ones(v, dtype=dtype, device=device) for k, v in obs_sizes.items()},
    )


def normalize(stats: RunningStats, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (x - stats.mean[k]) / stats.std[k] for k, x in obs.items()}
