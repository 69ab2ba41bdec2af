"""Running observation normalization (Welford over batches). Counterpart
of `open_duck_playground_tpu/train/running_stats.py`: `update` on a whole
batch, or the same result from moments about the old mean that the rollout
accumulates step by step (`zero_moments`, `accumulate_moments`,
`merge_moments`).

The moments are summed and merged in float64, the stats kept in float32. In
float32 the first merge (old mean 0) cancels: t2 - t1^2 / n for a feature
of mean 1 and std 2e-3 (gravity's z) keeps a few bits, and two orders of
the same sums (one process, or the ranks of a mesh) gave stds 1.4% apart."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

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


Moments = Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def _merged(stats: RunningStats, new_count, mean, summed_var) -> RunningStats:
    summed_var = {k: torch.clamp(v, min=0.0) for k, v in summed_var.items()}
    std = {k: torch.sqrt(v / new_count + 1e-6) for k, v in summed_var.items()}
    return RunningStats(count=new_count, mean=mean, summed_var=summed_var, std=std)


def update(stats: RunningStats, obs: Dict[str, torch.Tensor]) -> RunningStats:
    """Fold a batch in; obs leaves have any leading batch dims."""
    any_leaf = next(iter(obs.values()))
    new_count = stats.count + any_leaf.numel() // any_leaf.shape[-1]
    mean, summed_var = {}, {}
    for k, x in obs.items():
        x2 = x.reshape(-1, x.shape[-1])
        diff = x2 - stats.mean[k]
        mean[k] = stats.mean[k] + diff.sum(0) / new_count
        summed_var[k] = stats.summed_var[k] + (diff * (x2 - mean[k])).sum(0)
    return _merged(stats, new_count, mean, summed_var)


def zero_moments(stats: RunningStats) -> Moments:
    """(t1, t2) float64 accumulators for `merge_moments`."""
    z = lambda v: torch.zeros_like(v, dtype=torch.float64)
    return ({k: z(v) for k, v in stats.mean.items()}, {k: z(v) for k, v in stats.mean.items()})


def accumulate_moments(stats: RunningStats, moments: Moments, obs: Dict[str, torch.Tensor]) -> Moments:
    """Add one batch of obs (leading dims flattened) into (t1, t2), summed
    in their dtype."""
    t1, t2 = moments
    nt1, nt2 = {}, {}
    for k, x in obs.items():
        y = x.reshape(-1, x.shape[-1]) - stats.mean[k]
        nt1[k] = t1[k] + y.sum(0, dtype=t1[k].dtype)
        nt2[k] = t2[k] + (y * y).sum(0, dtype=t2[k].dtype)
    return nt1, nt2


def merge_moments(stats: RunningStats, batch_count, t1: Dict[str, torch.Tensor],
                  t2: Dict[str, torch.Tensor]) -> RunningStats:
    """`update` from moments about the old mean, t1 = sum(x - mean) and
    t2 = sum((x - mean)^2): with d = t1 / new_count the new mean is
    mean + d and the summed variance grows by t2 - d * t1, in float64 and
    then rounded to the stats' dtype."""
    new_count = stats.count + batch_count
    mean, summed_var = {}, {}
    for k in t1:
        delta = t1[k] / new_count
        mean[k] = (stats.mean[k] + delta).to(stats.mean[k].dtype)
        summed_var[k] = (stats.summed_var[k] + (t2[k] - delta * t1[k])).to(stats.summed_var[k].dtype)
    return _merged(stats, new_count, mean, summed_var)
