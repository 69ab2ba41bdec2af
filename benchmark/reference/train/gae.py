"""Truncation-aware Generalized Advantage Estimation (brax semantics: a
truncated step neither bootstraps through termination nor passes credit
across the truncation boundary). Counterpart of
`open_duck_playground_tpu/train/gae.py`."""

from __future__ import annotations

from typing import Tuple

import torch


def compute_gae(
    truncation: torch.Tensor,  # (T, B)
    termination: torch.Tensor,  # (T, B)
    rewards: torch.Tensor,  # (T, B)
    values: torch.Tensor,  # (T, B)
    bootstrap_value: torch.Tensor,  # (B,)
    lambda_: float = 0.95,
    discount: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value targets, advantages), both (T, B) and detached: no gradient
    flows through them (stop_gradient in the reference), so the recursion
    runs without recording a graph."""
    with torch.no_grad():
        truncation_mask = 1 - truncation
        values_t1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
        deltas = (rewards + discount * (1 - termination) * values_t1 - values) * truncation_mask
        carry = discount * (1 - termination) * truncation_mask * lambda_

        acc = torch.zeros_like(bootstrap_value)
        vs_minus_v = [None] * deltas.shape[0]
        for t in range(deltas.shape[0] - 1, -1, -1):
            acc = deltas[t] + carry[t] * acc
            vs_minus_v[t] = acc
        vs = torch.stack(vs_minus_v) + values
        vs_t1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
        advantages = (rewards + discount * (1 - termination) * vs_t1 - values) * truncation_mask
    return vs, advantages
