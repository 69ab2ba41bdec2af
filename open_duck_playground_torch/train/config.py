"""Pinned PPO sizes of the training rollout (the values of
`open_duck_playground_tpu/train/config.py:ppo_config` this package uses)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 8192
    unroll_length: int = 20
    episode_length: int = 1000
    policy_hidden_layer_sizes: Tuple[int, ...] = (128, 128, 128, 128)
    value_hidden_layer_sizes: Tuple[int, ...] = (256, 256, 256, 256)
    policy_obs_key: str = "state"
    value_obs_key: str = "privileged_state"
