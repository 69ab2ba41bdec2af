"""Pinned PPO hyperparameters: the port's own copy of the values of
`open_duck_playground_tpu/train/config.py:ppo_config` (which follow the
mujoco_playground locomotion defaults) as a frozen dataclass. Override with
`dataclasses.replace(PPOConfig(), ...)` or keyword arguments."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class PPOConfig:
    num_timesteps: int = 150_000_000
    num_evals: int = 10
    reward_scaling: float = 1.0
    episode_length: int = 1000
    normalize_observations: bool = True
    action_repeat: int = 1
    unroll_length: int = 20
    num_minibatches: int = 32
    num_updates_per_batch: int = 4
    discounting: float = 0.97
    learning_rate: float = 3.0e-4
    entropy_cost: float = 1.0e-2
    num_envs: int = 8192
    batch_size: int = 256
    max_grad_norm: Optional[float] = 1.0
    clipping_epsilon: float = 0.3
    gae_lambda: float = 0.95
    normalize_advantage: bool = True
    num_eval_envs: int = 128
    deterministic_eval: bool = False
    seed: int = 0
    # bf16 operands with f32 results in the actor's and critic's products
    # (networks.MLP); off: f32 products, brax parity
    bf16_matmuls: bool = False
    policy_hidden_layer_sizes: Tuple[int, ...] = (128, 128, 128, 128)
    value_hidden_layer_sizes: Tuple[int, ...] = (256, 256, 256, 256)
    policy_obs_key: str = "state"
    value_obs_key: str = "privileged_state"

    @property
    def k_unrolls(self) -> int:
        """Unroll segments per env and training step: the rollout contract
        is batch_size * num_minibatches = k * num_envs, k >= 1."""
        total = self.batch_size * self.num_minibatches
        if total % self.num_envs or total < self.num_envs:
            raise ValueError(
                "PPO rollout contract: batch_size * num_minibatches must be a positive "
                f"multiple of num_envs, got {self.batch_size} * {self.num_minibatches} "
                f"and {self.num_envs}")
        return total // self.num_envs

    @property
    def steps_per_training_step(self) -> int:
        return self.k_unrolls * self.num_envs * self.unroll_length * self.action_repeat
