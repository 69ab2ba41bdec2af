"""Actor/critic MLPs and the tanh-Normal action distribution (brax
semantics). Counterpart of `open_duck_playground_tpu/train/networks.py` for
the rollout: init, forward, sampling, postprocess and the deterministic
action. `log_prob` and `entropy` come with the PPO update.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from open_duck_playground_torch.physics.forward import pin_f32

_MIN_STD = 0.001


class MLP(nn.Module):
    """Linear layers with swish between them (none after the last)."""

    def __init__(self, sizes: Sequence[int], generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if torch.device(device).type == "cuda":
            pin_f32()
        self.sizes = tuple(sizes)
        self.layers = nn.ModuleList(
            nn.Linear(din, dout, device=device) for din, dout in zip(sizes[:-1], sizes[1:])
        )
        with torch.no_grad():
            for layer in self.layers:
                # lecun uniform on the (in, out) kernel, zero bias
                bound = (3.0 / layer.in_features) ** 0.5
                w = torch.rand(layer.weight.shape, generator=generator,
                               device=generator.device if generator is not None else device)
                layer.weight.copy_(w * (2 * bound) - bound)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = nn.functional.silu(x)
        return x


class PPONetworks(nn.Module):
    """The policy MLP over the `state` obs (the value MLP comes with the
    PPO update)."""

    def __init__(self, policy: MLP, policy_obs_key: str = "state"):
        super().__init__()
        self.policy = policy
        self.policy_obs_key = policy_obs_key

    @classmethod
    def init(cls, obs_sizes: Dict[str, int], action_size: int, policy_hidden: Sequence[int],
             generator: torch.Generator, device="cuda", policy_obs_key: str = "state"):
        policy = MLP((obs_sizes[policy_obs_key], *policy_hidden, 2 * action_size),
                     generator, device)
        return cls(policy, policy_obs_key)

    def policy_logits(self, norm_obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.policy(norm_obs[self.policy_obs_key])


def dist_params(logits: torch.Tensor):
    loc, raw_scale = torch.chunk(logits, 2, dim=-1)
    # softplus as log(1 + e^x), like jax.nn.softplus (no linear cut-over)
    scale = torch.logaddexp(raw_scale, torch.zeros_like(raw_scale)) + _MIN_STD
    return loc, scale


def sample_raw(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Pre-tanh sample from standard-normal `noise` of the loc's shape."""
    loc, scale = dist_params(logits)
    return loc + scale * noise


def normal_noise(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    shape = logits.shape[:-1] + (logits.shape[-1] // 2,)
    return torch.randn(shape, generator=generator, device=logits.device, dtype=logits.dtype)


def postprocess(raw_action: torch.Tensor) -> torch.Tensor:
    return torch.tanh(raw_action)


def deterministic_action(logits: torch.Tensor) -> torch.Tensor:
    loc, _ = dist_params(logits)
    return torch.tanh(loc)
