"""Actor/critic MLPs and the tanh-Normal action distribution (brax
semantics). Counterpart of `open_duck_playground_tpu/train/networks.py`:
init, forward, sampling, postprocess, the deterministic action, `log_prob`
and `entropy`. Random numbers are arguments (`noise`), never drawn here
except by `normal_noise` from an explicit generator.

`matmul_dtype=torch.bfloat16` (the trainer's `bf16_matmuls`) gives the
JAX package's mixed-precision products (`jnp.dot` of bf16 operands with
`preferred_element_type=float32`): each product takes bf16-rounded inputs
and returns f32, in the form of an f32 product of the rounded operands (two
bf16 mantissas multiply exactly in f32, and TF32 is off). The backward pass
is JAX's transpose of that product: the gradients of both operands are
rounded to bf16. Parameters, biases, activations, gradients and Adam's
state stay f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from open_duck_playground_torch.physics.forward import pin_f32

_MIN_STD = 0.001
_LOG2 = 0.6931471805599453


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _Bf16Linear(torch.autograd.Function):
    """x W^T + b with bf16-rounded x and W and an f32 result; the operands'
    gradients are rounded to bf16 as JAX rounds them, the bias's is not."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xb, wb = _bf16(x), _bf16(weight)
        ctx.save_for_backward(xb, wb)
        return torch.matmul(xb, wb.t()) + bias

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = _bf16(torch.matmul(g, wb)) if ctx.needs_input_grad[0] else None
        gw = _bf16(torch.matmul(g2.t(), xb.reshape(-1, xb.shape[-1])))
        return gx, gw, g2.sum(0)


class MLP(nn.Module):
    """Linear layers with swish between them (none after the last)."""

    def __init__(self, sizes: Sequence[int], generator: Optional[torch.Generator] = None,
                 device="cuda", matmul_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if torch.device(device).type == "cuda":
            pin_f32()
        if matmul_dtype not in (None, torch.bfloat16):
            raise ValueError(f"matmul_dtype must be None or torch.bfloat16, got {matmul_dtype}")
        self.matmul_dtype = matmul_dtype
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
            if self.matmul_dtype is None:
                x = layer(x)
            else:
                x = _Bf16Linear.apply(x, layer.weight, layer.bias)
            if i < n - 1:
                x = nn.functional.silu(x)
        return x


class PPONetworks(nn.Module):
    """The policy MLP over the `state` obs and the value MLP over the
    `privileged_state` obs (asymmetric actor-critic)."""

    def __init__(self, policy: MLP, value: MLP, policy_obs_key: str = "state",
                 value_obs_key: str = "privileged_state"):
        super().__init__()
        self.policy = policy
        self.value_mlp = value
        self.policy_obs_key = policy_obs_key
        self.value_obs_key = value_obs_key

    @classmethod
    def init(cls, obs_sizes: Dict[str, int], action_size: int, policy_hidden: Sequence[int],
             generator: torch.Generator, device="cuda", policy_obs_key: str = "state",
             value_hidden: Sequence[int] = (256, 256, 256, 256),
             value_obs_key: str = "privileged_state",
             matmul_dtype: Optional[torch.dtype] = None):
        policy = MLP((obs_sizes[policy_obs_key], *policy_hidden, 2 * action_size),
                     generator, device, matmul_dtype)
        value = MLP((obs_sizes[value_obs_key], *value_hidden, 1), generator, device, matmul_dtype)
        return cls(policy, value, policy_obs_key, value_obs_key)

    def policy_logits(self, norm_obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.policy(norm_obs[self.policy_obs_key])

    def value(self, norm_obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.value_mlp(norm_obs[self.value_obs_key])[..., 0]


def dist_params(logits: torch.Tensor):
    loc, raw_scale = torch.chunk(logits, 2, dim=-1)
    # softplus as log(1 + e^x), like jax.nn.softplus (no linear cut-over)
    scale = _softplus(raw_scale) + _MIN_STD
    return loc, scale


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _tanh_log_det_jac(raw: torch.Tensor) -> torch.Tensor:
    return 2.0 * (_LOG2 - raw - _softplus(-2.0 * raw))


def log_prob(logits: torch.Tensor, raw_action: torch.Tensor) -> torch.Tensor:
    """Log-density of tanh(raw) under the squashed distribution, summed over
    the action dims."""
    loc, scale = dist_params(logits)
    z = (raw_action - loc) / scale
    lp = -0.5 * z * z - 0.5 * math.log(2 * math.pi) - torch.log(scale)
    return torch.sum(lp - _tanh_log_det_jac(raw_action), dim=-1)


def entropy(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Entropy estimate: the base Normal's entropy plus the log-det-jacobian
    at one sample, drawn with standard-normal `noise` (brax's estimator)."""
    loc, scale = dist_params(logits)
    base = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(scale)
    raw = loc + scale * noise
    return torch.sum(base + _tanh_log_det_jac(raw), dim=-1)


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
