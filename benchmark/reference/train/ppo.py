"""Plain PPO pieces of the reference: the actor and critic MLPs as
functions of their weights, the tanh-Normal policy, the clipped-surrogate
loss of one minibatch (brax semantics, one process), the global-norm clip
and Adam as optax computes it. Written after the port's
`train/networks.py` and `train/ppo.py` (f32 products, no mesh) and importing
nothing of it."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.reference.train import gae, running_stats as RS

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
_MIN_STD = 0.001
_LOG2 = 0.6931471805599453

Layers = List[Tuple[torch.Tensor, torch.Tensor]]  # (weight (out, in), bias (out,)) per layer


def mlp(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """Linear layers with swish between them (none after the last)."""
    for i, (w, b) in enumerate(layers):
        x = torch.matmul(x, w.t()) + b
        if i < len(layers) - 1:
            x = torch.nn.functional.silu(x)
    return x


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def dist_params(logits: torch.Tensor):
    loc, raw_scale = torch.chunk(logits, 2, dim=-1)
    return loc, _softplus(raw_scale) + _MIN_STD


def _tanh_log_det_jac(raw: torch.Tensor) -> torch.Tensor:
    return 2.0 * (_LOG2 - raw - _softplus(-2.0 * raw))


def log_prob(logits: torch.Tensor, raw_action: torch.Tensor) -> torch.Tensor:
    loc, scale = dist_params(logits)
    z = (raw_action - loc) / scale
    lp = -0.5 * z * z - 0.5 * math.log(2 * math.pi) - torch.log(scale)
    return torch.sum(lp - _tanh_log_det_jac(raw_action), dim=-1)


def entropy(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    loc, scale = dist_params(logits)
    base = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(scale)
    return torch.sum(base + _tanh_log_det_jac(loc + scale * noise), dim=-1)


def sample_raw(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    loc, scale = dist_params(logits)
    return loc + scale * noise


class Params:
    """The actor's and the critic's layers, over one flat list of leaves
    (weight, bias, weight, bias, ... actor first)."""

    def __init__(self, leaves: Sequence[torch.Tensor], n_policy_layers: int):
        self.leaves = list(leaves)
        self.n_policy = n_policy_layers

    def _layers(self, a: int, b: int) -> Layers:
        return [(self.leaves[2 * i], self.leaves[2 * i + 1]) for i in range(a, b)]

    @property
    def policy(self) -> Layers:
        return self._layers(0, self.n_policy)

    @property
    def value(self) -> Layers:
        return self._layers(self.n_policy, len(self.leaves) // 2)


def policy_step(params: Params, normalizer: RS.RunningStats, obs: Dict[str, torch.Tensor],
                noise: torch.Tensor, policy_key: str = "state"):
    """(action, raw action, log-prob) of the stochastic policy at `obs`."""
    logits = mlp(RS.normalize(normalizer, obs)[policy_key], params.policy)
    raw = sample_raw(logits, noise)
    return torch.tanh(raw), raw, log_prob(logits, raw)


def loss(params: Params, normalizer: RS.RunningStats, data: dict, final_obs: Dict[str, torch.Tensor],
         entropy_noise: torch.Tensor, cfg, policy_key: str = "state",
         value_key: str = "privileged_state") -> torch.Tensor:
    """Clipped-surrogate PPO loss of one minibatch; `data` leaves are
    time-major (T, MB, ...), `final_obs` leaves (MB, ...)."""
    norm_obs = RS.normalize(normalizer, data["obs"])
    logits = mlp(norm_obs[policy_key], params.policy)
    baseline = mlp(norm_obs[value_key], params.value)[..., 0]
    bootstrap = mlp(RS.normalize(normalizer, final_obs)[value_key], params.value)[..., 0]
    rewards = data["reward"] * cfg.reward_scaling
    truncation = data["truncation"]
    termination = data["done"] * (1 - truncation)
    vs, advantages = gae.compute_gae(
        truncation=truncation, termination=termination, rewards=rewards, values=baseline,
        bootstrap_value=bootstrap, lambda_=cfg.gae_lambda, discount=cfg.discounting)
    if cfg.normalize_advantage:
        advantages = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
    rho = torch.exp(log_prob(logits, data["raw_action"]) - data["log_prob"])
    clipped = torch.clamp(rho, 1 - cfg.clipping_epsilon, 1 + cfg.clipping_epsilon) * advantages
    policy_loss = -torch.mean(torch.minimum(rho * advantages, clipped))
    v_error = vs - baseline
    v_loss = torch.mean(v_error * v_error) * 0.5 * 0.5
    entropy_loss = -cfg.entropy_cost * torch.mean(entropy(logits, entropy_noise))
    return policy_loss + v_loss + entropy_loss


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Adam:
    """optax.adam (eps_root 0) after optax.clip_by_global_norm."""

    def __init__(self, leaves: Sequence[torch.Tensor], learning_rate: float, max_grad_norm):
        self.lr, self.max_grad_norm = learning_rate, max_grad_norm
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    def clip(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.max_grad_norm is None:
            return list(grads)
        norm = global_norm(grads)
        scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
        return [g * scale for g in grads]

    def step(self, leaves: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """New leaves from clipped `grads` (the state advances in place)."""
        b1, b2 = ADAM_BETAS
        self.t += 1
        out = []
        for i, (p, g) in enumerate(zip(leaves, grads)):
            self.m[i] = b1 * self.m[i] + (1 - b1) * g
            self.v[i] = b2 * self.v[i] + (1 - b2) * g * g
            m_hat = self.m[i] / (1 - b1 ** self.t)
            v_hat = self.v[i] / (1 - b2 ** self.t)
            out.append(p - self.lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        return out
