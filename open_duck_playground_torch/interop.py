"""Carry weights and state over from the JAX package, through numpy only.

The arguments are JAX pytrees already converted to numpy (for example with
`jax.tree.map(np.asarray, tree)`): nested dicts, or objects with the same
attribute names. Each helper builds on `device`, the card unless the caller
passes "cpu". Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.physics.types import Data
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig
from open_duck_playground_torch.train.networks import MLP, PPONetworks
from open_duck_playground_torch.train.running_stats import RunningStats


def _get(tree: Any, key: str):
    return tree[key] if isinstance(tree, Mapping) else getattr(tree, key)


def _tensor(x, device="cuda") -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def mlp_from_jax(params: Mapping, device="cuda", matmul_dtype: Optional[torch.dtype] = None) -> MLP:
    """MLP from {"hidden_i": {"kernel": (in, out), "bias": (out,)}}, its
    products in `matmul_dtype` as the JAX network's (None: f32)."""
    n = len(params)
    kernels = [np.asarray(params[f"hidden_{i}"]["kernel"], np.float32) for i in range(n)]
    sizes = [kernels[0].shape[0]] + [k.shape[1] for k in kernels]
    mlp = MLP(sizes, device=device, matmul_dtype=matmul_dtype)
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            layer.weight.copy_(_tensor(kernels[i].T, device))
            layer.bias.copy_(_tensor(np.asarray(params[f"hidden_{i}"]["bias"], np.float32), device))
    return mlp


def networks_from_jax(params_np: Mapping, device="cuda",
                      matmul_dtype: Optional[torch.dtype] = None) -> PPONetworks:
    """PPONetworks from the JAX {"policy": ..., "value": ...} parameter tree
    (`matmul_dtype=torch.bfloat16` for a network trained with
    `bf16_matmuls`: the parameter tree does not say)."""
    return PPONetworks(mlp_from_jax(params_np["policy"], device, matmul_dtype),
                       mlp_from_jax(params_np["value"], device, matmul_dtype))


def normalizer_from_jax(stats_np: Any, device="cuda") -> RunningStats:
    """RunningStats from a JAX RunningStats (count, mean, summed_var, std)."""
    f = lambda x: _tensor(np.asarray(x, np.float32), device)
    d = lambda key: {k: f(v) for k, v in _get(stats_np, key).items()}
    return RunningStats(count=f(_get(stats_np, "count")), mean=d("mean"),
                        summed_var=d("summed_var"), std=d("std"))


def _data_from_jax(data_np: Any, device="cuda") -> Data:
    fields = {}
    for name in Data.__dataclass_fields__:
        fields[name] = _tensor(np.asarray(_get(data_np, name), np.float32), device)
    return Data(**fields)


def _value(x, device):
    if hasattr(x, "qpos"):
        return _data_from_jax(x, device)
    if isinstance(x, Mapping):
        return {k: _value(v, device) for k, v in x.items()}
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return _tensor(a, device)


def state_from_jax(state_np: Any, device="cuda") -> State:
    """A port State from a batched JAX State converted to numpy. The JAX
    env's PRNG key (`info["rng"]`) is dropped: the port takes its random
    numbers as explicit draws."""
    info = {k: _value(v, device) for k, v in _get(state_np, "info").items() if k != "rng"}
    return State(
        data=_data_from_jax(_get(state_np, "data"), device),
        obs={k: _value(v, device) for k, v in _get(state_np, "obs").items()},
        reward=_value(_get(state_np, "reward"), device),
        done=_value(_get(state_np, "done"), device),
        metrics={k: _value(v, device) for k, v in _get(state_np, "metrics").items()},
        info=info,
    )


def _adam_state(opt_state: Any):
    """The optax ScaleByAdamState (count, mu, nu) inside the optimizer
    state of the `clip_by_global_norm` -> `adam` chain, as a namedtuple or
    as the nested lists and dicts an orbax restore without a target gives."""
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        children = list(opt_state.values())
    elif hasattr(opt_state, "_fields"):
        if {"count", "mu", "nu"} <= set(opt_state._fields):
            return opt_state
        children = list(opt_state)
    elif isinstance(opt_state, (list, tuple)):
        children = list(opt_state)
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def training_state_from_jax(tree_np: Any, learning_rate: float = PPOConfig().learning_rate,
                            device="cuda") -> "ppo.TrainingState":
    """The port's TrainingState from the JAX trainer's full checkpoint
    (`save_training_state`: normalizer, params, opt_state, env_steps,
    epoch_key) read back as numpy. Adam's count, mu and nu become torch
    Adam's per-parameter `step`, `exp_avg` and `exp_avg_sq` (kernels
    transposed to the `(out, in)` weight layout), so a run trained with JAX
    resumes here with its moments and bias correction. The epoch key is not
    carried: threefry keys have no Philox counterpart."""
    net = networks_from_jax(_get(tree_np, "params"), device)
    optimizer = ppo.make_optimizer(net, learning_rate)
    adam = _adam_state(_get(tree_np, "opt_state"))
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in opt_state")
    mu, nu = _get(adam, "mu"), _get(adam, "nu")
    step = float(np.asarray(_get(adam, "count")))
    for name, mlp in (("policy", net.policy), ("value", net.value_mlp)):
        for i, layer in enumerate(mlp.layers):
            for attr, leaf in (("weight", "kernel"), ("bias", "bias")):
                pick = lambda tree: np.asarray(tree[name][f"hidden_{i}"][leaf], np.float32)
                m, v = pick(mu), pick(nu)
                if attr == "weight":
                    m, v = m.T, v.T
                optimizer.state[getattr(layer, attr)] = {
                    "step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": _tensor(m, device),
                    "exp_avg_sq": _tensor(v, device),
                }
    return ppo.TrainingState(net=net, optimizer=optimizer,
                             normalizer=normalizer_from_jax(_get(tree_np, "normalizer"), device),
                             env_steps=int(np.asarray(_get(tree_np, "env_steps"))))
