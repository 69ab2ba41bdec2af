"""The system under test: the port's own entry points, built as its trainer
and its CLI build them. Imported only inside functions, after the run has
found its card."""

from __future__ import annotations

import dataclasses
import importlib
import types

import torch

from benchmark.harness import trees
from benchmark.reference.train import ppo as RP


def modules() -> types.SimpleNamespace:
    from open_duck_playground_torch.envs import randomize, wrappers
    from open_duck_playground_torch.train import config as pconfig, ppo

    return types.SimpleNamespace(randomize=randomize, wrappers=wrappers, ppo=ppo, pconfig=pconfig)


def classes() -> dict:
    """The port's dataclasses by name, to hand it the benchmark's draws."""
    return trees.package_classes("open_duck_playground_torch")


def env(P, config: dict, device):
    """The port's task of `config`: the class `env_class` of its module
    `envs/<env>.py`."""
    cls = getattr(importlib.import_module(f"open_duck_playground_torch.envs.{config['env']}"), config["env_class"])
    return cls(task=config["task"], config_overrides=config.get("env_overrides") or None, device=device)


def ppo_config(P, config: dict):
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in config["ppo"].items()}
    return dataclasses.replace(P.pconfig.PPOConfig(), **fields)


def set_weights(net: torch.nn.Module, params: RP.Params) -> None:
    """The benchmark's weights into the port's networks, leaf by leaf in
    parameter order (actor, then critic; weight, then bias)."""
    mine = list(net.parameters())
    if len(mine) != len(params.leaves) or any(p.shape != q.shape for p, q in zip(mine, params.leaves)):
        raise RuntimeError("the port's networks have another layout than the configuration's MLPs: "
                           f"{[tuple(p.shape) for p in mine]}")
    with torch.no_grad():
        for p, q in zip(mine, params.leaves):
            p.copy_(q)
