"""What the benchmark makes from `--seed` and hands to both the port and
the reference: the per-env domain-randomization draws, the reset draws of
the task and the networks' weights, from one `torch.Generator` on the
run's device, drawn by the reference's frozen samplers
(`benchmark/reference/envs`), so the same seed gives the same start
whatever the port's own samplers become. The random numbers of each
training step and each eval are the port's own, drawn from a generator of
its own seeded from `--seed` (`program_generator`), as its trainer draws
them; the recorders hand what it drew to the reference."""

from __future__ import annotations

import importlib
import time
import types
from typing import List, Sequence, Tuple

import torch

from benchmark.harness import trees
from benchmark.reference.envs import randomize as RR, wrappers as RW
from benchmark.reference.train import ppo as RP

PROGRAM_STREAM = 0x5EED0F


class Timings:
    """Seconds of each part of set-up, each ended by a synchronize."""

    def __init__(self, sync):
        self.sync, self.last, self.parts = sync, time.perf_counter(), {}

    def restart(self, **parts: float) -> None:
        self.parts, self.last = dict(parts), time.perf_counter()

    def mark(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


def reference_classes() -> dict:
    """The reference's dataclasses by name (states, draws, models)."""
    return trees.package_classes("benchmark.reference")


def reference_task_module(config: dict):
    return importlib.import_module(f"benchmark.reference.envs.{config['env']}")


def generator(seed: int, device) -> torch.Generator:
    """The run's generator; any whole number, taken modulo 2**63."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def program_generator(seed: int, device) -> torch.Generator:
    """The generator the port draws each step's random numbers from, as its
    trainer's: another stream of the same seed."""
    return generator(int(seed) ^ PROGRAM_STREAM, device)


def reference_env(config: dict, device):
    """The reference's task of `config`: the class `env_class` of the
    module `env` (`benchmark/reference/envs/<env>.py`), on `task` with the
    `env_overrides`."""
    cls = getattr(reference_task_module(config), config["env_class"])
    return cls(config["task"], config_overrides=config.get("env_overrides") or None, device=device)


def ppo_config(config: dict) -> types.SimpleNamespace:
    return types.SimpleNamespace(**config["ppo"])


def layer_sizes(config: dict, obs_sizes: dict, action_size: int) -> Tuple[List[int], List[int]]:
    p = config["ppo"]
    policy = [obs_sizes[p["policy_obs_key"]], *p["policy_hidden_layer_sizes"], 2 * action_size]
    value = [obs_sizes[p["value_obs_key"]], *p["value_hidden_layer_sizes"], 1]
    return policy, value


def weights(gen: torch.Generator, policy: Sequence[int], value: Sequence[int]) -> RP.Params:
    """Both MLPs' leaves (weight (out, in), bias; actor first) from one
    draw: lecun-uniform weights, zero biases, as the recipe initializes."""
    shapes = [(o, i) for sizes in (policy, value) for i, o in zip(sizes[:-1], sizes[1:])]
    flat = torch.rand(sum(o * i for o, i in shapes), generator=gen, device=gen.device)
    leaves, at = [], 0
    for o, i in shapes:
        bound = (3.0 / i) ** 0.5
        leaves.append(flat[at : at + o * i].reshape(o, i) * (2 * bound) - bound)
        leaves.append(torch.zeros(o, device=gen.device))
        at += o * i
    return RP.Params(leaves, len(policy) - 1)


def sample_envs(gen: torch.Generator, num_envs: int, count: int) -> torch.Tensor:
    """`count` of the `num_envs` envs drawn from the seed, in order (every
    env where `count` is 0 or not under `num_envs`)."""
    if not 0 < count < num_envs:
        return torch.arange(num_envs, device=gen.device)
    return torch.randperm(num_envs, generator=gen, device=gen.device)[:count].sort().values


def reference_training_env(env, config: dict, dr):
    cfg = config["ppo"]
    if dr is None:
        return RW.TrainingEnv(env, cfg["episode_length"], action_repeat=cfg["action_repeat"])
    return RW.TrainingEnv(env, cfg["episode_length"], dr_draws=dr, action_repeat=cfg["action_repeat"],
                          randomization_fn=RR.domain_randomize)
