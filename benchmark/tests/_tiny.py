"""Tiny sizes at which a cell runs on the CPU in a few seconds (the port's
CPU path is the plain engine), and a run of a cell at them."""

import torch

from benchmark.harness import runner

TRAIN_PPO = dict(num_envs=16, batch_size=4, num_minibatches=4, unroll_length=3, num_updates_per_batch=2)
TRAIN_TRAFFIC = dict(setup_steps=2, checked_steps=2, checked_envs=8, reference_block_steps=2)
EVAL_PPO = dict(num_eval_envs=4, episode_length=6)
EVAL_TRAFFIC = dict(warmup_steps=2, checked_steps_per_eval=3, trace_steps=2)
SEED = 2 ** 31 + 12345


def overrides(cell: str):
    return (TRAIN_PPO, TRAIN_TRAFFIC) if cell.startswith("train.") else (EVAL_PPO, EVAL_TRAFFIC)


def run(cell: str, seed: int = SEED, device="cpu", ppo=None, **kw):
    torch.set_num_threads(2)
    small, traffic = overrides(cell)
    return runner.run(cell, seed, 0.0, False, device=device, config_overrides=ppo or small,
                      traffic_overrides=traffic, need_card=False, **kw)
