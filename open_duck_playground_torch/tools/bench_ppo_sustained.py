"""Sustained training throughput of the port: env steps per second of
`ppo.train` at the full config, period by period, with each period's eval
reward.

    python -m open_duck_playground_torch.tools.bench_ppo_sustained \\
        [--task flat_terrain_backlash] [--timesteps 50000000] [--json_out F] \\
        [--bf16_matmuls] [--config_override KEY=VALUE ...]
    torchrun --nproc_per_node=N -m open_duck_playground_torch.tools.bench_ppo_sustained

Counterpart of the JAX package's `tools/bench_ppo_sustained.py`:
`ppo.train` with `num_evals=7` and domain randomization, and a period
timed from one `progress_fn` call to the next. A period holds its training
steps and the eval (128 envs x 1000 control steps) and hooks that end it,
as the JAX tool's periods do; the eval is not cut to flatter the rate.
`--config_override` takes the CLI's PPO keys (num_envs=..., for a smaller
run). Under `torchrun` the run is data parallel over the ranks
(`parallel.mesh.distributed_from_env`), and rank 0 prints.

The last line is one JSON record in the JAX tool's form: `value` is env
steps/s per chip (card) over `n_chips` ranks, leaving out the first
period (warm-up); each chunk is one period with its global env steps, its
seconds and its `eval/episode_reward`, the training-quality record.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from open_duck_playground_torch.tools import benchutil


def main(argv=None, device="cuda") -> dict:
    """Run the benchmark; returns its record. `device` is for callers on the
    CPU (tests); the command line measures the card. Under `torchrun`
    the process group it starts is destroyed on return."""
    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.parallel import mesh as M

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="flat_terrain_backlash")
    ap.add_argument("--timesteps", type=int, default=50_000_000)
    ap.add_argument("--json_out", default=None, help="also write the JSON record to this path")
    ap.add_argument("--bf16_matmuls", action="store_true",
                    help="bf16 operands with f32 results in the actor's and critic's products")
    ap.add_argument("--config_override", action="append", default=None, metavar="KEY=VALUE",
                    help="a PPO config key of the CLI, repeatable")
    args = ap.parse_args(argv)
    ppo_overrides, env_overrides = runner.split_overrides(runner.parse_overrides(args.config_override))
    if env_overrides:
        raise ValueError(f"not PPO config keys: {sorted(env_overrides)}")
    initialized = torch.distributed.is_initialized()
    device, mesh = M.distributed_from_env(device)
    try:
        return _run(args, ppo_overrides, device, mesh)
    finally:
        if mesh is not None and not initialized:
            torch.distributed.destroy_process_group()


def _run(args, ppo_overrides, device, mesh) -> dict:
    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.randomize import domain_randomize
    from open_duck_playground_torch.train import ppo

    dev = benchutil.measured_device(device)
    sync = benchutil.synchronizer(dev)
    lead = mesh is None or mesh.rank == 0
    n_chips = 1 if mesh is None else mesh.world_size

    cfg = runner.ppo_config(**{"num_evals": 7, **ppo_overrides, "bf16_matmuls": args.bf16_matmuls})
    env = Joystick(args.task, device=dev)
    marks = []  # (global env steps, seconds, eval reward) at each progress_fn call

    def progress(num_steps, metrics):
        sync()
        marks.append((num_steps, time.perf_counter(), metrics.get("eval/episode_reward")))
        if lead and len(marks) > 1:
            (s0, t0, _), (s1, t1, reward) = marks[-2:]
            print(f"chunk: {s1 - s0} steps in {t1 - t0:.2f}s -> {(s1 - s0) / (t1 - t0):,.0f} steps/s, "
                  f"eval reward {reward}", flush=True)

    ppo.train(env, num_timesteps=args.timesteps, config=cfg, device=dev, randomization_fn=domain_randomize,
              progress_fn=progress, max_env_steps_per_jit=8_192_000, mesh=mesh)

    periods = [(s1 - s0, t1 - t0, r1) for (s0, t0, _), (s1, t1, r1) in zip(marks, marks[1:])]
    tail = periods[1:] if len(periods) > 1 else periods
    rate = sum(s for s, _, _ in tail) / sum(t for _, t, _ in tail) / n_chips
    record = {
        "metric": "sustained_ppo_env_steps_per_sec_per_chip",
        "value": round(rate),
        "unit": "env_steps/s/chip",
        "n_chips": n_chips,
        "task": args.task,
        "timesteps": args.timesteps,
        "bf16_matmuls": bool(args.bf16_matmuls),
        # global env steps per period; the first period is warm-up, left out of "value"
        "chunks": [{"steps": s, "seconds": round(t, 3), "warmup": i == 0, "eval_episode_reward": r}
                   for i, (s, t, r) in enumerate(periods)],
        "initial_eval_episode_reward": marks[0][2] if marks else None,
        "device": benchutil.device_name(dev),
        "card": benchutil.card(dev),
    }
    if lead:
        print(f"SUSTAINED: {rate:,.0f} env steps/s/chip over {n_chips} chip(s) (excl. first timed chunk)")
        print(json.dumps(record), flush=True)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
