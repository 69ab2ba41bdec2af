"""Rollout throughput of the port: env steps per second of the training
rollout on the card.

    python -m open_duck_playground_torch.tools.bench_rollout [--envs 4096] \\
        [--steps 500] [--reps 3] [--task flat_terrain_backlash]

Counterpart of the JAX package's root `bench.py`, with its pipeline:
`Joystick(task)` in `TrainingEnv` with episodes of 1000 steps (so autoreset
runs) and per-env domain randomization, and the policy in the loop at
`PPOConfig`'s sizes (obs normalization, the actor MLP, tanh-Normal
sampling) with random weights from a seeded generator. One timed control
step is one `TrainingEnv.step` with its random draws; GAE and SGD, which
run once per training step, are left out. Schedule: two untimed runs of
`--steps` steps, then `--reps` timed runs with the card synchronized
around the window.

Prints a line with ms per control step and the card's name and power
limit, then one JSON line in `bench.py`'s form (`metric`, `value`, `unit`)
with the device it ran on. No TPU figure is a baseline here.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from open_duck_playground_torch.tools import benchutil


def main(argv=None, device="cuda") -> dict:
    """Run the benchmark; returns its JSON record. `device` is for callers
    on the CPU (tests); the command line measures the card."""
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
    from open_duck_playground_torch.envs.wrappers import TrainingEnv
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.physics import megakernel as MK
    from open_duck_playground_torch.train import networks as N
    from open_duck_playground_torch.train import running_stats as RS
    from open_duck_playground_torch.train.config import PPOConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--task", default="flat_terrain_backlash")
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    sync = benchutil.synchronizer(dev)
    if dev.type == "cuda":
        F.pin_f32()

    cfg = PPOConfig()
    n = args.envs
    gen = torch.Generator(device=dev).manual_seed(0)
    env = Joystick(args.task, device=dev)
    wrapped = TrainingEnv(env, episode_length=1000, dr_draws=DRDraws.sample(gen, n, env.model.spec),
                          randomization_fn=domain_randomize)
    state = wrapped.reset(env.reset_draws(gen, n))
    sizes = {k: v.shape[-1] for k, v in state.obs.items()}
    net = N.PPONetworks.init(sizes, env.action_size, cfg.policy_hidden_layer_sizes, gen, device=dev,
                             policy_obs_key=cfg.policy_obs_key, value_hidden=cfg.value_hidden_layer_sizes,
                             value_obs_key=cfg.value_obs_key)
    normalizer = RS.init(sizes, device=dev)

    def rollout(state):
        for _ in range(args.steps):
            with torch.no_grad():
                logits = net.policy_logits(RS.normalize(normalizer, state.obs))
                action = N.postprocess(N.sample_raw(logits, N.normal_noise(gen, logits)))
            state = wrapped.step(state, action, wrapped.step_draws(gen, n))
        return state

    state = rollout(rollout(state))  # warm-up: allocator, cuBLAS handles, the kernel's build
    sync()
    launches = MK.launches
    t0 = time.perf_counter()
    for _ in range(args.reps):
        state = rollout(state)
    sync()
    seconds = time.perf_counter() - t0
    steps = args.steps * args.reps
    rate = n * steps / seconds
    print(json.dumps({"tool": "bench_rollout", "task": args.task, "envs": n, "steps": args.steps,
                      "reps": args.reps, "seconds": seconds, "ms_per_control_step": 1e3 * seconds / steps,
                      "kernel_launches": MK.launches - launches, "card": benchutil.card(dev)}), flush=True)
    record = {"metric": f"env_steps_per_sec@{n}envs", "value": round(rate, 1), "unit": "env_steps/s",
              "device": benchutil.device_name(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
