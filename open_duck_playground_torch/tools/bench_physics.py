"""Physics throughput of the port: env steps per second of `forward.step`
alone, which on the card is one launch of the CUDA megakernel per control
step.

    python -m open_duck_playground_torch.tools.bench_physics \\
        [--task flat_terrain_backlash] [--envs 4096] [--steps 50]

Counterpart of the JAX package's `tools/bench_physics.py`: from `reset`
states of `Joystick(task)` on the nominal model, `--steps` steps chained
under the default actuator targets (the home keyframe's ctrl), two untimed
runs and three timed ones from the same start. Any of the five scenes
(kernel rows 1, 1f, 1h and 1n of PERF.md). There is no `--tile`: the lanes
per env are a constant of `csrc/megakernel.cu`, which `tools/lanes_bench.py`
times.

Prints the JAX tool's text line, then one JSON line with env steps/s and
ms per launch.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from open_duck_playground_torch.tools import benchutil

REPS = 3


def main(argv=None, device="cuda") -> dict:
    """Run the benchmark; returns its JSON record. `device` is for callers
    on the CPU (tests), where `forward.step` is the plain engine."""
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.physics import megakernel as MK

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="flat_terrain_backlash")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    sync = benchutil.synchronizer(dev)

    env = Joystick(args.task, device=dev)
    m = env.model
    gen = torch.Generator(device=dev).manual_seed(0)
    start = env.reset(env.reset_draws(gen, args.envs)).data
    ctrl = m.key_ctrl.expand(args.envs, -1).contiguous()

    def run(d):
        for _ in range(args.steps):
            d = F.step(m, d, ctrl, env.n_substeps)
        return d

    for _ in range(2):
        out = run(start)
    sync()
    launches = MK.launches
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = run(start)
    sync()
    seconds = time.perf_counter() - t0
    calls = args.steps * REPS
    rate = args.envs * calls / seconds
    print(f"task={args.task} envs={args.envs}: {rate:,.0f} env-steps/s (physics only)", flush=True)
    record = {"metric": f"physics_env_steps_per_sec@{args.envs}envs", "value": round(rate, 1),
              "unit": "env_steps/s", "ms_per_launch": 1e3 * seconds / calls, "task": args.task,
              "envs": args.envs, "steps": args.steps, "reps": REPS, "kernel_launches": MK.launches - launches,
              "finite": bool(torch.isfinite(out.qpos).all()), "device": benchutil.device_name(dev),
              "card": benchutil.card(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
