"""Breakdown of one control step: physics alone, the full env step, the
gait oracle, and the layers between them.

    python -m open_duck_playground_torch.tools.profile_step \\
        [--task flat_terrain_backlash] [--envs 4096] [--steps 500] [--reps 3]

Counterpart of the JAX package's `tools/profile_step.py`, from `reset`
states of `Joystick(task)` on the nominal model, each piece chained
`--steps` times, one untimed run and `--reps` timed ones from the same
start (CUDA events on the card):
  1. physics alone: `forward.step` with the env's 10 substeps under the
     home keyframe's ctrl, on the card one launch of the megakernel;
  2. the full `Joystick.step` under zero actions, its step draws taken in
     the loop as the trainer takes them;
  3. the gait oracle's `reference_frame` alone.
The port adds `TrainingEnv.step` (episodes of 1000 steps, nominal model)
under zero actions, and splits one control step into its layers: physics,
task (`Joystick.step` minus physics, the draws included) and wrapper
(`TrainingEnv.step` minus `Joystick.step`). Eager PyTorch has no compiled
program to time, so each piece also shows its overhead as the CUDA kernel
launches per control step, read with `torch.profiler` (`benchutil.
device_trace`), with its host synchronizations and the device's idle share.

Prints the JAX tool's text line per piece, then one JSON record.
"""

from __future__ import annotations

import argparse
import json

import torch

from open_duck_playground_torch.tools import benchutil


def main(argv=None, device="cuda") -> dict:
    """Run the profile; returns its JSON record. `device` is for callers on
    the CPU (tests), where `forward.step` is the plain engine and nothing
    is traced."""
    return profile(argv, device)[0]


def profile(argv=None, device="cuda"):
    """(record, outputs): `outputs` holds each piece's last value after
    its last timed run (`physics`: the Data after `--steps` chained steps
    from the reset states)."""
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.wrappers import TrainingEnv
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.physics import megakernel as MK

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="flat_terrain_backlash")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    if dev.type == "cuda":
        F.pin_f32()
    n = args.envs
    env = Joystick(args.task, device=dev)
    m = env.model
    gen = torch.Generator(device=dev).manual_seed(0)
    state = env.reset(env.reset_draws(gen, n))
    wrapped = TrainingEnv(env, episode_length=1000)
    wstate = wrapped.reset(env.reset_draws(gen, n))
    ctrl = m.key_ctrl.expand(n, -1).contiguous()
    act = torch.zeros((n, env.action_size), device=dev)
    cmd = state.info["command"]

    def physics(d):
        return F.step(m, d, ctrl, env.n_substeps)

    def env_step(s):
        return env.step(s, act, env.step_draws(gen, n))

    def wrapper_step(s):
        return wrapped.step(s, act, wrapped.step_draws(gen, n))

    def oracle(i):
        out = env.gait.reference_frame(cmd[:, 0], cmd[:, 1], cmd[:, 2], i)
        return i + out[:, 0].to(torch.int32) * 0

    pieces = {
        "physics": ("megakernel physics only (10 substeps)", physics, state.data),
        "env_step": ("full env.step (batched)", env_step, state),
        "training_env_step": ("TrainingEnv.step (autoreset, quarantine)", wrapper_step, wstate),
        "gait_oracle": ("gait oracle reference_frame", oracle, torch.zeros(n, dtype=torch.int32, device=dev)),
    }
    record = {"tool": "profile_step", "task": args.task, "envs": n, "steps": args.steps, "reps": args.reps}
    outputs = {}
    for key, (label, fn, start) in pieces.items():
        def run(fn=fn, start=start, key=key):
            x = start
            for _ in range(args.steps):
                x = fn(x)
            outputs[key] = x

        before = MK.launches
        seconds = benchutil.seconds_per_call(run, dev, reps=args.reps)
        calls = args.steps * (args.reps + 1)
        rate = n * args.steps / seconds
        us = 1e6 * seconds / args.steps
        print(f"{label:40s} {rate:12,.0f} env-steps/s  ({us:8.1f} us/batch-step)", flush=True)
        record[key] = {"env_steps_per_s": rate, "us_per_batch_step": us,
                       "megakernel_launches_per_step": (MK.launches - before) / calls}

    # one control step of each piece, traced
    traces = {}
    for key, (_, fn, start) in pieces.items():
        traces[key] = {"trace": benchutil.device_trace(lambda mark, fn=fn, start=start: fn(start), dev),
                       "host_syncs": benchutil.host_syncs(lambda mark, fn=fn, start=start: fn(start), dev)}
        if dev.type == "cuda":  # device busy time over the untraced step time
            traces[key]["idle_share_unprofiled"] = (
                1 - 1e3 * traces[key]["trace"]["whole"]["device_busy_ms"] / record[key]["us_per_batch_step"])
        record[key].update(traces[key])
    us = {k: record[k]["us_per_batch_step"] for k in pieces}
    layers = {"physics_us": us["physics"], "task_us": us["env_step"] - us["physics"],
              "wrapper_us": us["training_env_step"] - us["env_step"]}
    if dev.type == "cuda":
        launches = {k: traces[k]["trace"]["whole"]["kernel_launches"] for k in pieces}
        syncs = {k: traces[k]["host_syncs"]["whole"] for k in pieces}
        layers.update(physics_launches=launches["physics"],
                      task_launches=launches["env_step"] - launches["physics"],
                      wrapper_launches=launches["training_env_step"] - launches["env_step"],
                      task_host_syncs=syncs["env_step"] - syncs["physics"],
                      wrapper_host_syncs=syncs["training_env_step"] - syncs["env_step"])
    record["layers"] = layers
    record["finite"] = bool(torch.isfinite(outputs["physics"].qpos).all()
                            and torch.isfinite(outputs["env_step"].reward).all()
                            and torch.isfinite(outputs["training_env_step"].reward).all())
    record["device"] = benchutil.device_name(dev)
    record["card"] = benchutil.card(dev)
    print(json.dumps(record), flush=True)
    return record, outputs


if __name__ == "__main__":
    main()
