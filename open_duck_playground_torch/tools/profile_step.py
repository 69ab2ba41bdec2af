"""Breakdown of one control step: physics alone, the full env step, the
gait oracle, and the layers between them.

    python -m open_duck_playground_torch.tools.profile_step [--env joystick] \\
        [--task flat_terrain_backlash] [--envs 4096] [--steps 500] [--reps 3]

Counterpart of the JAX package's `tools/profile_step.py`, from `reset`
states of `Joystick(task)` (or, with `--env standing`, `Standing(task)`) on
the nominal model, each piece chained
`--steps` times, one untimed run and `--reps` timed ones from the same
start (CUDA events on the card):
  1. physics alone: `forward.step` with the env's 10 substeps under the
     home keyframe's ctrl, on the card one launch of the megakernel;
  2. the full `Joystick.step` under zero actions, its step draws taken in
     the loop as the trainer takes them;
  3. the gait oracle's `reference_frame` alone (a task with imitation).
The port adds one control step of `ppo.run_eval` (`ppo.eval_actor`: the
step draws and the stochastic policy of fresh networks, then `EvalEnv.step`
under no grad, so that on the card both replay their CUDA graphs: episodes
of 1000 steps, nominal model), and the same control step run eagerly
(`eval_step_eager`: `ppo.eval_draws`, the policy, and `EvalEnv._step`
inside the wrapper's span). Each is split into its layers by the program's
own spans (`utils/tracing.py`): `layers` (the graphed step) and
`layers_eager` hold the host us per control step of `policy`, `env.draws`,
`act.graph`, `env.wrapper`, `env.graph`, `env.task` and `env.physics`
(self times, the first call left out; a span that closed in under half the
piece's calls, such as the task under the graph, which runs only in its
warm-up and capture, is left out).
Eager PyTorch has no compiled program to time, so each piece also shows
its overhead as the CUDA kernel launches per control step, read with
`torch.profiler` (`benchutil.device_trace`), with its host
synchronizations and the device's idle share; for the control steps the
trace also gives each span's launches and device ms and the card's idle
gaps labelled by the span open when each began (`trace["spans"]`), and
the layers each span's launches.

Prints the JAX tool's text line per piece, then one JSON record.
"""

from __future__ import annotations

import argparse
import json

import torch

from open_duck_playground_torch.tools import benchutil

# the program's spans of one control step (`utils/tracing.py`), by their
# names in the record
STEP_SPANS = {"policy": "policy", "env.draws": "draws", "act.graph": "act_graph", "env.wrapper": "wrapper",
              "env.graph": "graph", "env.task": "task", "env.physics": "physics"}
# the two control steps of `run_eval`, graphed and eager, and their layers
CONTROL_STEPS = {"eval_step": "layers", "eval_step_eager": "layers_eager"}


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
    from open_duck_playground_torch.envs.standing import Standing
    from open_duck_playground_torch.envs.wrappers import EvalEnv
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.physics import megakernel as MK
    from open_duck_playground_torch.train import ppo
    from open_duck_playground_torch.train.config import PPOConfig
    from open_duck_playground_torch.utils import tracing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", choices=("joystick", "standing"), default="joystick")
    ap.add_argument("--task", default="flat_terrain_backlash")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    if dev.type == "cuda":
        F.pin_f32()
    n = args.envs
    env = {"joystick": Joystick, "standing": Standing}[args.env](args.task, device=dev)
    m = env.model
    gen = torch.Generator(device=dev).manual_seed(0)
    state = env.reset(env.reset_draws(gen, n))
    wrapped = EvalEnv(env, episode_length=1000)
    wstate = wrapped.reset(env.reset_draws(gen, n))
    ts = ppo.init_training_state(wstate.obs, env.action_size, PPOConfig(), gen, device=dev)
    policy = ppo.make_policy((ts.normalizer, ts.net))
    act_graphed = ppo.eval_actor(wrapped, ts.net, n, False, gen)
    ctrl = m.key_ctrl.expand(n, -1).contiguous()
    act = torch.zeros((n, env.action_size), device=dev)
    cmd = state.info["command"]

    def physics(d):
        return F.step(m, d, ctrl, env.n_substeps)

    def env_step(s):
        return env.step(s, act, env.step_draws(gen, n))

    def eval_step(s):
        with torch.no_grad():  # as in `ppo.run_eval`
            return wrapped.step(s, *act_graphed(s.obs, ts.normalizer))

    def eval_step_eager(s):
        with torch.no_grad():
            noise, draws = ppo.eval_draws(wrapped, n, False, gen)
            action = policy(s.obs, noise)[0]
            with tracing.span("env.wrapper"):
                return wrapped._step(s, action, draws)

    def oracle(i):
        out = env.gait.reference_frame(cmd[:, 0], cmd[:, 1], cmd[:, 2], i)
        return i + out[:, 0].to(torch.int32) * 0

    pieces = {
        "physics": ("megakernel physics only (10 substeps)", physics, state.data),
        "env_step": ("full env.step (batched)", env_step, state),
        "eval_step": ("run_eval control step (policy, EvalEnv)", eval_step, wstate),
        "eval_step_eager": ("run_eval control step, env step eager", eval_step_eager, wstate),
    }
    if env.use_imitation:
        pieces["gait_oracle"] = ("gait oracle reference_frame", oracle, torch.zeros(n, dtype=torch.int32, device=dev))
    record = {"tool": "profile_step", "env": args.env, "task": args.task, "envs": n, "steps": args.steps, "reps": args.reps}
    outputs, spans = {}, {}
    calls = args.steps * (args.reps + 1)
    for key, (label, fn, start) in pieces.items():
        def run(fn=fn, start=start, key=key):
            x = start
            for _ in range(args.steps):
                x = fn(x)
            outputs[key] = x

        before = MK.launches
        tracing.reset()
        seconds = benchutil.seconds_per_call(run, dev, reps=args.reps)
        spans[key] = tracing.snapshot()
        rate = n * args.steps / seconds
        us = 1e6 * seconds / args.steps
        print(f"{label:40s} {rate:12,.0f} env-steps/s  ({us:8.1f} us/batch-step)", flush=True)
        record[key] = {"env_steps_per_s": rate, "us_per_batch_step": us,
                       "megakernel_launches_per_step": (MK.launches - before) / calls}
    # the control steps' layers: each span's steady self time per call
    for key, layers in CONTROL_STEPS.items():
        record[layers] = {f"{STEP_SPANS[name]}_us": 1e6 * (s["self_s"] - s["first_self_s"]) / (s["calls"] - 1)
                          for name, s in spans[key].items() if name in STEP_SPANS and 2 * s["calls"] >= calls}

    # one control step of each piece, traced
    traces = {}
    for key, (_, fn, start) in pieces.items():
        traces[key] = {"trace": benchutil.device_trace(lambda mark, fn=fn, start=start: fn(start), dev),
                       "host_syncs": benchutil.host_syncs(lambda mark, fn=fn, start=start: fn(start), dev)}
        if dev.type == "cuda":  # device busy time over the untraced step time
            traces[key]["idle_share_unprofiled"] = (
                1 - 1e3 * traces[key]["trace"]["whole"]["device_busy_ms"] / record[key]["us_per_batch_step"])
        record[key].update(traces[key])
    if dev.type == "cuda":
        for key, layers in CONTROL_STEPS.items():
            by_span = traces[key]["trace"]["spans"]["spans"]
            record[layers].update({f"{label}_launches": by_span.get(name, {}).get("kernel_launches", 0)
                                   for name, label in STEP_SPANS.items()})
    record["finite"] = bool(torch.isfinite(outputs["physics"].qpos).all()
                            and torch.isfinite(outputs["env_step"].reward).all()
                            and all(torch.isfinite(outputs[key].reward).all() for key in CONTROL_STEPS))
    record["device"] = benchutil.device_name(dev)
    record["card"] = benchutil.card(dev)
    print(json.dumps(record), flush=True)
    return record, outputs


if __name__ == "__main__":
    main()
