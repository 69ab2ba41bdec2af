"""How whole `torch.profiler`'s trace of one control step is on the card,
with and without the guards of `benchutil._profiled`.

    python -m open_duck_playground_torch.tools.profile_window \
        [--task flat_terrain_backlash] [--envs 8192] [--traces 100] \
        [--after-profile-step]

Builds the training rollout's control step as `profile_train_step` traces
it (the policy on the normalized observation, the step draws,
`TrainingEnv.step` with domain randomization, the normalizer's moments),
runs it once untraced, then traces it `--traces` times in each setting,
the settings taken in turn so that each sees the same conditions:
  bare     the window opens and closes on the traced call;
  guarded  `benchutil._profiled` as the profilers use it: idle host time
           at both ends of the window and a lead-in launch before the call.
Per trace, `benchutil.coverage` of the traced call's range: the host calls
that put work on the card, those with no device event, whether the first
of them is among those, the least time from a launch to its device event's
start; and whether the physics kernel is in it. `--after-profile-step`
first runs `profile_step` at 4096 envs x 50 steps in the same process, as
`chip_smoke.py`'s profile phase does before `profile_train_step`.

Prints one text line per setting, then one JSON record.
"""

from __future__ import annotations

import argparse
import json

import torch

from open_duck_playground_torch.tools import benchutil

PHYSICS_KERNEL = "mk_kernel"


def main(argv=None, device="cuda") -> dict:
    """Run the traces; returns the JSON record. `device` is for callers on
    the CPU (tests), where the control step runs once and nothing is
    traced (`settings` is None)."""
    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
    from open_duck_playground_torch.envs.wrappers import TrainingEnv
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.train import networks as N
    from open_duck_playground_torch.train import ppo
    from open_duck_playground_torch.train import running_stats as RS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="flat_terrain_backlash")
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--traces", type=int, default=100)
    ap.add_argument("--after-profile-step", action="store_true")
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    if dev.type == "cuda":
        F.pin_f32()
    cfg = runner.ppo_config(num_envs=args.envs)
    n = cfg.num_envs
    gen = torch.Generator(device=dev).manual_seed(0)
    env = Joystick(args.task, device=dev)
    train_env = TrainingEnv(env, cfg.episode_length, dr_draws=DRDraws.sample(gen, n, env.model.spec),
                            action_repeat=cfg.action_repeat, randomization_fn=domain_randomize)
    state = train_env.reset(env.reset_draws(gen, n))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=dev)
    noise = N.normal_noise(gen, ts.net.policy_logits(RS.normalize(ts.normalizer, state.obs)))
    zero = RS.zero_moments(ts.normalizer)

    def control_step(mark):
        with torch.no_grad():
            logits = ts.net.policy_logits(RS.normalize(ts.normalizer, state.obs))
            raw = N.sample_raw(logits, noise)
            action = N.postprocess(raw)
        train_env.step(state, action, train_env.step_draws(gen, n))
        RS.accumulate_moments(ts.normalizer, zero, state.obs)

    control_step(benchutil.no_marks)
    record = {"tool": "profile_window", "task": args.task, "envs": n, "traces": args.traces, "settings": None,
              "device": benchutil.device_name(dev), "card": benchutil.card(dev)}
    if dev.type != "cuda":
        print(json.dumps(record), flush=True)
        return record
    if args.after_profile_step:
        from open_duck_playground_torch.tools import profile_step

        profile_step.main(["--task", args.task, "--envs", "4096", "--steps", "50", "--reps", "1"])
    settings = {"bare": {"margin": 0.0, "lead_in": False}, "guarded": {}}
    cuda = torch.autograd.DeviceType.CUDA
    seen = {name: [] for name in settings}
    for _ in range(args.traces):
        for name, kw in settings.items():
            events = benchutil._profiled(control_step, dev, benchutil.no_marks, **kw)
            whole = next(e for e in events if e.name == benchutil.SECTION + "whole"
                         and e.device_type == torch.autograd.DeviceType.CPU).time_range
            c = benchutil.coverage(events, (whole.start, whole.end))
            calls = sorted((e for e in events if e.name in benchutil.LAUNCH_CALLS and e.device_type != cuda
                            and whole.start <= e.time_range.start <= whole.end), key=lambda e: e.time_range.start)
            c["first_launch_lost"] = bool(calls) and not any(e.device_type == cuda and e.id == calls[0].id
                                                             for e in events)
            c["physics_kernel"] = any(e.device_type == cuda and PHYSICS_KERNEL in e.name for e in events)
            seen[name].append(c)
    record["settings"] = []
    for name, cs in seen.items():
        row = {"setting": name, **settings[name], "launch_calls": max(c["launch_calls"] for c in cs),
               "traces_losing_events": sum(c["untraced_launches"] > 0 for c in cs),
               "most_lost": max(c["untraced_launches"] for c in cs),
               "traces_losing_first_launch": sum(c["first_launch_lost"] for c in cs),
               "least_launch_to_start_us": min(c["least_launch_to_start_us"] for c in cs),
               "traces_without_physics_kernel": sum(not c["physics_kernel"] for c in cs)}
        record["settings"].append(row)
        print(f"{name}: {row['traces_losing_events']}/{len(cs)} traces lost events (most {row['most_lost']} of "
              f"{row['launch_calls']}; the first launch in {row['traces_losing_first_launch']}), "
              f"{row['traces_without_physics_kernel']} without {PHYSICS_KERNEL}; least launch-to-start "
              f"{row['least_launch_to_start_us']:.1f} us", flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
