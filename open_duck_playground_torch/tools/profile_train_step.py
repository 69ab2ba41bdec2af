"""Ablation profile of the full PPO training step at the production shapes.

    python -m open_duck_playground_torch.tools.profile_train_step \\
        [--task flat_terrain_backlash] [--num-envs 8192] [--reps 5] \\
        [--eval-envs 128] [--eval-steps 1000] [--eval-reps 2] \\
        [--config_override KEY=VALUE ...]

Counterpart of the JAX package's `tools/profile_train_step.py`, at the full
`PPOConfig` (8192 envs, unroll 20, 32 minibatches x 4 epochs) with domain
randomization, each piece through the trainer's own functions, one untimed
call and then timed ones (CUDA events on the card):
  1. rollout: `ppo.unroll_draws` + `ppo.generate_unroll` (policy, env step,
     the normalizer's moments), from the same start each time;
  2. rollout with the env step only (`TrainingEnv.step` under zero
     actions, its draws in the loop);
  3. normalizer update: `accumulate_moments` over the rollout's
     observations and `merge_moments` (the trainer accumulates inside the
     rollout, so this is part of 1);
  4. one SGD epoch: the permutation and 32 minibatch steps
     (`profile_epoch.production`: `ppo.minibatch`, `ppo.loss_fn`,
     backward, `ppo.apply_gradients`);
  5. shuffle only: the permutation and the 32 minibatch gathers;
  6. the 32 minibatch steps on minibatches gathered beforehand;
  7. one eval (`ppo.run_eval`, `--eval-envs` x `--eval-steps`);
  8. the sum, rollout + 4 epochs, against one `ppo.training_step` timed in
     the same call.
For one control step of the rollout and one SGD step, the port's form of
JAX's separately jitted pieces, read with `torch.profiler` on the card
(`benchutil.device_trace`, `benchutil.host_syncs`): kernel launches, host
synchronizations under `torch.cuda.set_sync_debug_mode("warn")`, device
busy time (the union of kernel intervals) over the section's wall time,
so the device's idle share, and the top 10 kernels by device time; per
layer of the control step (policy, draws, env = wrapper + task, task =
`Joystick.step` with the physics kernel, normalizer) and of the SGD step
(shuffle, forward_gae, backward, clip_adam), each with the card
synchronized at its ends. The profiler's own host cost per operation
lengthens every wall time it reads, so its idle shares are upper bounds;
`idle_share_unprofiled` takes the device busy time of the traced step over
the step's time from the untraced timings (rollout / control steps,
pre-shuffled minibatches / minibatches).

Prints a text line per measurement, then one JSON record.
"""

from __future__ import annotations

import argparse
import json

import torch

from open_duck_playground_torch.tools import benchutil, profile_epoch

PHYSICS_KERNEL = "mk_kernel"


class TaskMarked:
    """The env under a `TrainingEnv`, its `step` inside the section "task"
    of the current `mark`."""

    def __init__(self, env):
        self._env = env
        self.mark = benchutil.no_marks

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, *args, **kwargs):
        with self.mark("task"):
            return self._env.step(*args, **kwargs)


def main(argv=None, device="cuda") -> dict:
    """Run the profile; returns its JSON record. `device` is for callers on
    the CPU (tests), where nothing is traced."""
    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
    from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.physics import megakernel as MK
    from open_duck_playground_torch.train import networks as N
    from open_duck_playground_torch.train import ppo
    from open_duck_playground_torch.train import running_stats as RS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="flat_terrain_backlash")
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--eval-envs", type=int, default=128)
    ap.add_argument("--eval-steps", type=int, default=1000)
    ap.add_argument("--eval-reps", type=int, default=2)
    ap.add_argument("--config_override", action="append", default=None, metavar="KEY=VALUE",
                    help="a PPO config key of the CLI, repeatable")
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    if dev.type == "cuda":
        F.pin_f32()
    cfg = runner.ppo_config(**{"num_envs": args.num_envs, **(runner.parse_overrides(args.config_override) or {})})
    k, T, n = cfg.k_unrolls, cfg.unroll_length, cfg.num_envs
    gen = torch.Generator(device=dev).manual_seed(0)
    env = Joystick(args.task, device=dev)
    dr = DRDraws.sample(gen, n, env.model.spec)
    train_env = TrainingEnv(env, cfg.episode_length, dr_draws=dr, action_repeat=cfg.action_repeat,
                            randomization_fn=domain_randomize)
    marked = TaskMarked(env)
    marked_env = TrainingEnv(marked, cfg.episode_length, dr_draws=dr, action_repeat=cfg.action_repeat,
                             randomization_fn=domain_randomize)
    state = train_env.reset(env.reset_draws(gen, n))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=dev)
    print(f"reset done; envs={n} T={T}", flush=True)
    record = {"tool": "profile_train_step", "task": args.task, "envs": n, "unroll_length": T,
              "num_minibatches": cfg.num_minibatches, "num_updates_per_batch": cfg.num_updates_per_batch,
              "batch_size": cfg.batch_size, "reps": args.reps}
    ms = {}

    def timeit(key, label, fn, reps=args.reps, warmup=1):
        ms[key] = 1e3 * benchutil.seconds_per_call(fn, dev, reps=reps, warmup=warmup)
        print(f"{label:48s} {ms[key]:9.2f} ms", flush=True)

    # 1. rollout
    rolled = {}

    def rollout():
        rolled["out"] = ppo.generate_unroll(train_env, ts.net, ts.normalizer, state,
                                            ppo.unroll_draws(train_env, n, k * T, gen),
                                            accumulate=cfg.normalize_observations)

    before = MK.launches
    timeit("rollout", f"rollout (T={T}, policy+env)", rollout)
    record["rollout_megakernel_launches"] = MK.launches - before
    print(f"  -> rollout-only throughput: {k * n * T / (ms['rollout'] / 1e3):,.0f} env steps/s", flush=True)
    _, data, final_obs, moments = rolled["out"]

    # 2. env step only
    act0 = torch.zeros((n, env.action_size), device=dev)

    def env_only():
        s = state
        for _ in range(k * T):
            s = train_env.step(s, act0, train_env.step_draws(gen, n))

    timeit("rollout_env_only", "rollout env.step only (no policy)", env_only)

    # 3. normalizer update
    frames = float(k * n * T)

    def normalizer():
        m = RS.zero_moments(ts.normalizer)
        for obs in (dict(zip(data["obs"], o)) for o in zip(*data["obs"].values())):
            m = RS.accumulate_moments(ts.normalizer, m, obs)
        return RS.merge_moments(ts.normalizer, frames, *m)

    timeit("normalizer_update", "normalizer update", normalizer)
    ts.normalizer = RS.merge_moments(ts.normalizer, frames, *moments)
    if k > 1:
        data, final_obs = ppo.to_segments(data, final_obs, k, T)

    # 4-6. the update
    sgd = ppo.sgd_draws(cfg, env.action_size, gen)
    perm, noise = sgd.perms[0], sgd.entropy_noise[0]
    epoch = profile_epoch.production(ts, cfg, data, final_obs)
    timeit("sgd_epoch", f"one SGD epoch (shuffle + {cfg.num_minibatches} minibatches)",
           lambda: epoch(torch.randperm(k * n, generator=gen, device=dev), noise))
    print(f"  -> x{cfg.num_updates_per_batch} epochs = {ms['sgd_epoch'] * cfg.num_updates_per_batch:.2f} ms",
          flush=True)
    members = lambda p: [profile_epoch.members(p, cfg, i) for i in range(cfg.num_minibatches)]

    def shuffle():
        return [ppo.minibatch(data, final_obs, envs)
                for envs in members(torch.randperm(k * n, generator=gen, device=dev))]

    timeit("shuffle_only", "shuffle only", shuffle)
    mbs = shuffle()

    def sgd_only():
        for i, mb in enumerate(mbs):
            profile_epoch.sgd_step(ts, cfg, lambda: mb, noise[i])

    timeit("minibatches_preshuffled", f"{cfg.num_minibatches} minibatches SGD only (pre-shuffled)", sgd_only)

    # 7. eval
    ev_env = EvalEnv(env, cfg.episode_length, action_repeat=cfg.action_repeat)
    eval_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1000)
    evals = []
    before = MK.launches
    timeit("eval", f"one eval ({args.eval_envs} envs x {args.eval_steps} steps)",
           lambda: evals.append(ppo.run_eval(ev_env, (ts.normalizer, ts.net), args.eval_envs, args.eval_steps,
                                             cfg.deterministic_eval, eval_gen)),
           reps=args.eval_reps)
    record["eval_megakernel_launches"] = MK.launches - before

    # 8. the sum against a training step
    stepped = {"state": state}

    def training_step():
        _, stepped["state"], stepped["metrics"] = ppo.training_step(ts, train_env, env, stepped["state"], cfg, gen)

    timeit("training_step", "ppo.training_step", training_step, reps=2, warmup=0)
    total = ms["rollout"] + ms["sgd_epoch"] * cfg.num_updates_per_batch
    print(f"\nrollout + {cfg.num_updates_per_batch} epochs = {total:.2f} ms "
          f"-> {k * n * T / (total / 1e3):,.0f} env steps/s sustained-ish "
          f"(one training_step: {ms['training_step']:.2f} ms)", flush=True)

    # one control step and one SGD step, traced
    noise0 = N.normal_noise(gen, ts.net.policy_logits(RS.normalize(ts.normalizer, state.obs)))
    zero = RS.zero_moments(ts.normalizer)

    def control_step(mark):
        marked.mark = mark
        try:
            with mark("policy"):
                with torch.no_grad():
                    logits = ts.net.policy_logits(RS.normalize(ts.normalizer, state.obs))
                    raw = N.sample_raw(logits, noise0)
                    action = N.postprocess(raw)
                    N.log_prob(logits, raw)
            with mark("draws"):
                draws = marked_env.step_draws(gen, n)
            with mark("env"):
                marked_env.step(state, action, draws)
            with mark("normalizer"):
                RS.accumulate_moments(ts.normalizer, zero, state.obs)
        finally:
            marked.mark = benchutil.no_marks

    envs0 = profile_epoch.members(perm, cfg, 0)

    def sgd_step(mark):
        profile_epoch.sgd_step(ts, cfg, lambda: ppo.minibatch(data, final_obs, envs0), noise[0], mark)

    control_step(benchutil.no_marks)
    traced = {}
    for key, fn in (("control_step", control_step), ("sgd_step", sgd_step)):
        traced[key] = {"trace": benchutil.device_trace(fn, dev, named=(PHYSICS_KERNEL,)),
                       "host_syncs": benchutil.host_syncs(fn, dev)}
    if dev.type == "cuda":
        # device busy time of one step (profiler) over the step's time
        # unprofiled (the timed pieces), the profiler's host cost left out
        per_step = {"control_step": ms["rollout"] / (k * T),
                    "sgd_step": ms["minibatches_preshuffled"] / cfg.num_minibatches}
        for key, step_ms in per_step.items():
            traced[key]["step_ms_unprofiled"] = step_ms
            traced[key]["idle_share_unprofiled"] = 1 - traced[key]["trace"]["whole"]["device_busy_ms"] / step_ms
    record.update(ms=ms, sum_rollout_and_epochs_ms=total, traced=traced,
                  eval_episode_reward=evals[-1]["eval/episode_reward"],
                  finite=bool(all(torch.isfinite(p).all() for p in ts.net.parameters())
                              and all(torch.isfinite(v).all() for v in stepped["metrics"].values())),
                  device=benchutil.device_name(dev), card=benchutil.card(dev))
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
