"""Read the outcome of one trained recipe: the final policy of a CLI run
under three evaluations of 1024 envs (stochastic, deterministic actions,
pushes off).

    python -m open_duck_playground_torch.cli.runner --env standing --task flat_terrain \\
        --num_timesteps 150000000 --config_override num_evals=15 --seed 2 -o runs/standing_seed2
    python -m open_duck_playground_torch.tools.recipe_outcome runs/standing_seed2 \\
        --env standing --task flat_terrain

RUN is the CLI's `-o` directory, whose checkpoint of the highest step is
evaluated, or one checkpoint directory. Writes `RUN/evals.json` and prints
an `EVAL` line per evaluation. The CLI run itself logs every eval in
`RUN/metrics.jsonl`. `--env`, `--task` and `--config_override` are the
CLI's own, as the run was given them (`bf16_matmuls=True` evaluates with
bf16 products, as the run trained).

Beside the evaluator's metrics each evaluation reports where the task's
clip of the step reward at 0 bites: `eval/clip_share`, the share of the
episodes' steps whose reward before the clip is negative, and
`eval/episode_clip_fill`, the mean points per episode the clip adds (the
episode reward less the sum of its scaled terms).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch

from open_duck_playground_torch.envs.wrappers import EvalEnv

EVAL_VARIANTS = (("stochastic", {}, False), ("deterministic", {}, True),
                 ("no_push", {"push_config.enable": False}, False))


class ClipCountingEvalEnv(EvalEnv):
    """An `EvalEnv` that also sums, over the steps its episode sums take
    in, the steps whose reward before the clip at 0 is negative and the
    points the clip adds; `clip_metrics` reads them per episode."""

    def reset(self, draws):
        self.steps = self.clipped = self.fill = 0.0
        return super().reset(draws)

    def step(self, state, action, draws):
        alive = 1.0 - state.info["eval_metrics"]["episode_done"]
        nstate = super().step(state, action, draws)
        total = 0.0
        for k, scale in self.env.config.reward_config.scales.items():
            if scale != 0:
                m = nstate.metrics[("reward/" if scale > 0 else "cost/") + k]
                total = total + scale * (m if scale > 0 else -m) * self.env.dt
        self.steps = self.steps + alive.sum()
        self.clipped = self.clipped + (alive * (total < 0)).sum()
        self.fill = self.fill + (alive * (nstate.reward - total)).sum()
        return nstate

    def clip_metrics(self, num_envs: int) -> dict:
        return {"eval/clip_share": float(self.clipped / self.steps),
                "eval/episode_clip_fill": float(self.fill / num_envs)}


def last_checkpoint(run: Path) -> Path:
    """`run` itself when it holds a checkpoint, else its `<date>_<step>`
    checkpoint directory of the highest step."""
    from open_duck_playground_torch.train import checkpoint as CKPT

    if (run / CKPT.STATE_FILE).is_file():
        return run
    ckpts = [p for p in run.iterdir() if (p / CKPT.STATE_FILE).is_file()]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint in {run}")
    return max(ckpts, key=lambda p: int(p.name.rsplit("_", 1)[1]))


def eval_variants(ckpt, env_name: str, task: str, overrides, num_envs: int, length: int,
                  device="cuda", seed: int = 0, ppo_overrides=None) -> dict:
    """The checkpoint's policy (the networks of the CLI's PPO config with
    `ppo_overrides`, `bf16_matmuls` included) in `EVAL_VARIANTS`, each with
    a generator seeded `seed + 1000`: per variant the eval/* metrics, the
    reward's standard error, the clip's share and fill, and the seconds."""
    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.train import checkpoint as CKPT, ppo

    cfg = runner.ppo_config(**(ppo_overrides or {}))
    env = runner.build_env(env_name, task, overrides, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    probe = env.reset(env.reset_draws(gen, 2))
    ts = ppo.init_training_state(probe.obs, env.action_size, cfg, gen, device=device)
    ts, _ = CKPT.restore_training_state(ckpt, ts)
    out = {}
    for name, extra, deterministic in EVAL_VARIANTS:
        ev_env = runner.build_env(env_name, task, {**(overrides or {}), **extra} or None, device)
        eval_env = ClipCountingEvalEnv(ev_env, cfg.episode_length)
        t0 = time.time()
        m = ppo.run_eval(eval_env, (ts.normalizer, ts.net), num_envs, length,
                         deterministic, torch.Generator(device=device).manual_seed(seed + 1000))
        m.update(eval_env.clip_metrics(num_envs))
        m["eval/episode_reward_stderr"] = m["eval/episode_reward_std"] / math.sqrt(num_envs)
        m["seconds"] = time.time() - t0
        out[name] = m
        print("EVAL", name, json.dumps({k: round(v, 4) for k, v in m.items()}), flush=True)
    return out


def main(argv=None, device="cuda") -> dict:
    """Evaluate as the module docstring says; returns the evaluations.
    `device` is for callers on the CPU (tests)."""
    from open_duck_playground_torch.cli import runner

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run", type=Path)
    ap.add_argument("--env", default="joystick", choices=sorted(runner.ENVS))
    ap.add_argument("--task", default="flat_terrain", choices=list(runner.TASKS))
    ap.add_argument("--config_override", action="append", default=None, metavar="KEY=VALUE")
    ap.add_argument("--eval_envs", type=int, default=1024)
    ap.add_argument("--eval_length", type=int, default=1000)
    args = ap.parse_args(argv)
    ppo_overrides, env_overrides = runner.split_overrides(runner.parse_overrides(args.config_override))
    ckpt = last_checkpoint(args.run)
    print("CKPT", ckpt, flush=True)
    evals = eval_variants(ckpt, args.env, args.task, env_overrides, args.eval_envs, args.eval_length,
                          device, ppo_overrides=ppo_overrides)
    (args.run / "evals.json").write_text(json.dumps(evals, indent=1) + "\n")
    return evals


if __name__ == "__main__":
    main()
