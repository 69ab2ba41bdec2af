"""Training CLI of the port, on the card unless told otherwise.

Counterpart of `open_duck_playground_tpu/cli/runner.py`: the same flags,
choices and defaults, and the same side effects (TensorBoard scalars when
`tensorboardX` is installed, a full checkpoint and an ONNX export per eval).
It also appends every progress call's metrics to `<output_dir>/metrics.jsonl`,
one JSON object per line with `env_steps`, `wall_s` (seconds since the
Runner was built), `kernel_launches` (the physics megakernel's launches in
this process so far, 0 on the CPU) and `host_s` (the host self seconds of
each span of `utils/tracing.py` that closed since the previous line: the
period's training steps, `sgd.*` for the SGD steps, then its eval), so that
a machine without `tensorboardX` keeps them too.

    python -m open_duck_playground_torch.cli.runner \\
        --env joystick --task flat_terrain_backlash --num_timesteps 300000000

It trains with domain randomization (`envs.randomize.domain_randomize`), as
the JAX runner asks for it. Under `torchrun` it trains data parallel, one
card per process (`cuda:LOCAL_RANK`), the envs sharded over the ranks; rank
0 alone prints and writes checkpoints and .onnx files:

    torchrun --nproc_per_node=8 -m open_duck_playground_torch.cli.runner \\
        --env joystick --task flat_terrain_backlash --num_timesteps 300000000

Unlike the JAX runner, an error of the ONNX export is not swallowed: the
writer is pure numpy, so an exception there is a fault to see.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import time
from datetime import datetime
from pathlib import Path

import torch

from open_duck_playground_torch.envs.randomize import domain_randomize
from open_duck_playground_torch.export import onnx_export
from open_duck_playground_torch.parallel import mesh as M
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.train import checkpoint as CKPT
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig
from open_duck_playground_torch.utils import tracing

ENVS = ("joystick", "standing")
TASKS = ("flat_terrain", "rough_terrain", "flat_terrain_backlash", "rough_terrain_backlash",
         "flat_terrain_no_head")
# The JAX package's ppo_config() keeps these under "network_factory".
NETWORK_FIELDS = ("policy_hidden_layer_sizes", "value_hidden_layer_sizes", "policy_obs_key",
                  "value_obs_key")
# The keys of that ppo_config(); num_timesteps and seed have flags of their own, which win.
PPO_KEYS = ({f.name for f in dataclasses.fields(PPOConfig)} - set(NETWORK_FIELDS)
            | {"network_factory"}) - {"num_timesteps", "seed"}


def build_env(name: str, task: str, config_overrides=None, device="cuda"):
    if name == "joystick":
        from open_duck_playground_torch.envs.joystick import Joystick

        return Joystick(task=task, config_overrides=config_overrides, device=device)
    if name == "standing":
        from open_duck_playground_torch.envs.standing import Standing

        return Standing(task=task, config_overrides=config_overrides, device=device)
    raise ValueError(f"unknown env {name!r}; choose from {sorted(ENVS)}")


def parse_overrides(pairs):
    """--config_override dotted.key=value pairs -> a flat dict of overrides
    (values read as Python literals, else kept as strings), or None."""
    out = {}
    for pair in pairs or []:
        key, sep, val = pair.partition("=")
        if not sep:
            raise ValueError(f"--config_override needs key=value, got {pair!r}")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val  # plain string
    return out or None


def split_overrides(overrides):
    """(PPO overrides, env overrides or None): keys that name PPO config
    fields (num_evals, batch_size, ...) go to the PPO config, everything else
    (dotted env keys like reward_config.scales.*) to the env."""
    overrides = dict(overrides or {})
    ppo_overrides = {k: overrides.pop(k) for k in [k for k in overrides if k in PPO_KEYS]}
    return ppo_overrides, overrides or None


def ppo_config(**overrides) -> PPOConfig:
    """PPOConfig with `overrides` in the JAX ppo_config's keys (the network
    sizes under `network_factory`)."""
    network = overrides.pop("network_factory", None) or {}
    unknown = set(network) - set(NETWORK_FIELDS)
    if unknown:
        raise KeyError(f"network_factory has no {sorted(unknown)}")
    return dataclasses.replace(PPOConfig(), **overrides, **network)


class Runner:
    """`mesh`: train data parallel over its ranks; rank 0 alone prints and
    writes."""

    def __init__(self, args: argparse.Namespace, device="cuda", mesh=None):
        self.args = args
        self.device = device
        self.mesh = mesh
        self.writes = mesh is None or mesh.rank == 0
        self.output_dir = Path.cwd() / Path(args.output_dir)
        self.metrics_log = self.output_dir / "metrics.jsonl"
        self.t0 = time.time()
        self.spans = tracing.snapshot()
        self.writer = None
        if self.writes:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(log_dir=str(self.output_dir))
            except ImportError:
                pass

        ppo_overrides, overrides = split_overrides(parse_overrides(args.config_override))
        self.env = build_env(args.env, args.task, overrides, device)
        self.eval_env = build_env(args.env, args.task, overrides, device)
        self.num_timesteps = args.num_timesteps
        self.restore_checkpoint_path = args.restore_checkpoint_path
        # training steps per eval period as the JAX trainer counts them: its
        # chunk limits at the megakernel paths' rates (plane, heightfield),
        # and at the plain version's where the physics runs on the CPU
        self.max_env_steps_per_jit = args.max_env_steps_per_jit
        if self.max_env_steps_per_jit is None:
            if torch.device(device).type != "cuda":
                self.max_env_steps_per_jit = 1_000_000
            elif args.task.startswith("rough"):
                self.max_env_steps_per_jit = 4_000_000
            else:
                self.max_env_steps_per_jit = 8_192_000
        self.ppo_params = ppo_config(num_timesteps=args.num_timesteps, seed=args.seed,
                                     **ppo_overrides)
        self.action_size = self.env.action_size

    def progress_callback(self, num_steps: int, metrics: dict) -> None:
        if not self.writes:
            return
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(k, float(v), num_steps)
        spans, before = tracing.snapshot(), self.spans
        self.spans = spans
        zero = {"calls": 0, "self_s": 0.0}
        host_s = {name: s["self_s"] - before.get(name, zero)["self_s"] for name, s in spans.items()
                  if s["calls"] != before.get(name, zero)["calls"]}
        rec = {"env_steps": int(num_steps), "wall_s": time.time() - self.t0,
               "kernel_launches": MK.launches, "host_s": host_s,
               **{k: float(v) for k, v in metrics.items()}}
        with open(self.metrics_log, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if "eval/episode_reward" in metrics:
            print("-----------")
            print(
                f"STEP: {num_steps} reward: {metrics['eval/episode_reward']}"
                f" reward_std: {metrics['eval/episode_reward_std']}"
            )
            print("-----------")

    def policy_params_fn(self, current_step, make_policy, variables, full_state=None) -> None:
        """A checkpoint directory and an .onnx policy named `<date>_<step>`."""
        del make_policy
        if not self.writes:
            return
        d = datetime.now().strftime("%Y_%m_%d_%H%M%S")
        path = self.output_dir / f"{d}_{current_step}"
        print(f"Saving checkpoint (step: {current_step}): {path}")
        if full_state is not None:
            training_state, generator_state = full_state
            CKPT.save_training_state(path, training_state, generator_state)
        else:
            CKPT.save(path, variables)
        obs_size = int(variables[0].mean["state"].shape[-1])
        onnx_export.export_policy(variables, self.action_size, self.ppo_params, obs_size,
                                  output_path=str(self.output_dir / f"{d}_{current_step}.onnx"))

    def train(self):
        return ppo.train(
            self.env,
            num_timesteps=self.num_timesteps,
            config=self.ppo_params,
            device=self.device,
            randomization_fn=domain_randomize,
            eval_env=self.eval_env,
            progress_fn=self.progress_callback,
            policy_params_fn=self.policy_params_fn,
            restore_checkpoint_path=self.restore_checkpoint_path,
            max_env_steps_per_jit=self.max_env_steps_per_jit,
            mesh=self.mesh,
        )


def main(argv=None, device="cuda"):
    """Parse `argv` and train. `device` is for callers on the CPU (tests);
    the command line always runs on the card. Under `torchrun` with more
    than one process, data parallel over them (`mesh.distributed_from_env`)."""
    parser = argparse.ArgumentParser(description="Open Duck Mini V2 trainer (PyTorch, CUDA)")
    parser.add_argument("-o", "--output_dir", type=str, default="checkpoints")
    parser.add_argument("--num_timesteps", type=int, default=150_000_000)
    parser.add_argument("--env", type=str, default="joystick", choices=sorted(ENVS))
    parser.add_argument("--task", type=str, default="flat_terrain", choices=list(TASKS))
    parser.add_argument("--restore_checkpoint_path", type=str, default=None)
    parser.add_argument(
        "--seed",
        type=int,
        default=0,
        help="PPO RNG seed (brax ppo.train default 0); drives env resets, "
        "domain randomization, minibatch shuffling and network init",
    )
    parser.add_argument(
        "--config_override",
        action="append",
        default=None,
        metavar="KEY=VALUE",
        help="env-config override as a flattened dotted key, repeatable "
        "(e.g. --config_override push_config.magnitude_range=[0.1,0.5] "
        "--config_override reward_config.scales.tracking_lin_vel=4.0)",
    )
    parser.add_argument(
        "--max_env_steps_per_jit",
        type=int,
        default=None,
        help="env steps per training chunk, which sets the training steps per "
        "eval period as the JAX trainer counts them (default: 8.19M on flat "
        "tasks, 4M on rough tasks, 1M on the CPU)",
    )
    args = parser.parse_args(argv)
    initialized = torch.distributed.is_initialized()
    device, mesh = M.distributed_from_env(device)
    try:
        return Runner(args, device, mesh).train()
    finally:
        if mesh is not None and not initialized:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
