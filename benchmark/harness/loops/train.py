"""Traffic of the `train` kind: whole PPO training steps through the port's
`ppo.training_step`, the body of `ppo.train`'s loop, on the `TrainingEnv`
that `ppo.train` builds (per-env domain randomization where the
configuration has it), each step's random numbers drawn by the port from
its own generator, as `ppo.train` draws them.

Set-up builds the training state and the env once and drives the first
`checked_steps` training steps through the same call the window makes, with
a recorder on the training env's `step` (this object's own) that copies, for
every control step, the state after it of a sample of `checked_envs` envs
drawn from the seed (and their first state), and of every env the action,
the step draws, the observations, reward, done and truncation. After each
step it copies what `training_step` returns: the parameters, the
normalizer and the metrics. The draws the port made that the env does not
see (action noise, permutations, entropy noise) are replayed from its
generator's state before the step through the port's own samplers, and the
step draws replayed beside them must equal those the env was given. Then
`setup_steps - checked_steps` more steps bare, and the same objects go to
the window, which runs whole training steps until `--seconds` have passed
and ends with a synchronize; it adds none of its own."""

from __future__ import annotations

import time
import types
from typing import Callable, Optional

import torch

from benchmark.harness import check, inputs, port, trees
from benchmark.reference.envs import randomize as RR


class Loop:
    kind = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" else (lambda: None)
        self.timings = inputs.Timings(self.sync)

    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        mark = self.timings.mark
        P = self.P = port.modules()
        mark("import")
        config, dev = self.config, self.device
        self.cfg = cfg = port.ppo_config(P, config)
        if cfg.k_unrolls != 1 or cfg.action_repeat != 1:
            raise ValueError("the train mix records one unroll segment per env and no action repeat")
        self.gen = inputs.generator(self.seed, dev)
        self.program_gen = inputs.program_generator(self.seed, dev)
        self.ref_env = inputs.reference_env(config, dev)
        self.env = port.env(P, config, dev)
        self.classes = port.classes()
        mark("envs")
        n = cfg.num_envs
        self.dr = RR.DRDraws.sample(self.gen, n, self.ref_env.model.spec) if config["domain_randomize"] else None
        self.train_env = P.wrappers.TrainingEnv(
            self.env, cfg.episode_length, action_repeat=cfg.action_repeat,
            dr_draws=None if self.dr is None else trees.recast(self.dr, self.classes),
            randomization_fn=None if self.dr is None else P.randomize.domain_randomize)
        self.reset = self.ref_env.reset_draws(self.gen, n)
        self.env_state = self.train_env.reset(trees.recast(self.reset, self.classes))
        mark("reset")
        self.obs_sizes = {k: int(v.shape[-1]) for k, v in self.env_state.obs.items()}
        own = torch.Generator(device=dev).manual_seed(0)
        self.ts = P.ppo.init_training_state(self.env_state.obs, self.env.action_size, cfg, own, device=dev)
        self.params0 = inputs.weights(self.gen, *inputs.layer_sizes(config, self.obs_sizes, self.env.action_size))
        port.set_weights(self.ts.net, self.params0)
        mark("weights")
        envs = inputs.sample_envs(self.gen, n, self.traffic["checked_envs"])
        cpu = lambda x: trees.to(x, "cpu")
        self.record = types.SimpleNamespace(
            envs=envs.cpu(), dr=None if self.dr is None else cpu(trees.rows(self.dr, envs)),
            reset=cpu(trees.rows(self.reset, envs)), state0=cpu(trees.rows(self.env_state, envs)),
            params0=[p.cpu() for p in self.params0.leaves], n_policy=self.params0.n_policy,
            obs_sizes=self.obs_sizes, steps=[])
        for _ in range(self.traffic["checked_steps"]):
            self.record.steps.append(self._recorded_step())
        mark("recorded_steps")
        for _ in range(self.traffic["setup_steps"] - self.traffic["checked_steps"]):
            self.step()
        mark("more_steps")

    def step(self, phase_hook: Optional[Callable[[str], None]] = None):
        """One training step through the port's `ppo.training_step` with the
        port's generator, as `ppo.train` makes it; its metrics (0-d
        tensors, not read here)."""
        self.ts, self.env_state, metrics = self.P.ppo.training_step(
            self.ts, self.train_env, self.env, self.env_state, self.cfg, self.program_gen, phase_hook=phase_hook)
        return metrics

    def _recorded_step(self) -> types.SimpleNamespace:
        P, cfg, rec = self.P, self.cfg, self.record
        envs = rec.envs.to(self.device)
        cpu = lambda x: trees.to(x, "cpu")
        out = types.SimpleNamespace(states=[], actions=[], draws=[], obs=[cpu(self.env_state.obs)], reward=[],
                                    done=[], truncation=[])
        before = self.program_gen.get_state()
        inner = self.train_env.step

        def step(state, action, d):
            nstate = inner(state, action, d)
            out.states.append(cpu(trees.rows(nstate, envs)))
            out.actions.append(action.cpu())
            out.draws.append(cpu(d))
            out.obs.append(cpu(nstate.obs))
            out.reward.append(nstate.reward.cpu())
            out.done.append(nstate.done.cpu())
            out.truncation.append(nstate.info["truncation"].cpu())
            return nstate

        self.train_env.step = step
        try:
            metrics = self.step()
        finally:
            del self.train_env.step
        out.metrics = {k: float(v) for k, v in metrics.items()}
        out.params = [p.detach().cpu().clone() for p in self.ts.net.parameters()]
        out.normalizer = cpu(self.ts.normalizer)
        # the draws the port made, again from its generator's state before
        # the step, through its own samplers in `training_step`'s order
        gen = torch.Generator(device=self.device)
        gen.set_state(before)
        unroll = P.ppo.unroll_draws(self.train_env, cfg.num_envs, cfg.k_unrolls * cfg.unroll_length, gen)
        sgd = P.ppo.sgd_draws(cfg, self.env.action_size, gen)
        out.noise, out.replayed = unroll.action_noise.cpu(), [cpu(d) for d in unroll.env]
        out.perms, out.entropy_noise = sgd.perms.cpu(), sgd.entropy_noise.cpu()
        return out

    # ----------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        """Whole training steps until `seconds` have passed, then a
        synchronize: (units, env steps, seconds, failed)."""
        self.sync()
        t0 = time.perf_counter()
        metrics = []
        while True:
            metrics.append(self.step())
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        finite = torch.stack([torch.isfinite(m["total_loss"]) & torch.isfinite(m["reward_mean"]) for m in metrics])
        return {"units": len(metrics), "work": len(metrics) * self.cfg.steps_per_training_step,
                "seconds": elapsed, "failed": int((~finite).sum())}

    def timed_phases(self, seconds: float) -> dict:
        """The trace run's untraced stretch: whole training steps for
        `seconds`, each phase timed by the trainer's synchronized
        `phase_hook`: seconds per step, rollout (its draws included) and
        update (mean)."""
        times = {"rollout": [], "update": []}
        last = [0.0]

        def hook(name):
            self.sync()
            now = time.perf_counter()
            times[name].append(now - last[0])
            last[0] = now

        self.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not times["update"]:
            last[0] = time.perf_counter()
            self.step(hook)
        steps = len(times["update"])
        mean = {k: sum(v) / steps for k, v in times.items()}
        return {"units": steps, "step_s": sum(mean.values()), "rollout_s": mean["rollout"],
                "update_s": mean["update"]}

    def traced_unit(self, span: Callable[[str], None]) -> None:
        """One training step for the profiler, its phases marked as spans."""
        span("rollout")
        self.step(lambda name: span("update") if name == "rollout" else None)

    def one_env_step(self) -> Callable[[], object]:
        """A call of one control step of the training env, as the rollout
        makes it, its inputs made beforehand (for the host-sync count)."""
        gen = torch.Generator(device=self.device).manual_seed(1)
        draws = self.train_env.step_draws(gen, self.cfg.num_envs)
        action = torch.zeros((self.cfg.num_envs, self.env.action_size), device=self.device)
        state = self.env_state
        self.sync()
        return lambda: self.train_env.step(state, action, draws)

    # ------------------------------------------------------ what is read
    def work_shape(self) -> dict:
        """What the counting functions of `benchmark/metrics` take: one
        training step's kernel launches, samples, epochs and minibatches."""
        cfg = self.cfg
        policy, value = inputs.layer_sizes(self.config, self.obs_sizes, self.env.action_size)
        return {"envs": cfg.num_envs, "substeps": self.env.n_substeps, "launches": cfg.k_unrolls * cfg.unroll_length,
                "samples": cfg.steps_per_training_step, "epochs": cfg.num_updates_per_batch,
                "minibatches": cfg.num_minibatches, "batch": cfg.batch_size,
                "policy_sizes": policy, "value_sizes": value}

    def final_data(self):
        return self.env_state.data

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("ts", "env_state", "train_env", "env"):
            setattr(self, name, None)

    def numbers(self, device) -> dict:
        """The numbers the check compares (`check.train_numbers`)."""
        ref = check.train_reference(self.record, self.config, self.traffic, device)
        return check.train_numbers(check.program_outputs(self.record), ref, self.record, self.traffic)
