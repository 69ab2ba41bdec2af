"""Traffic of the `eval` kind: the port's `ppo.run_eval` as `ppo.train`'s
evaluator calls it: `num_eval_envs` fresh episodes of `episode_length`
control steps on the nominal model under the policy (stochastic unless the
configuration's `deterministic_eval`), evals back to back, each drawing its
random numbers from the port's generator, as the trainer's evaluator does.

Set-up builds the eval env and the networks and warms the shapes with one
short eval. The window runs whole evals until `--seconds` have passed. In
each, recorders on the eval env's `reset` and `step` (this object's own)
keep the reset draws and state, and the state in, the action, the step
draws and the state out of `checked_steps_per_eval` control steps drawn from
the seed (references only: nothing is copied or waited for), beside the
generator's state as the eval starts. Once the window has closed, the
eval's draws are replayed from that state in `run_eval`'s order through the
port's samplers: the action noise of the kept steps, and the reset and step
draws, which must equal those the env was given. The check compares them
then."""

from __future__ import annotations

import random
import time
import types

import torch

from benchmark.harness import check, inputs, port, trees
from benchmark.reference.train import running_stats as RS


class Loop:
    kind = "eval"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.sync = (lambda: torch.cuda.synchronize(self.device)) if self.device.type == "cuda" else (lambda: None)
        self.timings = inputs.Timings(self.sync)
        self.rng = random.Random(int(seed))

    def setup(self) -> None:
        mark = self.timings.mark
        P = self.P = port.modules()
        mark("import")
        config, dev = self.config, self.device
        self.cfg = cfg = port.ppo_config(P, config)
        if cfg.action_repeat != 1:
            raise ValueError("the eval mix records one env step per control step")
        self.gen = inputs.generator(self.seed, dev)
        self.program_gen = inputs.program_generator(self.seed, dev)
        self.ref_env = inputs.reference_env(config, dev)
        self.env = port.env(P, config, dev)
        self.classes = port.classes()
        self.eval_env = P.wrappers.EvalEnv(self.env, cfg.episode_length, action_repeat=cfg.action_repeat)
        mark("envs")
        self.num_envs = cfg.num_eval_envs
        self.length = cfg.episode_length // cfg.action_repeat
        self.deterministic = cfg.deterministic_eval
        # the observation sizes, from one env of the task
        probe = self.eval_env.reset(trees.recast(self.ref_env.reset_draws(self.gen, 1), self.classes))
        self.obs_sizes = {k: int(v.shape[-1]) for k, v in probe.obs.items()}
        own = torch.Generator(device=dev).manual_seed(0)
        ts = P.ppo.init_training_state(probe.obs, self.env.action_size, cfg, own, device=dev)
        self.params0 = inputs.weights(self.gen, *inputs.layer_sizes(config, self.obs_sizes, self.env.action_size))
        port.set_weights(ts.net, self.params0)
        self.variables = (ts.normalizer, ts.net)
        self.normalizer0 = RS.init(self.obs_sizes, device=dev)
        mark("weights")
        self.records = []
        self.evaluate(self.traffic["warmup_steps"], keep=0)
        mark("warmup_eval")

    def evaluate(self, length: int, keep: int) -> dict:
        """One eval of `length` control steps through `ppo.run_eval` with the
        port's generator, recording `keep` of its steps (drawn from the
        seed, the first among them) and its reset."""
        if not keep:
            return self.P.ppo.run_eval(self.eval_env, self.variables, self.num_envs, length, self.deterministic,
                                       self.program_gen)
        chosen = set(self.rng.sample(range(length), min(keep, length))) | {0}
        rec = types.SimpleNamespace(length=length, generator=self.program_gen.get_state(), steps={})
        self.records.append(rec)
        inner_reset, inner_step = self.eval_env.reset, self.eval_env.step
        counter = [0]

        def reset(draws):
            rec.reset_draws = draws
            rec.reset_state = inner_reset(draws)
            return rec.reset_state

        def step(state, action, d):
            out = inner_step(state, action, d)
            if counter[0] in chosen:
                rec.steps[counter[0]] = types.SimpleNamespace(state=state, action=action, draws=d, out=out)
            counter[0] += 1
            return out

        self.eval_env.reset, self.eval_env.step = reset, step
        try:
            return self.P.ppo.run_eval(self.eval_env, self.variables, self.num_envs, length, self.deterministic,
                                       self.program_gen)
        finally:
            del self.eval_env.reset, self.eval_env.step

    def replay(self) -> None:
        """The draws of each recorded eval again, from the generator's state
        as it started, in `run_eval`'s order: the noise of the kept steps,
        and how far the reset and step draws lie from those the env got."""
        n, act = self.num_envs, self.env.action_size
        for rec in self.records:
            if hasattr(rec, "draws_gap"):
                continue
            gen = torch.Generator(device=self.device)
            gen.set_state(rec.generator)
            gaps = [check.draws_gap(rec.reset_draws, self.eval_env.env.reset_draws(gen, n))]
            for t in range(rec.length):
                noise = None if self.deterministic else torch.randn((n, act), generator=gen, device=gen.device)
                draws = self.eval_env.step_draws(gen, n)
                if t in rec.steps:
                    rec.steps[t].noise = noise
                    gaps.append(check.draws_gap(rec.steps[t].draws, draws))
            rec.draws_gap = max(gaps)

    def window(self, seconds: float) -> dict:
        self.sync()
        t0 = time.perf_counter()
        results = []
        while True:
            results.append(self.evaluate(self.length, self.traffic["checked_steps_per_eval"]))
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        self.replay()
        failed = sum(not all(v == v and abs(v) != float("inf") for v in r.values()) for r in results)
        return {"units": len(results), "work": len(results) * self.num_envs * self.length,
                "seconds": elapsed, "failed": failed}

    def timed_phases(self, seconds: float) -> dict:
        """The trace run's untraced stretch: whole evals for `seconds`, and
        then an untraced eval of `trace_steps` control steps, the traced
        unit's twin."""
        w = self.window(seconds)
        n = self.traffic["trace_steps"]
        self.sync()
        t0 = time.perf_counter()
        self.evaluate(n, keep=0)
        self.sync()
        return {"units": w["units"], "step_s": time.perf_counter() - t0}

    def traced_unit(self, span) -> None:
        span("eval")
        self.evaluate(self.traffic["trace_steps"], keep=0)

    def one_env_step(self):
        gen = torch.Generator(device=self.device).manual_seed(1)
        state = self.eval_env.reset(self.eval_env.env.reset_draws(gen, self.num_envs))
        draws = self.eval_env.step_draws(gen, self.num_envs)
        action = torch.zeros((self.num_envs, self.env.action_size), device=self.device)
        self.sync()
        return lambda: self.eval_env.step(state, action, draws)

    def work_shape(self) -> dict:
        """What the counting functions of `benchmark/metrics` take: the
        traced unit's control steps, one kernel launch each."""
        n = self.traffic["trace_steps"]
        policy, value = inputs.layer_sizes(self.config, self.obs_sizes, self.env.action_size)
        return {"envs": self.num_envs, "substeps": self.env.n_substeps, "launches": n, "samples": self.num_envs * n,
                "policy_sizes": policy, "value_sizes": value}

    def final_data(self):
        last = self.records[-1]
        return last.steps[max(last.steps)].out.data

    def free(self) -> None:
        self.variables = None
        self.eval_env = None
        self.env = None

    def numbers(self, device) -> dict:
        """The numbers the check compares (`check.eval_numbers`)."""
        refs = check.eval_reference(self.records, self.config, self.params0, self.normalizer0, self.deterministic,
                                    device)
        return check.eval_numbers(check.eval_program_outputs(self.records), refs, self.records, self.traffic)
