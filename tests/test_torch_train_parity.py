"""Whole PPO training steps of the port against the JAX package's trainer,
on the standing task: `open_duck_playground_tpu.train.ppo.train` itself, on
the real `Standing("flat_terrain")` with `domain_randomize` as the CLI
passes it, at a toy width, against the port's `ppo.training_step` and
`ppo.run_eval` with every random number replayed from JAX's key chain.

The run: 16 envs, unroll 8, 2 epochs of 2 minibatches, networks (16, 16),
episode length 12, 3 training steps, evals of 4 envs x 12 steps. Two cases:
batch 8 (k = 1) with an eval period per training step, and batch 16 (k = 2)
with the three steps in one period. The episode length puts truncations,
autoresets and a normalizer merge with a new count into every step; the env
config pushes the base every 1-3 control steps at 1-3 m/s (`push_config`,
both sides) so that falls occur as well. The test asserts that each run
held an autoreset, a truncation and a fall.

The JAX side runs unmodified. In the k = 1 case its `TrainingEnv` is
subclassed only to record each step's state, action and result
(`jax.debug.callback`); the k = 2 case records nothing. The port starts
from JAX's initial training state (`interop.training_state_from_jax`) and
its own reset, and replays: the key chain `PRNGKey(seed)` -> domain
randomization, network init, env reset and the epoch key (asserted equal
to the one `policy_params_fn` reports); per training step `key,
unroll_key, sgd_key`; per rollout step `akey` (action noise); each env's
`info["rng"]` chain from its reset on, which an autoreset leaves as it is
(asserted equal to the recorded one at every step); per epoch `perm_key`
and per minibatch `ent_key`; per eval the eval key chain from
`PRNGKey(seed + 1000)` and its envs' rng chains.

Where JAX's steps are recorded, each env step of the port runs free and is
held to JAX's: actions within 5e-4 (measured 3.2e-5), then the gates of
test_torch_standing_long.py (qpos, qvel, obs, reward, metrics, done,
truncation, the info entries; the p90 gates over all env steps of the run).
An env over a max physics gate must be an edge of the plain version
(`is_edge`); the test then re-syncs that env to JAX's recorded state and
counts it (none so far).

At the end of each eval period, against what the JAX hooks report, as
max |port - JAX| / max(|JAX|, floor) over the entries (`LIMITS`, ten times
the largest measured, rounded up): parameters 5e-6 (floor 1; measured
4.5e-7; updates are up to 3e-4 per SGD step); Adam's mu and nu 2e-4 of each
tensor's largest entry (measured 2.1e-5, 1.9e-5: the gradients' own
agreement, test_torch_ppo.py) and its count exactly; the normalizer's count
exactly, mean 1e-3 (floor 1e-2; measured 3.4e-4), summed variance 3e-4 and
std 1.5e-4 (floor 1e-3; measured 3.0e-5, 1.5e-5: the port sums the moments
in float64, JAX in float32); env_steps exactly; the period's `training/*`
metrics 2e-4 and the eval's `eval/*` metrics 1.5e-4 (floor 1e-3; measured
1.7e-5, 1.5e-5).

Also here: the port's float64 normalizer against JAX's float32 one on a
nearly constant feature, and `tools.recipe_outcome` after a toy CLI run.

About 3 min on one CPU thread, most of it XLA compiling the recorded JAX
trainer (a computation with a host callback stays out of the persistent
compilation cache).
"""

import dataclasses
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from open_duck_playground_tpu.envs import wrappers as JW
from open_duck_playground_tpu.envs.randomize import domain_randomize as jax_dr
from open_duck_playground_tpu.envs.standing import Standing as JStanding
from open_duck_playground_tpu.train import ppo as JPPO

from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.envs.randomize import domain_randomize
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv
from open_duck_playground_torch.interop import state_from_jax, training_state_from_jax
from open_duck_playground_torch.physics.types import Data
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig

from test_torch_envs import per_env_err, reset_draws_fn, step_draws_fn
from test_torch_rollout import _dr_draws
from test_torch_standing_long import (
    INFO_CLOSE, INFO_EXACT, P90, assert_state_close, physics_edges, to_numpy,
)

torch.set_num_threads(1)

SEED = 0
E, T, NMB, EPOCHS, HIDDEN, EPISODE, EVAL_ENVS, STEPS = 16, 8, 2, 2, (16, 16), 12, 4, 3
ENV_OVERRIDES = {"push_config.interval_range": [0.02, 0.06], "push_config.magnitude_range": [1.0, 3.0]}
# batch size (batch * NMB = k * E) and num_evals: k = 1 with an eval period
# per training step, k = 2 with all three steps in one period
CASES = {"k1": (8, STEPS + 1), "k2": (16, 2)}
ACTION_TOL = 5e-4
INFO_KEYS = INFO_EXACT + tuple(INFO_CLOSE)
# each side acts on its own policy's action: what the env keeps of it
ACTION_INFO = dict.fromkeys(("last_act", "last_last_act", "last_last_last_act", "action_history",
                             "motor_targets"), ACTION_TOL)


def _cfg(batch_size: int, num_evals: int) -> PPOConfig:
    return PPOConfig(num_envs=E, batch_size=batch_size, num_minibatches=NMB, unroll_length=T,
                     num_updates_per_batch=EPOCHS, episode_length=EPISODE,
                     num_eval_envs=EVAL_ENVS, num_evals=num_evals, seed=SEED,
                     policy_hidden_layer_sizes=HIDDEN, value_hidden_layer_sizes=HIDDEN)


# ------------------------------------------------------------ the JAX side
def _tapped(cls, sink):
    """`cls` whose step also hands (state, action, result) to `sink`."""

    class Tapped(cls):
        def step(self, state, action):
            out = super().step(state, action)
            jax.debug.callback(lambda *a: sink.append(jax.tree.map(np.array, a)),
                               state, action, out, ordered=True)
            return out

    return Tapped


def jax_train(jenv, cfg: PPOConfig, tap: bool):
    """JAX's `ppo.train` as the CLI runs it, on one CPU device. Returns the
    hooks' (step, (training_state, epoch_key)), the progress metrics, and
    with `tap` the recorded training env steps (else None)."""
    out = dict(hooks=[], progress=[], train=[] if tap else None)
    with pytest.MonkeyPatch.context() as mp:
        if tap:
            mp.setattr(JPPO, "TrainingEnv", _tapped(JW.TrainingEnv, out["train"]))
        JPPO.train(
            jenv, num_timesteps=STEPS * cfg.steps_per_training_step, num_envs=E,
            episode_length=EPISODE, unroll_length=T, num_minibatches=NMB,
            num_updates_per_batch=EPOCHS, batch_size=cfg.batch_size, num_evals=cfg.num_evals,
            num_eval_envs=EVAL_ENVS, seed=SEED, policy_hidden_layer_sizes=HIDDEN,
            value_hidden_layer_sizes=HIDDEN, randomization_fn=jax_dr,
            progress_fn=lambda step, m: out["progress"].append((step, dict(m))),
            policy_params_fn=lambda step, _mp, _v, full_state=None: out["hooks"].append(
                (step, to_numpy(full_state))),
            mesh=Mesh(np.array(jax.devices()[:1]), ("data",)),
        )
    return out


# ----------------------------------------------------------- the port side
def splice(a, b, mask: np.ndarray):
    """`a` with the envs of `mask` taken from `b` (State, Data, dicts)."""
    if isinstance(a, State):
        return State(**{f.name: splice(getattr(a, f.name), getattr(b, f.name), mask)
                        for f in dataclasses.fields(a)})
    if isinstance(a, Data):
        return a.replace(**{k: splice(v, getattr(b, k), mask) for k, v in a.fields()})
    if isinstance(a, dict):
        return {k: splice(v, b[k], mask) for k, v in a.items()}
    m = torch.as_tensor(mask).reshape((-1,) + (1,) * (a.dim() - 1))
    return torch.where(m, b.to(a.dtype), a)


class Synced:
    """A port TrainingEnv that counts the falls, truncations and autoresets
    of its steps and, given JAX's recorded steps `taps` (in order), holds
    each step against JAX's: the env's rng, the action, then the result
    under the gates; an env at a physics edge is re-synced to JAX's
    recorded result and counted in `resyncs`."""

    def __init__(self, inner, taps=None, label: str = "train"):
        self.inner, self.taps, self.label = inner, None if taps is None else iter(taps), label
        self.counts = dict(falls=0, truncations=0, autoresets=0, resyncs=0, steps=0)
        self.max_action_err = 0.0
        self.p90 = P90()
        self.rngs = []  # each step's env rngs, set by the caller

    @property
    def env(self):
        return self.inner.env

    @property
    def action_size(self):
        return self.inner.action_size

    def step(self, state, action, draws):
        label = f"{self.label} step {self.counts['steps']}"
        post = self.inner.step(state, action, draws)
        if self.taps is not None:
            jpre, jaction, jpost = next(self.taps)
            np.testing.assert_array_equal(self.rngs[self.counts["steps"]], jpre.info["rng"], err_msg=label)
            err = per_env_err(jaction, action.numpy())
            self.max_action_err = max(self.max_action_err, float(err.max()))
            assert err.max() < ACTION_TOL, (label, "action", err)
            edges = physics_edges(self.inner.env, self.inner._model, state, post, draws, jpost, label,
                                  self.p90)
            assert_state_close(post, jpost, ~edges, label, self.p90, INFO_KEYS, ACTION_INFO)
            if edges.any():
                self.counts["resyncs"] += int(edges.sum())
                post = splice(post, state_from_jax(jpost, device="cpu"), edges)
        c = self.counts
        c["steps"] += 1
        c["autoresets"] += int((state.done > 0).sum())
        c["truncations"] += int((post.info["truncation"] > 0).sum())
        c["falls"] += int(((post.done > 0) & (post.info["truncation"] == 0)).sum())
        return post


def _normal(key, shape):
    return torch.as_tensor(np.array(jax.random.normal(key, shape, jnp.float32)))


def _chain(key, n, shape):
    """n draws of the scan idiom `key, sub = split(key)`: (key, (n, *shape))."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_normal(sub, shape))
    return key, torch.stack(out)


def sgd_draws(key, cfg: PPOConfig, nu: int) -> ppo.SGDDraws:
    """JAX's one_epoch / minibatch_step splits of `sgd_key`."""
    perms, noise = [], []
    for _ in range(cfg.num_updates_per_batch):
        key, perm_key = jax.random.split(key)
        perms.append(torch.as_tensor(np.array(jax.random.permutation(perm_key, cfg.k_unrolls * E))))
        key, n = _chain(key, cfg.num_minibatches, (cfg.unroll_length, cfg.batch_size, nu))
        noise.append(n)
    return ppo.SGDDraws(perms=torch.stack(perms).long(), entropy_noise=torch.stack(noise))


# limit of each compared quantity: max |port - JAX| / max(|JAX|, floor),
# over the entries (floor None: the entry's largest |JAX| in its tensor)
LIMITS = {"params": (5e-6, 1.0), "adam mu": (2e-4, None), "adam nu": (2e-4, None),
          "normalizer mean": (1e-3, 1e-2), "normalizer summed_var": (3e-4, 1e-3),
          "normalizer std": (1.5e-4, 1e-3), "training metrics": (2e-4, 1e-3),
          "eval metrics": (1.5e-4, 1e-3)}
MEASURED = {}


def check(cat: str, got, want, where: str):
    """`got` against `want` under LIMITS[cat]; the largest error per
    category is kept in MEASURED."""
    limit, floor = LIMITS[cat]
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not want.size:
        return
    scale = np.maximum(np.abs(want), np.abs(want).max() if floor is None else floor)
    err = float((np.abs(got - want) / np.maximum(scale, 1e-30)).max())
    MEASURED[cat] = max(MEASURED.get(cat, 0.0), err)
    assert err <= limit, (where, cat, err, limit)


def assert_training_state(ts, jts, label: str):
    """Parameters, Adam's moments and count, the normalizer and env_steps
    of the port's TrainingState against JAX's (numpy)."""
    adam = next(s for s in jax.tree.leaves(jts.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))
    for name, mlp in (("policy", ts.net.policy), ("value", ts.net.value_mlp)):
        for i, layer in enumerate(mlp.layers):
            for attr, leaf in (("weight", "kernel"), ("bias", "bias")):
                p = getattr(layer, attr)
                tr = (lambda x: x.T) if attr == "weight" else (lambda x: x)
                where = f"{label} {name} hidden_{i} {leaf}"
                check("params", p.detach().numpy(), tr(jts.params[name][f"hidden_{i}"][leaf]), where)
                st = ts.optimizer.state[p]
                check("adam mu", st["exp_avg"].numpy(), tr(adam.mu[name][f"hidden_{i}"][leaf]), where)
                check("adam nu", st["exp_avg_sq"].numpy(), tr(adam.nu[name][f"hidden_{i}"][leaf]), where)
                assert float(st["step"]) == int(adam.count), (where, float(st["step"]), adam.count)
    n, jn = ts.normalizer, jts.normalizer
    assert float(n.count) == float(jn.count), (label, float(n.count), jn.count)
    for k in jn.mean:
        for field in ("mean", "summed_var", "std"):
            check(f"normalizer {field}", getattr(n, field)[k].numpy(), getattr(jn, field)[k],
                  f"{label} {field} {k}")
    assert ts.env_steps == int(jts.env_steps), (label, ts.env_steps, jts.env_steps)


def assert_metrics(got: dict, want: dict, cat: str, prefix: str, label: str):
    names = [k for k in want if k.startswith(prefix) and k != "training/sps"]
    assert names and set(names) <= set(got), (label, sorted(names), sorted(got))
    for k in names:
        check(cat, got[k], want[k], f"{label} {k}")


def port_train(jenv, cfg: PPOConfig, jax_out: dict) -> dict:
    """The port's training steps and evals with JAX's draws, compared at
    the end of each eval period with what the JAX hooks reported, and step
    by step where JAX's steps were recorded. Returns the counts."""
    hooks, progress, taps = jax_out["hooks"], jax_out["progress"], jax_out["train"]
    L = cfg.k_unrolls * T
    periods = cfg.num_evals - 1
    per_period = STEPS // periods
    assert [s for s, _ in hooks] == [i * per_period * cfg.steps_per_training_step
                                     for i in range(periods + 1)]

    rng = jax.random.PRNGKey(SEED)
    rng, wrap_rng = jax.random.split(rng)
    rng, _init_rng = jax.random.split(rng)
    rng, reset_rng, epoch_key = jax.random.split(rng, 3)
    np.testing.assert_array_equal(np.asarray(epoch_key), hooks[0][1][1])  # the rebuilt chain

    tenv = Standing("flat_terrain", config_overrides=ENV_OVERRIDES, device="cpu")
    draws_of, reset_of = step_draws_fn(jenv), reset_draws_fn(jenv)
    train_env = TrainingEnv(tenv, EPISODE, dr_draws=_dr_draws(jenv.model.spec, jax.random.split(wrap_rng, E)),
                            randomization_fn=domain_randomize)
    reset, env_rng = reset_of(jax.random.split(reset_rng, E))
    env_state = train_env.reset(reset)
    if taps is not None:
        assert len(taps) == STEPS * L
        reset_p90 = P90()
        assert_state_close(env_state, taps[0][0], np.ones(E, bool), "reset", reset_p90, INFO_KEYS, ACTION_INFO)
        reset_p90.check("reset")
    ts = training_state_from_jax(hooks[0][1][0], learning_rate=cfg.learning_rate, device="cpu")
    assert_training_state(ts, hooks[0][1][0], "initial")

    synced = Synced(train_env, taps)
    eval_env = EvalEnv(tenv, EPISODE)
    eval_rng = jax.random.PRNGKey(SEED + 1000)

    def env_draws(rng, n):
        """n steps of the envs' draws along their rng chains (an autoreset
        leaves `info["rng"]` as it is): (draws, rngs before each, rng)."""
        draws, rngs = [], []
        for _ in range(n):
            rngs.append(np.asarray(rng))
            d, rng = draws_of(rng)
            draws.append(d)
        return draws, rngs, rng

    def evaluate(p):
        """Eval p: the evaluator's key chain, each env's rng chain from its
        reset on, the metrics against JAX's."""
        nonlocal eval_rng
        eval_rng, key = jax.random.split(eval_rng)
        key, rkey = jax.random.split(key)
        _, noise = _chain(key, EPISODE, (EVAL_ENVS, tenv.action_size))
        reset, rng = reset_of(jax.random.split(rkey, EVAL_ENVS))
        draws, _, _ = env_draws(rng, EPISODE)
        got = ppo.run_eval(eval_env, (ts.normalizer, ts.net), EVAL_ENVS, EPISODE, False, None,
                           ppo.EvalDraws(reset=reset, action_noise=noise, env=draws))
        assert progress[p][0] == hooks[p][0]
        assert_metrics(got, progress[p][1], "eval metrics", "eval/", f"eval {p}")

    evaluate(0)
    key = epoch_key
    period = []
    for i in range(STEPS):
        key, unroll_key, sgd_key = jax.random.split(key, 3)
        _, noise = _chain(unroll_key, L, (E, tenv.action_size))
        draws, rngs, env_rng = env_draws(env_rng, L)
        synced.rngs += rngs
        ts, env_state, metrics = ppo.training_step(
            ts, synced, tenv, env_state, cfg, None, unroll=ppo.UnrollDraws(action_noise=noise, env=draws),
            sgd=sgd_draws(sgd_key, cfg, tenv.action_size))
        period.append(metrics)
        if (i + 1) % per_period:
            continue
        p = (i + 1) // per_period
        assert_training_state(ts, hooks[p][1][0], f"after training step {i + 1}")
        mean = {f"training/{k}": float(torch.stack([m[k] for m in period]).mean()) for k in metrics}
        assert_metrics(mean, progress[p][1], "training metrics", "training/", f"period {p}")
        period = []
        evaluate(p)

    synced.p90.check("train")
    counts = dict(synced.counts, max_action_err=synced.max_action_err, p90=synced.p90.summary())
    print(f"train parity (k={cfg.k_unrolls}):", counts, "measured so far:", MEASURED)
    return counts


@pytest.fixture(scope="module")
def jenv():
    return JStanding(task="flat_terrain", config_overrides=ENV_OVERRIDES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_steps_match_jax_trainer(jenv, case):
    """k = 1 records JAX's env steps and holds the port to each of them;
    k = 2 holds the port's three steps to JAX's trainer at the end (its
    JAX trainer, with nothing recorded, compiles into the persistent
    cache)."""
    cfg = _cfg(*CASES[case])
    assert cfg.k_unrolls == {"k1": 1, "k2": 2}[case]
    counts = port_train(jenv, cfg, jax_train(jenv, cfg, tap=case == "k1"))
    assert counts["falls"] > 0 and counts["truncations"] > 0 and counts["autoresets"] > 0, counts
    assert counts["steps"] == STEPS * cfg.k_unrolls * T
    assert counts["resyncs"] <= counts["steps"] * E // 50, counts  # each an edge; at most 2% of env steps


def test_resync_splices_only_the_edge_envs(jenv):
    """The re-sync `Synced` applies at an edge: `splice` takes the masked
    envs' every leaf (physics, obs, info, the cached reset state) from the
    other state, and keeps the others."""
    tenv = Standing("flat_terrain", config_overrides=ENV_OVERRIDES, device="cpu")
    te = TrainingEnv(tenv, EPISODE)
    reset_of = reset_draws_fn(jenv)
    a = te.reset(reset_of(jax.random.split(jax.random.PRNGKey(5), 4))[0])
    b = te.reset(reset_of(jax.random.split(jax.random.PRNGKey(6), 4))[0])
    mask = np.array([False, True, False, True])
    got = splice(a, b, mask)
    for (x, y, z) in [(got.data.qpos, a.data.qpos, b.data.qpos), (got.obs["state"], a.obs["state"], b.obs["state"]),
                      (got.info["command"], a.info["command"], b.info["command"]),
                      (got.info["first_data"].qvel, a.info["first_data"].qvel, b.info["first_data"].qvel)]:
        torch.testing.assert_close(x[~torch.as_tensor(mask)], y[~torch.as_tensor(mask)], rtol=0, atol=0)
        torch.testing.assert_close(x[torch.as_tensor(mask)], z[torch.as_tensor(mask)], rtol=0, atol=0)
    assert got.info["step"].dtype == a.info["step"].dtype


# ------------------------------------------ the normalizer's float32 sums
@contextmanager
def float32_moments():
    """The port's normalizer with its moments summed in float32 and merged
    as JAX merges them (sv + t2 - delta * t1, left to right), for the
    block's duration."""
    from open_duck_playground_torch.train import running_stats as RS

    def zero_moments(stats):
        return tuple({k: torch.zeros_like(v) for k, v in stats.mean.items()} for _ in range(2))

    def merge_moments(stats, batch_count, t1, t2):
        new_count = stats.count + batch_count
        mean, summed_var = {}, {}
        for k in t1:
            delta = t1[k] / new_count
            mean[k] = stats.mean[k] + delta
            summed_var[k] = stats.summed_var[k] + t2[k] - delta * t1[k]
        return RS._merged(stats, new_count, mean, summed_var)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RS, "zero_moments", zero_moments)
        mp.setattr(RS, "merge_moments", merge_moments)
        yield


def test_float32_moments_merge_as_jax_does():
    """`float32_moments`: three rollouts' moments summed in float32 and
    merged in the JAX package's order of operations give JAX's normalizer
    within 2e-6 relative on well-conditioned features (the sums' order
    differs). On a nearly constant feature (mean 1, std 2e-3, as gravity's
    z) the float32 sum about the first mean (0) cancels, and the summed
    variance depends on the order of the sums: the two float32 orders agree
    within 3% (measured: JAX's 0.85% under the exact value, the port's
    order 0.14% over); the port's float64 sums are within 2e-4 of it
    (measured 5e-5: each x - mean is still taken in float32). Summing in
    float32 did not move the standing recipe on the card (PERF.md)."""
    from open_duck_playground_tpu.train import running_stats as JRS
    from open_duck_playground_torch.train import running_stats as TRS

    rng = np.random.default_rng(7)
    n, steps = 4096, 3
    scale = np.array([1.0, 0.3, 2e-3], np.float32)
    loc = np.array([0.5, -2.0, 1.0], np.float32)
    batches = [[(loc + scale * rng.standard_normal((n // 8, 3))).astype(np.float32) for _ in range(8)]
               for _ in range(steps)]

    js = JRS.init({"x": 3})
    for b in batches:
        m = JRS.zero_moments(js)
        for x in b:
            m = JRS.accumulate_moments(js, m, {"x": jnp.asarray(x)})
        js = JRS.merge_moments(js, jnp.asarray(n, jnp.float32), *m)

    def port(stats):
        for b in batches:
            m = TRS.zero_moments(stats)
            for x in b:
                m = TRS.accumulate_moments(stats, m, {"x": torch.as_tensor(x)})
            stats = TRS.merge_moments(stats, float(n), *m)
        return stats

    with float32_moments():
        f32 = port(TRS.init({"x": 3}, device="cpu"))
    f64 = port(TRS.init({"x": 3}, device="cpu"))
    for field in ("mean", "summed_var", "std"):
        got, want = getattr(f32, field)["x"].numpy(), np.asarray(getattr(js, field)["x"])
        np.testing.assert_allclose(got[:2], want[:2], rtol=2e-6, atol=0, err_msg=field)
    np.testing.assert_allclose(f32.mean["x"][2].item(), float(js.mean["x"][2]), rtol=2e-6)
    np.testing.assert_allclose(f32.summed_var["x"][2].item(), float(js.summed_var["x"][2]), rtol=3e-2)
    assert f32.count.dtype == torch.float32 and float(f32.count) == float(js.count) == n * steps
    x2 = np.concatenate([np.concatenate(b) for b in batches])[:, 2].astype(np.float64)
    exact = float(np.var(x2) * x2.size)
    print("summed variance of the nearly constant feature: float64", float(f64.summed_var["x"][2]),
          "float32 (port order)", float(f32.summed_var["x"][2]), "float32 (JAX)",
          float(js.summed_var["x"][2]), "exact", exact)
    np.testing.assert_allclose(float(f64.summed_var["x"][2]), exact, rtol=2e-4)
    assert TRS.zero_moments(f64)[0]["x"].dtype == torch.float64  # the default is restored


def test_recipe_outcome_trains_through_the_cli_and_evaluates(tmp_path):
    """A toy CLI run on the CPU logs every eval as a JSON line; the tool
    then evaluates the run's checkpoint of the highest step three ways."""
    import json

    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.tools import recipe_outcome

    toy = ["num_envs=8", "batch_size=4", "num_minibatches=2", "unroll_length=4", "num_evals=3",
           "num_eval_envs=2", "episode_length=5"]
    env = ["--env", "standing", "--task", "flat_terrain"]
    for o in toy:
        env += ["--config_override", o]
    run = tmp_path / "run"
    runner.main(env + ["--num_timesteps", "128", "-o", str(run)], device="cpu")
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["env_steps"] for r in recs] == [0, 64, 128]
    assert all("eval/episode_reward" in r for r in recs) and "training/sps" in recs[-1]
    assert 0 < recs[1]["wall_s"] < recs[2]["wall_s"]
    assert recipe_outcome.last_checkpoint(run).name.endswith("_128")

    evals = recipe_outcome.main([str(run), *env, "--eval_envs", "3", "--eval_length", "4"], device="cpu")
    assert set(evals) == {"stochastic", "deterministic", "no_push"}
    assert json.loads((run / "evals.json").read_text()) == evals
    for m in evals.values():
        assert m["eval/avg_episode_length"] == 4 and np.isfinite(m["eval/episode_reward_stderr"])
