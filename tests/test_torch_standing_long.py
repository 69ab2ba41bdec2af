"""The standing task of the port against the JAX package's over a long run:
`TrainingEnv(Standing("flat_terrain"))` with domain randomization, 8 envs,
520 control steps, through pushes, falls, a command resample at
`step > 500`, truncations and autoresets.

Both sides start every control step from the same state (the JAX state
carried over with `interop.state_from_jax`) and the port takes the JAX env's
own random numbers, replayed from each env's `info["rng"]`. Per step:

- qpos and qvel under the gates of test_megakernel_interpret.py (p90 1e-5 /
  max 1e-4 and p90 1e-3 / max 1e-2). An env over a max gate passes only as
  an edge of the plain version: from the same physics input perturbed at
  rounding scale (relative 1e-6), the port's own plain step moves by at
  least the max gate, and one of those results lies within the max gates
  of JAX's (the rule of `assert_substep_gates`, test_torch_physics.py, over
  the 10 substeps of a control step). Its other fields are then not
  compared on that step; the edges are counted.
- Obs, reward and the reward terms (the metrics) at test_torch_envs.py's
  tolerances (obs p90 1e-3 / max 1e-2, reward 2.2e-4 and metrics 1e-3
  relative), with the p90 taken over every env step of the run and each
  step's max at ten times the p90 (the qvel gates' ratio); the obs columns
  that are derived physics fields at test_megakernel_interpret.py's p90
  gates (accelerometer 5e-2, actuator forces 1e-2); `done` and
  `truncation` exactly.
- The info entries `step`, `push_step`, `push_interval_steps` exactly,
  `command`, `push`, `last_act` (and the two before it), the action delay
  buffer and `motor_targets` within 1e-6; the IMU delay buffer (noisy
  gravity, a physics output) within the obs max 1e-2; `feet_air_time` and
  `last_contact` exactly.

Env 1 takes reset draws with a push every 8 control steps (injected
`ResetDraws.push_interval`, the JAX state's `push_interval_steps` set to
match), the others the drawn interval (250-500 steps); env 0 takes an
action stream that leans it over for its first 60 steps, every other
action is zero. The test asserts that the run holds a push, a fall, a command
resample and an autoreset (by a fall and by truncation at 300 steps).

`cross_eval` scores a checkpoint of the port in JAX's `EvalEnv(Standing)`
and in the port's; run as a script it prints both at full eval length:

    JAX_PLATFORMS=cpu python tests/test_torch_standing_long.py CKPT_DIR --envs 1024

Measured on one CPU thread: ~110 s for the run, most of it the port's plain
physics (0.2 s per control step).
"""

if __name__ == "__main__":  # run as a script: the repo on the path, the tests' JAX settings
    import pathlib
    import sys

    sys.path[:0] = [str(pathlib.Path(__file__).resolve().parents[1])]
    import conftest  # noqa: F401  (CPU, x64)

import argparse
import dataclasses
import json
import math
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_duck_playground_tpu.envs import wrappers as JW
from open_duck_playground_tpu.envs.randomize import domain_randomize as jax_dr
from open_duck_playground_tpu.envs.standing import Standing as JStanding

from open_duck_playground_torch.envs.randomize import domain_randomize
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv, _where_done
from open_duck_playground_torch.interop import state_from_jax
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics.types import RANDOMIZED_FIELDS

from test_torch_envs import (
    METRIC_REL, OBS_MAX, OBS_P90, REWARD_REL, per_env_err, reset_draws_fn, step_draws_fn,
)
from test_torch_rollout import _dr_draws

torch.set_num_threads(1)

B = 8
STEPS = 520
EPISODE = 300
GATES = [("qpos", 1e-5, 1e-4), ("qvel", 1e-3, 1e-2)]
EDGE_COPIES, EDGE_SCALE = 64, 1e-6
INFO_EXACT = ("step", "push_step", "push_interval_steps", "feet_air_time", "last_contact", "steps",
              "truncation")
# obs columns of the standing task that are derived physics fields, gated
# as test_megakernel_interpret.py gates them (p90 over the envs): the
# accelerometer (sensordata, noisy in `state` 3:6 and in `privileged_state`
# 3:6, plain at 88:91) and the actuator forces (privileged 129:143)
ACCEL = [3, 4, 5]
DERIVED_OBS = {"state": [(ACCEL, 5e-2)],
               "privileged_state": [(ACCEL + [88, 89, 90], 5e-2), (list(range(129, 143)), 1e-2)]}
INFO_CLOSE = {"command": 1e-6, "push": 1e-6, "last_act": 1e-6, "last_last_act": 1e-6,
              "last_last_last_act": 1e-6, "action_history": 1e-6, "motor_targets": 1e-6,
              "imu_history": OBS_MAX}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------- physics edges
def physics_input(env, pre, post, draws):
    """What the port's physics took in a TrainingEnv step from `pre`: the
    autoreset state, the push added to the base velocity, and the servo
    targets (`post.info["motor_targets"]`)."""
    data = _where_done(pre.done > 0, pre.info["first_data"], pre.data)
    qvel = data.qvel.clone()
    a = env._floating_base_qvel_addr
    qvel[:, a : a + 2] += post.info["push"] * draws.push_magnitude[:, None]
    return data.replace(qvel=qvel), post.info["motor_targets"]


def _select(model, data, ctrl, env, copies):
    sel = torch.full((copies,), env, dtype=torch.long)
    m = model.replace(**{f: getattr(model, f)[sel] for f in RANDOMIZED_FIELDS if model.is_batched(f)})
    return m, data.map(lambda x: x[sel]), ctrl[sel]


def is_edge(model, data, ctrl, env: int, want: dict, n_substeps: int) -> bool:
    """True when `env` sits at an edge of the plain version over one control
    step: from its physics input perturbed at rounding scale (EDGE_COPIES
    copies, relative EDGE_SCALE; copy 0 unperturbed) the plain version's
    own result moves by at least the max gate, and one of the perturbed
    results lies within the max gates of `want` (JAX's qpos and qvel)."""
    m, d, c = _select(model, data, ctrl, env, EDGE_COPIES)
    gen = torch.Generator().manual_seed(env)

    def perturb(x):
        noise = torch.randn(x.shape, generator=gen)
        noise[0] = 0
        return x * (1 + EDGE_SCALE * noise)

    out = TF.step_reference(m, d.replace(qpos=perturb(d.qpos), qvel=perturb(d.qvel)), c, n_substeps)
    jump = np.zeros(EDGE_COPIES)
    err = np.zeros(EDGE_COPIES)
    for f, _, mx in GATES:
        x = getattr(out, f).double().numpy()
        jump = np.maximum(jump, np.abs(x - x[:1]).max(1) / mx)
        err = np.maximum(err, np.abs(x - np.asarray(want[f], np.float64)[None]).max(1) / mx)
    return bool(jump.max() >= 1 and err.min() < 1)


class P90:
    """Per-env errors of each gated field over a whole run: a p90 gate
    reads them all at the end (`check`), as test_megakernel_interpret.py
    reads its 128 envs, where a step's max gates apply at once."""

    def __init__(self):
        self.errs, self.gates = {}, {}

    def add(self, name: str, e: np.ndarray, p90: float):
        self.errs.setdefault(name, []).append(e)
        self.gates[name] = p90

    def check(self, label: str):
        for name, es in self.errs.items():
            e = np.concatenate(es)
            assert np.percentile(e, 90) < self.gates[name], (label, name, np.percentile(e, 90), e.size)

    def summary(self) -> dict:
        return {name: float(np.percentile(np.concatenate(es), 90)) for name, es in self.errs.items()}


def physics_edges(env, model, pre, post, draws, jpost, label, p90: P90) -> np.ndarray:
    """qpos and qvel of the port's step `post` against JAX's `jpost` (numpy
    State): every env under the max gates or certified by `is_edge`; the
    other envs' errors go to `p90`. Returns the bool mask of edge envs."""
    errs = {f: per_env_err(getattr(jpost.data, f), getattr(post.data, f).numpy()) for f, _, _ in GATES}
    over = np.any([errs[f] >= mx for f, _, mx in GATES], 0)
    for f, gate, _ in GATES:
        p90.add(f, errs[f][~over], gate)
    if over.any():
        data, ctrl = physics_input(env, pre, post, draws)
        for i in np.nonzero(over)[0]:
            want = {f: getattr(jpost.data, f)[i] for f, _, _ in GATES}
            assert is_edge(model, data, ctrl, int(i), want, env.n_substeps), (
                label, "env over the max gate and not at an edge of the plain version", int(i))
    return over


def assert_state_close(post, jpost, keep: np.ndarray, label: str, p90: P90, info_keys=(), info_tol=None):
    """Obs, reward, metrics, done, truncation and `info_keys` of the envs
    `keep` (numpy bool) against JAX's numpy State; the obs errors also go
    to `p90`. `info_tol` overrides INFO_CLOSE's tolerances."""
    tol = {**INFO_CLOSE, **(info_tol or {})}
    k = torch.as_tensor(keep)
    for name in jpost.obs:
        d = np.abs(np.asarray(jpost.obs[name][keep], np.float64) - post.obs[name][k].double().numpy())
        if not d.size:
            continue
        derived = set()
        for i, (cols, gate) in enumerate(DERIVED_OBS[name]):
            derived.update(cols)
            p90.add(f"{name} {cols[0]}:{cols[-1] + 1}", d[:, cols].max(-1), gate)
        rest = d[:, [c for c in range(d.shape[1]) if c not in derived]]
        e = rest.max(-1)
        p90.add(name, e, OBS_P90)
        assert e.max() < OBS_MAX, (label, name, e, rest.argmax(-1))
    # reward and reward terms: |port - JAX| / (1 + |JAX|), p90 over the run
    # at test_torch_envs.py's tolerance, each step's max at ten times it (the
    # ratio of the qvel gates, whose sensors the terms read)
    for name, got, want, rel in ([("reward", post.reward, jpost.reward, REWARD_REL)]
                                 + [(n, post.metrics[n], v, METRIC_REL) for n, v in jpost.metrics.items()]):
        want = np.asarray(want, np.float64)[keep]
        e = np.abs(got[k].double().numpy() - want) / (1 + np.abs(want))
        p90.add(name, e, rel)
        assert e.max() < 10 * rel, (label, name, e)
    np.testing.assert_array_equal(post.done[k].numpy(), np.asarray(jpost.done)[keep], err_msg=label)
    for name in info_keys:
        got, want = post.info[name][k].numpy(), np.asarray(jpost.info[name])[keep]
        if name in INFO_EXACT:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=tol[name], err_msg=f"{label} {name}")


# ----------------------------------------------------------------- the run
SHORT_PUSH_S = np.array([0.16], np.float32)  # env 1: a push every 8 steps
LEAN_STEPS = 60


def _actions(nu):
    """(STEPS, B, nu): for env 0's first LEAN_STEPS steps random actions
    with the legs' roll and pitch servos held to one side (it leans and
    falls), zero everywhere else."""
    rng = np.random.default_rng(3)
    a = np.zeros((STEPS, B, nu), np.float32)
    a[:LEAN_STEPS, 0] = rng.uniform(-1, 1, (LEAN_STEPS, nu))
    a[:LEAN_STEPS, 0, [1, 2, 6, 7]] = 1.0
    return a


@pytest.fixture(scope="module")
def run():
    key = jax.random.PRNGKey(11)
    jenv = JStanding(task="flat_terrain", dtype=jnp.float32)
    tenv = Standing("flat_terrain", device="cpu")
    dr_key, reset_key = jax.random.split(key)
    jte = JW.TrainingEnv(jenv, episode_length=EPISODE, randomization_fn=jax_dr, rng=dr_key, num_envs=B)
    tte = TrainingEnv(tenv, EPISODE, dr_draws=_dr_draws(jenv.model.spec, jax.random.split(dr_key, B)),
                      randomization_fn=domain_randomize)
    keys = jax.random.split(reset_key, B)
    jstate = jax.jit(jte.reset)(keys)
    steps = np.asarray(jstate.info["push_interval_steps"]).copy()
    steps[1:2] = np.round(SHORT_PUSH_S / tenv.dt).astype(np.int32)
    jstate = jstate.replace(info={**jstate.info, "push_interval_steps": jnp.asarray(steps)})
    draws, _ = reset_draws_fn(jenv)(keys)
    push = draws.push_interval.clone()
    push[1:2] = torch.as_tensor(SHORT_PUSH_S)
    tstate = tte.reset(dataclasses.replace(draws, push_interval=push))
    return dict(jenv=jenv, tenv=tenv, jte=jte, tte=tte, jstate=jstate, tstate=tstate)


def test_standing_held_against_jax_through_pushes_falls_resample_and_autoresets(run):
    jenv, tenv, tte = run["jenv"], run["tenv"], run["tte"]
    jstep = jax.jit(run["jte"].step)
    draws_fn = step_draws_fn(jenv)
    info_keys = INFO_EXACT + tuple(INFO_CLOSE)
    p90 = P90()
    assert_state_close(run["tstate"], to_numpy(run["jstate"]), np.ones(B, bool), "reset", p90, info_keys)

    actions = _actions(tenv.action_size)
    jstate = run["jstate"]
    jpost = to_numpy(jstate)
    counts = dict(push=0, fall=0, resample=0, autoreset=0, truncation=0, edges=0)
    for t in range(STEPS):
        jpre = jpost
        pre = state_from_jax(jpre, device="cpu")  # the shared state
        draws, _ = draws_fn(jstate.info["rng"])
        jstate = jstep(jstate, jnp.asarray(actions[t]))
        jpost = to_numpy(jstate)
        post = tte.step(pre, torch.as_tensor(actions[t]), draws)
        label = f"step {t}"
        edges = physics_edges(tenv, tte._model, pre, post, draws, jpost, label, p90)
        assert_state_close(post, jpost, ~edges, label, p90, info_keys)

        counts["edges"] += int(edges.sum())
        counts["push"] += int((np.abs(jpost.info["push"]).sum(-1) > 0).sum())
        fell = (jpost.done > 0) & (jpost.info["truncation"] == 0)
        counts["fall"] += int(fell.sum())
        counts["truncation"] += int((jpost.info["truncation"] > 0).sum())
        counts["autoreset"] += int((jpre.done > 0).sum())
        changed = np.abs(jpost.info["command"] - jpre.info["command"]).max(-1) > 0
        counts["resample"] += int((changed & (jpre.info["step"] >= 500)).sum())
    print("standing long run:", counts, "p90:", p90.summary())
    p90.check("over the run")
    assert counts["push"] > 0 and counts["fall"] > 0 and counts["resample"] > 0, counts
    assert counts["autoreset"] > counts["truncation"] > 0, counts  # falls reset too
    assert counts["edges"] <= B * STEPS // 50, counts  # each certified; at most 2% of env steps


# ------------------------------------------- the evaluation on both sides
def cross_eval(ckpt, num_envs: int, length: int, seed: int = 0):
    """A port checkpoint's policy (stochastic) in JAX's EvalEnv(Standing)
    and in the port's, each with its own random numbers, on this host's
    CPU. Returns {"jax": metrics, "port": metrics}, each with the mean
    episode reward, its standard error, the mean episode length and the
    share of episodes that ended in a fall."""
    from open_duck_playground_tpu.train import networks as JN, running_stats as JRS
    from open_duck_playground_torch.train import checkpoint as CKPT, ppo
    from open_duck_playground_torch.train.config import PPOConfig

    cfg = PPOConfig()
    tenv = Standing("flat_terrain", device="cpu")
    gen = torch.Generator().manual_seed(seed)
    probe = tenv.reset(tenv.reset_draws(gen, 2))
    ts = ppo.init_training_state(probe.obs, tenv.action_size, cfg, gen, device="cpu")
    ts, _ = CKPT.restore_training_state(ckpt, ts)

    def summary(em):
        r = np.asarray(em["episode_reward"], np.float64)
        n = np.asarray(em["episode_length"], np.float64)
        return {"episode_reward": float(r.mean()), "stderr": float(r.std() / math.sqrt(r.size)),
                "avg_episode_length": float(n.mean()), "fell": float((n < length).mean()),
                "envs": int(r.size)}

    t0 = time.time()
    ev = EvalEnv(tenv, cfg.episode_length)
    state = ev.reset(tenv.reset_draws(gen, num_envs))
    policy = ppo.make_policy((ts.normalizer, ts.net))
    with torch.no_grad():
        for _ in range(length):
            action, _ = policy(state.obs, torch.randn((num_envs, tenv.action_size), generator=gen))
            state = ev.step(state, action, ev.step_draws(gen, num_envs))
    port = summary({k: v.numpy() for k, v in state.info["eval_metrics"].items() if k != "episode_metrics"})
    port["seconds"] = time.time() - t0

    # the same weights in the JAX network, the JAX evaluator's loop
    jenv = JStanding(task="flat_terrain", dtype=jnp.float32)
    sd = ts.net.state_dict()

    def mlp(prefix, n):
        return {f"hidden_{i}": {"kernel": jnp.asarray(sd[f"{prefix}.layers.{i}.weight"].numpy().T),
                                "bias": jnp.asarray(sd[f"{prefix}.layers.{i}.bias"].numpy())}
                for i in range(n)}

    params = {"policy": mlp("policy", len(ts.net.policy.layers)),
              "value": mlp("value_mlp", len(ts.net.value_mlp.layers))}
    norm = JRS.RunningStats(
        count=jnp.asarray(ts.normalizer.count.numpy()),
        mean={k: jnp.asarray(v.numpy()) for k, v in ts.normalizer.mean.items()},
        summed_var={k: jnp.asarray(v.numpy()) for k, v in ts.normalizer.summed_var.items()},
        std={k: jnp.asarray(v.numpy()) for k, v in ts.normalizer.std.items()})
    obs_sizes = {k: int(v.shape[-1]) for k, v in probe.obs.items()}
    net = JN.PPONetworks(obs_sizes, jenv.action_size, cfg.policy_hidden_layer_sizes,
                         cfg.value_hidden_layer_sizes)
    jev = JW.EvalEnv(jenv, episode_length=cfg.episode_length)

    @jax.jit
    def run_jax(key):
        key, rkey = jax.random.split(key)
        s = jev.reset(jax.random.split(rkey, num_envs))

        def step(carry, _):
            s, k = carry
            k, ak = jax.random.split(k)
            logits = net.policy_logits(params, JRS.normalize(norm, s.obs))
            return (jev.step(s, JN.postprocess(JN.sample_raw(ak, logits))), k), None

        (s, _), _ = jax.lax.scan(step, (s, key), None, length=length)
        return s.info["eval_metrics"]

    t0 = time.time()
    em = run_jax(jax.random.PRNGKey(seed + 1000))
    jres = summary({k: np.asarray(v) for k, v in em.items() if k != "episode_metrics"})
    jres["seconds"] = time.time() - t0
    return {"jax": jres, "port": port}


def test_cross_eval_scores_one_policy_on_both_sides(tmp_path):
    """`cross_eval` at a toy size: a fresh checkpoint (random weights) in
    both evaluators; both run every env to the end or to a fall, with
    finite rewards of the same sign."""
    from open_duck_playground_torch.train import checkpoint as CKPT, ppo
    from open_duck_playground_torch.train.config import PPOConfig

    tenv = Standing("flat_terrain", device="cpu")
    gen = torch.Generator().manual_seed(0)
    probe = tenv.reset(tenv.reset_draws(gen, 2))
    ts = ppo.init_training_state(probe.obs, tenv.action_size, PPOConfig(), gen, device="cpu")
    CKPT.save_training_state(tmp_path / "ck", ts, gen.get_state())
    out = cross_eval(tmp_path / "ck", num_envs=4, length=6)
    for side in ("jax", "port"):
        r = out[side]
        assert r["envs"] == 4 and np.isfinite(r["episode_reward"]) and r["episode_reward"] > 0, out
        assert 1 <= r["avg_episode_length"] <= 6, out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--length", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    a = p.parse_args()
    torch.set_num_threads(a.threads)
    print(json.dumps(cross_eval(a.ckpt, a.envs, a.length, a.seed)))
    sys.exit(0)
