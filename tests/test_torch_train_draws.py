"""The joint structure of the random numbers on the port's own training path.

Every parity test hands the port the numbers JAX drew, and
`test_torch_draws.py` holds each sampler's marginal law against JAX's. Here
the port's `ppo.train` runs un-injected, as the CLI runs it, on
`Standing("flat_terrain")` with domain randomization at toy width, and every
draw it makes is recorded by wrapping the functions that make them (the
originals are called through): `ppo.unroll_draws`, `ppo.sgd_draws`,
`DRDraws.sample`, the env's `reset_draws` / `step_draws`, and the
evaluator's reset and step draws and action noise (`run_eval` through
`make_policy`). A generator misused there (reseeded per step, one row
broadcast over the envs, the evaluator drawing from the trainer's stream)
would pass every parity test and still change training. Asserted:

- within each draw no two envs share a row of any float field, and no two
  steps of any unroll, no two training steps, no two evals share one: rows
  of fields with several columns are distinct over the whole run (all-zero
  commands, drawn with probability 0.1, are left out); a field with one
  value per env has distinct values within each draw and differs as a
  vector between draws;
- the SGD permutations differ across epochs and training steps, and the
  entropy noise across minibatches, epochs and training steps;
- the DR draws are made once per run, differ across envs, and the model
  built from them stays unchanged and is the one every training env step
  runs on;
- the two evals draw different numbers, none of them the trainer's, and
  the training stream with evals in between equals the one without (the
  same draws, the same parameters bit for bit);
- the sample correlation between any two envs' action noise over the run
  stays within 5 / sqrt(n), n the noise values per env.
"""

import dataclasses
import math
from unittest import mock

import pytest
import torch

from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig

torch.set_num_threads(1)

E, T, BATCH, NMB, EPOCHS, HIDDEN, EPISODE, EVAL_ENVS, STEPS = 16, 8, 8, 2, 2, (16, 16), 12, 8, 3
CORR_Z = 5.0


def _cfg(num_evals: int) -> PPOConfig:
    return PPOConfig(num_envs=E, batch_size=BATCH, num_minibatches=NMB, unroll_length=T,
                     num_updates_per_batch=EPOCHS, episode_length=EPISODE,
                     num_eval_envs=EVAL_ENVS, num_evals=num_evals, seed=0,
                     policy_hidden_layer_sizes=HIDDEN, value_hidden_layer_sizes=HIDDEN)


def _tensors(model):
    return [(f.name, getattr(model, f.name)) for f in dataclasses.fields(model)
            if isinstance(getattr(model, f.name), torch.Tensor)]


def _recorded(fn, sink):
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.append(out)
        return out

    return wrapper


def _train(with_evals: bool) -> dict:
    """The port's `ppo.train` with every draw recorded."""
    rec = {k: [] for k in ("unroll", "sgd", "dr", "reset", "step", "eval_reset", "eval_step",
                           "eval_noise", "models", "step_models")}
    env = Standing(task="flat_terrain", device="cpu")
    eval_env = Standing(task="flat_terrain", device="cpu") if with_evals else None
    env.reset_draws = _recorded(env.reset_draws, rec["reset"])
    env.step_draws = _recorded(env.step_draws, rec["step"])
    env_step = env.step

    def step(state, action, draws, model=None):
        rec["step_models"].append(model)
        return env_step(state, action, draws, model=model)

    env.step = step
    if eval_env is not None:
        eval_env.reset_draws = _recorded(eval_env.reset_draws, rec["eval_reset"])
        eval_env.step_draws = _recorded(eval_env.step_draws, rec["eval_step"])

    def randomize(model, draws):
        out = domain_randomize(model, draws)
        rec["models"].append((out, {k: v.clone() for k, v in _tensors(out)}))
        return out

    make_policy = ppo.make_policy

    def recording_make_policy(variables, deterministic=False):
        policy = make_policy(variables, deterministic)

        def recorded(obs, noise=None):
            rec["eval_noise"].append(noise)
            return policy(obs, noise)

        return recorded

    sample = DRDraws.sample
    cfg = _cfg(2 if with_evals else 1)
    with mock.patch.object(ppo, "unroll_draws", _recorded(ppo.unroll_draws, rec["unroll"])), \
            mock.patch.object(ppo, "sgd_draws", _recorded(ppo.sgd_draws, rec["sgd"])), \
            mock.patch.object(DRDraws, "sample", classmethod(
                lambda cls, *a, **k: _recorded(sample, rec["dr"])(*a, **k))), \
            mock.patch.object(ppo, "make_policy", recording_make_policy):
        _, (normalizer, net), _ = ppo.train(
            env, num_timesteps=STEPS * cfg.steps_per_training_step, config=cfg, device="cpu",
            randomization_fn=randomize, eval_env=eval_env, max_env_steps_per_jit=None)
    rec["params"] = [p.detach().clone() for p in net.parameters()]
    rec["normalizer"] = normalizer
    return rec


@pytest.fixture(scope="module")
def runs():
    return {"evals": _train(True), "no_evals": _train(False)}


# ------------------------------------------------------------------ helpers
def float_fields(draw, prefix=""):
    """(name, tensor) of every float tensor of a draw dataclass, nested
    dataclasses included."""
    for f in dataclasses.fields(draw):
        v = getattr(draw, f.name)
        if dataclasses.is_dataclass(v):
            yield from float_fields(v, prefix + f.name + ".")
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            yield prefix + f.name, v


def by_field(draws):
    out = {}
    for d in draws:
        for name, v in float_fields(d):
            out.setdefault(name, []).append(v)
    return out


def assert_distinct_rows(rows: torch.Tensor, what: str) -> None:
    n = torch.unique(rows, dim=0).shape[0]
    assert n == rows.shape[0], f"{what}: {rows.shape[0] - n} repeated rows of {rows.shape[0]}"


def assert_field_fresh(name: str, values, drop_zero_rows: bool = False) -> None:
    """`values`: one tensor (envs, ...) per draw of the field."""
    if values[0].dim() == 1:
        for i, v in enumerate(values):
            assert_distinct_rows(v[:, None], f"{name}, draw {i}")
        if len(values) > 1:
            assert_distinct_rows(torch.stack(values), f"{name} across draws")
        return
    rows = torch.cat([v.reshape(-1, v.shape[-1]) for v in values])
    if drop_zero_rows:
        rows = rows[rows.abs().amax(-1) > 0]
    assert_distinct_rows(rows, name)


def assert_draws_fresh(draws) -> None:
    for name, values in by_field(draws).items():
        assert_field_fresh(name, values, drop_zero_rows=name.endswith("command"))


def all_rows(draws):
    """Every row of every float field with several columns, per field name."""
    return {name: torch.cat([v.reshape(-1, v.shape[-1]) for v in values])
            for name, values in by_field(draws).items() if values[0].dim() > 1}


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("kind", ["reset", "step", "dr"])
def test_env_draws_share_no_row(runs, kind):
    """Reset, step (every step of every unroll, over the three training
    steps) and DR draws: no two envs, steps or training steps share a row."""
    draws = runs["evals"][kind]
    assert draws, kind
    want = {"reset": 1, "step": STEPS * T, "dr": 1}[kind]
    assert len(draws) == want
    assert_draws_fresh(draws)
    if kind == "step":
        # the unroll hands the env exactly the draws its step_draws made
        unroll_env = [d for u in runs["evals"]["unroll"] for d in u.env]
        assert len(unroll_env) == len(draws) and all(a is b for a, b in zip(unroll_env, draws))


def test_action_noise_is_fresh_and_uncorrelated_between_envs(runs):
    unrolls = runs["evals"]["unroll"]
    assert len(unrolls) == STEPS
    noise = torch.cat([u.action_noise for u in unrolls])  # (STEPS * T, E, A)
    assert noise.shape[:2] == (STEPS * T, E)
    assert_distinct_rows(noise.reshape(-1, noise.shape[-1]), "action noise")
    per_env = noise.transpose(0, 1).reshape(E, -1).double()
    n = per_env.shape[1]
    corr = torch.corrcoef(per_env)
    off = corr[~torch.eye(E, dtype=torch.bool)].abs()
    assert float(off.max()) <= CORR_Z / math.sqrt(n), (float(off.max()), n)


def test_sgd_draws_differ_across_epochs_minibatches_and_steps(runs):
    sgd = runs["evals"]["sgd"]
    assert len(sgd) == STEPS
    perms = torch.cat([s.perms for s in sgd])  # (STEPS * EPOCHS, E)
    assert perms.shape == (STEPS * EPOCHS, E)
    assert all(torch.equal(p.sort().values, torch.arange(E)) for p in perms)
    assert_distinct_rows(perms, "permutations")
    noise = torch.stack([s.entropy_noise for s in sgd])  # (STEPS, EPOCHS, NMB, T, BATCH, A)
    assert noise.shape[:5] == (STEPS, EPOCHS, NMB, T, BATCH)
    assert_distinct_rows(noise.reshape(-1, noise.shape[-1]), "entropy noise")
    # and per minibatch as a whole: none repeats another's block
    blocks = noise.reshape(STEPS * EPOCHS * NMB, -1)
    assert_distinct_rows(blocks, "entropy noise per minibatch")


def test_dr_draws_once_per_run_fixed_and_per_env(runs):
    rec = runs["evals"]
    assert len(rec["dr"]) == 1 and len(rec["models"]) == 1
    (dr,) = rec["dr"]
    for name, v in float_fields(dr):
        assert v.shape[0] == E, name
    model, at_build = rec["models"][0]
    # every training env step runs on that model, which nothing changed
    assert len(rec["step_models"]) == STEPS * T
    assert all(m is model for m in rec["step_models"])
    assert len(at_build) > 8
    for name, v in _tensors(model):
        assert torch.equal(v, at_build[name]), name
    # per env: the randomized fields differ between envs
    for name in ("geom_friction", "body_mass", "qpos0", "actuator_gainprm", "dof_armature"):
        v = getattr(model, name)
        assert_distinct_rows(v.reshape(E, -1), name)


def test_evals_draw_fresh_numbers(runs):
    rec = runs["evals"]
    length = EPISODE
    assert len(rec["eval_reset"]) == 2 and len(rec["eval_step"]) == 2 * length
    assert len(rec["eval_noise"]) == 2 * length
    assert all(n is not None and n.shape[0] == EVAL_ENVS for n in rec["eval_noise"])
    assert_draws_fresh(rec["eval_reset"])
    assert_draws_fresh(rec["eval_step"])
    assert_distinct_rows(torch.cat(rec["eval_noise"]), "eval action noise")
    # the evaluator's generator is its own: no row of the trainer's
    train = all_rows(rec["reset"] + rec["step"])
    for name, rows in all_rows(rec["eval_reset"] + rec["eval_step"]).items():
        joint = torch.cat([train[name], rows])
        if name.endswith("command"):
            joint = joint[joint.abs().amax(-1) > 0]
        assert_distinct_rows(joint, f"{name}, eval against training")
    train_noise = torch.cat([u.action_noise for u in rec["unroll"]])
    assert_distinct_rows(torch.cat([train_noise.reshape(-1, train_noise.shape[-1]),
                                    torch.cat(rec["eval_noise"])]), "eval against training noise")


def test_training_stream_is_independent_of_the_evals(runs):
    a, b = runs["evals"], runs["no_evals"]
    assert not b["eval_reset"] and not b["eval_noise"]
    for kind in ("reset", "step", "dr"):
        assert len(a[kind]) == len(b[kind])
        for da, db in zip(a[kind], b[kind]):
            for (name, va), (_, vb) in zip(float_fields(da), float_fields(db)):
                assert torch.equal(va, vb), (kind, name)
    for ua, ub in zip(a["unroll"], b["unroll"], strict=True):
        assert torch.equal(ua.action_noise, ub.action_noise)
    for sa, sb in zip(a["sgd"], b["sgd"], strict=True):
        assert torch.equal(sa.perms, sb.perms) and torch.equal(sa.entropy_noise, sb.entropy_noise)
    for pa, pb in zip(a["params"], b["params"], strict=True):
        assert torch.equal(pa, pb)
    assert torch.equal(a["normalizer"].mean["state"], b["normalizer"].mean["state"])
