"""The standing task and the `flat_terrain` scene (the robot without backlash
joints on the plane) against the JAX package.

- The `scene_flat_terrain` snapshot equals the JAX loader's model, field
  for field (exact).
- The kernel body (csrc/megakernel.cuh) built by the host C++ compiler for
  that model, against `step_reference`, nominal and randomized, under the
  gates of test_torch_physics.py (qpos p90 1e-5 / max 1e-4, qvel p90 1e-3 /
  max 1e-2; derived fields at p90).
- `Standing("flat_terrain")` reset and two steps against the JAX env with
  its own draws injected, at test_torch_envs.py's tolerances; the reward
  terms are compared through the metrics that carry them.
- The standing reward terms (orientation, stand_still over the legs,
  head_pos gated and ungated) against the JAX functions; the ungated
  head_pos reaches the env through its config override.
- Obs sizes equal JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import duck_base as JD
from open_duck_playground_tpu.envs import rewards as JRW
from open_duck_playground_tpu.envs.standing import Standing as JStanding
from open_duck_playground_tpu.models import loader as JL

from open_duck_playground_torch.envs import rewards as TRW
from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.physics.types import Model

from test_torch_envs import (
    METRIC_REL, OBS_MAX, assert_obs_close, assert_reward_close, jax_reset_draws,
    jax_step_draws, per_env_err,
)
from test_torch_physics import _assert_gates, build_host_kernel, host_step

torch.set_num_threads(1)

SCENE = "scene_flat_terrain"
B = 8


# ------------------------------------------------------------ the scene
@pytest.fixture(scope="module")
def models32():
    jm, mj = JL.load_model(str(JD.XML_DIR / f"{SCENE}.xml"), timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(SCENE, device="cpu", dtype=torch.float32, timestep=0.002)
    return jm, tm, np.asarray(mj.keyframe("home").qpos), np.asarray(mj.keyframe("home").ctrl)


def test_flat_terrain_snapshot_equals_jax_loader(models32):
    jm, tm, _, _ = models32
    assert (tm.spec.nq, tm.spec.nv, tm.spec.nu, tm.spec.floor_is_hfield) == (21, 20, 14, False)
    for f in dataclasses.fields(Model):
        if f.name == "spec":
            continue
        want = np.asarray(getattr(jm, f.name))
        got = getattr(tm, f.name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    for f in dataclasses.fields(tm.spec):
        assert getattr(tm.spec, f.name) == getattr(jm.spec, f.name), f.name


@pytest.mark.parametrize("dr", [False, True], ids=["nominal", "randomized"])
def test_flat_terrain_kernel_arithmetic_matches_step_reference(models32, tmp_path_factory, dr):
    _, tm, kq, kc = models32
    lib = build_host_kernel(tm.spec, tmp_path_factory.mktemp("mk_flat"))
    batch = 64
    rng = np.random.default_rng(6)
    qpos = np.tile(kq, (batch, 1)) + 0.01 * rng.standard_normal((batch, kq.size))
    qvel = 0.1 * rng.standard_normal((batch, tm.spec.nv))
    ctrl = np.tile(kc, (batch, 1))
    qpos, qvel, ctrl = (torch.as_tensor(x, dtype=torch.float32) for x in (qpos, qvel, ctrl))
    m = domain_randomize(tm, DRDraws.sample(torch.Generator().manual_seed(5), batch, tm.spec)) if dr else tm
    d0 = TF.init(m, qpos, qvel, ctrl)
    assert MK.kernel_dims(tm.spec)["NROOT"] == 6  # the block-arrow partition, not the dense one
    got = host_step(lib, m, d0, ctrl, 10)
    _assert_gates(got, TF.step_reference(m, d0, ctrl, 10), "flat_terrain kernel arithmetic")


# ---------------------------------------------------------- the env
@pytest.fixture(scope="module")
def envs():
    jenv = JStanding(task="flat_terrain", dtype=jnp.float32)
    tenv = Standing("flat_terrain", device="cpu")
    return jenv, tenv, jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))


def test_standing_obs_sizes_equal_jax(envs):
    jenv, tenv, _, _ = envs
    gen = torch.Generator().manual_seed(0)
    state = tenv.reset(tenv.reset_draws(gen, 2))
    assert {k: (v.shape[-1],) for k, v in state.obs.items()} == dict(jenv.observation_size)
    assert tenv.action_size == jenv.action_size == 14


def test_standing_reset_and_steps_match_jax(envs):
    jenv, tenv, jreset, jstep = envs
    keys = jax.random.split(jax.random.PRNGKey(21), B)
    jstate = jreset(keys)
    tstate = tenv.reset(jax_reset_draws(jenv, keys))
    assert_obs_close(jstate.obs, tstate.obs)
    assert set(tstate.info) == set(jstate.info) - {"rng"}
    for k in tstate.info:
        assert tuple(tstate.info[k].shape) == np.shape(jstate.info[k]), k
        if tstate.info[k].numel():  # current_reference_motion is empty without imitation
            e = per_env_err(jstate.info[k], tstate.info[k].numpy())
            assert e.max() < OBS_MAX, (k, e)
    cmd = tstate.info["command"].numpy()
    assert (cmd[:, :3] == 0).all() and (np.abs(cmd[:, 5]) > 1.5).any()  # no locomotion, head yaw to 2.7

    rng = np.random.default_rng(4)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, tenv.action_size)).astype(np.float32)
        draws = jax_step_draws(jenv, jstate.info["rng"])
        jstate = jstep(jstate, jnp.asarray(action))
        tstate = tenv.step(tstate, torch.as_tensor(action), draws)
        assert_obs_close(jstate.obs, tstate.obs)
        assert_reward_close(jstate.reward, tstate.reward)
        np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
        assert set(tstate.metrics) == set(jstate.metrics)
        for k in jstate.metrics:
            np.testing.assert_allclose(tstate.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                       rtol=METRIC_REL, atol=METRIC_REL, err_msg=k)
    assert float(tstate.metrics["cost/head_pos"].abs().max()) == 0.0  # the gate never opens


def test_standing_rewards_match_jax():
    rng = np.random.default_rng(9)
    n = 16
    cmd = rng.uniform(-0.6, 0.6, (n, 7)).astype(np.float32)
    cmd[:8, :3] = 0.0  # the standing task's commands: no locomotion
    jq, jv, dp = rng.normal(0, 0.3, (3, n, 14)).astype(np.float32)
    up = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    T, J = torch.as_tensor, jnp.asarray
    cases = [
        (TRW.orientation(T(up)), jax.vmap(JRW.orientation)(J(up))),
        (TRW.stand_still(T(cmd), T(jq), T(jv), T(dp[0]), ignore_head=True),
         jax.vmap(lambda c, q, v: JRW.stand_still(c, q, v, J(dp[0]), ignore_head=True))(J(cmd), J(jq), J(jv))),
        (TRW.stand_still(T(cmd), T(jq), T(jv), T(dp[0])),
         jax.vmap(lambda c, q, v: JRW.stand_still(c, q, v, J(dp[0])))(J(cmd), J(jq), J(jv))),
    ]
    for ungated in (False, True):
        cases.append((TRW.head_pos(T(jq), T(jv), T(cmd), ungated=ungated),
                      jax.vmap(lambda q, v, c: JRW.head_pos(q, v, c, ungated=ungated))(J(jq), J(jv), J(cmd))))
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    gated = TRW.head_pos(T(jq), T(jv), T(cmd))
    assert (gated[:8] == 0).all() and (gated[8:] > 0).all()


def test_head_pos_ungated_override_reaches_the_env(envs):
    _, tenv, _, _ = envs
    ungated = Standing("flat_terrain", config_overrides={"head_pos_ungated": True}, device="cpu")
    assert ungated.config.head_pos_ungated and not tenv.config.head_pos_ungated
    gen = torch.Generator().manual_seed(3)
    draws = tenv.reset_draws(gen, B)
    step_draws = tenv.step_draws(gen, B)
    action = torch.zeros(B, tenv.action_size)
    got = ungated.step(ungated.reset(draws), action, step_draws)
    want = tenv.step(tenv.reset(draws), action, step_draws)
    jq = ungated.get_actuator_joints_qpos(got.data.qpos)
    # a cost's metric is the negated term
    want_cost = -TRW.head_pos(jq, None, got.info["command"], ungated=True)
    torch.testing.assert_close(got.metrics["cost/head_pos"], want_cost, rtol=0, atol=0)
    assert float(want_cost.max()) < 0 and float(want.metrics["cost/head_pos"].abs().max()) == 0
    assert float((want.reward - got.reward).min()) >= 0  # the ungated cost only subtracts
