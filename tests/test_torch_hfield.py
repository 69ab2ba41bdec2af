"""The port's heightfield path (the rough-terrain scenes) against the JAX
package.

- The snapshot of each rough scene equals the JAX loader field for field.
- f64: `_hfield_height_normal` and `collide` equal the JAX functions within
  1e-9 relative at points over the whole field, outside it (the clip) and on
  cell diagonals.
- f32: `step_reference` on `scene_rough_terrain_backlash` against JAX
  `F.step(use_megakernel=False)`, 64 envs spread over +-3 m, per control
  step from a shared state, under the gates of test_megakernel_interpret.py
  (qpos p90 1e-5 / max 1e-4, qvel p90 1e-3 / max 1e-2; derived fields at
  p90: sensordata 5e-2, site_xpos 1e-4, actuator_force 1e-2).
- The kernel body (csrc/megakernel.cuh, -DMK_HFIELD=1) built by the host C++
  compiler against `step_reference`: same gates, nominal and randomized, and
  per substep along its own trajectory.
- `Joystick("rough_terrain_backlash")` reset + 1 step against the JAX env
  with its own draws injected (tolerances of test_torch_envs.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_duck_playground_tpu.envs import duck_base as JD
from open_duck_playground_tpu.envs.joystick import Joystick as JJoystick
from open_duck_playground_tpu.models import loader as JL
from open_duck_playground_tpu.physics import collision as JC
from open_duck_playground_tpu.physics import forward as JF
from open_duck_playground_tpu.physics import kinematics as JK

from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import collision as TC
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics import kinematics as TK
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.physics.types import Model

from test_torch_envs import (
    assert_obs_close, assert_reward_close, jax_reset_draws, jax_step_draws,
)
from test_torch_physics import GATES, _assert_gates, _per_env, build_host_kernel, host_step

torch.set_num_threads(1)

SCENE = "scene_rough_terrain_backlash"
ROUGH_SCENES = ("scene_rough_terrain_backlash", "scene_rough_terrain")


def _xml(scene):
    return str(JD.XML_DIR / f"{scene}.xml")


def _inputs(seed, batch, dtype, key_qpos, key_ctrl, nv, lift, ctrl_noise=0.05):
    """States near the home keyframe (qpos 0.01, qvel 0.1 normal), the base
    spread uniformly over +-3 m in x and y, `lift` added to its height."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(key_qpos, (batch, 1)) + 0.01 * rng.standard_normal((batch, key_qpos.size))
    qpos[:, :2] += rng.uniform(-3.0, 3.0, (batch, 2))
    qpos[:, 2] += lift
    qvel = 0.1 * rng.standard_normal((batch, nv))
    ctrl = np.tile(key_ctrl, (batch, 1)) + ctrl_noise * rng.standard_normal((batch, key_ctrl.size))
    return [x.astype(dtype) for x in (qpos, qvel, ctrl)]


@pytest.fixture(scope="module")
def models32():
    jm, mj = JL.load_model(_xml(SCENE), timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(SCENE, device="cpu", dtype=torch.float32, timestep=0.002)
    return jm, tm, np.asarray(mj.keyframe("home").qpos), np.asarray(mj.keyframe("home").ctrl)


@pytest.fixture(scope="module")
def models64():
    jm, mj = JL.load_model(_xml(SCENE), timestep=0.002, dtype=jnp.float64)
    tm = TL.load_model(SCENE, device="cpu", dtype=torch.float64, timestep=0.002)
    return jm, tm, np.asarray(mj.keyframe("home").qpos), np.asarray(mj.keyframe("home").ctrl)


@pytest.mark.parametrize("scene", ROUGH_SCENES)
def test_rough_snapshot_equals_jax_loader(scene):
    jm, _ = JL.load_model(_xml(scene), timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(scene, device="cpu", dtype=torch.float32, timestep=0.002)
    assert tm.spec.floor_is_hfield and tm.hfield_data.shape == (256, 256)
    for f in dataclasses.fields(Model):
        if f.name == "spec":
            continue
        want = np.asarray(getattr(jm, f.name))
        got = getattr(tm, f.name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    for f in dataclasses.fields(tm.spec):
        assert getattr(tm.spec, f.name) == getattr(jm.spec, f.name), f.name


def test_hfield_height_normal_matches_jax_f64(models64):
    """Exact (1e-9 relative) in f64: random points over the field, points
    outside it (both sides, the clip), grid nodes, and points on the cell
    diagonal u + v = 1 (both triangles meet there: `<=` takes the lower).
    The JAX function runs op by op, not jitted: on a point that sits exactly
    on an edge XLA's fused code rounds the cell coordinate differently in
    the last bit and takes the other triangle (36 of 1000 such points)."""
    jm, tm, _, _ = models64
    rng = np.random.default_rng(0)
    sx, sy = float(tm.hfield_size[0]), float(tm.hfield_size[1])
    n = tm.spec.hfield_ncol
    dx, dy = 2 * sx / (n - 1), 2 * sy / (tm.spec.hfield_nrow - 1)
    inside = rng.uniform(-1, 1, (4000, 2)) * [sx, sy]
    outside = rng.uniform(-1.3, 1.3, (500, 2)) * [sx, sy]
    ij = rng.integers(0, n - 1, (500, 2))
    nodes = ij * [dx, dy] - [sx, sy]
    u = rng.uniform(0, 1, 500)
    diag = (ij + np.stack([u, 1 - u], 1)) * [dx, dy] - [sx, sy]
    pts = np.concatenate([inside, outside, nodes, diag, [[sx, sy], [-sx, -sy], [sx, -sy]]])
    h_w, n_w = JC._hfield_height_normal(jm, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    h_g, n_g = TC._hfield_height_normal(tm, torch.as_tensor(pts[:, 0]), torch.as_tensor(pts[:, 1]))
    assert np.ptp(np.asarray(h_w)) > 0.005 and np.abs(np.asarray(n_w)[:, :2]).max() > 0.05
    np.testing.assert_allclose(h_g.numpy(), np.asarray(h_w), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(n_g.numpy(), np.asarray(n_w), rtol=1e-9, atol=1e-12)


def test_hfield_collide_matches_jax_f64(models64):
    jm, tm, kq, kc = models64
    B = 32
    qpos, _, _ = _inputs(1, B, np.float64, kq, kc, tm.spec.nv, lift=0.0)
    qpos[:4, :2] = [[9.99, 0], [-12, 3], [0, 10.5], [-9.995, -9.995]]  # border and beyond

    def contacts(q):
        xpos, xquat = JK.kinematics(jm, q)[:2]
        c = JC.collide(jm, xpos, xquat)
        return c.dist, c.pos, c.frame, c.friction, c.solref, c.solimp

    want = jax.jit(jax.vmap(contacts))(qpos)
    xpos, xquat = TK.kinematics(tm.expand_batch(B), torch.as_tensor(qpos))[:2]
    c = TC.collide(tm.expand_batch(B), xpos, xquat)
    got = (c.dist, c.pos, c.frame, c.friction, c.solref, c.solimp)
    assert (c.dist < 0).any() and (c.frame[:, :, 0, 2] < 1 - 1e-6).any()  # penetrating, tilted
    for g, w, name in zip(got, want, ("dist", "pos", "frame", "friction", "solref", "solimp")):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() < 1e-9 * max(np.abs(w).max(), 1.0), name


def test_hfield_step_reference_matches_jax_f32(models32):
    jm, tm, kq, kc = models32
    B = 64
    qpos, qvel, ctrl = _inputs(2, B, np.float32, kq, kc, tm.spec.nv, lift=0.0)
    d0 = jax.jit(jax.vmap(lambda q, v, c: JF.init(jm, q, v, c)))(qpos, qvel, ctrl)
    want = jax.jit(jax.vmap(lambda d, c: JF.step(jm, d, c, 10, use_megakernel=False)))(d0, ctrl)
    tq, tv, tc = (torch.as_tensor(x) for x in (qpos, qvel, ctrl))
    t0 = TF.init(tm, tq, tv, tc)
    assert (t0.contact_dist < 0).any()
    np.testing.assert_allclose(t0.contact_dist.numpy(), np.asarray(d0.contact_dist), atol=1e-6)
    got = TF.step_reference(tm, t0, tc, 10)
    _assert_gates(got, want, "heightfield step_reference vs JAX")


# ------------------------------------------------- the kernel body, host build
@pytest.fixture(scope="module")
def host_kernel(models32, tmp_path_factory):
    """csrc/megakernel.cuh with MK_HFIELD=1, compiled by the host C++ compiler."""
    _, tm, _, _ = models32
    assert MK.kernel_dims(tm.spec)["HFIELD"] == 1
    return build_host_kernel(tm.spec, tmp_path_factory.mktemp("mkh"))


def _host_step(lib, m, d, ctrl, n):
    assert len(sum(MK.kernel_tensors(m, d, ctrl, n), [])) == 24  # the height table is the 15th input
    return host_step(lib, m, d, ctrl, n)


@pytest.mark.parametrize("dr", [False, True], ids=["nominal", "randomized"])
def test_hfield_kernel_arithmetic_matches_step_reference(models32, host_kernel, dr):
    _, tm, kq, kc = models32
    batch = 64
    m = domain_randomize(tm, DRDraws.sample(torch.Generator().manual_seed(5), batch, tm.spec)) if dr else tm
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in
                        _inputs(6, batch, np.float32, kq, kc, tm.spec.nv, lift=0.0, ctrl_noise=0.0))
    d0 = TF.init(m, qpos, qvel, ctrl)
    got = _host_step(host_kernel, m, d0, ctrl, 10)
    want = TF.step_reference(m, d0, ctrl, 10)
    _assert_gates(got, want, "heightfield kernel arithmetic vs step_reference")
    np.testing.assert_array_equal(got.qacc_warmstart.numpy(), got.qacc.numpy())
    assert (got.contact_dist < 0).any()


def test_hfield_kernel_arithmetic_matches_every_substep(models32, host_kernel):
    """Substep by substep along the kernel's own trajectory every env stays
    within the max gates of the plain version, contact distances within
    1e-6, with contacts active on tilted triangles."""
    _, tm, kq, kc = models32
    batch = 64
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in
                        _inputs(0, batch, np.float32, kq, kc, tm.spec.nv, lift=0.0))
    d = TF.init(tm, qpos, qvel, ctrl)
    touching = 0
    for _ in range(10):
        got = _host_step(host_kernel, tm, d, ctrl, 1)
        want = TF.step_reference(tm, d, ctrl, 1)
        for f, _, mx in GATES:
            e = _per_env(getattr(got, f), getattr(want, f))
            assert e.max() < mx, (f, e.max())
        assert _per_env(got.contact_dist, want.contact_dist).max() < 1e-6
        touching += int((got.contact_dist < 0).any(1).sum())
        d = got
    assert touching > batch


def test_hfield_kernel_survives_nan_state(models32, host_kernel):
    """A blown-up env (NaN base position) reads cell 0 of the table, stays
    NaN for the quarantine, and leaves its neighbours untouched."""
    _, tm, kq, kc = models32
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in _inputs(3, 4, np.float32, kq, kc, tm.spec.nv, lift=0.0))
    d0 = TF.init(tm, qpos, qvel, ctrl)
    bad = d0.replace(qpos=d0.qpos.clone())
    bad.qpos[1, :3] = float("nan")
    got, ref = _host_step(host_kernel, tm, bad, ctrl, 2), _host_step(host_kernel, tm, d0, ctrl, 2)
    plain = TF.step_reference(tm, bad, ctrl, 2)
    assert torch.isnan(got.qpos[1]).any() and torch.isnan(plain.qpos[1]).any()
    keep = [0, 2, 3]
    assert torch.equal(got.qpos[keep], ref.qpos[keep])


# ----------------------------------------------------------------- the env
def test_rough_joystick_reset_and_step_match_jax():
    B = 8
    jenv = JJoystick(task="rough_terrain_backlash", dtype=jnp.float32)
    tenv = Joystick(task="rough_terrain_backlash", device="cpu")
    np.testing.assert_array_equal(tenv._init_q.numpy(), np.asarray(jenv._init_q))
    assert float(tenv._init_q[2] - tenv.model.key_qpos[2]) == pytest.approx(0.012, abs=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(21), B)
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate = tenv.reset(jax_reset_draws(jenv, keys))
    assert_obs_close(jstate.obs, tstate.obs)
    action = np.random.default_rng(4).uniform(-1, 1, (B, tenv.action_size)).astype(np.float32)
    draws = jax_step_draws(jenv, jstate.info["rng"])
    jstate = jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(action))
    tstate = tenv.step(tstate, torch.as_tensor(action), draws)
    assert_obs_close(jstate.obs, tstate.obs)
    assert_reward_close(jstate.reward, tstate.reward)
    np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))


def test_rough_terrain_without_backlash_constructs_and_steps():
    env = Joystick(task="rough_terrain", device="cpu")
    assert env.model.spec.floor_is_hfield and env.backlash_joint_names == []
    gen = torch.Generator().manual_seed(0)
    from open_duck_playground_torch.envs.joystick import ResetDraws, StepDraws

    state = env.reset(ResetDraws.sample(gen, 4, env))
    state = env.step(state, torch.zeros(4, env.action_size), StepDraws.sample(gen, 4, env))
    assert all(torch.isfinite(v).all() for v in state.obs.values()) and torch.isfinite(state.reward).all()
