"""The robot without its head (`flat_terrain_no_head`: nq 17, nv 16, nu 10,
legs only) against the JAX package.

- The `scene_flat_terrain_no_head` snapshot equals the JAX loader's model,
  field for field (exact).
- Its kernel partition: root 6 and two leg chains of 5 dofs, a foot on each
  (the block-arrow form, not the degenerate one), the `-D` constants read
  from the model, and the block-arrow solve on its mass matrix against a
  dense solve in f64 (1e-10 relative).
- The kernel body (csrc/megakernel.cuh) built by the host C++ compiler for
  these constants, against `step_reference` over 10 substeps (qpos p90 1e-5
  / max 1e-4, qvel p90 1e-3 / max 1e-2; derived fields at p90) and substep
  by substep along its own trajectory, every env within the max gates or
  certified as an edge of the plain version.
- The f32 plain step (`step_reference`) against JAX `F.step` under the same
  gates.
- `Joystick("flat_terrain_no_head")` reset and two steps against the JAX env
  with its own draws injected, on reset seeds 11 and 13-16 (8 envs each):
  obs p90 1e-3 / max 1e-2, reward relative 2.2e-4, metrics 1e-3
  (test_torch_envs.py's tolerances); no head metric. One entry has its own
  rule, the reset's accelerometer x (obs dim 3): measured on the CPU, its
  error reaches p90 5.4e-4 to 2.4e-3 (max 2.9e-3) where every other entry
  stays under 7.3e-4, and after a step the obs p90 is 7e-5 to 3e-4. That
  reading is the first contact solve's acceleration, ~10 m/s^2 out of
  forces that cancel, and f32 rounding alone moves it: perturbed at 1e-6
  relative (256 copies of each env's `forward.init` input, as
  `plain_jump` perturbs), and equally at 1e-7, the plain version's own
  reading spreads over 6e-5 to 9e-3. So at the reset dim 3 is held per env
  to the max gate and certified as an edge: the plain version's spread
  reaches JAX's error, and one perturbed copy lies within 1e-4 of JAX's
  reading (measured: within 3.8e-5).
- A JAX no-head State carried into the port (`interop.state_from_jax`)
  steps on like the JAX env.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import duck_base as JD
from open_duck_playground_tpu.envs import imitation as JI
from open_duck_playground_tpu.envs.joystick import Joystick as JJoystick
from open_duck_playground_tpu.models import loader as JL
from open_duck_playground_tpu.physics import forward as JF

from open_duck_playground_torch.envs import imitation as TI
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.interop import state_from_jax
from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics import kinematics as TK
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.physics import smooth as TS
from open_duck_playground_torch.physics.types import Model

from test_torch_envs import (
    METRIC_REL, OBS_MAX, assert_obs_close, assert_reward_close, jax_reset_draws, jax_step_draws,
    per_env_err,
)
from test_torch_physics import _assert_gates, assert_substep_gates, build_host_kernel, host_step

torch.set_num_threads(1)

SCENE = "scene_flat_terrain_no_head"
TASK = "flat_terrain_no_head"
B = 8


@pytest.fixture(scope="module")
def models32():
    jm, mj = JL.load_model(str(JD.XML_DIR / f"{SCENE}.xml"), timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(SCENE, device="cpu", dtype=torch.float32, timestep=0.002)
    return jm, tm, np.asarray(mj.keyframe("home").qpos), np.asarray(mj.keyframe("home").ctrl)


def _start(tm, kq, kc, seed, batch, sink=0.0):
    """States near the home keyframe (qpos 0.01, qvel 0.1 normal), the base
    lowered by `sink` (feet into the floor)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(kq, (batch, 1)) + 0.01 * rng.standard_normal((batch, kq.size))
    qpos[:, 2] -= sink
    qvel = 0.1 * rng.standard_normal((batch, tm.spec.nv))
    ctrl = np.tile(kc, (batch, 1))
    return (torch.as_tensor(x, dtype=torch.float32) for x in (qpos, qvel, ctrl))


# ------------------------------------------------------------ the scene
def test_no_head_snapshot_equals_jax_loader(models32):
    jm, tm, _, _ = models32
    s = tm.spec
    assert (s.nq, s.nv, s.nu, s.nbody, s.njnt, s.floor_is_hfield) == (17, 16, 10, 14, 11, False)
    for f in dataclasses.fields(Model):
        if f.name == "spec":
            continue
        want = np.asarray(getattr(jm, f.name))
        got = getattr(tm, f.name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    for f in dataclasses.fields(s):
        assert getattr(s, f.name) == getattr(jm.spec, f.name), f.name


def test_no_head_partition_tables(models32):
    _, tm, kq, _ = models32
    s = tm.spec
    part = MK.partition(s)
    assert part == MK.Partition(root=6, chains=((6, 11), (11, 16)), foot_chain=(0, 1))
    dims = MK.kernel_dims(s)
    assert {k: dims[k] for k in ("NQ", "NV", "NU", "NBODY", "NROOT", "NCHAIN", "MAXCHAIN")} == dict(
        NQ=17, NV=16, NU=10, NBODY=14, NROOT=6, NCHAIN=2, MAXCHAIN=5)
    # the rest read from the model: one friction row per actuated dof, a
    # limit row per limited hinge, the stored lower block-arrow entries
    rowoff, shift, entries = part.row_offsets(s.nv)
    assert (dims["NFRIC"], dims["NLIM"], dims["NBA"]) == (len(s.friction_dofs), 10, len(entries))
    assert len(entries) == 21 + 2 * (6 * 5 + 15)
    tables = MK.model_tables(tm)
    assert tables["chain_start"].tolist() == [6, 11] and tables["foot_chain"].tolist() == [0, 1]
    # no fill-in: the block-arrow solve on the robot's mass matrix (f64)
    # equals a dense solve, its entries between the legs being zero
    tm64 = TL.load_model(SCENE, device="cpu", dtype=torch.float64, timestep=0.002)
    rng = np.random.default_rng(1)
    q = torch.as_tensor(np.tile(kq, (4, 1)) + 0.05 * rng.standard_normal((4, kq.size)))
    m = tm64.expand_batch(4)
    xpos, xquat, xanchor, xaxis, xipos, ximat, _, _ = TK.kinematics(m, q)
    com, cdof = TK.com_cdof(m, xquat, xanchor, xaxis, xipos)
    M = TS.mass_matrix(m, cdof, xipos, ximat, com) + torch.diag(tm64.dof_armature)
    assert float(M[:, 6:11, 11:16].abs().max()) == 0.0
    b = torch.as_tensor(rng.standard_normal((4, s.nv)))
    want = torch.linalg.solve(M, b[..., None])[..., 0]
    got = MK.block_arrow_solve(M, b, part)
    assert float((got - want).abs().max()) < 1e-10 * float(want.abs().max())


@pytest.fixture(scope="module")
def host_kernel(models32, tmp_path_factory):
    return build_host_kernel(models32[1].spec, tmp_path_factory.mktemp("mk_no_head"))


@pytest.mark.parametrize("dr", [False, True], ids=["nominal", "randomized"])
def test_no_head_kernel_arithmetic_matches_step_reference(models32, host_kernel, dr):
    _, tm, kq, kc = models32
    batch = 64
    qpos, qvel, ctrl = _start(tm, kq, kc, 6, batch)
    m = domain_randomize(tm, DRDraws.sample(torch.Generator().manual_seed(5), batch, tm.spec)) if dr else tm
    d0 = TF.init(m, qpos, qvel, ctrl)
    got = host_step(host_kernel, m, d0, ctrl, 10)
    _assert_gates(got, TF.step_reference(m, d0, ctrl, 10), "no-head kernel arithmetic")
    np.testing.assert_array_equal(got.qacc_warmstart.numpy(), got.qacc.numpy())


def test_no_head_kernel_arithmetic_every_substep(models32, host_kernel):
    """Substep by substep along the kernel's own trajectory, feet in the
    floor (every contact row in play), randomized: every env within the max
    gates or certified as an edge of the plain version; and the one
    10-substep call gives that trajectory bit for bit."""
    _, tm, kq, kc = models32
    batch = 64
    qpos, qvel, ctrl = _start(tm, kq, kc, 2, batch, sink=0.01)
    m = domain_randomize(tm, DRDraws.sample(torch.Generator().manual_seed(7), batch, tm.spec))
    d0 = d = TF.init(m, qpos, qvel, ctrl)
    edges = 0
    for _ in range(10):
        got = host_step(host_kernel, m, d, ctrl, 1)
        edges += assert_substep_gates(m, d, ctrl, got, TF.step_reference(m, d, ctrl, 1), "no-head")
        d = got
    assert edges <= 2  # of 640 env-substeps
    assert (d.contact_dist < 0).any(1).sum() > batch // 2
    ten = host_step(host_kernel, m, d0, ctrl, 10)
    assert torch.equal(ten.qpos, d.qpos) and torch.equal(ten.qvel, d.qvel)


def test_no_head_step_reference_matches_jax_f32(models32):
    jm, tm, kq, kc = models32
    qpos, qvel, ctrl = (x.numpy() for x in _start(tm, kq, kc, 3, 16))
    step = jax.jit(jax.vmap(lambda q, v, c: JF.step(jm, JF.init(jm, q, v, c), c, 10, use_megakernel=False)))
    want = step(qpos, qvel, ctrl)
    tq, tv, tc = (torch.as_tensor(x) for x in (qpos, qvel, ctrl))
    got = TF.step_reference(tm, TF.init(tm, tq, tv, tc), tc, 10)
    _assert_gates(got, want, "no-head step_reference vs JAX")


# ---------------------------------------------------------- the env
@pytest.fixture(scope="module")
def envs():
    """The JAX env and its reset and step, jitted once for the module."""
    jenv = JJoystick(task=TASK, dtype=jnp.float32)
    tenv = Joystick(TASK, device="cpu")
    return jenv, tenv, jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))


def test_no_head_gait_retarget_equals_jax(envs):
    jenv, tenv, _, _ = envs
    np.testing.assert_array_equal(np.asarray(TI.GAIT_HOME_LEGS, np.float32), np.asarray(JI.GAIT_HOME_LEGS))
    np.testing.assert_array_equal(tenv._imitation_ref_offset.numpy(), np.asarray(jenv._imitation_ref_offset))
    assert float(tenv._imitation_ref_offset.abs().max()) > 0.2  # hip pitch and ankle re-balanced
    assert Joystick("flat_terrain", device="cpu")._imitation_ref_offset is None


ACCEL_X, ACCEL_NEAREST = 3, 1e-4
RESET_COPIES, RESET_SCALE = 256, 1e-6


def reset_reach(tenv, init_args, gen):
    """Per env, the accelerometer x of the plain `forward.init` from its
    input perturbed at rounding scale (RESET_COPIES copies, relative
    RESET_SCALE; copy 0 unperturbed): (RESET_COPIES, B) readings."""
    m, qpos, qvel, ctrl = init_args
    out = []
    for env in range(qpos.shape[0]):
        q, v, c = (x[env : env + 1].repeat(RESET_COPIES, 1) for x in (qpos, qvel, ctrl))

        def perturb(x):
            noise = torch.randn(x.shape, generator=gen)
            noise[0] = 0
            return x * (1 + RESET_SCALE * noise)

        d = TF.init(m, perturb(q), perturb(v), c)
        out.append(tenv.get_accelerometer(d)[:, 0].double().numpy())
    return np.stack(out, 1)


@pytest.mark.parametrize("seed", [11, 13, 14, 15, 16])
def test_no_head_reset_and_steps_match_jax(envs, seed, monkeypatch):
    jenv, tenv, jreset, jstep = envs
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jstate = jreset(keys)
    init = TF.init
    captured = []
    monkeypatch.setattr(TF, "init", lambda *a: captured.append(a) or init(*a))
    tstate = tenv.reset(jax_reset_draws(jenv, keys))
    monkeypatch.setattr(TF, "init", init)
    assert {k: v.shape[-1] for k, v in tstate.obs.items()} == dict(
        (k, v[0]) for k, v in jenv.observation_size.items()) == {"state": 77, "privileged_state": 176}
    assert tenv.action_size == jenv.action_size == 10

    # the reset: every entry but the accelerometer's x under the env gates
    rest = [i for i in range(77) if i != ACCEL_X]
    assert_obs_close({"state": np.asarray(jstate.obs["state"])[:, rest]}, {"state": tstate.obs["state"][:, rest]})
    jx = np.asarray(jstate.obs["state"], np.float64)[:, ACCEL_X]
    tx = tstate.obs["state"][:, ACCEL_X].double().numpy()
    err = np.abs(jx - tx)
    assert err.max() < OBS_MAX, err
    # ... and that one an edge: the same noise on both sides, so JAX's reading is jx - (tx - reading)
    (args,) = captured
    readings = reset_reach(tenv, args, torch.Generator().manual_seed(1))
    jax_reading = jx - (tx - readings[0])
    spread = readings.max(0) - readings.min(0)
    nearest = np.abs(readings - jax_reading).min(0)
    assert (spread >= err).all() and (nearest < ACCEL_NEAREST).all(), (err, spread, nearest)

    assert set(tstate.info) == set(jstate.info) - {"rng"}
    for k in tstate.info:
        e = per_env_err(jstate.info[k], tstate.info[k].numpy())
        assert e.max() < OBS_MAX, (k, e)

    rng = np.random.default_rng(4)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, tenv.action_size)).astype(np.float32)
        draws = jax_step_draws(jenv, jstate.info["rng"])
        jstate = jstep(jstate, jnp.asarray(action))
        tstate = tenv.step(tstate, torch.as_tensor(action), draws)
        assert_obs_close(jstate.obs, tstate.obs)
        assert_reward_close(jstate.reward, tstate.reward)
        np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
        assert set(tstate.metrics) == set(jstate.metrics) and "tracking_err/head" not in tstate.metrics
        for k in jstate.metrics:
            np.testing.assert_allclose(tstate.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                       rtol=METRIC_REL, atol=METRIC_REL, err_msg=k)
    # the imitation term is in play (nonzero commands), so the retarget is exercised
    assert float(tstate.metrics["reward/imitation"].abs().max()) > 0


def test_no_head_state_from_jax_steps_on(envs):
    """A JAX no-head State carried into the port steps on like the JAX env."""
    jenv, tenv, jreset, jstep = envs
    jstate = jreset(jax.random.split(jax.random.PRNGKey(14), B))
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    assert set(tstate.info) == set(jstate.info) - {"rng"} and set(tstate.metrics) == set(jstate.metrics)
    action = np.zeros((B, tenv.action_size), np.float32)
    draws = jax_step_draws(jenv, jstate.info["rng"])
    jstate = jstep(jstate, jnp.asarray(action))
    tstate = tenv.step(tstate, torch.as_tensor(action), draws)
    assert_obs_close(jstate.obs, tstate.obs)
    assert_reward_close(jstate.reward, tstate.reward)
