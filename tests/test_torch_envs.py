"""The port's env layer against the JAX package: domain randomization, the
reward functions, the gait oracle, and Joystick reset + 2 steps with the
JAX env's own random numbers injected, the steps taken by the eager body
and by the task kernels' body (the host build of `csrc/task_step.cuh`).

Tolerances: ten times the agreement measured on this CPU (3 seeds x reset
+ 2 steps, 8 envs), capped at obs p90 1e-3 / max 1e-2 and reward relative
1e-3. Measured: obs per-env max error p90 8.6e-4 and max 1.1e-3 (the
accelerometer, a second derivative of the contact solve, carries most of
it: the physics runs in f32 on both sides through independent arithmetic),
reward relative 2.2e-5, metrics relative 5.9e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_duck_playground_tpu.envs import randomize as JR
from open_duck_playground_tpu.envs import rewards as JRW
from open_duck_playground_tpu.envs.joystick import Joystick as JJoystick
from open_duck_playground_tpu.eval_tools import rewards_numpy as RN

from open_duck_playground_torch.envs import imitation as TI
from open_duck_playground_torch.envs import randomize as TR
from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs import rewards as TRW
from open_duck_playground_torch.envs.joystick import (
    Joystick, ObsNoise, ResetDraws, StepDraws,
)
from open_duck_playground_torch.interop import state_from_jax
from task_kernel_check import host_library

torch.set_num_threads(1)

B = 8
OBS_P90, OBS_MAX = 1e-3, 1e-2  # measured x10 exceeds the caps: the caps
REWARD_REL = 2.2e-4  # measured 2.2e-5, x10
METRIC_REL = 1e-3  # measured 5.9e-4; x10 exceeds the reward cap: the cap


# ------------------------------------------- replay of the JAX env's draws
def _unit(key, n):
    return 2.0 * jax.random.uniform(key, (n,), jnp.float32) - 1.0


def _obs_noise(rng, nu):
    """The 6 splits of Joystick._get_obs, in order; returns (rng, noises)."""
    out = []
    for n in (3, 3, 3, None, nu, nu):
        rng, key = jax.random.split(rng)
        if n is not None:  # the IMU-delay draw is discarded by the reference
            out.append(_unit(key, n))
    return rng, out


def _reset_draws_one(env, rng):
    """The splits of the JAX Joystick.reset (which the standing task
    inherits; no reference-state init), in order: (draws, the env's
    `info["rng"]` after them)."""
    nu = env.action_size
    lo, hi = env._config.get("reset_joint_scale_range", (0.5, 1.5))
    rng, k = jax.random.split(rng)
    dxy = jax.random.uniform(k, (2,), jnp.float32, minval=-0.05, maxval=0.05)
    rng, k = jax.random.split(rng)
    yaw = jax.random.uniform(k, (1,), jnp.float32, minval=-3.14, maxval=3.14)[0]
    rng, k = jax.random.split(rng)
    js = jax.random.uniform(k, (nu,), jnp.float32, minval=lo, maxval=hi)
    rng, k = jax.random.split(rng)
    bv = jax.random.uniform(k, (6,), jnp.float32, minval=-0.05, maxval=0.05)
    rng, k = jax.random.split(rng)
    cmd = env.sample_command(k)
    rng, k = jax.random.split(rng)
    pc = env._config.push_config
    push = jax.random.uniform(k, dtype=jnp.float32, minval=pc.interval_range[0],
                              maxval=pc.interval_range[1])
    rng, noise = _obs_noise(rng, nu)
    return (dxy, yaw, js, bv, cmd, push, *noise), rng


def _step_draws_one(env, rng):
    """The splits of the JAX Joystick.step, in order: (draws, the env's
    `info["rng"]` after the step)."""
    nu = env.action_size
    cfg = env._config
    rng, p1, p2, dk = jax.random.split(rng, 4)
    delay = jax.random.randint(dk, (), minval=cfg.noise_config.action_min_delay,
                               maxval=cfg.noise_config.action_max_delay)
    theta = jax.random.uniform(p1, dtype=jnp.float32, maxval=2 * jnp.pi)
    mag = jax.random.uniform(p2, dtype=jnp.float32,
                             minval=cfg.push_config.magnitude_range[0],
                             maxval=cfg.push_config.magnitude_range[1])
    rng, noise = _obs_noise(rng, nu)
    rng, k = jax.random.split(rng)
    cmd = env.sample_command(k)
    return (delay, theta, mag, *noise, cmd), rng


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def _as_reset_draws(d) -> ResetDraws:
    dxy, yaw, js, bv, cmd, push, gy, ac, gr, jp, jv = d
    return ResetDraws(
        base_dxy=_t(dxy), yaw=_t(yaw), joint_scale=_t(js), base_vel=_t(bv),
        command=_t(cmd), push_interval=_t(push),
        obs=ObsNoise(gyro=_t(gy), accelerometer=_t(ac), gravity=_t(gr),
                     joint_pos=_t(jp), joint_vel=_t(jv)),
    )


def _as_step_draws(d) -> StepDraws:
    delay, theta, mag, gy, ac, gr, jp, jv, cmd = d
    return StepDraws(
        action_delay=_t(delay, torch.int64), push_theta=_t(theta), push_magnitude=_t(mag),
        obs=ObsNoise(gyro=_t(gy), accelerometer=_t(ac), gravity=_t(gr),
                     joint_pos=_t(jp), joint_vel=_t(jv)),
        command=_t(cmd),
    )


def jax_reset_draws(env, keys) -> ResetDraws:
    return _as_reset_draws(jax.vmap(lambda k: _reset_draws_one(env, k))(keys)[0])


def jax_step_draws(env, rngs) -> StepDraws:
    return _as_step_draws(jax.vmap(lambda k: _step_draws_one(env, k))(rngs)[0])


def reset_draws_fn(env):
    """For runs of many steps: keys (B, 2) -> (ResetDraws, each env's rng
    after the reset), jitted."""
    f = jax.jit(jax.vmap(lambda k: _reset_draws_one(env, k)))

    def draws(keys):
        d, rng = f(keys)
        return _as_reset_draws(d), rng

    return draws


def step_draws_fn(env):
    """For runs of many steps: rngs (B, 2) -> (StepDraws, each env's rng
    after the step), jitted."""
    f = jax.jit(jax.vmap(lambda k: _step_draws_one(env, k)))

    def draws(rngs):
        d, rng = f(rngs)
        return _as_step_draws(d), rng

    return draws


def per_env_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).reshape(a.shape[0], -1).max(1)


def assert_obs_close(jobs, tobs):
    for k in jobs:
        e = per_env_err(jobs[k], tobs[k].numpy())
        assert np.percentile(e, 90) < OBS_P90 and e.max() < OBS_MAX, (k, e)


def assert_reward_close(jr, tr):
    jr, tr = np.asarray(jr, np.float64), tr.numpy().astype(np.float64)
    np.testing.assert_allclose(tr, jr, rtol=REWARD_REL, atol=REWARD_REL)


# ----------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def envs():
    jenv = JJoystick(task="flat_terrain_backlash", dtype=jnp.float32)
    tenv = Joystick(task="flat_terrain_backlash", device="cpu")
    return jenv, tenv


@pytest.fixture(scope="module")
def jax_fns(envs):
    """The JAX env's reset and step, jitted once for the module."""
    jenv, _ = envs
    return jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))


# -------------------------------------------------------------------- tests
def test_domain_randomize_matches_jax(envs):
    jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jm, _ = JR.domain_randomize(jenv.model, keys)

    # replay the JAX draws: the 8 splits of randomize.py, in order
    def one(rng):
        s = jenv.model.spec
        nf = len(s.friction_dofs)
        out = []
        for shape, lo, hi in [((), 0.5, 1.0), ((nf,), 0.9, 1.1), ((nf,), 1.0, 1.05),
                              ((3,), -0.05, 0.05), ((s.nbody,), 0.9, 1.1), ((), -0.1, 0.1),
                              ((nf,), -0.03, 0.03), ((s.nu,), 0.9, 1.1)]:
            rng, k = jax.random.split(rng)
            out.append(jax.random.uniform(k, shape, minval=lo, maxval=hi, dtype=jnp.float32))
        return out

    d = [_t(x) for x in jax.vmap(one)(keys)]
    tm = TR.domain_randomize(tenv.model, TR.DRDraws(*d))
    for name in ("geom_friction", "body_ipos", "dof_frictionloss", "dof_armature",
                 "body_mass", "qpos0", "actuator_gainprm", "actuator_biasprm"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)


def test_rewards_match_numpy_twins():
    rng = np.random.default_rng(5)
    n = 16
    cmd = rng.uniform(-0.3, 0.3, (n, 7)).astype(np.float32)
    cmd[:4] = 0.0  # gated terms see a zero command too
    vel = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    ang = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    af = rng.normal(0, 1, (n, 14)).astype(np.float32)
    a1, a2 = rng.normal(0, 1, (2, n, 14)).astype(np.float32)
    jq, jv, dp = rng.normal(0, 0.3, (3, n, 14)).astype(np.float32)
    base = rng.normal(0, 0.3, (n, 6)).astype(np.float32)
    contacts = rng.random((n, 2)) > 0.5
    ref = rng.normal(0, 0.5, (n, 40)).astype(np.float32)
    T = torch.as_tensor
    cases = [
        (TRW.tracking_lin_vel(T(cmd), T(vel), 0.01), lambda i: RN.tracking_lin_vel(cmd[i], vel[i], 0.01)),
        (TRW.tracking_ang_vel(T(cmd), T(ang), 0.01), lambda i: RN.tracking_ang_vel(cmd[i], ang[i], 0.01)),
        (TRW.torques(T(af)), lambda i: RN.torques(af[i])),
        (TRW.action_rate(T(a1), T(a2)), lambda i: RN.action_rate(a1[i], a2[i])),
        (TRW.stand_still(T(cmd), T(jq), T(jv), T(dp[0])), lambda i: RN.stand_still(cmd[i], jq[i], jv[i], dp[0])),
        (TRW.forward_progress(T(cmd), T(vel)), lambda i: RN.forward_progress(cmd[i], vel[i])),
        (TRW.yaw_rate_l1(T(cmd), T(ang)), lambda i: RN.yaw_rate_l1(cmd[i], ang[i])),
        (TRW.lin_vel_l1(T(cmd), T(vel)), lambda i: RN.lin_vel_l1(cmd[i], vel[i])),
        (TI.imitation_reward(T(base), T(jq), T(jv), T(contacts), T(ref), T(cmd)),
         lambda i: RN.imitation_reward(base[i], jq[i], jv[i], contacts[i], ref[i], cmd[i])),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), [want(i) for i in range(n)], rtol=1e-5, atol=1e-6)
    assert TRW.alive(3).tolist() == [float(JRW.alive())] * 3


def test_gait_oracle_matches_jax(envs):
    jenv, tenv = envs
    rng = np.random.default_rng(2)
    cmd = rng.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    ph = rng.integers(0, 60, 64).astype(np.int32)
    want = jax.vmap(jenv.gait.reference_frame)(cmd[:, 0], cmd[:, 1], cmd[:, 2], ph)
    got = tenv.gait.reference_frame(*(torch.as_tensor(cmd[:, i]) for i in range(3)),
                                    torch.as_tensor(ph))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _reset_and_steps_match_jax(envs, jax_fns, step):
    """Reset and two steps of the JAX env and of the port, the port's steps
    taken by `step(env, state, action, draws)`, at the tolerances above."""
    jenv, tenv = envs
    jreset, jstep = jax_fns
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    jstate = jreset(keys)
    tstate = tenv.reset(jax_reset_draws(jenv, keys))
    assert_obs_close(jstate.obs, tstate.obs)
    for k in jstate.info:
        if k != "rng":
            e = per_env_err(jstate.info[k], tstate.info[k].numpy())
            assert e.max() < OBS_MAX, (k, e)

    rng = np.random.default_rng(4)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, tenv.action_size)).astype(np.float32)
        draws = jax_step_draws(jenv, jstate.info["rng"])
        jstate = jstep(jstate, jnp.asarray(action))
        tstate = step(tenv, tstate, torch.as_tensor(action), draws)
        assert_obs_close(jstate.obs, tstate.obs)
        assert_reward_close(jstate.reward, tstate.reward)
        np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
        assert set(tstate.metrics) == set(jstate.metrics)
        for k in jstate.metrics:
            np.testing.assert_allclose(tstate.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                       rtol=METRIC_REL, atol=METRIC_REL, err_msg=k)


def test_joystick_reset_and_steps_match_jax(envs, jax_fns):
    _reset_and_steps_match_jax(envs, jax_fns, lambda env, state, action, draws: env.step(state, action, draws))


def test_joystick_task_kernels_match_jax(envs, jax_fns):
    """The task kernels' body (built by the host's C++ compiler, as
    tests/test_torch_task_kernel.py holds it against the eager step), with
    the plain physics between its two launches, on the JAX env's draws."""
    lib = host_library(TK.kernel_dims(envs[1]))
    _reset_and_steps_match_jax(envs, jax_fns,
                               lambda env, state, action, draws: TK.step(env, state, action, draws, lib=lib))


def test_state_from_jax_resumes_the_jax_rollout(envs, jax_fns):
    """A port State built from a JAX State steps on like the JAX env."""
    jenv, tenv = envs
    jreset, jstep = jax_fns
    keys = jax.random.split(jax.random.PRNGKey(12), B)
    jstate = jreset(keys)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    assert set(tstate.info) == set(jstate.info) - {"rng"}
    action = np.zeros((B, tenv.action_size), np.float32)
    draws = jax_step_draws(jenv, jstate.info["rng"])
    jstate = jstep(jstate, jnp.asarray(action))
    tstate = tenv.step(tstate, torch.as_tensor(action), draws)
    assert_obs_close(jstate.obs, tstate.obs)
    assert_reward_close(jstate.reward, tstate.reward)
