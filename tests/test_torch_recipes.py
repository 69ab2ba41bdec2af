"""The options of RESULTS.md's training recipes against the JAX package:
reference-state init (`rsi_prob`), direct head targets
(`head_direct_targets`) and bf16 products (`bf16_matmuls`).

- `rsi_prob=0.5` on both robots, the JAX reset's own draws injected (the
  gate passes for some envs and not for others): the reset state and obs
  within test_torch_envs.py's tolerances (obs p90 1e-3 / max 1e-2; the
  frame index exact); on the 14-actuator robot, with `head_direct_targets`
  on as well, two steps after it (reward relative 2.2e-4, metrics 1e-3).
- `rsi_prob=1.0` in the port alone, as JAX tests/test_envs.py:182-231 holds
  the JAX env: the legs sit on the (retargeted) reference frame within
  1e-5, the phase observation encodes the first frame within 1e-5, the
  head keeps its perturbed reset pose; `rsi_prob=0` draws nothing more, so
  every existing run keeps its generator stream.
- `Standing` with `head_direct_targets` against the JAX env, reset and two
  steps at the same tolerances; the head servos take the head command.
- `bf16_matmuls`: the MLPs' outputs against JAX `apply_mlp(...,
  matmul_dtype=bfloat16)` within 1.5e-3 of the largest output (measured
  4.4e-4; the f32 products are 4.1e-3 away), on a 10-action policy carried
  over by `interop.networks_from_jax`; the PPO loss within 1e-5 relative
  and every gradient within 1e-5 of its tensor's largest entry (measured
  7.6e-7 and 8e-7: the kernels' gradients are equal bit for bit, both sides
  round them to bf16); the f32 products' loss is 4.6% away. `ppo.train` on
  the toy env learns with bf16 products, its parameters f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs.joystick import Joystick as JJoystick
from open_duck_playground_tpu.envs.standing import Standing as JStanding
from open_duck_playground_tpu.train import networks as JN

from open_duck_playground_torch.envs import imitation as TI
from open_duck_playground_torch.envs.joystick import Joystick, ObsNoise, ResetDraws
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.interop import networks_from_jax
from open_duck_playground_torch.train import ppo

from test_torch_envs import (
    METRIC_REL, OBS_MAX, _obs_noise, _t, assert_obs_close, assert_reward_close, jax_step_draws,
    per_env_err,
)
from test_torch_ppo import (  # noqa: F401 (loss_case is a fixture)
    ACT, CFG, HID_P, HID_V, OBS, TOY, PointEnv, T_, _f32, _jax_loss, _param_pairs, _port_side, loss_case,
)
from test_torch_standing import jax_reset_draws as standing_reset_draws

torch.set_num_threads(1)

B = 8
RSI = {"rsi_prob": 0.5, "head_direct_targets": True}


# ------------------------------------------------ replay of the JAX draws
def _reset_draws_one_rsi(env, rng):
    """The splits of the JAX Joystick.reset with rsi_prob > 0, in order."""
    nu = env.action_size
    lo, hi = env._config.reset_joint_scale_range
    out = []
    for shape, a, b in [((2,), -0.05, 0.05), ((1,), -3.14, 3.14), ((nu,), lo, hi), ((6,), -0.05, 0.05)]:
        rng, k = jax.random.split(rng)
        out.append(jax.random.uniform(k, shape, jnp.float32, minval=a, maxval=b))
    rng, k = jax.random.split(rng)
    cmd = env.sample_command(k)
    rng, gate_key, phase_key = jax.random.split(rng, 3)
    phase = jax.random.randint(phase_key, (), 0, env.gait.nb_steps_in_period, jnp.int32)
    gate = jax.random.uniform(gate_key)  # the default float, as the env draws it
    rng, k = jax.random.split(rng)
    pc = env._config.push_config
    push = jax.random.uniform(k, dtype=jnp.float32, minval=pc.interval_range[0], maxval=pc.interval_range[1])
    _, noise = _obs_noise(rng, nu)
    return (*out, cmd, gate, phase, push, *noise)


def jax_rsi_reset_draws(env, keys) -> ResetDraws:
    dxy, yaw, js, bv, cmd, gate, phase, push, gy, ac, gr, jp, jv = jax.vmap(
        lambda k: _reset_draws_one_rsi(env, k))(keys)
    return ResetDraws(base_dxy=_t(dxy), yaw=_t(yaw)[:, 0], joint_scale=_t(js), base_vel=_t(bv),
                      command=_t(cmd), push_interval=_t(push),
                      obs=ObsNoise(gyro=_t(gy), accelerometer=_t(ac), gravity=_t(gr),
                                   joint_pos=_t(jp), joint_vel=_t(jv)),
                      rsi_gate=_t(gate, torch.float64), rsi_phase=_t(phase, torch.int64))


def assert_reset_close(jstate, tstate):
    assert_obs_close(jstate.obs, tstate.obs)
    assert set(tstate.info) == set(jstate.info) - {"rng"}
    np.testing.assert_array_equal(tstate.info["imitation_i"].numpy(), np.asarray(jstate.info["imitation_i"]))
    for k in tstate.info:
        e = per_env_err(jstate.info[k], tstate.info[k].numpy())
        assert e.max() < OBS_MAX, (k, e)
    for f in ("qpos", "qvel"):
        e = per_env_err(getattr(jstate.data, f), getattr(tstate.data, f).numpy())
        assert e.max() < 1e-5, (f, e)


# ------------------------------------------------ reference-state init
@pytest.fixture(scope="module")
def joystick_rsi():
    """The 14-actuator robot with rsi_prob 0.5 and direct head targets: the
    JAX env's reset and step, jitted once for the module."""
    jenv = JJoystick(task="flat_terrain_backlash", config_overrides=RSI, dtype=jnp.float32)
    tenv = Joystick("flat_terrain_backlash", config_overrides=RSI, device="cpu")
    return jenv, tenv, jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))


def test_rsi_reset_and_head_targets_match_jax(joystick_rsi):
    jenv, tenv, jreset, jstep = joystick_rsi
    keys = jax.random.split(jax.random.PRNGKey(31), B)
    draws = jax_rsi_reset_draws(jenv, keys)
    gate = draws.rsi_gate < 0.5
    assert 0 < int(gate.sum()) < B  # the gate both ways
    jstate = jreset(keys)
    tstate = tenv.reset(draws)
    assert_reset_close(jstate, tstate)
    i0 = tstate.info["imitation_i"]
    assert (i0[~gate] == 0).all() and torch.equal(i0[gate], draws.rsi_phase[gate].to(i0.dtype))

    rng = np.random.default_rng(5)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, tenv.action_size)).astype(np.float32)
        step_draws = jax_step_draws(jenv, jstate.info["rng"])
        cmd = tstate.info["command"]
        jstate = jstep(jstate, jnp.asarray(action))
        tstate = tenv.step(tstate, torch.as_tensor(action), step_draws)
        assert_obs_close(jstate.obs, tstate.obs)
        assert_reward_close(jstate.reward, tstate.reward)
        assert set(tstate.metrics) == set(jstate.metrics)
        for k in jstate.metrics:
            np.testing.assert_allclose(tstate.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                       rtol=METRIC_REL, atol=METRIC_REL, err_msg=k)
        # the head servos took the head command, in both packages
        assert torch.equal(tstate.info["motor_targets"][:, 5:9], cmd[:, 3:7])
        np.testing.assert_array_equal(np.asarray(jstate.info["motor_targets"])[:, 5:9], cmd[:, 3:7].numpy())


def test_no_head_rsi_reset_matches_jax():
    jenv = JJoystick(task="flat_terrain_no_head", config_overrides={"rsi_prob": 0.5}, dtype=jnp.float32)
    tenv = Joystick("flat_terrain_no_head", config_overrides={"rsi_prob": 0.5}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(32), B)
    draws = jax_rsi_reset_draws(jenv, keys)
    assert 0 < int((draws.rsi_gate < 0.5).sum()) < B
    assert_reset_close(jax.jit(jax.vmap(jenv.reset))(keys), tenv.reset(draws))


@pytest.mark.parametrize("task", ["flat_terrain_no_head", "flat_terrain_backlash"])
def test_rsi_reset_starts_mid_gait(task):
    """rsi_prob 1: every env's legs on the (retargeted) reference frame of
    its first frame, the phase observation encoding that frame, the head
    at its perturbed reset pose; the frames differ between envs."""
    env = Joystick(task, config_overrides={"rsi_prob": 1.0, "reset_joint_scale_range": [1.0, 1.0]},
                   device="cpu")
    gen = torch.Generator().manual_seed(4)
    draws = env.reset_draws(gen, 16)
    state = env.reset(draws)
    i0 = state.info["imitation_i"]
    assert torch.equal(i0, draws.rsi_phase.to(i0.dtype)) and len(set(i0.tolist())) > 2
    ref_legs = TI.legs16(state.info["current_reference_motion"][:, 0:16])
    if env._imitation_ref_offset is not None:
        ref_legs = ref_legs + env._imitation_ref_offset
    jpos = env.get_actuator_joints_qpos(state.data.qpos)
    legs = jpos if env.action_size == 10 else torch.cat([jpos[:, :5], jpos[:, 9:]], -1)
    assert float((legs - ref_legs).abs().max()) < 1e-5
    ph = i0.double() / env.gait.nb_steps_in_period * 2 * np.pi
    want = torch.stack([torch.cos(ph), torch.sin(ph)], -1)
    assert float((state.info["imitation_phase"].double() - want).abs().max()) < 1e-5
    if env.action_size == 14:  # the head keeps the reset pose (home keyframe, scale 1)
        home = env.get_actuator_joints_qpos(env._init_q[None])
        assert torch.equal(jpos[:, 5:9], home[:, 5:9].expand(16, -1))


def test_rsi_off_draws_nothing_more():
    """rsi_prob 0 (the default): no gate or phase drawn, the generator stream
    of every existing run unchanged, the reset at frame 0 with a zero phase
    observation."""
    env = Joystick("flat_terrain_no_head", device="cpu")
    gen, replay = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    draws = env.reset_draws(gen, 4)
    assert draws.rsi_gate is None and draws.rsi_phase is None
    # the draws of the reset before reference-state init, in their order
    u = lambda shape: torch.rand(shape, generator=replay)
    for shape in ((4, 2), (4,), (4, 10), (4, 6)):
        u(shape)
    env.sample_command(replay, 4)
    u((4,))
    ObsNoise.sample(replay, 4, 10)
    assert torch.equal(gen.get_state(), replay.get_state())
    state = env.reset(draws)
    assert (state.info["imitation_i"] == 0).all() and (state.info["imitation_phase"] == 0).all()
    rsi = Joystick("flat_terrain_no_head", config_overrides={"rsi_prob": 0.5}, device="cpu")
    more = rsi.reset_draws(torch.Generator().manual_seed(9), 4)
    for f in ("base_dxy", "yaw", "joint_scale", "base_vel", "command", "push_interval"):
        assert torch.equal(getattr(more, f), getattr(draws, f)), f
    with pytest.raises(ValueError):  # an env with rsi_prob > 0 needs the gate and phase draws
        rsi.reset(draws)


# ------------------------------------------------ standing head targets
def test_standing_head_direct_targets_match_jax():
    jenv = JStanding(task="flat_terrain", config_overrides={"head_direct_targets": True}, dtype=jnp.float32)
    tenv = Standing("flat_terrain", config_overrides={"head_direct_targets": True}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(33), B)
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate = tenv.reset(standing_reset_draws(jenv, keys))
    assert_obs_close(jstate.obs, tstate.obs)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(6)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, tenv.action_size)).astype(np.float32)
        step_draws = jax_step_draws(jenv, jstate.info["rng"])
        jstate = jstep(jstate, jnp.asarray(action))
        tstate = tenv.step(tstate, torch.as_tensor(action), step_draws)
        assert_obs_close(jstate.obs, tstate.obs)
        assert_reward_close(jstate.reward, tstate.reward)
        for k in jstate.metrics:
            np.testing.assert_allclose(tstate.metrics[k].numpy(), np.asarray(jstate.metrics[k]),
                                       rtol=METRIC_REL, atol=METRIC_REL, err_msg=k)
        assert torch.equal(tstate.info["motor_targets"][:, 5:9], tstate.info["command"][:, 3:7])
    # the standing task's head commands reach beyond the actions' 0.25 rad
    assert float((tstate.info["motor_targets"][:, 5:9] - tenv._default_actuator[5:9]).abs().max()) > 0.25


# ------------------------------------------------------- bf16 products
def test_bf16_mlp_matches_jax():
    """A 10-action policy and its critic (the no-head robot's obs sizes),
    carried over by networks_from_jax."""
    rng = np.random.default_rng(0)
    sizes = {"state": 77, "privileged_state": 176}
    jnet = JN.PPONetworks(sizes, 10, (128,) * 4, (256,) * 4, matmul_dtype=jnp.bfloat16)
    params = jnet.init(jax.random.PRNGKey(1))
    obs = {k: _f32(rng, 64, n) for k, n in sizes.items()}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: T_(v) for k, v in obs.items()}
    tree = jax.tree.map(np.asarray, params)
    tnet = networks_from_jax(tree, device="cpu", matmul_dtype=torch.bfloat16)
    f32 = networks_from_jax(tree, device="cpu")
    for want, got, plain in ((jnet.policy_logits(params, jobs), tnet.policy_logits(tobs), f32.policy_logits(tobs)),
                             (jnet.value(params, jobs), tnet.value(tobs), f32.value(tobs))):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert got.dtype == torch.float32
        assert np.abs(got.detach().numpy() - want).max() < 1.5e-3 * scale
        assert np.abs(plain.detach().numpy() - want).max() > 2e-3 * scale  # the products are bf16's
    assert tnet.policy.sizes[-1] == 20 and all(p.dtype == torch.float32 for p in tnet.parameters())


def test_bf16_loss_and_gradients_match_jax(loss_case):
    _, params, normalizer, data, final_obs = loss_case
    jnet = JN.PPONetworks(OBS, ACT, HID_P, HID_V, matmul_dtype=jnp.bfloat16)
    ent_key = jax.random.PRNGKey(9)
    jdata, jfinal = jax.tree.map(jnp.asarray, data), jax.tree.map(jnp.asarray, final_obs)
    (_, want), grads = jax.value_and_grad(
        lambda p: _jax_loss(jnet, p, normalizer, jdata, jfinal, ent_key, CFG), has_aux=True)(params)
    noise = T_(np.asarray(jax.random.normal(ent_key, data["raw_action"].shape, jnp.float32)))
    tdata = {k: T_(v) for k, v in data.items() if k != "obs"}
    tdata["obs"] = {k: T_(v) for k, v in data["obs"].items()}
    tfinal = {k: T_(v) for k, v in final_obs.items()}
    tnet, tnorm = _port_side(params, normalizer)
    plain, _, _ = ppo.loss_fn(tnet, tnorm, tdata, tfinal, noise, CFG)
    for mlp in (tnet.policy, tnet.value_mlp):
        mlp.matmul_dtype = torch.bfloat16
    total, got, _ = ppo.loss_fn(tnet, tnorm, tdata, tfinal, noise, CFG)
    for k, w in want.items():
        assert float(got[k].detach()) == pytest.approx(float(w), rel=1e-5), k
    assert abs(float(plain.detach()) / float(want["total_loss"]) - 1) > 1e-2  # f32 products are another loss
    total.backward()
    for name, p, g in _param_pairs(tnet, grads):
        assert p.grad.dtype == torch.float32
        assert np.abs(p.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max(), name


def test_bf16_ppo_learns_toy_env():
    """test_torch_ppo.py's toy run with bf16 products: the last of 4 evals
    beats the first by more than 10; parameters and Adam's state stay f32."""
    rewards = []

    def progress(step, metrics):
        if "eval/episode_reward" in metrics:
            rewards.append(float(metrics["eval/episode_reward"]))

    _, (normalizer, net), metrics = ppo.train(
        PointEnv(), 40_000, device="cpu", progress_fn=progress,
        **{**TOY, "num_evals": 4, "num_eval_envs": 16, "bf16_matmuls": True})
    assert rewards[-1] > rewards[0] + 10, rewards
    assert net.policy.matmul_dtype == net.value_mlp.matmul_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(np.isfinite(v) for v in metrics.values())
    cfg = dataclasses.replace(ppo.PPOConfig(), **{**TOY, "bf16_matmuls": True})
    ts = ppo.init_training_state({"state": torch.zeros(2, 4), "privileged_state": torch.zeros(2, 4)}, 2, cfg,
                                 torch.Generator().manual_seed(0), device="cpu")
    ts.net.policy({"state": torch.ones(3, 4)}["state"]).sum().backward()
    ts.optimizer.step()
    assert all(s["exp_avg"].dtype == torch.float32 for s in ts.optimizer.state.values())
