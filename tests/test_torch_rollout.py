"""The slice end to end: the training rollout of the port (policy MLP with
tanh-Normal sampling, TrainingEnv with domain randomization, Joystick,
physics) against the JAX rollout of bench.py, with the JAX package's params
carried over and every random number injected. Also the NaN quarantine.

Tolerances as in test_torch_envs.py (obs p90 1e-3 / max 1e-2, reward
relative 2.2e-4); actions within 8e-4 absolute, ten times the measured
7.6e-5 of the first step, where the policy sees each side's own reset obs
(3.6e-7 on later steps, which start from a shared state).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_duck_playground_tpu.envs.joystick import Joystick as JJoystick
from open_duck_playground_tpu.envs.randomize import domain_randomize as jax_dr
from open_duck_playground_tpu.envs.wrappers import TrainingEnv as JTrainingEnv
from open_duck_playground_tpu.train import networks as JN, running_stats as JRS

from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.envs.wrappers import TrainingEnv
from open_duck_playground_torch.interop import normalizer_from_jax, networks_from_jax, state_from_jax
from open_duck_playground_torch.train import networks as TN, running_stats as TRS

from test_torch_envs import (
    assert_obs_close, assert_reward_close, jax_reset_draws, jax_step_draws, per_env_err,
)
from task_kernel_check import fused_wrapper_step, wrapper_host_library

torch.set_num_threads(1)

B = 8
HIDDEN = (128, 128, 128, 128)


def _dr_draws(spec, keys) -> DRDraws:
    """Replay of the 8 uniform draws of randomize.domain_randomize."""
    nf = len(spec.friction_dofs)

    def one(rng):
        out = []
        for shape, lo, hi in [((), 0.5, 1.0), ((nf,), 0.9, 1.1), ((nf,), 1.0, 1.05),
                              ((3,), -0.05, 0.05), ((spec.nbody,), 0.9, 1.1), ((), -0.1, 0.1),
                              ((nf,), -0.03, 0.03), ((spec.nu,), 0.9, 1.1)]:
            rng, k = jax.random.split(rng)
            out.append(jax.random.uniform(k, shape, minval=lo, maxval=hi, dtype=jnp.float32))
        return out

    return DRDraws(*[torch.as_tensor(np.array(x)) for x in jax.vmap(one)(keys)])


@pytest.fixture(scope="module")
def rollout():
    rng = jax.random.PRNGKey(0)
    jenv = JJoystick(task="flat_terrain_backlash", dtype=jnp.float32)
    jwrapped = JTrainingEnv(jenv, episode_length=1000, randomization_fn=jax_dr,
                            rng=rng, num_envs=B)
    tenv = Joystick(task="flat_terrain_backlash", device="cpu")
    twrapped = TrainingEnv(tenv, episode_length=1000,
                           dr_draws=_dr_draws(jenv.model.spec, jax.random.split(rng, B)),
                           randomization_fn=domain_randomize)
    keys = jax.random.split(rng, B)
    jstate = jax.jit(jwrapped.reset)(keys)
    tstate = twrapped.reset(jax_reset_draws(jenv, keys))

    obs_sizes = {k: v.shape[-1] for k, v in jstate.obs.items()}
    net = JN.PPONetworks(obs_sizes, jenv.action_size, HIDDEN, (256, 256, 256, 256))
    params = net.init(jax.random.PRNGKey(2))
    normalizer = JRS.init(obs_sizes)
    tnet = networks_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tnorm = normalizer_from_jax(jax.tree.map(np.asarray, normalizer), device="cpu")
    return dict(jenv=jenv, jwrapped=jwrapped, twrapped=twrapped, jstate=jstate,
                tstate=tstate, net=net, params=params, normalizer=normalizer,
                tnet=tnet, tnorm=tnorm, jstep=jax.jit(jwrapped.step))


def test_training_rollout_matches_jax(rollout):
    """Each control step starts both rollouts from the same state (the JAX
    state carried over with `state_from_jax`): the 1-iteration Newton solve
    is discontinuous where a constraint row sits at the edge of its active
    set, so free-running f32 trajectories may part after a few steps even
    though every step agrees."""
    r = rollout
    jstate, tstate = r["jstate"], r["tstate"]
    assert_obs_close(jstate.obs, tstate.obs)
    key = jax.random.PRNGKey(1)
    for i in range(3):
        if i:
            tstate = state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        # bench.py's rollout body: split, policy forward, tanh-Normal sample
        key, ak = jax.random.split(key)
        logits = r["net"].policy_logits(r["params"], JRS.normalize(r["normalizer"], jstate.obs))
        noise = jax.random.normal(ak, (B, r["jenv"].action_size), logits.dtype)
        jaction = JN.postprocess(JN.sample_raw(ak, logits))

        with torch.no_grad():
            tlogits = r["tnet"].policy_logits(TRS.normalize(r["tnorm"], tstate.obs))
            taction = TN.postprocess(TN.sample_raw(tlogits, torch.as_tensor(np.array(noise), dtype=torch.float32)))
        e = per_env_err(jaction, taction.numpy())
        assert e.max() < 8e-4, e

        draws = jax_step_draws(r["jenv"], jstate.info["rng"])
        jstate = r["jstep"](jstate, jaction)
        tstate = r["twrapped"].step(tstate, taction, draws)
        assert_obs_close(jstate.obs, tstate.obs)
        assert_reward_close(jstate.reward, tstate.reward)
        np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
        np.testing.assert_array_equal(tstate.info["steps"].numpy(), np.asarray(jstate.info["steps"]))
        assert np.isfinite(tstate.reward.numpy()).all()


def test_nan_env_is_quarantined_like_jax(rollout):
    """An env whose state is NaN comes back as its cached reset state, with
    zero reward and done = 1, as wrappers.py does; the others step on."""
    _nan_env_is_quarantined_like_jax(rollout, rollout["twrapped"].step)


def test_nan_env_is_quarantined_like_jax_through_the_wrapper_kernels(rollout):
    """The same through the wrapper's two kernels (`envs/wrapper_kernel.py`,
    the body the card runs), built for the host
    (`csrc/wrapper_step_host.cpp`)."""
    lib, wenv = wrapper_host_library(), rollout["twrapped"]
    _nan_env_is_quarantined_like_jax(rollout, lambda state, action, draws:
                                     fused_wrapper_step(wenv, state, action, draws, lib))


def _nan_env_is_quarantined_like_jax(rollout, step):
    r = rollout
    jstate, tstate = r["jstate"], r["tstate"]
    jstate = jstate.replace(data=jstate.data.replace(qvel=jstate.data.qvel.at[0].set(jnp.nan)))
    tqvel = tstate.data.qvel.clone()
    tqvel[0] = float("nan")
    tstate = tstate.replace(data=tstate.data.replace(qvel=tqvel))
    action = np.zeros((B, r["jenv"].action_size), np.float32)
    draws = jax_step_draws(r["jenv"], jstate.info["rng"])
    jstate = r["jstep"](jstate, jnp.asarray(action))
    tstate = step(tstate, torch.as_tensor(action), draws)

    first = tstate.info["first_data"]
    assert tstate.done[0] == 1.0 and tstate.reward[0] == 0.0
    for name, x in tstate.data.fields():
        assert torch.equal(x[0], getattr(first, name)[0]), name
    for k, x in tstate.obs.items():
        assert torch.equal(x[0], tstate.info["first_obs"][k][0]), k
    for k, x in tstate.metrics.items():
        assert torch.isfinite(x).all(), k
    assert_obs_close(jstate.obs, tstate.obs)
    assert_reward_close(jstate.reward, tstate.reward)
    np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
