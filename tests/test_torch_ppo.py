"""The port's PPO update against the JAX package: the action distribution,
the running normalizer, GAE, the loss and its gradients, one optimizer step,
the minibatch gather, the k-unroll contract, learning on a toy env, the
trainer's schedule of evals and hooks, and the eval and action-repeat
wrappers.

Inputs come from a numpy seed and go through both sides in float32. Stated
tolerances: distribution, normalizer and GAE 1e-6 to 2e-6 (relative, with
an absolute floor of the same size; the normalizer's summed variance 1e-5,
see `_assert_stats`); loss terms 1e-5 relative; gradients 1e-4 of each tensor's
largest entry; parameters after an optimizer step 1e-7 absolute (the
updates themselves are 3e-4). The schedule's step counts and the wrappers'
bookkeeping on a deterministic toy env are compared exactly (rewards to
float32 rounding, 1e-6 relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from open_duck_playground_tpu.envs import env_types as JET
from open_duck_playground_tpu.envs import wrappers as JW
from open_duck_playground_tpu.physics import types as JT
from open_duck_playground_tpu.train import gae as JG
from open_duck_playground_tpu.train import networks as JN
from open_duck_playground_tpu.train import ppo as JPPO
from open_duck_playground_tpu.train import running_stats as JRS

from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv
from open_duck_playground_torch.interop import networks_from_jax, normalizer_from_jax
from open_duck_playground_torch.physics.types import Data
from open_duck_playground_torch.train import gae as TG
from open_duck_playground_torch.train import networks as TN
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train import running_stats as TRS
from open_duck_playground_torch.train.config import PPOConfig

from task_kernel_check import fused_wrapper_step, wrapper_host_library

torch.set_num_threads(1)

T_ = torch.as_tensor


def _f32(rng, *shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------- distribution math
def test_log_prob_and_entropy_match_jax():
    rng = np.random.default_rng(0)
    logits, raw = _f32(rng, 7, 5, 12, scale=1.5), _f32(rng, 7, 5, 6, scale=1.2)
    np.testing.assert_allclose(TN.log_prob(T_(logits), T_(raw)).numpy(),
                               np.asarray(JN.log_prob(jnp.asarray(logits), jnp.asarray(raw))),
                               rtol=1e-6, atol=1e-5)  # sums of 6 terms of size ~10
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (7, 5, 6), jnp.float32))  # what entropy() draws
    np.testing.assert_allclose(TN.entropy(T_(logits), T_(noise)).numpy(),
                               np.asarray(JN.entropy(key, jnp.asarray(logits))), rtol=1e-6, atol=1e-5)


# -------------------------------------------------------------- normalizer
def _stats_pair(rng):
    js = JRS.init({"a": 4, "b": 2}, dtype=jnp.float32)
    ts = TRS.init({"a": 4, "b": 2}, device="cpu")
    warm = {"a": _f32(rng, 32, 4, scale=2.0, loc=1.0), "b": _f32(rng, 32, 2, scale=0.5, loc=-3.0)}
    return (JRS.update(js, {k: jnp.asarray(v) for k, v in warm.items()}),
            TRS.update(ts, {k: T_(v) for k, v in warm.items()}))


def _assert_stats(ts, js, **tol):
    """mean and std within `tol`. summed_var within 1e-5 relative: one ulp
    of difference in the new mean (the two sides sum in different orders)
    enters it times sum(x - old mean), measured 3.6e-6 relative here."""
    np.testing.assert_allclose(float(ts.count), float(js.count))
    for field in ("mean", "summed_var", "std"):
        for k in ("a", "b"):
            np.testing.assert_allclose(
                getattr(ts, field)[k].numpy(), np.asarray(getattr(js, field)[k]), err_msg=f"{field}[{k}]",
                **(dict(rtol=1e-5) if field == "summed_var" else tol))


def test_running_stats_update_matches_jax():
    rng = np.random.default_rng(1)
    js, ts = _stats_pair(rng)
    _assert_stats(ts, js, rtol=1e-6, atol=1e-6)
    batch = {"a": _f32(rng, 7, 16, 4, scale=2.5, loc=1.5), "b": _f32(rng, 7, 16, 2, loc=-2.0)}
    js = JRS.update(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts = TRS.update(ts, {k: T_(v) for k, v in batch.items()})
    _assert_stats(ts, js, rtol=2e-6, atol=1e-6)
    # a constant feature keeps the 1e-6 floor under the root, and summed_var >= 0
    c = TRS.update(TRS.init({"a": 1}, device="cpu"), {"a": torch.full((8, 1), 3.0)})
    assert float(c.summed_var["a"]) >= 0 and float(c.std["a"]) == pytest.approx(1e-3, rel=1e-3)


def test_merge_moments_equals_update_and_jax():
    rng = np.random.default_rng(2)
    js, ts = _stats_pair(rng)
    Tn, B = 7, 16
    batch = {"a": _f32(rng, Tn, B, 4, scale=2.5, loc=1.5), "b": _f32(rng, Tn, B, 2, loc=-2.0)}
    direct = TRS.update(ts, {k: T_(v) for k, v in batch.items()})
    jm, tm = JRS.zero_moments(js), TRS.zero_moments(ts)
    for t in range(Tn):
        jm = JRS.accumulate_moments(js, jm, {k: jnp.asarray(v[t]) for k, v in batch.items()})
        tm = TRS.accumulate_moments(ts, tm, {k: T_(v[t]) for k, v in batch.items()})
    jfused = JRS.merge_moments(js, jnp.asarray(Tn * B, jnp.float32), *jm)
    fused = TRS.merge_moments(ts, float(Tn * B), *tm)
    _assert_stats(fused, jfused, rtol=2e-6, atol=1e-6)
    for k in ("a", "b"):  # == update, to the rounding of two different sums
        np.testing.assert_allclose(fused.mean[k].numpy(), direct.mean[k].numpy(), rtol=1e-5)
        np.testing.assert_allclose(fused.std[k].numpy(), direct.std[k].numpy(), rtol=1e-5)


# --------------------------------------------------------------------- GAE
def _rollout_flags(rng, Tn, B):
    done = (rng.random((Tn, B)) < 0.15).astype(np.float32)
    truncation = done * (rng.random((Tn, B)) < 0.5)  # a truncated step is also done
    return done, truncation.astype(np.float32)


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(3)
    Tn, B = 20, 12
    done, truncation = _rollout_flags(rng, Tn, B)
    termination = done * (1 - truncation)
    assert termination[1:-1].sum() > 0 and truncation[1:-1].sum() > 0  # both occur mid-unroll
    rewards, values, boot = _f32(rng, Tn, B), _f32(rng, Tn, B, scale=2.0), _f32(rng, B, scale=2.0)
    want = JG.compute_gae(*(jnp.asarray(x) for x in (truncation, termination, rewards, values, boot)),
                          lambda_=0.95, discount=0.97)
    values_t = T_(values).requires_grad_()
    got = TG.compute_gae(T_(truncation), T_(termination), T_(rewards), values_t, T_(boot),
                         lambda_=0.95, discount=0.97)
    for g, w in zip(got, want):
        assert not g.requires_grad  # detached, as stop_gradient
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=2e-6)
    np.testing.assert_array_equal(got[1].numpy()[truncation > 0], 0.0)  # truncation cuts credit


# ------------------------------------------------------ loss and gradients
OBS = {"state": 12, "privileged_state": 20}
ACT, HID_P, HID_V = 4, (32, 32), (48, 48)
CFG = PPOConfig(num_envs=16, batch_size=8, num_minibatches=2, unroll_length=6,
                policy_hidden_layer_sizes=HID_P, value_hidden_layer_sizes=HID_V)


def _jax_loss(net, params, normalizer, data, final_obs, ent_key, cfg, debug_loss_metrics=False):
    """`loss_fn` of open_duck_playground_tpu/train/ppo.py:217-287, which is a
    closure of `train` and cannot be called: composed here line for line
    from the package's public functions."""
    norm_obs = JRS.normalize(normalizer, data["obs"])  # :224
    logits = net.policy_logits(params, norm_obs)  # :225
    baseline = net.value(params, norm_obs)  # :226
    bootstrap = net.value(params, JRS.normalize(normalizer, final_obs))  # :227-228
    rewards = data["reward"] * cfg.reward_scaling  # :230
    truncation = data["truncation"]  # :231
    termination = data["done"] * (1 - truncation)  # :232
    target_lp = JN.log_prob(logits, data["raw_action"])  # :234
    behaviour_lp = data["log_prob"]  # :235
    vs, advantages = JG.compute_gae(  # :237-248
        truncation=truncation, termination=termination, rewards=rewards, values=baseline,
        bootstrap_value=bootstrap, lambda_=cfg.gae_lambda, discount=cfg.discounting,
        unroll=cfg.unroll_length)
    advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)  # :250
    rho = jnp.exp(target_lp - behaviour_lp)  # :251
    surrogate = rho * advantages  # :252
    clipped = jnp.clip(rho, 1 - cfg.clipping_epsilon, 1 + cfg.clipping_epsilon) * advantages  # :253-255
    policy_loss = -jnp.mean(jnp.minimum(surrogate, clipped))  # :256
    v_error = vs - baseline  # :258
    v_loss = jnp.mean(v_error * v_error) * 0.5 * 0.5  # :259
    ent = jnp.mean(JN.entropy(ent_key, logits))  # :261
    entropy_loss = -cfg.entropy_cost * ent  # :262
    total = policy_loss + v_loss + entropy_loss  # :264
    out = {"total_loss": total, "policy_loss": policy_loss, "v_loss": v_loss, "entropy_loss": entropy_loss}
    if debug_loss_metrics:  # :271-286
        am = lambda x: jnp.abs(x).max()
        out.update(obs_absmax=am(data["obs"]["state"]), pobs_absmax=am(data["obs"]["privileged_state"]),
                   normobs_absmax=am(norm_obs["state"]), pnormobs_absmax=am(norm_obs["privileged_state"]),
                   baseline_absmax=am(baseline), bootstrap_absmax=am(bootstrap), vs_absmax=am(vs),
                   adv_absmax=am(advantages), rho_max=rho.max(), lp_absmax=am(target_lp),
                   blp_absmax=am(behaviour_lp), ent=ent)
    return total, out


@pytest.fixture(scope="module")
def loss_case():
    rng = np.random.default_rng(4)
    Tn, MB = CFG.unroll_length, CFG.batch_size
    net = JN.PPONetworks(OBS, ACT, HID_P, HID_V)
    params = net.init(jax.random.PRNGKey(0))
    # biases off zero, so their gradients matter too
    params = jax.tree.map(lambda x: x + 0.05 * jnp.asarray(_f32(rng, *x.shape)), params)
    normalizer = JRS.update(JRS.init(OBS, dtype=jnp.float32),
                            {k: jnp.asarray(_f32(rng, 64, n, scale=1.5, loc=0.3)) for k, n in OBS.items()})
    obs = {k: _f32(rng, Tn, MB, n, scale=1.5, loc=0.3) for k, n in OBS.items()}
    final_obs = {k: _f32(rng, MB, n, scale=1.5, loc=0.3) for k, n in OBS.items()}
    raw = _f32(rng, Tn, MB, ACT)
    done, truncation = _rollout_flags(rng, Tn, MB)
    # behaviour log-probs of a slightly different policy, so rho is off 1 and the clip bites
    old = jax.tree.map(lambda x: x * 1.1, params)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    behaviour = JN.log_prob(net.policy_logits(old, JRS.normalize(normalizer, jobs)), jnp.asarray(raw))
    data = {"obs": obs, "raw_action": raw, "log_prob": np.asarray(behaviour),
            "reward": _f32(rng, Tn, MB, scale=0.5, loc=0.5), "done": done, "truncation": truncation}
    return net, params, normalizer, data, final_obs


def _port_side(params, normalizer):
    tnet = networks_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tnorm = normalizer_from_jax(jax.tree.map(np.asarray, normalizer), device="cpu")
    return tnet, tnorm


def _param_pairs(tnet, tree):
    """(name, port tensor, JAX array in the port's layout) per parameter."""
    for mlp, name in ((tnet.policy, "policy"), (tnet.value_mlp, "value")):
        for i, layer in enumerate(mlp.layers):
            p = tree[name][f"hidden_{i}"]
            yield f"{name}.{i}.kernel", layer.weight, np.asarray(p["kernel"]).T
            yield f"{name}.{i}.bias", layer.bias, np.asarray(p["bias"])


def test_loss_and_gradients_match_jax(loss_case):
    net, params, normalizer, data, final_obs = loss_case
    ent_key = jax.random.PRNGKey(9)
    jdata = jax.tree.map(jnp.asarray, data)
    jfinal = jax.tree.map(jnp.asarray, final_obs)
    (_, want), grads = jax.value_and_grad(
        lambda p: _jax_loss(net, p, normalizer, jdata, jfinal, ent_key, CFG), has_aux=True)(params)
    clipped = np.asarray(jnp.exp(JN.log_prob(
        net.policy_logits(params, JRS.normalize(normalizer, jdata["obs"])), jdata["raw_action"])
        - jdata["log_prob"]))
    assert ((clipped < 0.7) | (clipped > 1.3)).mean() > 0.05  # the clip is in play

    tnet, tnorm = _port_side(params, normalizer)
    noise = np.asarray(jax.random.normal(ent_key, data["raw_action"].shape, jnp.float32))
    tdata = {k: T_(v) for k, v in data.items() if k != "obs"}
    tdata["obs"] = {k: T_(v) for k, v in data["obs"].items()}
    total, got, maxima = ppo.loss_fn(tnet, tnorm, tdata, {k: T_(v) for k, v in final_obs.items()}, T_(noise),
                                     CFG)
    assert maxima == {}
    for k, w in want.items():
        assert float(got[k].detach()) == pytest.approx(float(w), rel=1e-5), k
    total.backward()
    for name, p, g in _param_pairs(tnet, grads):
        assert np.abs(p.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max(), name


def test_debug_loss_metrics_match_jax(loss_case):
    """`debug_loss_metrics`: the JAX trainer's 12 diagnostics (ppo.py:271-286)
    on the minibatch of `loss_case` with JAX's entropy draw injected, 1e-5
    relative like the loss terms (the abs-max of the raw obs exactly); and
    the same metric names from JAX `ppo.train` and the port's on the toy
    env, where the port refused the option before (TypeError)."""
    from test_train import PointEnv as JPointEnv

    net, params, normalizer, data, final_obs = loss_case
    ent_key = jax.random.PRNGKey(9)
    _, want = _jax_loss(net, params, normalizer, jax.tree.map(jnp.asarray, data),
                        jax.tree.map(jnp.asarray, final_obs), ent_key, CFG, debug_loss_metrics=True)
    tnet, tnorm = _port_side(params, normalizer)
    noise = np.asarray(jax.random.normal(ent_key, data["raw_action"].shape, jnp.float32))
    tdata = {k: T_(v) for k, v in data.items() if k != "obs"}
    tdata["obs"] = {k: T_(v) for k, v in data["obs"].items()}
    _, got, maxima = ppo.loss_fn(tnet, tnorm, tdata, {k: T_(v) for k, v in final_obs.items()}, T_(noise),
                                 CFG, debug_loss_metrics=True)
    assert set(got) == {"total_loss", "policy_loss", "v_loss", "entropy_loss", "ent"}
    assert set(maxima) == {k for k in want if k.endswith("_absmax")} | {"rho_max"} and len(maxima) == 11
    got.update(maxima)
    assert set(got) == set(want) and len(want) == 4 + 12
    for k in ("obs_absmax", "pobs_absmax", "blp_absmax"):
        assert float(got[k]) == float(want[k]), k
    for k, w in want.items():
        assert float(got[k].detach()) == pytest.approx(float(w), rel=1e-5), k

    toy = dict(num_envs=8, episode_length=5, unroll_length=2, num_minibatches=2, batch_size=4,
               num_updates_per_batch=1, seed=0, policy_hidden_layer_sizes=(4,), value_hidden_layer_sizes=(4,))
    _, _, jm = JPPO.train(JPointEnv(), num_timesteps=16, debug_loss_metrics=True, **toy)
    _, _, tm = ppo.train(PointEnv(), 16, device="cpu", debug_loss_metrics=True, **toy)
    assert set(tm) == set(jm) and {"training/obs_absmax", "training/rho_max", "training/ent"} <= set(tm)
    assert all(np.isfinite(v) for v in tm.values())


class _OneRank:
    """A one-rank mesh: its all-reduce is an identity, as one gloo or NCCL
    rank's sum is. Counts its calls."""
    world_size, rank = 1, 0

    def __init__(self):
        self.calls = 0

    def all_reduce(self, tensors, op="sum"):
        self.calls += 1
        return [t.clone() for t in tensors]


@pytest.mark.parametrize("debug_loss_metrics", [False, True], ids=["plain", "debug_loss_metrics"])
def test_a_one_rank_mesh_computes_the_loss_of_no_mesh(loss_case, debug_loss_metrics):
    """`loss_fn` under a one-rank mesh takes the mesh's path (sums over the
    minibatch's count, the advantages' mean and variance all-reduced) and
    gives the no-mesh loss, metrics and gradients bit for bit. The rewards
    are drawn anew: on `loss_case`'s own, PyTorch's `mean()` and one-pass
    `std()` happen to round as the two sums do."""
    net, params, normalizer, data, final_obs = loss_case
    rng = np.random.default_rng(9)
    tdata = {k: T_(v) for k, v in data.items() if k != "obs"}
    tdata["obs"] = {k: T_(v) for k, v in data["obs"].items()}
    tdata["reward"] = T_(_f32(rng, *data["reward"].shape, scale=0.5, loc=0.5))
    tfinal = {k: T_(v) for k, v in final_obs.items()}
    noise = T_(_f32(rng, *data["raw_action"].shape))
    mesh = _OneRank()
    out = []
    for m in (None, mesh):
        tnet, tnorm = _port_side(params, normalizer)
        total, metrics, maxima = ppo.loss_fn(tnet, tnorm, tdata, tfinal, noise, CFG, mesh=m,
                                             debug_loss_metrics=debug_loss_metrics)
        total.backward()
        out.append(({**metrics, **maxima}, [p.grad for p in tnet.parameters()]))
    assert mesh.calls == 2  # the advantages' mean, then their variance
    (want, want_grads), (got, got_grads) = out
    assert set(got) == set(want) and len(want) == (16 if debug_loss_metrics else 4)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert len(got_grads) == len(want_grads) > 0
    for g, w in zip(got_grads, want_grads):
        assert torch.equal(g, w)


@pytest.mark.parametrize("scale", [40.0, 0.02], ids=["norm_above_1", "norm_below_1"])
def test_optimizer_step_matches_optax(loss_case, scale):
    """Two steps from the same gradients through optax.chain(
    clip_by_global_norm(1.0), adam(3e-4)) (ppo.py:149-153) and through
    `apply_gradients`; the second step exercises Adam's carried moments."""
    _, params, normalizer, _, _ = loss_case
    rng = np.random.default_rng(6)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-4))
    opt_state = tx.init(params)
    tnet, tnorm = _port_side(params, normalizer)
    ts = ppo.TrainingState(net=tnet, optimizer=ppo.make_optimizer(tnet, 3e-4), normalizer=tnorm)
    for step in range(2):
        grads = jax.tree.map(lambda x: jnp.asarray((scale * _f32(rng, *x.shape) / np.sqrt(x.size)).astype(np.float32)), params)
        norm = float(optax.global_norm(grads))
        assert (norm > 1.0) == (scale > 1.0)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for _, p, g in _param_pairs(tnet, grads):
            p.grad = T_(np.ascontiguousarray(g))
        norms = ppo.apply_gradients(ts, 1.0)
        assert float(norms["grad_norm"]) == pytest.approx(norm, rel=1e-6)
        for name, p, w in _param_pairs(tnet, params):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-7, err_msg=f"{name} step {step}")


# ------------------------------------------- minibatches and the k contract
def test_minibatch_gather_matches_reference_shuffle():
    """`minibatch` takes each minibatch's envs out of the time-major data by
    permuted indices; its contents equal the shuffle it replaces (env-major
    transpose, permutation over envs, reshape into minibatches), as
    tests/test_train.py pins for the JAX trainer."""
    Tn, B, F, nmb = 3, 8, 5, 4
    mb = B // nmb
    x = torch.arange(Tn * B * F, dtype=torch.float32).reshape(Tn, B, F)
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(3))
    ref = x.transpose(0, 1)[perm].reshape(nmb, mb, Tn, F)
    data = {"reward": x[..., 0], "obs": {"state": x}}
    final = {"state": x[0]}
    for i in range(nmb):
        got, fin = ppo.minibatch(data, final, perm[i * mb : (i + 1) * mb])
        assert torch.equal(got["obs"]["state"], ref[i].transpose(0, 1))
        assert torch.equal(got["reward"], ref[i].transpose(0, 1)[..., 0])
        assert torch.equal(fin["state"], x[0][perm[i * mb : (i + 1) * mb]])


def test_k_unroll_segments_match_jax_formulation():
    """to_segments against the jnp code of ppo.py:327-341 at k = 2."""
    k, Tn, E, F = 2, 3, 4, 5
    x = np.arange(k * Tn * E * F, dtype=np.float32).reshape(k * Tn, E, F)
    fin = -np.arange(E * F, dtype=np.float32).reshape(E, F)

    def jseg(a):  # :329-332
        a = a.reshape((k, Tn) + a.shape[1:])
        a = jnp.swapaxes(a, 0, 1)
        return a.reshape((Tn, k * E) + a.shape[3:])

    jx, jfin = jnp.asarray(x), jnp.asarray(fin)
    want_fin = jnp.concatenate([jx[Tn::Tn][: k - 1], jfin[None]], axis=0).reshape((k * E,) + jfin.shape[1:])
    data = {"reward": T_(x[..., 0]), "obs": {"state": T_(x)}}
    got, got_fin = ppo.to_segments(data, {"state": T_(fin)}, k, Tn)
    np.testing.assert_array_equal(got["obs"]["state"].numpy(), np.asarray(jseg(jx)))
    np.testing.assert_array_equal(got["reward"].numpy(), np.asarray(jseg(jx[..., 0])))
    np.testing.assert_array_equal(got_fin["state"].numpy(), np.asarray(want_fin))
    # segment j of env e is trajectory j*E + e, and its bootstrap obs is the next segment's first
    assert torch.equal(got["obs"]["state"][:, 1 * E + 2], T_(x[Tn:, 2]))
    assert torch.equal(got_fin["state"][0 * E + 2], T_(x[Tn, 2]))


def test_config_contract_and_unported_requests():
    """The rollout contract; and no option of the JAX trainer is refused any
    more: a mesh is taken, and its world must divide num_envs (JAX
    ppo.py:119)."""
    from open_duck_playground_torch.parallel.mesh import Mesh

    assert PPOConfig().k_unrolls == 1 and PPOConfig().steps_per_training_step == 8192 * 20
    assert PPOConfig(num_envs=16, batch_size=8, num_minibatches=4).k_unrolls == 2
    assert PPOConfig(action_repeat=2).steps_per_training_step == 2 * 8192 * 20
    with pytest.raises(ValueError):
        PPOConfig(num_envs=16, batch_size=8, num_minibatches=3).k_unrolls
    with pytest.raises(ValueError):
        PPOConfig(num_envs=16, batch_size=4, num_minibatches=2).k_unrolls
    with pytest.raises(ValueError, match="do not shard"):
        ppo.train(PointEnv(), 10, device="cpu", mesh=Mesh(3, 0, torch.device("cpu")), **TOY)


# ----------------------------------------------------------------- toy env
class PointEnv:
    """The toy env of tests/test_train.py, batched: move a point to the
    origin, reward 1 - |pos| per step."""

    action_size = 2
    model = None

    def reset_draws(self, gen, batch):
        return 2.0 * torch.rand((batch, 2), generator=gen) - 1.0

    def step_draws(self, gen, batch):
        return None

    def _obs(self, pos):
        o = torch.cat([pos, torch.zeros_like(pos)], -1)
        return {"state": o, "privileged_state": o.clone()}

    def reset(self, draws, model=None):
        pos = draws
        z = torch.zeros_like(pos)
        empty = torch.zeros((pos.shape[0], 0))
        data = Data(qpos=pos, qvel=z, ctrl=z, qacc=z, qacc_warmstart=z, site_xpos=empty,
                    site_xmat=empty, actuator_force=empty, contact_dist=empty, sensordata=empty)
        zero = torch.zeros(pos.shape[0])
        return State(data=data, obs=self._obs(pos), reward=zero, done=zero.clone(), metrics={}, info={})

    def step(self, state, action, draws, model=None):
        pos = state.data.qpos + 0.1 * action
        reward = 1.0 - torch.linalg.vector_norm(pos, dim=-1)
        return state.replace(data=state.data.replace(qpos=pos), obs=self._obs(pos), reward=reward,
                             done=torch.zeros_like(reward))


TOY = dict(num_envs=32, episode_length=50, unroll_length=10, num_minibatches=4, batch_size=8,
           num_updates_per_batch=2, learning_rate=3e-3, num_evals=1, seed=0,
           policy_hidden_layer_sizes=(32, 32), value_hidden_layer_sizes=(32, 32))


def test_ppo_learns_toy_env():
    """Same sizes and measure as tests/test_train.py::test_ppo_learns_toy_env:
    the eval episode reward (16 envs, 50 steps) of the last of 4 evals beats
    the initial eval's by more than 10. A point that reaches the origin and
    stays earns ~0.9 a step, a random walk from U(-1, 1)^2 about 0.2."""
    rewards, seen = [], []

    def progress(step, metrics):
        seen.append(step)
        if "eval/episode_reward" in metrics:
            rewards.append(float(metrics["eval/episode_reward"]))

    make_policy, (normalizer, net), metrics = ppo.train(
        PointEnv(), 40_000, device="cpu", progress_fn=progress,
        **{**TOY, "num_evals": 4, "num_eval_envs": 16})
    assert rewards[-1] > rewards[0] + 10, rewards
    # 40,000 steps over 3 periods after the initial eval: 42 training steps of 320 each
    assert seen == [0, 13_440, 26_880, 40_320] and float(normalizer.count) == 40_320
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["training/sps"] > 0
    policy = make_policy((normalizer, net), deterministic=True)
    a, extras = policy({"state": torch.ones(1, 4), "privileged_state": torch.ones(1, 4)})
    assert a.shape == (1, 2) and bool((a.abs() <= 1).all()) and extras == {}
    a, extras = make_policy((normalizer, net))({"state": torch.ones(3, 4), "privileged_state": torch.ones(3, 4)},
                                              torch.zeros(3, 2))
    np.testing.assert_allclose(a.numpy(), np.tanh(extras["raw_action"].numpy()), rtol=1e-6)
    assert extras["log_prob"].shape == (3,)


def test_training_step_k2_contract_and_replayed_draws():
    """k = 2 (batch_size * num_minibatches = 2 * num_envs): one training step
    rolls out 2 * unroll_length steps per env, counts every frame in the
    normalizer and in env_steps, and with the draws injected two runs from
    the same state give the same parameters bit for bit."""
    cfg = PPOConfig(**{**TOY, "num_envs": 16})
    assert cfg.k_unrolls == 2
    env = PointEnv()

    def run():
        gen = torch.Generator().manual_seed(1)
        train_env = TrainingEnv(env, cfg.episode_length)
        state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
        ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device="cpu")
        L = cfg.k_unrolls * cfg.unroll_length
        unroll = ppo.unroll_draws(env, cfg.num_envs, L, gen)
        assert unroll.action_noise.shape == (L, cfg.num_envs, 2) and len(unroll.env) == L
        sgd = ppo.sgd_draws(cfg, env.action_size, gen)
        ts, state, metrics = ppo.training_step(ts, train_env, env, state, cfg, None, unroll, sgd)
        return ts, metrics

    (a, ma), (b, mb) = run(), run()
    assert a.env_steps == 2 * 16 * 10 and float(a.normalizer.count) == 2 * 16 * 10
    for pa, pb in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(pa, pb)
    assert set(ma) == {"total_loss", "policy_loss", "v_loss", "entropy_loss", "grad_norm",
                       "params_norm", "reward_mean"}
    assert all(torch.isfinite(v) for v in ma.values()) and float(ma["total_loss"]) == float(mb["total_loss"])


class ModelRecorder:
    """An env that records the model each reset and step is handed."""

    def __init__(self, env):
        self.env, self.models = env, []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, draws, model=None):
        self.models.append(model)
        return self.env.reset(draws, model=model)

    def step(self, state, action, draws, model=None):
        self.models.append(model)
        return self.env.step(state, action, draws, model=model)


TINY_JOYSTICK = dict(num_envs=4, episode_length=6, unroll_length=2, num_minibatches=2, batch_size=2,
                     num_updates_per_batch=1, num_evals=1, policy_hidden_layer_sizes=(8,),
                     value_hidden_layer_sizes=(8,))


def test_train_defaults_to_the_nominal_model():
    """JAX `train(randomization_fn=None)` trains on the nominal model
    (ppo.py:92, wrappers.py:65-71): so does the port's, unless given
    `domain_randomize`, which draws per-env fields from the trainer's
    generator first (the stream of the port's earlier default)."""
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize

    env = ModelRecorder(Joystick("flat_terrain_backlash", device="cpu"))
    ppo.train(env, 8, device="cpu", **TINY_JOYSTICK)
    assert len(env.models) == 1 + 2 and all(m is env.model for m in env.models)

    env.models.clear()
    ppo.train(env, 8, device="cpu", randomization_fn=domain_randomize, **TINY_JOYSTICK)
    want = domain_randomize(env.model, DRDraws.sample(torch.Generator().manual_seed(0), 4, env.model.spec))
    m = env.models[0]
    assert all(x is m for x in env.models) and m is not env.model
    assert torch.equal(m.body_mass, want.body_mass) and m.body_mass.shape[0] == 4


def test_training_env_randomizes_only_with_its_function():
    """`TrainingEnv` has no default randomization: `randomization_fn` and
    `dr_draws` come together (the model `randomization_fn(model, draws)`),
    or neither comes (the nominal model); one without the other raises."""
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize

    env = Joystick("flat_terrain_backlash", device="cpu")
    draws = DRDraws.sample(torch.Generator().manual_seed(3), 4, env.model.spec)
    calls = []

    def randomize(model, d):
        calls.append(d)
        return domain_randomize(model, d)

    assert TrainingEnv(env, 10)._model is env.model
    wrapped = TrainingEnv(env, 10, dr_draws=draws, randomization_fn=randomize)
    assert calls == [draws] and torch.equal(wrapped._model.body_mass,
                                            domain_randomize(env.model, draws).body_mass)
    for kwargs in ({"dr_draws": draws}, {"randomization_fn": domain_randomize}):
        with pytest.raises(ValueError, match="go together"):
            TrainingEnv(env, 10, **kwargs)


# ----------------------------------------------------------- the schedule
SCHEDULE = dict(num_envs=8, episode_length=5, unroll_length=2, num_minibatches=2, batch_size=4,
                num_updates_per_batch=1, num_eval_envs=8, seed=0, policy_hidden_layer_sizes=(4,),
                value_hidden_layer_sizes=(4,))


@pytest.mark.parametrize("max_env_steps_per_jit", [None, 32], ids=["one_chunk", "chunks_of_2"])
@pytest.mark.parametrize("num_evals", [1, 2, 4])
def test_hook_steps_match_jax_schedule(num_evals, max_env_steps_per_jit):
    """The env steps passed to progress_fn and policy_params_fn by JAX
    `ppo.train` and by the port's, on the toy env: an initial eval when
    num_evals > 1, then per period the training steps of the JAX
    arithmetic (ppo.py:460-474; 200 steps of 16 give 5 per period in one
    chunk, 6 in chunks of at most 2 steps)."""
    from test_train import PointEnv as JPointEnv

    def run(train, env, **kw):
        seen = []
        train(env, num_timesteps=200, num_evals=num_evals, max_env_steps_per_jit=max_env_steps_per_jit,
              progress_fn=lambda step, m: seen.append(("progress", int(step), "eval/episode_reward" in m)),
              policy_params_fn=lambda step, make_policy, variables, full_state=None: seen.append(
                  ("params", int(step), full_state is not None)), **SCHEDULE, **kw)
        return seen

    want = run(JPPO.train, JPointEnv())
    got = run(ppo.train, PointEnv(), device="cpu")
    assert got == want and len(want) == 2 * (num_evals if num_evals > 1 else 1)


# ---------------------------------------------- EvalEnv and action repeat
class _JaxCounter:
    """Deterministic toy env (JAX side): a counter t per env; done from the
    step at which t reaches the env's period 2 + floor(12 u), u drawn at
    reset; reward and metrics from t, u and the action."""

    action_size = 2
    model = None

    def _state(self, t, u, reward, done):
        pos = jnp.stack([t, u])
        z = jnp.zeros(2, jnp.float32)
        data = JT.Data(qpos=pos, qvel=z, ctrl=z, qacc=z, qacc_warmstart=z)
        return JET.State(data=data, obs={"state": pos}, reward=reward, done=done,
                         metrics={"a": reward * 0.5, "tracking_err/t": t}, info={})

    def reset(self, rng, model=None):
        u = jax.random.uniform(rng, (), jnp.float32)
        return self._state(jnp.zeros((), jnp.float32), u, jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))

    def step(self, state, action, model=None):
        t, u = state.data.qpos[0] + 1.0, state.data.qpos[1]
        reward = t * u * (1.0 + jnp.sum(action))
        done = (t >= 2.0 + jnp.floor(12.0 * u)).astype(jnp.float32)
        return self._state(t, u, reward.astype(jnp.float32), done)


class _TorchCounter:
    """The port's twin of _JaxCounter; `reset` takes the u draws."""

    action_size = 2
    model = None

    def step_draws(self, gen, batch):
        return None

    def _state(self, t, u, reward, done):
        pos = torch.stack([t, u], -1)
        z = torch.zeros_like(pos)
        empty = torch.zeros((pos.shape[0], 0))
        data = Data(qpos=pos, qvel=z, ctrl=z, qacc=z, qacc_warmstart=z, site_xpos=empty,
                    site_xmat=empty, actuator_force=empty, contact_dist=empty, sensordata=empty)
        return State(data=data, obs={"state": pos}, reward=reward, done=done,
                     metrics={"a": reward * 0.5, "tracking_err/t": t}, info={})

    def reset(self, u, model=None):
        z = torch.zeros_like(u)
        return self._state(z, u, z, z.clone())

    def step(self, state, action, draws, model=None):
        t, u = state.data.qpos[:, 0] + 1.0, state.data.qpos[:, 1]
        reward = t * u * (1.0 + action.sum(-1))
        done = (t >= 2.0 + torch.floor(12.0 * u)).to(torch.float32)
        return self._state(t, u, reward, done)


@pytest.mark.parametrize("action_repeat", [1, 2])
def test_eval_env_and_action_repeat_match_jax(action_repeat):
    """12 steps of 6 envs through JAX's EvalEnv and the port's, episode
    length 9: rewards, dones, truncations, step counts and the eval sums
    (frozen after an env's first done) agree; the action changes every
    step, so a repeat runs the same action twice."""
    _eval_env_matches_jax(action_repeat, lambda tev, state, action, draws: tev.step(state, action, draws))


@pytest.mark.parametrize("action_repeat", [1, 2])
def test_eval_env_and_action_repeat_match_jax_through_the_wrapper_kernels(action_repeat):
    """The same through the wrapper's two kernels (`envs/wrapper_kernel.py`,
    the body the card runs), built for the host (`csrc/wrapper_step_host.cpp`):
    the autoreset, truncation and eval sums held against JAX's EvalEnv at
    the same tolerances."""
    lib = wrapper_host_library()
    _eval_env_matches_jax(action_repeat, lambda tev, state, action, draws:
                          fused_wrapper_step(tev, state, action, draws, lib))


def _eval_env_matches_jax(action_repeat, step):
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    jev = JW.EvalEnv(_JaxCounter(), episode_length=9, action_repeat=action_repeat)
    tev = EvalEnv(_TorchCounter(), episode_length=9, action_repeat=action_repeat)
    jstate = jax.jit(jev.reset)(keys)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(keys))
    tstate = tev.reset(T_(u))
    jstep = jax.jit(jev.step)
    gen = torch.Generator().manual_seed(0)
    dones = truncations = 0
    for i in range(12):
        action = np.full((6, 2), 0.1 * (i % 3), np.float32)
        jstate = jstep(jstate, jnp.asarray(action))
        tstate = step(tev, tstate, T_(action), tev.step_draws(gen, 6))
        np.testing.assert_allclose(tstate.reward.numpy(), np.asarray(jstate.reward), rtol=1e-6)
        for got, want in ((tstate.done, jstate.done), (tstate.info["truncation"], jstate.info["truncation"]),
                          (tstate.info["steps"], jstate.info["steps"]), (tstate.data.qpos, jstate.data.qpos)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jem, tem = jstate.info["eval_metrics"], tstate.info["eval_metrics"]
        for k in ("episode_reward", "episode_length", "episode_done"):
            np.testing.assert_allclose(tem[k].numpy(), np.asarray(jem[k]), rtol=1e-6, err_msg=k)
        for k in ("a", "tracking_err/t"):
            np.testing.assert_allclose(tem["episode_metrics"][k].numpy(), np.asarray(jem["episode_metrics"][k]),
                                       rtol=1e-6, err_msg=k)
        dones += int(tstate.done.sum())
        truncations += int(tstate.info["truncation"].sum())
    assert dones > 6 and truncations > 0  # both ways an episode ends
    assert float(tstate.info["eval_metrics"]["episode_done"].min()) == 1.0
