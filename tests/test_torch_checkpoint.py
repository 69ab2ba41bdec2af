"""The port's checkpoints, and a JAX checkpoint carried into the port.

- A JAX full training state (optax clip -> adam chain after three steps),
  written by the JAX package's `save_training_state` and read back with
  orbax to numpy, becomes the port's TrainingState through
  `interop.training_state_from_jax`; one more step on the same gradients
  gives the same parameters as optax within 1e-6 absolute (torch and optax
  round Adam differently, so not bitwise) and the same moments.
- A port save -> restore round trip is bitwise: parameters, Adam's step and
  moments, normalizer, env_steps, the generator's state.
- The legacy (normalizer, params) layout restores with Adam re-initialized
  and the steps at zero.
- The host copy handed to the hooks does not move when training goes on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_duck_playground_tpu.train import checkpoint as JCK
from open_duck_playground_tpu.train import networks as JN
from open_duck_playground_tpu.train import ppo as JPPO
from open_duck_playground_tpu.train import running_stats as JRS

from open_duck_playground_torch.interop import training_state_from_jax
from open_duck_playground_torch.train import checkpoint as CKPT
from open_duck_playground_torch.train import ppo

torch.set_num_threads(1)

OBS = {"state": 12, "privileged_state": 20}
ACT, LR = 4, 3e-4


def _grads(rng, params, scale):
    return jax.tree.map(
        lambda x: jnp.asarray((scale * rng.standard_normal(x.shape) / np.sqrt(x.size)).astype(np.float32)),
        params)


def _pairs(net, tree):
    """(port parameter, JAX leaf in the port's layout) per parameter."""
    for mlp, name in ((net.policy, "policy"), (net.value_mlp, "value")):
        for i, layer in enumerate(mlp.layers):
            leaf = tree[name][f"hidden_{i}"]
            yield layer.weight, np.asarray(leaf["kernel"]).T
            yield layer.bias, np.asarray(leaf["bias"])


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    rng = np.random.default_rng(0)
    net = JN.PPONetworks(OBS, ACT, (32, 32), (48, 48))
    params = net.init(jax.random.PRNGKey(0))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    opt_state = tx.init(params)
    for scale in (40.0, 0.5, 3.0):  # one step above the clip
        updates, opt_state = tx.update(_grads(rng, params, scale), opt_state, params)
        params = optax.apply_updates(params, updates)
    normalizer = JRS.update(JRS.init(OBS, dtype=jnp.float32), {
        k: jnp.asarray(rng.normal(0.3, 1.5, (64, n)).astype(np.float32)) for k, n in OBS.items()})
    ts = JPPO.TrainingState(params=params, opt_state=opt_state, normalizer=normalizer,
                            env_steps=jnp.asarray(491_520, jnp.int64))
    path = tmp_path_factory.mktemp("jax_ckpt") / "2026_01_01_000000_491520"
    JCK.save_training_state(path, ts, jax.random.PRNGKey(7))
    raw = jax.tree.map(np.asarray, JCK.restore(path))  # orbax, no target: nested dicts and lists
    return tx, ts, raw, rng


def test_jax_checkpoint_resumes_in_the_port(jax_checkpoint):
    tx, jts, raw, rng = jax_checkpoint
    ts = training_state_from_jax(raw, learning_rate=LR, device="cpu")
    assert ts.env_steps == 491_520 and float(ts.normalizer.count) == 64
    for layer_p, _ in _pairs(ts.net, raw["params"]):
        assert float(ts.optimizer.state[layer_p]["step"]) == 3.0
    grads = _grads(rng, jts.params, 2.0)
    updates, opt_state = tx.update(grads, jts.opt_state, jts.params)
    params = optax.apply_updates(jts.params, updates)
    for p, g in _pairs(ts.net, grads):
        p.grad = torch.as_tensor(np.ascontiguousarray(g))
    ppo.apply_gradients(ts, 1.0)
    for p, want in _pairs(ts.net, params):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=1e-6)
    adam = opt_state[1][0]
    for (p, mu), (_, nu) in zip(_pairs(ts.net, adam.mu), _pairs(ts.net, adam.nu)):
        st = ts.optimizer.state[p]
        assert float(st["step"]) == int(adam.count) == 4
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu, rtol=1e-5, atol=1e-12)


def _trained_state(seed=0):
    """A port TrainingState after two optimizer steps, and a generator."""
    gen = torch.Generator().manual_seed(seed)
    obs = {k: torch.randn(8, n, generator=gen) for k, n in OBS.items()}
    cfg = ppo.PPOConfig(policy_hidden_layer_sizes=(32, 32), value_hidden_layer_sizes=(48, 48))
    ts = ppo.init_training_state(obs, ACT, cfg, gen, device="cpu")
    for _ in range(2):
        for p in ts.net.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        ppo.apply_gradients(ts, 1.0)
    ts.normalizer = ppo.RS.update(ts.normalizer, obs)
    ts.env_steps = 327_680
    return ts, gen


def _equal_states(a, b):
    for (na, pa), (nb, pb) in zip(a.net.state_dict().items(), b.net.state_dict().items()):
        assert na == nb and torch.equal(pa, pb), na
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][field], sb["state"][k][field]), (k, field)
    for f in ("count", "mean", "summed_var", "std"):
        x, y = getattr(a.normalizer, f), getattr(b.normalizer, f)
        assert all(torch.equal(x[k], y[k]) for k in x) if isinstance(x, dict) else torch.equal(x, y), f
    assert a.env_steps == b.env_steps


def test_port_round_trip_is_bitwise(tmp_path):
    ts, gen = _trained_state()
    torch.rand(5, generator=gen)  # a generator state away from the seed
    path = tmp_path / "2026_01_01_000000_327680"
    CKPT.save_training_state(path, ts, gen.get_state())
    assert (path / CKPT.STATE_FILE).is_file()
    fresh, _ = _trained_state(seed=1)
    fresh.env_steps = 0
    restored, gen_state = CKPT.restore_training_state(path, fresh)
    _equal_states(restored, ts)
    assert torch.equal(gen_state, gen.get_state())
    # Adam goes on from the restored step: the same update on both
    for a, b in zip(ts.net.parameters(), restored.net.parameters()):
        a.grad = torch.ones_like(a)
        b.grad = torch.ones_like(b)
    ppo.apply_gradients(ts, 1.0)
    ppo.apply_gradients(restored, 1.0)
    _equal_states(restored, ts)


def test_legacy_layout_restores_with_adam_reinitialized(tmp_path):
    ts, _ = _trained_state()
    CKPT.save(tmp_path / "legacy", (ts.normalizer, ts.net))
    fresh, _ = _trained_state(seed=1)
    restored, gen_state = CKPT.restore_training_state(tmp_path / "legacy", fresh)
    assert gen_state is None and restored.env_steps == 0 and len(restored.optimizer.state) == 0
    for a, b in zip(restored.net.parameters(), ts.net.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(restored.normalizer.mean["state"], ts.normalizer.mean["state"])


def test_host_copy_is_a_snapshot():
    ts, gen = _trained_state()
    host = ppo.host_copy(ts)
    before = [p.clone() for p in host.net.parameters()]
    steps = [s["step"].clone() for s in host.optimizer.state.values()]
    for p in ts.net.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    ppo.apply_gradients(ts, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(before, host.net.parameters()))
    assert [s["step"] for s in host.optimizer.state.values()] == steps == [torch.tensor(2.0)] * len(steps)
    assert not any(torch.equal(a, b) for a, b in zip(before, ts.net.parameters()))
