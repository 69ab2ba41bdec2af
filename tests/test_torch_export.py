"""The port's ONNX export against the JAX package's.

- Weights carried over from JAX (`interop`) export to the very bytes of the
  JAX exporter's file (`build_policy_onnx` through `export_policy`).
- The port's numpy `OnnxPolicy` on that file equals the port's deterministic
  action within 1e-5 absolute (float32 matrix products in two orders), and
  JAX's `OnnxPolicy` on it within the same.
- Both readers parse the repo's tf2onnx-built reference policy alike.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.export import onnx_export as JE
from open_duck_playground_tpu.export import onnx_runtime as JRT
from open_duck_playground_tpu.train import networks as JN
from open_duck_playground_tpu.train import running_stats as JRS

from open_duck_playground_torch.export import onnx_export as TE
from open_duck_playground_torch.export import onnx_proto as TP
from open_duck_playground_torch.export import onnx_runtime as TRT
from open_duck_playground_torch.interop import networks_from_jax, normalizer_from_jax
from open_duck_playground_torch.train import ppo

torch.set_num_threads(1)

OBS = {"state": 20, "privileged_state": 30}
ACT = 6
ATOL = 1e-5
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "duck_policy_fixture.onnx"


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The same weights exported by both packages, and 64 observations."""
    rng = np.random.default_rng(0)
    net = JN.PPONetworks(OBS, ACT, (32, 32, 32), (16,))
    params = net.init(jax.random.PRNGKey(1))
    params = jax.tree.map(lambda x: x + 0.05 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), params)
    normalizer = JRS.update(JRS.init(OBS, dtype=jnp.float32), {
        k: jnp.asarray(rng.normal(0.5, 2.0, (256, n)).astype(np.float32)) for k, n in OBS.items()})
    out = tmp_path_factory.mktemp("onnx")
    jpath, tpath = out / "jax.onnx", out / "port.onnx"
    JE.export_policy((normalizer, params), ACT, None, OBS["state"], str(jpath))
    variables = (normalizer_from_jax(jax.tree.map(np.asarray, normalizer), device="cpu"),
                 networks_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    TE.export_policy(variables, ACT, None, OBS["state"], str(tpath))
    obs = rng.normal(0.5, 2.5, (64, OBS["state"])).astype(np.float32)
    return jpath, tpath, variables, obs


def test_port_export_is_the_jax_exporters_bytes(exported):
    jpath, tpath, _, _ = exported
    assert tpath.read_bytes() == jpath.read_bytes()
    graph = TP.parse_model(tpath.read_bytes())
    assert graph["inputs"] == ["obs"] and graph["outputs"] == ["continuous_actions"]
    assert [n["op"] for n in graph["nodes"]][:2] == ["Sub", "Div"]


def test_onnx_policy_equals_the_torch_deterministic_action(exported):
    jpath, tpath, variables, obs = exported
    policy = ppo.make_policy(variables, deterministic=True)
    want = policy({"state": torch.as_tensor(obs), "privileged_state": torch.zeros(64, OBS["privileged_state"])})[0]
    got = TRT.OnnxPolicy(str(tpath)).infer(obs)
    assert got.shape == (64, ACT)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, JRT.OnnxPolicy(str(jpath)).infer(obs), rtol=0, atol=ATOL)
    np.testing.assert_allclose(TRT.OnnxPolicy(str(tpath)).infer(obs[0]), got[0], rtol=0, atol=ATOL)


def test_onnx_readers_agree_on_the_reference_policy():
    j, t = JRT.OnnxPolicy(str(FIXTURE)), TRT.OnnxPolicy(str(FIXTURE))
    assert [n["op"] for n in t.graph["nodes"]] == [n["op"] for n in j.graph["nodes"]]
    for name, arr in j.graph["initializers"].items():
        np.testing.assert_array_equal(t.graph["initializers"][name], arr, err_msg=name)
    obs = np.random.default_rng(2).uniform(-1, 1, (8, 101))  # the fixture's obs size
    np.testing.assert_array_equal(t.infer(obs), j.infer(obs))
