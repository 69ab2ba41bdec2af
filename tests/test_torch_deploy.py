"""The port's deployment path against the JAX package's.

- `export.onnx_validate` against JAX's validator (which parses with the
  protobuf runtime): the same verdict on the repo's tf2onnx-built fixture,
  on a fresh export, and on a seeded corpus of mutations of a small export
  (truncations, tag and length bytes, a wrong `raw_data` length, wire-format
  edge cases), and the same summary dict on every blob both accept; the
  rejection cases of the JAX validator's own tests.
- `export.native_runtime` (the C++ runtime built with the host's compiler
  into build/host/) against the port's numpy `OnnxPolicy` and JAX's native
  runtime within 1e-5 (the JAX test's bound); a failed build raises.
- `utils.filters` against JAX's on a seeded action stream.
- Every module of the port imports with mujoco, matplotlib, google.protobuf,
  JAX and the JAX package blocked, as on the card's machine.
"""

import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from open_duck_playground_tpu.export import native_runtime as JNR
from open_duck_playground_tpu.export import onnx_schema_pb2 as pb
from open_duck_playground_tpu.export import onnx_validate as JV
from open_duck_playground_tpu.utils import filters as JF

from open_duck_playground_torch import cuda_build
from open_duck_playground_torch.export import native_runtime as TNR
from open_duck_playground_torch.export import onnx_export as TE
from open_duck_playground_torch.export import onnx_proto as OP
from open_duck_playground_torch.export import onnx_runtime as TRT
from open_duck_playground_torch.export import onnx_validate as TV
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig
from open_duck_playground_torch.utils import filters as TF

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "duck_policy_fixture.onnx"
ATOL = 1e-5


def verdict(validator, blob):
    """("ok", summary) or ("rejected", None); anything else propagates."""
    try:
        return "ok", validator.validate(blob)
    except ValueError:  # OnnxValidationError, or the protobuf runtime's enum lookup
        return "rejected", None


def small_export() -> bytes:
    """The exporter's graph for a 6 -> 4 -> 4 policy with 2 actions."""
    rng = np.random.default_rng(0)
    layers = [(rng.normal(size=(6, 4)).astype(np.float32), rng.normal(size=4).astype(np.float32)),
              (rng.normal(size=(4, 4)).astype(np.float32), rng.normal(size=4).astype(np.float32))]
    return TE.build_policy_onnx(np.zeros(6, np.float32), np.ones(6, np.float32), layers, 6, 2)


def _walk(buf: bytes, desc, base: int, tags: list, lengths: list) -> None:
    """Offsets of every tag and every length prefix in `buf`, descending
    into the message fields that the protobuf runtime's schema names."""
    pos = 0
    while pos < len(buf):
        tags.append(base + pos)
        key, pos = OP._read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            _, pos = OP._read_varint(buf, pos)
        elif wire in (1, 5):
            pos += 8 if wire == 1 else 4
        else:
            lengths.append(base + pos)
            n, pos = OP._read_varint(buf, pos)
            fd = desc.fields_by_number.get(number)
            if fd is not None and fd.message_type is not None:
                _walk(buf[pos:pos + n], fd.message_type, base + pos, tags, lengths)
            pos += n


def _nested(levels: int) -> bytes:
    """A valid model whose Tanh node carries a GRAPH attribute holding a
    graph -> node -> attribute -> graph ... chain, `levels` message levels
    deep below the model (the model's graph, its node and the attribute are
    the first 3)."""
    kinds = ["graph", "node", "attr"]
    chain = b""  # the innermost message, empty; then each one wraps the next
    for j in reversed(range(levels - 4)):
        chain = OP._len_field({"graph": 1, "node": 5, "attr": 6}[kinds[j % 3]], chain)
    attr = OP._str_field(1, "deep") + OP._len_field(6, chain) + OP._int_field(20, 5)  # type GRAPH
    node = OP._str_field(1, "x") + OP._str_field(2, "y") + OP._str_field(4, "Tanh") + OP._len_field(5, attr)
    return OP.model(OP.graph([node], "g", [], inputs=[OP.value_info("x", (1, 4))],
                             outputs=[OP.value_info("y", (1, 4))]))


def corpus(kind: str) -> list:
    blob = small_export()
    rng = random.Random(7)
    if kind == "truncations":
        return [blob[:k] for k in range(min(200, len(blob)))]
    tags, lengths = [], []
    _walk(blob, pb.ModelProto.DESCRIPTOR, 0, tags, lengths)
    swap = lambda p, b: blob[:p] + bytes([b & 0xFF]) + blob[p + 1:]
    if kind == "tags":
        out = []
        for p in tags:
            b = blob[p]
            for nb in (b ^ 0x08, (b & ~7) | rng.randrange(8), b | 0x80, b + 8, 0):
                out.append(swap(p, nb))
        return out
    if kind == "lengths":
        return [swap(p, nb) for p in lengths for nb in (blob[p] + 1, blob[p] - 1, 0, 0xFF, blob[p] | 0x80)]
    if kind == "bytes":  # single bytes anywhere, seeded
        return [swap(p, rng.randrange(256)) for p in (rng.randrange(len(blob)) for _ in range(150))]
    assert kind == "wire"
    graph = lambda init: OP.graph([OP.node("Tanh", ["x"], ["y"])], "g", init,
                                  inputs=[OP.value_info("x", (1, 4))],
                                  outputs=[OP.value_info("y", (1, 4))])
    raw_short = b"".join(OP._int_field(1, d) for d in (3, 4)) + OP._int_field(2, OP.FLOAT) \
        + OP._len_field(9, b"\0" * 44) + OP._str_field(8, "w")
    packed_dims = OP._len_field(1, OP._varint(3)) + OP._int_field(1, 4) + OP._int_field(2, OP.FLOAT) \
        + OP._len_field(9, b"\0" * 48) + OP._str_field(8, "w")
    unpacked_floats = OP._int_field(1, 2) + OP._int_field(2, OP.FLOAT) \
        + b"".join(OP._tag(4, 5) + np.float32(v).tobytes() for v in (1.0, 2.0)) + OP._str_field(8, "f")
    return [
        blob + OP._int_field(1, 7),  # a scalar twice: last wins
        blob + OP._int_field(1, 2),  # ... and the last is out of range
        blob + OP._len_field(7, b""),  # the graph again: merged
        blob + OP._len_field(7, OP._str_field(2, "renamed")),
        blob + OP._tag(1, 0) + b"\xff" * 9 + b"\x01",  # a 10-byte varint (-1)
        blob + OP._tag(1, 0) + b"\x87" + b"\x80" * 8 + b"\x00",  # 10 bytes, value 7
        blob + OP._tag(1, 0) + b"\x87" + b"\x80" * 9 + b"\x00",  # 11 bytes
        blob + b"\x88\x80\x80\x80\x00\x07",  # a 5-byte tag
        blob + b"\x88\x80\x80\x80\x80\x00\x07",  # a 6-byte tag
        blob + b"\x88\x80\x80\x80\x70\x07",  # a tag past 32 bits
        blob + b"\x00\x01",  # field number 0
        blob + OP._tag(99, 3) + OP._tag(99, 4),  # a group
        blob + OP._tag(1, 6) + b"\x00",
        blob + OP._tag(1, 7) + b"\x00",
        blob + OP._tag(99, 5) + b"\x00" * 4,  # an unknown fixed32
        blob + OP._tag(6, 2) + b"\x05ab",  # a length past the end
        blob + OP._len_field(2, b"\xff\xfe"),  # invalid UTF-8 in a string
        blob + OP._len_field(2, b"\xc0\x80"),  # overlong UTF-8
        blob + OP._len_field(2, "\U0001F986".encode()),  # valid 4-byte UTF-8
        blob + OP._int_field(2, 5),  # a string field as a varint
        blob + OP._len_field(1, b"\x07"),  # a singular int64 as length-delimited
        OP.model(graph([raw_short])),  # raw_data one float short
        OP.model(graph([packed_dims])),  # dims packed, then unpacked
        OP.model(graph([unpacked_floats])),  # float_data unpacked
        OP.model(graph([OP.tensor("w", np.zeros((2, 2), np.float32)) + OP._len_field(4, b"\0\0\0")])),
        OP.model(graph([])) + OP._len_field(7, OP._len_field(1, OP._len_field(5, OP._int_field(20, 99)))),
        _nested(100),
        _nested(101),
    ]


def test_validator_agrees_with_jax_on_the_fixture_and_a_fresh_export(tmp_path):
    gen = torch.Generator().manual_seed(0)
    obs = {"state": torch.randn(8, 101, generator=gen), "privileged_state": torch.randn(8, 212, generator=gen)}
    ts = ppo.init_training_state(obs, 14, PPOConfig(), gen, device="cpu")
    path = tmp_path / "policy.onnx"
    TE.export_policy((ts.normalizer, ts.net), 14, None, 101, str(path))
    for blob in (FIXTURE.read_bytes(), path.read_bytes()):
        want = JV.validate(blob)
        assert TV.validate(blob) == want
    assert TV.validate_file(str(path))["outputs"] == {"continuous_actions": (1, 14)}


@pytest.mark.parametrize("kind", ["truncations", "tags", "lengths", "bytes", "wire"])
def test_validator_agrees_with_jax_on_mutations(kind):
    """The same accept/reject as the protobuf-backed validator, and the same
    summary on accept, on every blob of one part of the corpus."""
    blobs = corpus(kind)
    verdicts = [(verdict(JV, b), verdict(TV, b)) for b in blobs]
    for k, (want, got) in enumerate(verdicts):
        assert got == want, (kind, k, want[0], got[0])
    if kind == "wire":
        assert [w[0] for w, _ in verdicts[:5]] == ["ok", "rejected", "ok", "ok", "rejected"]
        assert [w[0] for w, _ in verdicts[-2:]] == ["ok", "rejected"]  # 100 levels, 101


def test_mutation_corpus_has_300_blobs_with_accepts_and_rejects():
    blobs = [b for kind in ("truncations", "tags", "lengths", "bytes", "wire") for b in corpus(kind)]
    outcomes = [verdict(TV, b)[0] for b in blobs]
    assert len(blobs) >= 300
    assert outcomes.count("ok") >= 10 and outcomes.count("rejected") >= 200


def _tiny_graph(nodes, inits=(), inputs=(("x", (1, 4)),), outputs=(("y", (1, 4)),)):
    return OP.model(OP.graph(nodes, "g", list(inits), inputs=[OP.value_info(n, s) for n, s in inputs],
                             outputs=[OP.value_info(n, s) for n, s in outputs]))


def test_validator_rejects_truncation():
    blob = small_export()
    with pytest.raises(TV.OnnxValidationError):
        TV.validate(blob[: len(blob) // 2])


def test_validator_rejects_bad_field_number():
    with pytest.raises(TV.OnnxValidationError, match="unknown"):
        TV.validate(small_export() + OP._len_field(99, b"rogue"))


def test_validator_rejects_wrong_raw_data_length():
    t_bad = b"".join(OP._int_field(1, d) for d in (3, 4)) + OP._int_field(2, OP.FLOAT)
    t_bad += OP._len_field(9, b"\x00" * (4 * 11)) + OP._str_field(8, "w")
    with pytest.raises(TV.OnnxValidationError, match="raw_data"):
        TV.validate(_tiny_graph([OP.node("Tanh", ["x"], ["y"])], [t_bad]))


def test_validator_rejects_dangling_input_and_non_ssa():
    with pytest.raises(TV.OnnxValidationError, match="not a graph input"):
        TV.validate(_tiny_graph([OP.node("Tanh", ["missing"], ["y"])]))
    with pytest.raises(TV.OnnxValidationError, match="SSA"):
        TV.validate(_tiny_graph([OP.node("Tanh", ["x"], ["x"])], outputs=(("x", (1, 4)),)))


def test_validator_rejects_shape_mismatch():
    w = np.random.default_rng(1).normal(size=(4, 6)).astype(np.float32)
    with pytest.raises(TV.OnnxValidationError, match="declared"):
        TV.validate(_tiny_graph([OP.node("MatMul", ["x", "w"], ["y"])], [OP.tensor("w", w)],
                                outputs=(("y", (1, 7)),)))
    split = OP.node("Split", ["x"], ["a", "b"], attrs_int={"axis": 1}, attrs_ints={"split": [3, 3]})
    with pytest.raises(TV.OnnxValidationError, match="split"):
        TV.validate(_tiny_graph([split], outputs=(("a", (1, 3)), ("b", (1, 3)))))


@pytest.fixture(scope="module")
def exported_policy(tmp_path_factory):
    """An untrained 64 x 64 port policy on 101 observations, exported."""
    gen = torch.Generator().manual_seed(1)
    obs = {"state": torch.randn(8, 101, generator=gen), "privileged_state": torch.randn(8, 212, generator=gen)}
    cfg = PPOConfig(policy_hidden_layer_sizes=(64, 64), value_hidden_layer_sizes=(64,))
    ts = ppo.init_training_state(obs, 14, cfg, gen, device="cpu")
    path = tmp_path_factory.mktemp("onnx") / "policy.onnx"
    TE.export_policy((ts.normalizer, ts.net), 14, None, 101, str(path))
    return str(path)


def test_native_runtime_matches_numpy_and_jax_native(exported_policy):
    cc, py, jcc = TNR.NativeOnnxPolicy(exported_policy), TRT.OnnxPolicy(exported_policy), \
        JNR.NativeOnnxPolicy(exported_policy)
    assert cuda_build.build(TNR.SOURCE, host=True).path.parent == cuda_build.HOST_BUILD_DIR
    rng = np.random.default_rng(0)
    for _ in range(5):
        obs = rng.uniform(-2, 2, 101).astype(np.float32)
        got = cc.infer(obs)
        assert got.shape == (14,)
        np.testing.assert_allclose(got, py.infer(obs), atol=ATOL)
        np.testing.assert_allclose(got, jcc.infer(obs), atol=ATOL)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(cuda_build, "host_cxx", lambda: "false")
    with pytest.raises(RuntimeError, match="failed"):
        TNR.NativeOnnxPolicy(FIXTURE)
    assert not list((tmp_path / "host").glob("*.so"))
    monkeypatch.undo()
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C"):
        cuda_build.host_cxx()


def test_low_pass_filter_matches_jax():
    rng = np.random.default_rng(3)
    a, b = TF.LowPassActionFilter(50.0), JF.LowPassActionFilter(50.0)
    assert a.alpha == b.alpha
    for action in rng.normal(size=(40, 14)):
        a.push(action)
        b.push(action)
        np.testing.assert_array_equal(a.get_filtered_action(), b.get_filtered_action())
    a.reset()
    assert a.get_filtered_action() is None


def test_port_imports_without_mujoco_matplotlib_protobuf_or_jax():
    """Every module of the port, imported in a fresh interpreter that cannot
    load mujoco, matplotlib, google.protobuf, JAX or the JAX package (the
    card's machine has none of the first three and never uses the rest)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('mujoco', 'matplotlib', 'google.protobuf', 'jax', 'open_duck_playground_tpu',\n"
        "             'flax', 'optax', 'ml_collections'):\n"
        "    sys.modules[name] = None\n"
        "import open_duck_playground_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 50
