"""The issue-rate probe's plain version (`tools/issue_bench.py`) against a
numpy loop of the same recurrences, and the wrapper's routing. The CUDA
kernel itself (`csrc/issue_probe.cu`) is held against this plain version on
the card only (tests/test_torch_gpu.py, chip_smoke.py).

Tolerance: the plain version accumulates in f64 as the numpy loop does, so
they agree to 1e-12; its f32 output rounds once more (6e-8 relative).
"""

import numpy as np
import pytest
import torch

from open_duck_playground_torch.tools import issue_bench as IB

torch.set_num_threads(1)


def _numpy_loop(variant, x, trips):
    """The TPU tool's recurrences (tools/vpu_issue_bench.py:77-92) and the
    card's sqrt/divide chain, one round at a time, in f64."""
    ab = IB.constants(x.shape[0]).astype(np.float64)
    y = x.astype(np.float64).copy()
    for _ in range(trips * IB.ROUNDS):
        for c in range(y.shape[0]):
            a, b = ab[0, c], ab[1, c]
            if variant == "fma":
                y[c] = y[c] * a + b
            elif variant == "add":
                y[c] = y[c] + b
            elif variant == "exp":
                y[c] = np.exp(-0.5 * y[c]) + 0.25
            else:
                y[c] = a / np.sqrt(y[c] + b)
    return y


def test_constants_are_the_tpu_tools():
    ab = IB.constants(16)
    assert ab.dtype == np.float32 and ab.shape == (2, 16)
    for c in (0, 5, 15):
        assert ab[0, c] == np.float32(0.9993 + 7e-5 * c) and ab[1, c] == np.float32(1e-4 * (c + 1))
    assert IB.ROUNDS == 32


@pytest.mark.parametrize("variant", IB.VARIANTS)
@pytest.mark.parametrize("chains", [1, 8])
def test_plain_version_matches_numpy_loop(variant, chains):
    rng = np.random.default_rng(chains)
    x = rng.uniform(0.4, 0.6, (chains, 5))
    want = _numpy_loop(variant, x, trips=3)
    got = IB.plain(variant, torch.as_tensor(x), 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    got32 = IB.plain(variant, torch.as_tensor(x.astype(np.float32)), 3)
    assert got32.dtype == torch.float32
    want32 = _numpy_loop(variant, x.astype(np.float32), trips=3)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-7)


@pytest.mark.parametrize("variant", IB.VARIANTS)
def test_reference_follows_each_chain_from_x0(variant):
    ref = IB.reference(variant, 4, 2)
    assert ref.shape == (4,) and ref.dtype == torch.float64
    want = _numpy_loop(variant, np.full((4, 1), IB.X0), 2)[:, 0]
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-12)
    if variant != "add":  # the contracting recurrences head for their fixed points
        far = IB.reference(variant, 4, 400).numpy()
        ab = IB.constants(4).astype(np.float64)
        step = {"fma": lambda y: y * ab[0] + ab[1], "exp": lambda y: np.exp(-0.5 * y) + 0.25,
                "sqrt_div": lambda y: ab[0] / np.sqrt(y + ab[1])}[variant]
        np.testing.assert_allclose(step(far), far, rtol=1e-3 if variant == "fma" else 1e-12)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    x = torch.full((2, 64), 0.5)
    before = IB.launches
    assert torch.equal(IB.run("fma", x, 2), IB.plain("fma", x, 2))
    assert IB.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError):
        IB.run("col", x, 2)  # a TPU-only variant
    with pytest.raises(ValueError):
        IB.run("fma", x, -1)


def test_configs_cover_the_questions():
    variants = {v for v, _, _ in IB.CONFIGS}
    assert variants == set(IB.VARIANTS)
    assert {c for v, c, w in IB.CONFIGS if v == "fma" and w == 4} == set(IB.CHAINS)
    assert {w for v, c, w in IB.CONFIGS if v == "fma" and c == 1} >= {1, 2, 4, 8, 16}
    assert all(c in IB.CHAINS and 1 <= w <= 32 for _, c, w in IB.CONFIGS)
    assert set(IB.OPS_PER_ROUND) == set(IB.VARIANTS)
