"""The issue-rate probe's plain version (`tools/issue_bench.py`) against a
numpy loop of the same recurrences and against the JAX tool's Pallas kernel
(`tools/vpu_issue_bench.py:_build`, run in Pallas interpret mode), the
wrapper's routing and launch geometry, the rates a config line computes
from the kernel's timers, and the reader of the kernel's machine code. The
CUDA kernel itself (`csrc/issue_probe.cu`) is held against this plain
version on the card only (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: the plain version accumulates in f64 as the numpy loop does, so
they agree to 1e-12; its f32 output rounds once more (6e-8 relative). The
JAX kernel rounds every round to f32 (multiply and add apart): half an ulp
of 0.4-1 per rounding, all falling the same way over 128 rounds, stays
under 1e-5, the bound the card's kernel is held to (chip_smoke.py).
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_torch.tools import issue_bench as IB

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _numpy_loop(variant, x, trips):
    """The TPU tool's recurrences (tools/vpu_issue_bench.py:47-92) and the
    card's sqrt/divide chain, one round at a time, in f64."""
    ab = IB.constants(variant, x.shape[0]).astype(np.float64)
    y = x.astype(np.float64).copy()
    for _ in range(trips * IB.ROUNDS):
        for c in range(y.shape[0]):
            a, b = ab[0, c], ab[1, c]
            if variant in ("fma", "col", "narrow"):
                y[c] = y[c] * a + b
            elif variant == "add":
                y[c] = y[c] + b
            elif variant == "exp":
                y[c] = np.exp(-0.5 * y[c]) + 0.25
            else:
                y[c] = a / np.sqrt(y[c] + b)
    return y


def test_constants_are_the_tpu_tools():
    for variant in IB.VARIANTS:
        ab = IB.constants(variant, 16)
        assert ab.dtype == np.float32 and ab.shape == (2, 16)
        for c in (0, 5, 15):
            if variant == "col":  # one a, b for every chain (tools/vpu_issue_bench.py:54-55)
                assert ab[0, c] == np.float32(0.9997) and ab[1, c] == np.float32(1.3e-4)
            else:
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
        ab = IB.constants(variant, 4).astype(np.float64)
        step = {"exp": lambda y: np.exp(-0.5 * y) + 0.25,
                "sqrt_div": lambda y: ab[0] / np.sqrt(y + ab[1])}.get(variant, lambda y: y * ab[0] + ab[1])
        np.testing.assert_allclose(step(far), far, rtol=1e-12 if variant in ("exp", "sqrt_div") else 1e-3)


@pytest.fixture
def jax_tool(monkeypatch):
    """The JAX tool loaded by path, its `pl.pallas_call` in interpret mode
    for this test only (the module and the JAX package are not changed)."""
    spec = importlib.util.spec_from_file_location("vpu_issue_bench", ROOT / "tools" / "vpu_issue_bench.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tool.pl, "pallas_call", functools.partial(tool.pl.pallas_call, interpret=True))
    return tool


JAX_CASES = [(v, c) for v in ("fma", "add", "exp", "narrow") for c in (1, 8)] + [("col", 2), ("col", 8)]


@pytest.mark.parametrize("variant,chains", JAX_CASES)
def test_plain_version_matches_the_jax_kernel(jax_tool, variant, chains):
    trips = 3
    fn, x0, _ = jax_tool._build(variant, chains, trips)
    assert x0.shape == (chains, 1 if variant == "narrow" else 8, 128) and x0.dtype == jnp.float32
    x = np.random.default_rng(10 * chains + len(variant)).uniform(0.4, 0.6, x0.shape).astype(np.float32)
    got = np.asarray(fn(jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == x.shape
    want = IB.plain(variant, torch.from_numpy(x.reshape(chains, -1)), trips)
    np.testing.assert_allclose(got.reshape(chains, -1), want.numpy(), rtol=0, atol=1e-5)
    assert np.abs(got - x).max() > 1e-3  # the recurrence moved the chains
    if chains > 1 and variant != "exp":  # per-chain constants part the chains; col's one a, b does not
        y = IB.plain(variant, torch.full((chains, 1), IB.X0), trips)[:, 0].numpy()
        assert (len(np.unique(y)) == 1) == (variant == "col")


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    x = torch.full((2, 64), 0.5)
    before = IB.launches
    for variant in IB.VARIANTS:
        assert torch.equal(IB.run(variant, x, 2), IB.plain(variant, x, 2))
    assert IB.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError):
        IB.run("vreg", x, 2)  # a name no tool has
    with pytest.raises(ValueError):
        IB.run("fma", x, -1)
    with pytest.raises(ValueError):
        IB.run("fma", x, 2, operands="shared")


def test_launch_geometry():
    assert IB.per_block("fma", 128) == 128 and IB.per_block("narrow", 128) == 4 * IB.NARROW_LANES
    assert IB.blocks_for("fma", 132 * 512, 512) == 132
    assert IB.blocks_for("sqrt_div", 4 * 96, 96) == 4  # any block size but narrow's
    assert IB.blocks_for("narrow", 132 * 16, 128) == 132
    for variant, n, threads in (("fma", 100, 64), ("narrow", 132 * 16, 100), ("narrow", 20, 128),
                                ("add", 2048, 2048), ("exp", 64, 0)):
        with pytest.raises(ValueError):
            IB.blocks_for(variant, n, threads)


def _timers(sms, cycles, ns, start=1000):
    t = np.zeros((len(sms), len(IB.TIMERS)), dtype=np.int64)
    t[:, 0], t[:, 1], t[:, 2] = sms, start, start + np.asarray(cycles)
    t[:, 3], t[:, 4] = 5 * start, 5 * start + np.asarray(ns)
    return t


def test_rates_from_the_kernels_timers():
    sms = np.arange(132)
    t1, t2 = _timers(sms, 2.0e6, 1.0e6), _timers(sms[::-1], 10.0e6, 5.0e6)
    r = IB.rates("fma", 8, 16, "registers", (20_000, 100_000), (1.1e-3, 5.1e-3), (t1, t2))
    ops = 80_000 * 32 * 8 * 512 * 2  # per SM
    assert r["ops_per_clock_per_sm"] == pytest.approx(ops / 8e6)
    assert r["cycles_per_round"] == pytest.approx(8e6 / (80_000 * 32))
    assert r["clock_ghz_kernel"] == pytest.approx(2.0) and r["clock_ghz_events"] == pytest.approx(2.0)
    assert r["tflops"] == pytest.approx(ops * 132 / 4e-3 * 1e-12)
    assert r["blocks"] == r["distinct_sms"] == 132 and r["operands"] == "registers"
    # narrow counts its busy lanes only: 4 of each warp's 32
    n = IB.rates("narrow", 8, 16, "registers", (20_000, 100_000), (1.1e-3, 5.1e-3), (t1, t2))
    assert n["ops_per_clock_per_sm"] == pytest.approx(r["ops_per_clock_per_sm"] * IB.NARROW_LANES / 32)
    shared = sms.copy()
    shared[7] = shared[8]
    with pytest.raises(RuntimeError, match="131 SMs"):
        IB.rates("fma", 8, 16, "registers", (20_000, 100_000), (1.1e-3, 5.1e-3), (t1, _timers(shared, 1e7, 5e6)))


SASS = """
\tcode for sm_90a
\t\tFunction : _Z12probe_kernelILi0ELi1ELi0EEvPKfS1_7ProbeABPfPxi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe20000000800 */
        /*0010*/                   ISETP.GE.AND P0, PT, R6, 0x1, PT ;     /* 0x0000000106007c0c */
.L_x_1:
        /*0020*/                   IADD3 R4, R4, 0x2, RZ ;                /* 0x0000000204047810 */
{body}
        /*0{end:03x}*/                   ISETP.NE.AND P0, PT, R4, R6, PT ;
        /*0{br:03x}*/               @P0 BRA `(.L_x_1) ;                    /* 0xfffffffc00d40947 */
        /*0{ex:03x}*/                   EXIT ;
.L_x_2:
        /*0{tail:03x}*/                   BRA `(.L_x_2);
\t\tFunction : _Z12probe_kernelILi1ELi8ELi1EEvPKfS1_7ProbeABPfPxi
        /*0000*/                   FADD R3, R3, c[0x0][0x210] ;
        /*0010*/               @P0 BRA 0x0 ;
"""


def _sass(n_ffma, source="R2.reuse, R3"):
    body = "\n".join(f"        /*0{0x30 + 0x10 * i:03x}*/                   FFMA R5, R5, {source} ;"
                     for i in range(n_ffma))
    end = 0x30 + 0x10 * n_ffma
    return SASS.format(body=body, end=end, br=end + 0x10, ex=end + 0x20, tail=end + 0x30)


def test_sass_loop_per_trip():
    kernels = IB.parse_sass(_sass(64))
    assert set(kernels) == {("fma", 1, "registers"), ("add", 8, "constant")}
    r = IB.loop_report(kernels[("fma", 1, "registers")], "fma", 1)
    # two trips per loop (64 FFMAs of 32 rounds), + IADD3, ISETP, BRA
    assert r["trips_per_loop"] == 2 and r["loop_instructions"] == 67
    assert r["instructions_per_trip"] == 33.5
    assert r["per_trip_by_opcode"] == {"BRA": 0.5, "FFMA": 32.0, "IADD3": 0.5, "ISETP": 0.5}
    assert r["register_sources_with_reuse"] == 64 and r["ops_with_constant_bank_source"] == 0
    assert r["first"][0] == "FFMA R5, R5, R2.reuse, R3"
    c = IB.loop_report(IB.parse_sass(_sass(32, "c[0x0][0x210], R3"))[("fma", 1, "registers")], "fma", 1)
    assert c["ops_with_constant_bank_source"] == 32 and c["instructions_per_trip"] == 35
    a = IB.loop_report(IB.parse_sass(_sass(32))[("add", 8, "constant")], "add", 8)
    assert a["loop_instructions"] == 2 and a["trips_per_loop"] == 1 / 256  # a one-FADD loop


def test_configs_cover_the_questions():
    variants = {v for v, _, _ in IB.CONFIGS}
    assert variants == set(IB.VARIANTS)
    assert {c for v, c, w in IB.CONFIGS if v == "fma" and w == 4} == set(IB.CHAINS)
    assert {w for v, c, w in IB.CONFIGS if v == "fma" and c == 1} >= {1, 2, 4, 8, 16}
    # the JAX tool's col and narrow chain counts (tools/vpu_issue_bench.py:154-158)
    assert {c for v, c, w in IB.CONFIGS if v == "col"} == {2, 4, 8}
    assert {c for v, c, w in IB.CONFIGS if v == "narrow"} == {1, 8}
    assert all(c in IB.CHAINS and 1 <= w <= 32 for _, c, w in IB.CONFIGS)
    assert len(IB.CONFIGS) == 24 and len(set(IB.CONFIGS)) == 24
    assert set(IB.OPS_PER_ROUND) == set(IB.VARIANTS)
    assert IB.DEFAULT_OPERANDS in IB.OPERANDS
