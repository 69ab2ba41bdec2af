"""The port's physics engine and CUDA megakernel against the JAX engine.

- f64: forward stages (mass matrix, bias, contacts, qacc, sensordata) equal
  the JAX engine's within 1e-9 relative.
- f32: `step_reference` (the kernel's plain version) over 10 substeps
  against JAX `F.step(use_megakernel=False)`, under the per-env gates of
  test_megakernel_interpret.py: qpos p90 1e-5 / max 1e-4, qvel p90 1e-3 /
  max 1e-2; derived fields at p90: sensordata 5e-2, site_xpos 1e-4,
  actuator_force 1e-2.
- The kernel's arithmetic (csrc/megakernel.cuh) built by the host C++
  compiler (one lane) and held against `step_reference` under the same
  gates. The same body runs on the card through csrc/megakernel.cu;
  test_torch_gpu.py and chip_smoke.py hold that build against the plain
  version. test_torch_blockarrow.py holds the degenerate partition, the
  partition tables and a many-lane host build.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_duck_playground_tpu.envs import duck_base
from open_duck_playground_tpu.models import loader as JL
from open_duck_playground_tpu.physics import collision as JC
from open_duck_playground_tpu.physics import forward as JF
from open_duck_playground_tpu.physics import kinematics as JK
from open_duck_playground_tpu.physics import smooth as JS

from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import collision as TC
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics import kinematics as TK
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.physics import smooth as TS

torch.set_num_threads(1)

XML = str(duck_base.XML_DIR / "scene_flat_terrain_backlash.xml")
B = 16
GATES = [("qpos", 1e-5, 1e-4), ("qvel", 1e-3, 1e-2)]
DERIVED = [("sensordata", 5e-2), ("site_xpos", 1e-4), ("actuator_force", 1e-2)]


def _inputs(seed, batch, dtype, key_qpos, key_ctrl, ctrl_noise=0.05):
    """States near the home keyframe, perturbed as test_megakernel_tpu.py
    does (qpos 0.01, qvel 0.1 normal), with noisy servo targets."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(key_qpos, (batch, 1)) + 0.01 * rng.standard_normal((batch, key_qpos.size))
    qvel = 0.1 * rng.standard_normal((batch, 30))
    ctrl = np.tile(key_ctrl, (batch, 1)) + ctrl_noise * rng.standard_normal((batch, key_ctrl.size))
    return [x.astype(dtype) for x in (qpos, qvel, ctrl)]


def _per_env(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).reshape(a.shape[0], -1).max(1)


def _assert_gates(got, want, label):
    for f, p90, mx in GATES:
        e = _per_env(getattr(got, f), getattr(want, f))
        assert np.percentile(e, 90) < p90 and e.max() < mx, (label, f, np.percentile(e, 90), e.max())
    for f, p90 in DERIVED:
        e = _per_env(getattr(got, f), getattr(want, f))
        assert np.percentile(e, 90) < p90, (label, f, np.percentile(e, 90))


@pytest.fixture(scope="module")
def models32():
    jm, mj = JL.load_model(XML, timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(device="cpu", dtype=torch.float32, timestep=0.002)
    return jm, tm, np.asarray(mj.keyframe("home").qpos), np.asarray(mj.keyframe("home").ctrl)


def test_forward_stages_match_jax_f64():
    jm, mj = JL.load_model(XML, timestep=0.002, dtype=jnp.float64)
    tm = TL.load_model(device="cpu", dtype=torch.float64, timestep=0.002)
    qpos, qvel, ctrl = _inputs(1, B, np.float64, np.asarray(mj.keyframe("home").qpos),
                               np.asarray(mj.keyframe("home").ctrl))
    qpos[:, 2] -= 0.01  # feet into the floor: every contact row active

    def stages(q, v, c):
        xpos, xquat, xanchor, xaxis, xipos, ximat, _, _ = JK.kinematics(jm, q)
        com, cdof = JK.com_cdof(jm, xquat, xanchor, xaxis, xipos)
        cvel, cdof_dot = JK.com_vel(jm, cdof, v)
        con = JC.collide(jm, xpos, xquat)
        d = JF.init(jm, q, v, c)
        return dict(qm=JS.mass_matrix(jm, cdof, xipos, ximat, com),
                    bias=JS.rne_bias(jm, cdof, cdof_dot, cvel, v, xipos, ximat, com),
                    dist=con.dist, pos=con.pos, qacc=d.qacc, sensordata=d.sensordata)

    want = jax.jit(jax.vmap(stages))(qpos, qvel, ctrl)
    tq, tv, tc = (torch.as_tensor(x) for x in (qpos, qvel, ctrl))
    m = tm.expand_batch(B)
    xpos, xquat, xanchor, xaxis, xipos, ximat, _, _ = TK.kinematics(m, tq)
    com, cdof = TK.com_cdof(m, xquat, xanchor, xaxis, xipos)
    cvel, cdof_dot = TK.com_vel(m, cdof, tv)
    con = TC.collide(m, xpos, xquat)
    d = TF.init(tm, tq, tv, tc)
    got = dict(qm=TS.mass_matrix(m, cdof, xipos, ximat, com),
               bias=TS.rne_bias(m, cdof, cdof_dot, cvel, tv, xipos, ximat, com),
               dist=con.dist, pos=con.pos, qacc=d.qacc, sensordata=d.sensordata)
    assert (got["dist"] < 0).all()
    for k, w in want.items():
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(got[k].numpy() - w).max() < 1e-9 * scale, k


def test_step_reference_matches_jax_f32(models32):
    jm, tm, kq, kc = models32
    qpos, qvel, ctrl = _inputs(2, B, np.float32, kq, kc)
    d0 = jax.jit(jax.vmap(lambda q, v, c: JF.init(jm, q, v, c)))(qpos, qvel, ctrl)
    want = jax.jit(jax.vmap(lambda d, c: JF.step(jm, d, c, 10, use_megakernel=False)))(d0, ctrl)
    tq, tv, tc = (torch.as_tensor(x) for x in (qpos, qvel, ctrl))
    got = TF.step_reference(tm, TF.init(tm, tq, tv, tc), tc, 10)
    _assert_gates(got, want, "step_reference vs JAX")


def test_step_dispatches_cpu_tensors_to_the_plain_version(models32):
    _, tm, kq, kc = models32
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in _inputs(3, 4, np.float32, kq, kc))
    d0 = TF.init(tm, qpos, qvel, ctrl)
    launches = MK.launches
    a = TF.step(tm, d0, ctrl, 10)
    c = TF.step_reference(tm, d0, ctrl, 10)
    for name, x in a.fields():
        assert torch.equal(x, getattr(c, name)), name
    with pytest.raises(TypeError):  # the kernel's wrapper takes CUDA tensors only
        MK.megakernel_step(tm, d0, ctrl, 10)
    assert MK.launches == launches  # the plain version launches nothing


def test_kernel_wrapper_checks_its_inputs(models32):
    _, tm, kq, kc = models32
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in _inputs(4, 4, np.float32, kq, kc))
    d0 = TF.init(tm, qpos, qvel, ctrl)
    ins, outs = MK.kernel_tensors(tm, d0, ctrl, 10)
    assert len(ins) + len(outs) == 23 and all(t.is_contiguous() for t in ins + outs)
    with pytest.raises(TypeError):
        MK.kernel_tensors(tm, d0, ctrl.double(), 10)
    with pytest.raises(ValueError):
        MK.kernel_tensors(tm, d0, ctrl[:, :5], 10)
    with pytest.raises(ValueError):
        MK.kernel_tensors(tm, d0.replace(qvel=d0.qvel.t().contiguous().t()), ctrl, 10)
    with pytest.raises(ValueError):
        MK.kernel_tensors(tm, d0, ctrl, 0)
    hfield = tm.replace(spec=tm.spec.__class__(**{**tm.spec.__dict__, "floor_is_hfield": True}))
    with pytest.raises(NotImplementedError):
        MK.check_supported(hfield)


def build_host_kernel(spec, out_dir, dense=False, flags=()):
    """csrc/megakernel_host.cpp (the kernel body with a host lane context)
    compiled by the host C++ compiler for this model shape."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed for the kernel-arithmetic test"
    out = out_dir / "libmk_host.so"
    dims = MK.kernel_dims(spec, dense)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", *MK.dim_flags(dims),
                    *flags, "-o", str(out), str(MK.CSRC / "megakernel_host.cpp")], check=True)
    lib = ctypes.CDLL(str(out))
    for fn in ("mk_host_step", "mk_host_step_lanes"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            getattr(lib, fn).restype = ctypes.c_int
    assert lib.mk_model_size() == ctypes.sizeof(MK.model_struct_type(dims))
    return lib


def host_step(lib, m, d, ctrl, n, dense=False, fn="mk_host_step"):
    ins, outs = MK.kernel_tensors(m, d, ctrl, n)
    st = MK.model_struct(m, dense)
    assert getattr(lib, fn)(ctypes.byref(st), MK.pointer_array(ins + outs), d.qpos.shape[0], n) == 0
    return MK.data_from_outputs(d, ctrl, outs)


EDGE_COPIES, SMOOTH_COPIES, EDGE_SCALE = 256, 16, 1e-6


def perturbed_plain(m, d, ctrl, envs, copies, gen):
    """One substep of the plain version from `copies` copies of each env of
    `envs`, qpos and qvel perturbed at rounding scale (relative EDGE_SCALE;
    copy 0 of each env is the unperturbed input). Returns the gated fields,
    each shaped (len(envs), copies, -1)."""
    from open_duck_playground_torch.physics.types import RANDOMIZED_FIELDS

    sel = torch.as_tensor(list(envs)).repeat_interleave(copies)
    mm = m.replace(**{f: getattr(m, f)[sel] for f in RANDOMIZED_FIELDS if m.is_batched(f)})
    dd = d.map(lambda x: x[sel])

    def perturb(x):
        noise = torch.randn(x.shape, generator=gen)
        noise[::copies] = 0
        return x * (1 + EDGE_SCALE * noise)

    p = TF.step_reference(mm, dd.replace(qpos=perturb(dd.qpos), qvel=perturb(dd.qvel)), ctrl[sel], 1)
    return {f: getattr(p, f).double().reshape(len(sel) // copies, copies, -1).numpy() for f, _, _ in GATES}


def plain_jump(p):
    """Per env, how far the perturbed copies' results lie from the
    unperturbed one, in units of the max gates."""
    return np.max([np.abs(p[f] - p[f][:, :1]).max((1, 2)) / mx for f, _, mx in GATES], 0)


def assert_substep_gates(m, d, ctrl, got, want, label=""):
    """One substep from the shared state `d`: every env within the max gates
    of the plain version, or shown to sit at an edge of the plain version
    itself. The 1-iteration Newton step is discontinuous where a constraint
    row starts at the edge of its active set (and a hull vertex on a
    triangle's edge flips its normal), so two f32 evaluations that differ in
    their last bits may land on different sides. Such an env passes only if
    the plain version jumps there too: from its input perturbed at rounding
    scale (EDGE_COPIES copies, relative EDGE_SCALE) its own result moves by
    at least the max gate, and one of those results is within the max gates
    of the kernel's in every field (the rule of chip_smoke.py). Returns the
    number of edge envs."""
    over = np.zeros(d.qpos.shape[0], bool)
    for f, _, mx in GATES:
        over |= _per_env(getattr(got, f), getattr(want, f)) >= mx
    gen = torch.Generator().manual_seed(1)
    for env in np.nonzero(over)[0]:
        p = perturbed_plain(m, d, ctrl, [int(env)], EDGE_COPIES, gen)
        err = np.max([np.abs(p[f][0] - getattr(got, f)[env].double().numpy().reshape(1, -1)).max(1) / mx
                      for f, _, mx in GATES], 0)
        assert plain_jump(p)[0] >= 1 and err.min() < 1, (label, "env over the max gate and not at an edge",
                                                         int(env), err.min())
    return int(over.sum())


@pytest.fixture(scope="module")
def host_kernel(models32, tmp_path_factory):
    """csrc/megakernel.cuh compiled by the host C++ compiler (test harness)."""
    return build_host_kernel(models32[1].spec, tmp_path_factory.mktemp("mk"))


@pytest.mark.parametrize("dr, record", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["nominal", "randomized", "nominal-record", "randomized-record"])
def test_kernel_arithmetic_matches_step_reference(models32, host_kernel, dr, record):
    """`record`: the model passed as the card's launch passes it, the bytes
    of its record (`model_record`, here on the CPU) by address; the outputs
    equal those of the ctypes struct by reference bit for bit."""
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize

    _, tm, kq, kc = models32
    batch = 64
    m = domain_randomize(tm, DRDraws.sample(torch.Generator().manual_seed(5), batch, tm.spec)) if dr else tm
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in _inputs(6, batch, np.float32, kq, kc, 0.0))
    d0 = TF.init(m, qpos, qvel, ctrl)
    ins, outs = MK.kernel_tensors(m, d0, ctrl, 10)
    st, rec = MK.model_struct(m), MK.model_record(m)
    model = rec.data_ptr() if record else ctypes.byref(st)
    assert host_kernel.mk_host_step(model, MK.pointer_array(ins + outs), batch, 10) == 0
    got = MK.data_from_outputs(d0, ctrl, outs)
    want = TF.step_reference(m, d0, ctrl, 10)
    _assert_gates(got, want, "kernel arithmetic vs step_reference")
    np.testing.assert_array_equal(got.qacc_warmstart.numpy(), got.qacc.numpy())
    if record:
        by_struct = host_step(host_kernel, m, d0, ctrl, 10)
        for name, t in got.fields():
            assert torch.equal(t.view(torch.int32), getattr(by_struct, name).view(torch.int32)), name


def test_kernel_arithmetic_matches_every_substep(models32, host_kernel):
    """Substep by substep from the kernel's own trajectory, every env agrees
    with the plain version within the strict max gates, on a trajectory where
    the plain version itself is checked to be smooth (no env's result moves
    by a max gate when its input is perturbed at rounding scale): where
    10-substep trajectories part, it is the 1-iteration Newton solve's
    discontinuity (a row starting a substep at jar = 0), not a different
    function."""
    _, tm, kq, kc = models32
    batch = 64
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in _inputs(2, batch, np.float32, kq, kc))
    qpos[:, 2] -= 0.01  # feet into the floor: every contact row in play
    d = TF.init(tm, qpos, qvel, ctrl)
    gen = torch.Generator().manual_seed(2)
    for _ in range(10):
        got = host_step(host_kernel, tm, d, ctrl, 1)
        want = TF.step_reference(tm, d, ctrl, 1)
        for f, _, mx in GATES:
            e = _per_env(getattr(got, f), getattr(want, f))
            assert e.max() < mx, (f, e.max())
        assert plain_jump(perturbed_plain(tm, d, ctrl, range(batch), SMOOTH_COPIES, gen)).max() < 1
        d = got


def test_kernel_arithmetic_edge_envs_are_edges_of_the_plain_version(models32, host_kernel):
    """A trajectory on which one env meets a Newton edge (env 40 at the
    tenth substep): every env is within the max gates or certified as an
    edge of the plain version (`assert_substep_gates`), and the edge is
    there, so the certification itself is exercised."""
    _, tm, kq, kc = models32
    batch = 64
    qpos, qvel, ctrl = (torch.as_tensor(x) for x in _inputs(0, batch, np.float32, kq, kc))
    qpos[:, 2] -= 0.01
    d = TF.init(tm, qpos, qvel, ctrl)
    edges = 0
    for _ in range(10):
        got = host_step(host_kernel, tm, d, ctrl, 1)
        edges += assert_substep_gates(tm, d, ctrl, got, TF.step_reference(tm, d, ctrl, 1))
        d = got
    assert 1 <= edges <= 2  # of 640 env-substeps
