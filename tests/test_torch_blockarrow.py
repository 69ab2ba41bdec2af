"""The block-arrow forms and the many-lane form of the physics megakernel.

- The wrapper's partition tables equal `structure.dof_chain_blocks` and the
  JAX kernel's foot-to-chain rule for the three duck scenes, and the stored
  entries cover exactly the mass matrix's nonzeros.
- f64: `block_arrow_solve` (the plain version of the kernel's factor and
  solve) equals `linalg.cholesky_solve` within 1e-10 on the duck's mass
  matrix and on `M + J^T D J` with random active contacts: eliminating the
  chains before the root has no fill-in.
- The kernel body built by the host C++ compiler on the degenerate
  partition (no root, one chain of all dofs: the dense form a model without
  block-arrow shape takes) against `step_reference`, plane and heightfield,
  under the gates of test_torch_physics.py (qpos p90 1e-5 / max 1e-4, qvel
  p90 1e-3 / max 1e-2 over 10 substeps; per substep every env within the max
  or certified as an edge of the plain version).
- The body on 8 lanes (one host thread per lane, barriers where the card
  has warp barriers): same gates, one 10-substep launch equal bit for bit to
  ten chained 1-substep launches, and no data race under ThreadSanitizer.
"""

import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_duck_playground_tpu.envs import duck_base as JD
from open_duck_playground_tpu.models import loader as JL
from open_duck_playground_tpu.physics import structure as JST

from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import collision as TC
from open_duck_playground_torch.physics import constraint as TCN
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics import kinematics as TK
from open_duck_playground_torch.physics import linalg as TLA
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.physics import smooth as TS
from open_duck_playground_torch.physics import structure as TST

from test_torch_physics import (
    GATES, _assert_gates, _per_env, assert_substep_gates, build_host_kernel, host_step,
)

torch.set_num_threads(1)

SCENES = ("scene_flat_terrain_backlash", "scene_rough_terrain_backlash", "scene_rough_terrain")
LANES = 8


def _states(tm, seed, batch, dtype=np.float32, sink=0.0):
    """States near the home keyframe (qpos 0.01, qvel 0.1 normal, servo
    targets 0.05); on a heightfield the base is spread over +-3 m, on the
    plane it is lowered by `sink`."""
    rng = np.random.default_rng(seed)
    kq, kc = tm.key_qpos.numpy().astype(np.float64), tm.key_ctrl.numpy().astype(np.float64)
    qpos = np.tile(kq, (batch, 1)) + 0.01 * rng.standard_normal((batch, kq.size))
    if tm.spec.floor_is_hfield:
        qpos[:, :2] += rng.uniform(-3.0, 3.0, (batch, 2))
    qpos[:, 2] -= sink
    qvel = 0.1 * rng.standard_normal((batch, tm.spec.nv))
    ctrl = np.tile(kc, (batch, 1)) + 0.05 * rng.standard_normal((batch, kc.size))
    return [torch.as_tensor(x.astype(dtype)) for x in (qpos, qvel, ctrl)]


# ------------------------------------------------------------ the partition
@pytest.mark.parametrize("scene", SCENES)
def test_partition_tables_match_jax(scene):
    jm, _ = JL.load_model(str(JD.XML_DIR / f"{scene}.xml"), timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(scene, device="cpu", dtype=torch.float32, timestep=0.002)
    s = tm.spec
    part = MK.partition(s)
    root, chains = TST.dof_chain_blocks(s)
    assert (root, chains) == JST.dof_chain_blocks(jm.spec)
    assert (0, part.root) == root and part.chains == chains
    # the JAX kernel's rule (physics/megakernel.py, `foot_chain`): the one
    # chain that holds the foot body's non-root ancestor dofs
    anc = np.asarray(jm.ancestor_mask)
    want = []
    for gid in jm.spec.collide_geom_ids:
        b = jm.spec.geom_bodyid[gid]
        owners = {ci for d in range(root[1], s.nv) if anc[b, d] > 0
                  for ci, (a, e) in enumerate(chains) if a <= d < e}
        assert len(owners) == 1
        want.append(owners.pop())
    assert list(part.foot_chain) == want

    t = MK.model_tables(tm)
    dims = MK.kernel_dims(s)
    np.testing.assert_array_equal(t["chain_start"], [a for a, _ in chains])
    np.testing.assert_array_equal(t["chain_end"], [e for _, e in chains])
    np.testing.assert_array_equal(t["foot_chain"], want)
    assert dims["NROOT"] == 6 and dims["NCHAIN"] == len(chains)
    assert dims["MAXCHAIN"] == max(e - a for a, e in chains)
    # stored entries: root triangle, chain triangles, chain-to-root panels
    nba = 21 + sum((e - a) * (e - a + 1) // 2 + 6 * (e - a) for a, e in chains)
    assert dims["NBA"] == nba == len(t["ba_ij"])
    ij = [(int(v) & 255, int(v) >> 8) for v in t["ba_ij"]]
    for n, (i, j) in enumerate(ij):
        assert n == t["ba_rowoff"][i] + j - (t["ba_shift"][i] if j >= 6 else 0)
    # ... which hold every nonzero of the mass matrix's lower triangle
    coupled = anc.T @ anc > 0  # dofs i, j that move a common body
    on_path = np.array([[anc[s.dof_bodyid[i], j] > 0 for j in range(s.nv)] for i in range(s.nv)])
    assert {(i, j) for i in range(s.nv) for j in range(i + 1) if on_path[i, j]} <= set(ij)
    assert coupled.any()
    # the degenerate partition is the packed dense triangle
    dense = MK.kernel_dims(s, dense=True)
    assert (dense["NROOT"], dense["NCHAIN"], dense["MAXCHAIN"]) == (0, 1, s.nv)
    assert dense["NBA"] == s.nv * (s.nv + 1) // 2
    td = MK.model_tables(tm, dense=True)
    np.testing.assert_array_equal(td["ba_rowoff"], [i * (i + 1) // 2 for i in range(s.nv)])
    np.testing.assert_array_equal(td["foot_chain"], [0] * len(want))
    # tree levels and subtree masks as the kernel walks them
    levels = TST.tree_levels(s)
    assert [list(t["level_body"][a:b]) for a, b in zip(t["level_start"], t["level_start"][1:])] == \
        [list(l) for l in levels]
    for b in range(s.nbody):
        sub = {c for c in range(s.nbody) if t["body_sub"][b] >> c & 1}
        assert b in sub and all(c == b or s.body_parentid[c] in sub for c in sub)


def test_block_arrow_solve_matches_dense_f64():
    tm = TL.load_model(device="cpu", dtype=torch.float64, timestep=0.002)
    B = 16
    qpos, qvel, _ = _states(tm, 1, B, np.float64, sink=0.01)
    m = tm.expand_batch(B)
    xpos, xquat, xanchor, xaxis, xipos, ximat, _, _ = TK.kinematics(m, qpos)
    com, cdof = TK.com_cdof(m, xquat, xanchor, xaxis, xipos)
    Mq = TS.mass_matrix(m, cdof, xipos, ximat, com)
    efc = TCN.make_constraints(m, qpos, qvel, cdof, com, TC.collide(m, xpos, xquat))
    part = MK.partition(tm.spec)
    rng = np.random.default_rng(2)
    b = torch.as_tensor(rng.standard_normal((B, tm.spec.nv)))
    # random active set and curvatures on the engine's own Jacobian
    active = torch.as_tensor(rng.random(efc.D.shape) < 0.7)
    h = torch.as_tensor(rng.uniform(0.5, 50.0, efc.D.shape)) * active
    assert (efc.J[:, -32:].abs().sum(-1) > 0).any() and (h[:, -32:] > 0).any()
    H = Mq + torch.einsum("bri,br,brj->bij", efc.J, h, efc.J)
    for A in (Mq, H):
        want = TLA.cholesky_solve(A, b)
        got = MK.block_arrow_solve(A, b, part)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) < 1e-10 * max(scale, 1.0)
        # the pattern is all the solve reads: entries between chains are zero
        for ci, (a, e) in enumerate(part.chains):
            for a2, e2 in part.chains[ci + 1:]:
                assert float(A[:, a2:e2, a:e].abs().max()) == 0.0
        dense = MK.block_arrow_solve(A, b, MK.partition(tm.spec, dense=True))
        assert float((dense - want).abs().max()) < 1e-10 * max(scale, 1.0)


# ------------------------------------------- the degenerate (dense) partition
@pytest.fixture(scope="module", params=SCENES[:2], ids=["plane", "hfield"])
def dense_kernel(request, tmp_path_factory):
    tm = TL.load_model(request.param, device="cpu", dtype=torch.float32, timestep=0.002)
    return tm, build_host_kernel(tm.spec, tmp_path_factory.mktemp("mkd"), dense=True)


def test_dense_partition_matches_step_reference(dense_kernel):
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize

    tm, lib = dense_kernel
    batch = 64
    m = domain_randomize(tm, DRDraws.sample(torch.Generator().manual_seed(5), batch, tm.spec))
    qpos, qvel, ctrl = _states(tm, 6, batch)
    d0 = TF.init(m, qpos, qvel, ctrl)
    got = host_step(lib, m, d0, ctrl, 10, dense=True)
    _assert_gates(got, TF.step_reference(m, d0, ctrl, 10), "dense partition vs step_reference")
    assert (got.contact_dist < 0).any()


def test_dense_partition_matches_every_substep(dense_kernel):
    tm, lib = dense_kernel
    batch = 32
    qpos, qvel, ctrl = _states(tm, 0, batch, sink=0.005)
    d = TF.init(tm, qpos, qvel, ctrl)
    edges = 0
    for _ in range(10):
        got = host_step(lib, tm, d, ctrl, 1, dense=True)
        want = TF.step_reference(tm, d, ctrl, 1)
        edges += assert_substep_gates(tm, d, ctrl, got, want, "dense partition")
        assert _per_env(got.contact_dist, want.contact_dist).max() < 1e-6
        d = got
    assert edges <= 2


# --------------------------------------------------------------- many lanes
@pytest.fixture(scope="module", params=SCENES[:2], ids=["plane", "hfield"])
def lanes_kernel(request, tmp_path_factory):
    tm = TL.load_model(request.param, device="cpu", dtype=torch.float32, timestep=0.002)
    lib = build_host_kernel(tm.spec, tmp_path_factory.mktemp("mkl"), flags=(f"-DMK_HOST_LANES={LANES}",))
    return tm, lib


def test_lanes_match_step_reference_and_chained_launches(lanes_kernel):
    """The body on 8 lanes: gates per substep, and one launch of 10
    substeps equal bit for bit to ten launches of one (the order of the
    lanes' sums does not depend on the launch), on one lane too."""
    tm, lib = lanes_kernel
    batch = 12
    qpos, qvel, ctrl = _states(tm, 3, batch, sink=0.005)
    d0 = TF.init(tm, qpos, qvel, ctrl)
    for fn in ("mk_host_step_lanes", "mk_host_step"):
        d = d0
        for _ in range(10):
            got = host_step(lib, tm, d, ctrl, 1, fn=fn)
            assert_substep_gates(tm, d, ctrl, got, TF.step_reference(tm, d, ctrl, 1), fn)
            d = got
        once = host_step(lib, tm, d0, ctrl, 10, fn=fn)
        for name in ("qpos", "qvel", "qacc", "qacc_warmstart", "sensordata", "site_xpos",
                     "site_xmat", "actuator_force", "contact_dist"):
            assert torch.equal(getattr(once, name), getattr(d, name)), (fn, name)
        assert (once.contact_dist < 0).any()


def test_lanes_survive_nan_state(lanes_kernel):
    """A blown-up env stays NaN on every lane count and leaves the others
    untouched (the arg-min over hull vertices must not index with a NaN)."""
    tm, lib = lanes_kernel
    qpos, qvel, ctrl = _states(tm, 4, 4)
    d0 = TF.init(tm, qpos, qvel, ctrl)
    bad = d0.replace(qpos=d0.qpos.clone())
    bad.qpos[1, :3] = float("nan")
    got, ref = (host_step(lib, tm, x, ctrl, 2, fn="mk_host_step_lanes") for x in (bad, d0))
    assert torch.isnan(got.qpos[1]).any()
    assert torch.equal(got.qpos[[0, 2, 3]], ref.qpos[[0, 2, 3]])


@pytest.mark.parametrize("scene,dense", [(SCENES[0], False), (SCENES[1], False), (SCENES[0], True)],
                         ids=["plane", "hfield", "plane-dense"])
def test_lanes_race_free_under_thread_sanitizer(scene, dense, tmp_path):
    """The 8-lane host program under -fsanitize=thread: the sanitizer orders
    accesses by the barriers alone, so it reports a missing barrier or two
    lanes writing one entry of the env's working set. Its outputs equal the
    one-lane build's within the max gates."""
    cxx = shutil.which("g++") or shutil.which("c++")
    tm = TL.load_model(scene, device="cpu", dtype=torch.float32, timestep=0.002)
    dims = MK.kernel_dims(tm.spec, dense)
    exe = tmp_path / "mk_host_tsan"
    subprocess.run([cxx, "-O1", "-g", "-std=c++17", "-fsanitize=thread", "-pthread", "-DMK_HOST_MAIN",
                    f"-DMK_HOST_LANES={LANES}", *MK.dim_flags(dims), "-o", str(exe),
                    str(MK.CSRC / "megakernel_host.cpp")], check=True)
    batch, n = 3, 2
    qpos, qvel, ctrl = _states(tm, 5, batch, sink=0.005)
    d0 = TF.init(tm, qpos, qvel, ctrl)
    ins, outs = MK.kernel_tensors(tm, d0, ctrl, n)
    st = MK.model_struct(tm, dense)
    blob = struct.pack("4i", batch, n, 0, len(bytes(st))) + bytes(st)
    for i, t in enumerate(ins + outs):
        blob += struct.pack("i", t.numel()) + (t.numpy().tobytes() if i < len(ins) else b"")
    (tmp_path / "in.bin").write_bytes(blob)
    run = subprocess.run([str(exe), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "ThreadSanitizer" not in run.stderr, run.stderr[-3000:]
    flat = np.frombuffer((tmp_path / "out.bin").read_bytes(), np.float32)
    assert flat.size == sum(t.numel() for t in outs)
    got, at = [], 0
    for t in outs:
        got.append(torch.as_tensor(flat[at:at + t.numel()].copy()).reshape(t.shape))
        at += t.numel()
    got = MK.data_from_outputs(d0, ctrl, got)
    want = TF.step_reference(tm, d0, ctrl, n)
    for f, _, mx in GATES:
        assert _per_env(getattr(got, f), getattr(want, f)).max() < mx, f
