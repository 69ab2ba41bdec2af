"""Wrapper of the hand-written CUDA physics megakernel (`csrc/megakernel.cu`).

Replaces the Pallas TPU kernel
`open_duck_playground_tpu/physics/megakernel.py:megakernel_step_batched`
(`pl.pallas_call` at :2178): all `n_substeps` substeps of one control step
in one launch. A plane floor and a heightfield floor (the TPU kernel's
`IS_HFIELD` branch) are two builds of the same source, told apart by
`-DMK_HFIELD`; the heightfield build gathers from the height table in
device memory.

A launch passes the kernel its model by pointer, as the host test harness
takes it: a record per model and device (`_Kernel.record`), made at the
model's first eager launch there and dropped with the model.

What bounds it on an H100: not HBM (about 2.3 KB in and out per env and
control step) and not the f32 operations at peak, but the latency of many
short dependent stages. The kernel gives each env a group of lanes (a warp
or an aligned part of one, a constant of the source) that keep the env's
working set in shared memory across the substeps and meet at warp-level
barriers only. This wrapper sizes nothing at run time: the working set is
one struct whose size the library reports (`info()`), a block holds eight
envs and one copy of the structure tables, and shared memory decides how
many blocks an SM holds.

The dofs are partitioned block-arrow (`partition`): the root free joint's
block and the serial chains that couple only through it, from
`structure.dof_chain_blocks`. The mass matrix and the Newton Hessian keep
only the root triangle, the chains' triangles and the chain-to-root panels,
Cholesky runs chain by chain with the root's Schur complement last (no
fill-in: `block_arrow_solve` is that stage's plain version), and a contact's
Jacobian stays on the root and the foot's own chain. A model without that
shape, or whose foot hangs on several chains, gets the degenerate partition
(no root, one chain of all dofs): the same source is then dense. The
partition reaches the source as `-D` sizes and small tables in `MkModel`.

No tensor cores: the products are 10x10 and 6x6 blocks per env and the
gates need true f32.

The wrapper takes CUDA tensors only; `forward.step` sends CPU tensors to
the plain version, `forward.step_reference`. The kernel is built with `nvcc` at first use into
`build/kernels/` (one library per model shape, `cuda_build.build`) and bound with ctypes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from open_duck_playground_torch import cuda_build
from open_duck_playground_torch.physics import collision as C
from open_duck_playground_torch.physics import constraint as CN
from open_duck_playground_torch.physics import linalg
from open_duck_playground_torch.physics import structure
from open_duck_playground_torch.physics.types import FREE, Data, Model, ModelSpec

CSRC = cuda_build.CSRC
TPU_KERNEL = "open_duck_playground_tpu/physics/megakernel.py:2178"
TPU_KERNEL_HFIELD = "open_duck_playground_tpu/physics/megakernel.py:1098"
TPU_KERNEL_DENSE = "open_duck_playground_tpu/physics/megakernel.py:858"

SENSOR_KINDS = (
    "gyro",
    "velocimeter",
    "accelerometer",
    "framezaxis",
    "framexaxis",
    "framelinvel",
    "frameangvel",
    "framepos",
    "framequat",
)

# Kernel launches since the last reset; one per `megakernel_step` on a card,
# and one per replay of a CUDA graph that captured one (`Captured`).
# `launches_hfield` counts those of them that ran the heightfield build,
# `launches_dense` those on the degenerate partition; each built library
# counts its own (`kernel(spec).launches`, all of them: `build_launches`).
launches = 0
launches_hfield = 0
launches_dense = 0


def reset_launches() -> None:
    global launches, launches_hfield, launches_dense
    launches = 0
    launches_hfield = 0
    launches_dense = 0
    for k in _KERNELS.values():
        k.launches = 0


# ------------------------------------------------------------ model tables
@dataclass(frozen=True)
class Partition:
    """Block-arrow partition of the dofs: the root block `[0, root)`, the
    chains as half-open dof ranges, and the chain each foot hangs on."""

    root: int
    chains: Tuple[Tuple[int, int], ...]
    foot_chain: Tuple[int, ...]

    @property
    def max_chain(self) -> int:
        return max(e - a for a, e in self.chains)

    def dof_chain(self, nv: int) -> List[int]:
        out = [-1] * nv
        for c, (a, e) in enumerate(self.chains):
            out[a:e] = [c] * (e - a)
        return out

    def row_offsets(self, nv: int) -> Tuple[List[int], List[int], List[Tuple[int, int]]]:
        """(rowoff, shift, entries) of the stored lower entries, row by row:
        entry (i, j) sits at `rowoff[i] + j - (shift[i] if j >= root else 0)`.
        A root row keeps columns 0..i, a chain row the root columns and its
        chain's columns up to i."""
        chain = self.dof_chain(nv)
        rowoff, shift, entries = [], [], []
        for i in range(nv):
            rowoff.append(len(entries))
            if i < self.root:
                shift.append(0)
                entries += [(i, j) for j in range(i + 1)]
            else:
                a = self.chains[chain[i]][0]
                shift.append(a - self.root)
                entries += [(i, j) for j in range(self.root)] + [(i, j) for j in range(a, i + 1)]
        return rowoff, shift, entries


def partition(spec: ModelSpec, dense: bool = False) -> Partition:
    """The model's block-arrow partition, or the degenerate one (no root,
    one chain of all dofs) when it has none, when a foot hangs on no or on
    several chains, or when `dense` asks for it (tests and the smoke run
    check the degenerate form on the duck)."""
    feet = [spec.geom_bodyid[g] for g in spec.collide_geom_ids]
    degenerate = Partition(0, ((0, spec.nv),), (0,) * len(feet))
    blocks = None if dense else structure.dof_chain_blocks(spec)
    if blocks is None:
        return degenerate
    (_, root), chains = blocks
    foot_chain = []
    for b in feet:
        bodies = set()
        while b != 0:
            bodies.add(b)
            b = spec.body_parentid[b]
        owners = {c for c, (a, e) in enumerate(chains)
                  if any(spec.dof_bodyid[d] in bodies for d in range(a, e))}
        if len(owners) != 1:
            return degenerate
        foot_chain.append(owners.pop())
    return Partition(root, tuple(chains), tuple(foot_chain))


def kernel_dims(spec: ModelSpec, dense: bool = False) -> Dict[str, int]:
    """The -D constants of the kernel source, from the model's spec."""
    part = partition(spec, dense)
    return dict(
        NQ=spec.nq,
        NV=spec.nv,
        NU=spec.nu,
        NBODY=spec.nbody,
        NJNT=spec.njnt,
        NSITE=spec.nsite,
        NSENSDATA=spec.nsensordata,
        NSENSOR=len(spec.sensors),
        NFOOT=len(spec.collide_geom_ids),
        NVERT=spec.hull_nvert,
        KPTS=spec.points_per_foot,
        NFRIC=len(spec.friction_dofs),
        NLIM=len(structure.limited_hinges(spec)),
        HFIELD=int(spec.floor_is_hfield),
        NLEVEL=len(structure.tree_levels(spec)),
        NROOT=part.root,
        NCHAIN=len(part.chains),
        MAXCHAIN=part.max_chain,
        NBA=len(part.row_offsets(spec.nv)[2]),
    )


def _struct_fields(d: Dict[str, int]) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """(name, 'i'|'u'|'f', shape) of MkModel, in the order of megakernel.cuh."""
    B, J, V, U, S, N, F, L, X = (
        d["NBODY"], d["NJNT"], d["NV"], d["NU"], d["NSITE"], d["NSENSOR"],
        d["NFOOT"], d["NLIM"], d["NFRIC"],
    )
    nsup = d["NROOT"] + d["MAXCHAIN"]
    hfield = [
        ("hf_nrow", "i", ()),
        ("hf_ncol", "i", ()),
        ("hf_sx", "f", ()),
        ("hf_sy", "f", ()),
        ("hf_dx", "f", ()),
        ("hf_dy", "f", ()),
    ] if d["HFIELD"] else []
    return [
        ("body_parent", "i", (B,)),
        ("body_jntadr", "i", (B,)),
        ("body_jntnum", "i", (B,)),
        ("body_intree", "f", (B,)),
        ("body_dofs", "u", (B,)),
        ("body_sub", "u", (B,)),
        ("level_start", "i", (d["NLEVEL"] + 1,)),
        ("level_body", "i", (B - 1,)),
        ("body_pos", "f", (B, 3)),
        ("body_quat", "f", (B, 4)),
        ("body_iquat", "f", (B, 4)),
        ("body_inertia", "f", (B, 3)),
        ("jnt_type", "i", (J,)),
        ("jnt_qposadr", "i", (J,)),
        ("jnt_dofadr", "i", (J,)),
        ("jnt_bodyid", "i", (J,)),
        ("jnt_pos", "f", (J, 3)),
        ("jnt_axis", "f", (J, 3)),
        ("dof_body", "i", (V,)),
        ("dof_pred", "u", (V,)),
        ("dof_ftm", "f", (V,)),
        ("dof_damping", "f", (V,)),
        ("dof_fric", "i", (V,)),
        ("dof_lim", "i", (V,)),
        ("chain_start", "i", (d["NCHAIN"],)),
        ("chain_end", "i", (d["NCHAIN"],)),
        ("dof_chain", "i", (V,)),
        ("ba_rowoff", "i", (V,)),
        ("ba_shift", "i", (V,)),
        ("ba_ij", "i", (d["NBA"],)),
        ("sup_ij", "i", (nsup * (nsup + 1) // 2,)),
        ("foot_chain", "i", (F,)),
        ("act_qadr", "i", (U,)),
        ("act_dadr", "i", (U,)),
        ("act_ctrlrange", "f", (U, 2)),
        ("act_forcerange", "f", (U, 2)),
        ("site_body", "i", (S,)),
        ("site_pos", "f", (S, 3)),
        ("site_quat", "f", (S, 4)),
        ("sensor_kind", "i", (N,)),
        ("sensor_obj", "i", (N,)),
        ("sensor_adr", "i", (N,)),
        ("foot_body", "i", (F,)),
        ("foot_gpos", "f", (F, 3)),
        ("foot_gquat", "f", (F, 4)),
        ("foot_hull", "f", (F, d["NVERT"], 3)),
        ("foot_invw", "f", (F,)),
        ("floor_body", "i", ()),
        ("floor_gpos", "f", (3,)),
        ("floor_gquat", "f", (4,)),
        ("con_k", "f", ()),
        ("con_b", "f", ()),
        ("con_solimp", "f", (5,)),
        ("fric_dof", "i", (X,)),
        ("fric_b", "f", (X,)),
        ("fric_R", "f", (X,)),
        ("lim_qadr", "i", (L,)),
        ("lim_dadr", "i", (L,)),
        ("lim_range", "f", (L, 2)),
        ("lim_margin", "f", (L,)),
        ("lim_k", "f", (L,)),
        ("lim_b", "f", (L,)),
        ("lim_solimp", "f", (L, 5)),
        ("lim_invw", "f", (L,)),
        ("gravity", "f", (3,)),
        ("timestep", "f", ()),
        ("iterations", "i", ()),
        ("ls_iterations", "i", ()),
    ] + hfield


_CTYPES = {"i": ctypes.c_int32, "u": ctypes.c_uint32, "f": ctypes.c_float}
_NPTYPES = {"i": np.int32, "u": np.uint32, "f": np.float32}


def model_struct_type(dims: Dict[str, int]):
    fields = []
    for name, kind, shape in _struct_fields(dims):
        t = _CTYPES[kind]
        for n in reversed(shape):
            t = t * n
        fields.append((name, t))
    return type("MkModel", (ctypes.Structure,), {"_fields_": fields})


def check_supported(m: Model) -> None:
    """Raise on a model the kernel does not cover."""
    s = m.spec
    if s.floor_is_hfield:
        # the kernel reads the height table in the world's axes: a static,
        # unrotated, un-offset heightfield body (true of the duck's rough
        # scenes; the plain version assumes the same)
        b = s.geom_bodyid[s.floor_geom_id]
        while b != 0:
            if s.body_jntnum[b] != 0:
                raise NotImplementedError("the heightfield body must be static")
            if m.body_pos[b].abs().max() > 0 or m.body_quat[b].tolist() != [1.0, 0.0, 0.0, 0.0]:
                raise NotImplementedError("an offset or rotated heightfield body is unsupported")
            b = s.body_parentid[b]
        if abs(float(m.geom_quat[s.floor_geom_id, 0]) - 1.0) >= 1e-6:
            raise NotImplementedError("a rotated heightfield is unsupported")
        if s.hfield_nrow < 2 or s.hfield_ncol < 2:
            raise NotImplementedError("the heightfield needs at least 2 x 2 samples")
    pr = m.geom_priority.cpu()
    floor = int(pr[s.floor_geom_id])
    if any(int(pr[g]) >= floor for g in s.collide_geom_ids):
        raise NotImplementedError("the CUDA kernel needs the floor's contact params to win")
    if any(s.jnt_type[j] != FREE and s.jnt_type[j] != 3 for j in range(s.njnt)):
        raise NotImplementedError("only free and hinge joints")
    if max(s.nv, s.nbody, s.hull_nvert) > 32:
        raise NotImplementedError("dof, body and hull-vertex sets are 32-bit masks in the kernel")


def model_tables(m: Model, dense: bool = False) -> Dict[str, np.ndarray]:
    """The MkModel fields of `m` as numpy arrays. Derived constants (solref
    gains, friction-row regularizers) come from the engine's own f32
    functions on the model's tensors, so kernel and plain version share
    them."""
    check_supported(m)
    s = m.spec
    cpu = lambda x: x.detach().to("cpu", torch.float32)
    npf = lambda x: cpu(x).numpy()
    anc = m.ancestor_mask.cpu().numpy()
    bits = lambda row: int(sum(1 << int(i) for i in np.nonzero(row)[0]))
    pred = structure.dof_pred_mask(s)
    lim = [int(j) for j in structure.limited_hinges(s)]
    fd = list(s.friction_dofs)
    lim_dofs = [s.jnt_dofadr[j] for j in lim]
    if len(set(fd)) != len(fd) or len(set(lim_dofs)) != len(lim_dofs):
        raise NotImplementedError("the kernel takes one friction row and one limit row per dof")
    levels = structure.tree_levels(s)
    subtree = np.eye(s.nbody, dtype=bool)
    for b in range(s.nbody - 1, 0, -1):  # parents precede children
        subtree[s.body_parentid[b]] |= subtree[b]
    part = partition(s, dense)
    rowoff, shift, entries = part.row_offsets(s.nv)
    nsup = part.root + part.max_chain
    floor = s.floor_geom_id
    floor_b = s.geom_bodyid[floor]
    feet_b = [s.geom_bodyid[g] for g in s.collide_geom_ids]
    invw = npf(m.body_invweight0)

    dof_solimp, dof_solref = cpu(m.dof_solimp), cpu(m.dof_solref)
    imp_f = CN.impedance(dof_solimp[fd], torch.zeros(len(fd)))
    _, fric_b = CN.kb(dof_solref[fd], dof_solimp[fd])
    fric_R = torch.clamp((1 - imp_f) / imp_f * cpu(m.dof_invweight0)[fd], min=CN.MINVAL)
    lim_k, lim_b = CN.kb(cpu(m.jnt_solref)[lim], cpu(m.jnt_solimp)[lim])
    con_k, con_b = CN.kb(cpu(m.geom_solref)[floor], cpu(m.geom_solimp)[floor])

    hfield = {}
    if s.floor_is_hfield:
        # the cell sizes as the plain version computes them, in f32
        sx, sy = cpu(m.hfield_size)[0], cpu(m.hfield_size)[1]
        hfield = dict(
            hf_nrow=np.array(s.hfield_nrow),
            hf_ncol=np.array(s.hfield_ncol),
            hf_sx=sx.numpy(),
            hf_sy=sy.numpy(),
            hf_dx=(2 * sx / (s.hfield_ncol - 1)).numpy(),
            hf_dy=(2 * sy / (s.hfield_nrow - 1)).numpy(),
        )

    return dict(
        body_parent=np.array(s.body_parentid),
        body_jntadr=np.array(s.body_jntadr),
        body_jntnum=np.array(s.body_jntnum),
        body_intree=anc.any(axis=1).astype(np.float32),
        body_dofs=np.array([bits(r) for r in anc], dtype=np.uint32),
        body_sub=np.array([bits(r) for r in subtree], dtype=np.uint32),
        level_start=np.cumsum([0] + [len(l) for l in levels]),
        level_body=np.array([b for l in levels for b in l]),
        body_pos=npf(m.body_pos),
        body_quat=npf(m.body_quat),
        body_iquat=npf(m.body_iquat),
        body_inertia=npf(m.body_inertia),
        jnt_type=np.array(s.jnt_type),
        jnt_qposadr=np.array(s.jnt_qposadr),
        jnt_dofadr=np.array(s.jnt_dofadr),
        jnt_bodyid=np.array(s.jnt_bodyid),
        jnt_pos=npf(m.jnt_pos),
        jnt_axis=npf(m.jnt_axis),
        dof_body=np.array(s.dof_bodyid),
        dof_pred=np.array([bits(r) for r in pred], dtype=np.uint32),
        dof_ftm=structure.free_trans_mask(s),
        dof_damping=npf(m.dof_damping),
        dof_fric=np.array([fd.index(v) if v in fd else -1 for v in range(s.nv)]),
        dof_lim=np.array([lim_dofs.index(v) if v in lim_dofs else -1 for v in range(s.nv)]),
        chain_start=np.array([a for a, _ in part.chains]),
        chain_end=np.array([e for _, e in part.chains]),
        dof_chain=np.array(part.dof_chain(s.nv)),
        ba_rowoff=np.array(rowoff),
        ba_shift=np.array(shift),
        ba_ij=np.array([i | j << 8 for i, j in entries]),
        sup_ij=np.array([i | j << 8 for i in range(nsup) for j in range(i + 1)]),
        foot_chain=np.array(part.foot_chain),
        act_qadr=np.array([s.jnt_qposadr[j] for j in s.actuator_trnid]),
        act_dadr=np.array([s.jnt_dofadr[j] for j in s.actuator_trnid]),
        act_ctrlrange=npf(m.actuator_ctrlrange),
        act_forcerange=npf(m.actuator_forcerange),
        site_body=np.array(s.site_bodyid),
        site_pos=npf(m.site_pos),
        site_quat=npf(m.site_quat),
        sensor_kind=np.array([SENSOR_KINDS.index(k) for k, _, _, _ in s.sensors]),
        sensor_obj=np.array([o for _, o, _, _ in s.sensors]),
        sensor_adr=np.array([a for _, _, a, _ in s.sensors]),
        foot_body=np.array(feet_b),
        foot_gpos=npf(m.geom_pos)[list(s.collide_geom_ids)],
        foot_gquat=npf(m.geom_quat)[list(s.collide_geom_ids)],
        foot_hull=npf(m.foot_hull),
        foot_invw=np.array([invw[b, 0] + invw[floor_b, 0] for b in feet_b]),
        floor_body=np.array(floor_b),
        floor_gpos=npf(m.geom_pos)[floor],
        floor_gquat=npf(m.geom_quat)[floor],
        con_k=con_k.numpy(),
        con_b=con_b.numpy(),
        con_solimp=npf(m.geom_solimp)[floor],
        fric_dof=np.array(fd),
        fric_b=fric_b.numpy(),
        fric_R=fric_R.numpy(),
        lim_qadr=np.array([s.jnt_qposadr[j] for j in lim]),
        lim_dadr=np.array(lim_dofs),
        lim_range=npf(m.jnt_range)[lim],
        lim_margin=npf(m.jnt_margin)[lim],
        lim_k=lim_k.numpy(),
        lim_b=lim_b.numpy(),
        lim_solimp=npf(m.jnt_solimp)[lim],
        lim_invw=npf(m.dof_invweight0)[lim_dofs],
        gravity=npf(m.gravity),
        timestep=np.array(s.timestep),
        iterations=np.array(s.iterations),
        ls_iterations=np.array(s.ls_iterations),
        **hfield,
    )


def model_struct(m: Model, dense: bool = False):
    """A filled ctypes MkModel for `m` (`dense`: the degenerate partition)."""
    dims = kernel_dims(m.spec, dense)
    tables = model_tables(m, dense)
    st = model_struct_type(dims)()
    for name, kind, shape in _struct_fields(dims):
        v = np.array(tables[name], dtype=_NPTYPES[kind], order="C")
        if v.shape != shape:
            raise ValueError(f"{name}: shape {v.shape}, kernel expects {shape}")
        dst = getattr(st, name) if shape else None
        if shape:
            ctypes.memmove(ctypes.addressof(dst), v.ctypes.data, v.nbytes)
        else:
            setattr(st, name, v.item())
    return st


def model_record(m: Model, dense: bool = False, device=None) -> torch.Tensor:
    """The MkModel bytes of `m` (`model_struct`) as a uint8 tensor on
    `device`, the record whose address a launch passes the kernel."""
    return torch.tensor(np.frombuffer(model_struct(m, dense), dtype=np.uint8), device=device)


# ------------------------------------------- the factorization's plain version
def block_arrow_solve(A: torch.Tensor, b: torch.Tensor, part: Partition) -> torch.Tensor:
    """`A^{-1} b` for symmetric positive definite `A` (..., nv, nv) whose
    entries between different chains are zero, by the kernel's elimination
    order in plain torch: every chain block factored on its own, its panel
    to the root solved against that factor, the root block reduced by the
    panels' Schur complement and factored last, then the solve chains
    forward, root, chains backward. Entries of `A` outside the block-arrow
    pattern are never read, so agreement with a dense solve shows that the
    pattern has no fill-in."""
    r = part.root
    t = lambda x: x.transpose(-1, -2)
    factors = []
    S = A[..., :r, :r]
    br = b[..., :r]
    for a, e in part.chains:
        F = linalg.cholesky(A[..., a:e, a:e])
        X = t(linalg.solve_lower(F[..., None, :, :], t(A[..., a:e, :r])))  # F^{-1} A_cr, (nc, r)
        u = linalg.solve_lower(F, b[..., a:e])
        S = S - t(X) @ X
        br = br - (t(X) @ u[..., None])[..., 0]
        factors.append((F, X, u))
    x = torch.empty_like(b)
    if r:
        Fr = linalg.cholesky(S)
        x[..., :r] = linalg.solve_upper_t(Fr, linalg.solve_lower(Fr, br))
    for (a, e), (F, X, u) in zip(part.chains, factors):
        x[..., a:e] = linalg.solve_upper_t(F, u - (X @ x[..., :r, None])[..., 0])
    return x


# ------------------------------------------------------------ per-env tensors
def hfield_table(m: Model) -> torch.Tensor:
    """The (nrow, ncol) f32 height table the heightfield build reads."""
    z = C.hfield_heights(m).contiguous()
    if z.dtype != torch.float32 or tuple(z.shape) != (m.spec.hfield_nrow, m.spec.hfield_ncol):
        raise TypeError(f"height table must be float32 (nrow, ncol), got {z.dtype} {tuple(z.shape)}")
    return z


def kernel_tensors(m: Model, d: Data, ctrl: torch.Tensor, n_substeps: int,
                   hfield: Optional[torch.Tensor] = None):
    """(inputs, outputs) of one launch, in MkArgs order. Inputs are checked,
    outputs allocated with torch.empty on the inputs' device. On a
    heightfield model the height table is the last input: `hfield` where the
    caller keeps one, else a fresh `hfield_table(m)`."""
    s = m.spec
    if n_substeps < 1:
        raise ValueError("n_substeps must be >= 1")
    B = d.qpos.shape[0]
    if B < 1:
        raise ValueError("the kernel needs at least one env")
    dev = d.qpos.device
    state = [("qpos", d.qpos, (B, s.nq)), ("qvel", d.qvel, (B, s.nv)),
             ("ctrl", ctrl, (B, s.nu)), ("qacc_warmstart", d.qacc_warmstart, (B, s.nv))]
    for name, t, shape in state:
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32 on {dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def per_env(x: torch.Tensor, shape) -> torch.Tensor:
        if x.device != dev or x.dtype != torch.float32:
            raise TypeError(f"model field must be float32 on {dev}, got {x.dtype} on {x.device}")
        return x.expand((B,) + shape).contiguous()

    fl = s.floor_geom_id
    inputs = [
        d.qpos, d.qvel, ctrl, d.qacc_warmstart,
        per_env(m.qpos0, (s.nq,)),
        per_env(m.actuator_gainprm[..., 0], (s.nu,)),
        per_env(m.actuator_biasprm[..., 0], (s.nu,)),
        per_env(m.actuator_biasprm[..., 1], (s.nu,)),
        per_env(m.actuator_biasprm[..., 2], (s.nu,)),
        per_env(m.dof_frictionloss, (s.nv,)),
        per_env(m.dof_armature, (s.nv,)),
        per_env(m.body_mass, (s.nbody,)),
        per_env(m.body_ipos, (s.nbody, 3)),
        per_env(m.geom_friction[..., fl, 0], ()),
    ]
    if s.floor_is_hfield:
        table = hfield_table(m) if hfield is None else hfield
        if table.device != dev:
            raise TypeError(f"height table on {table.device}, state on {dev}")
        inputs.append(table)
    e = lambda *shape: torch.empty((B,) + shape, dtype=torch.float32, device=dev)
    outputs = [
        e(s.nq), e(s.nv), e(s.nv), e(s.nv), e(s.nsite, 3), e(s.nsite, 3, 3),
        e(s.nu), e(s.ncon_max), e(s.nsensordata),
    ]
    return inputs, outputs


def data_from_outputs(d: Data, ctrl: torch.Tensor, outputs) -> Data:
    qpos, qvel, qacc, warm, sxp, sxm, af, cd, sd = outputs
    return d.replace(
        qpos=qpos, qvel=qvel, ctrl=ctrl, qacc=qacc, qacc_warmstart=warm,
        site_xpos=sxp, site_xmat=sxm, actuator_force=af, contact_dist=cd,
        sensordata=sd,
    )


def pointer_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


# ------------------------------------------------------------ build and bind
def dim_flags(dims: Dict[str, int]) -> List[str]:
    return [f"-DMK_{k}={v}" for k, v in sorted(dims.items())]


SOURCE, HEADERS = "megakernel.cu", ("megakernel.cuh",)


def build_flags(dims: Dict[str, int]) -> List[str]:
    """nvcc's flags of the build for a model of `dims` (beside cuda_build's own)."""
    return [*dim_flags(dims), f"-I{CSRC}"]


class _Kernel:
    """One built library: its ctypes handle, path, build time and ptxas
    report, and the records of the models it has stepped."""

    def __init__(self, dims: Dict[str, int], dense: bool = False, source: str = SOURCE):
        self.dims, self.dense = dims, dense
        self.launches = 0
        built = cuda_build.build(source, build_flags(dims), headers=HEADERS)
        self.path, self.build_seconds, self.ptxas = built.path, built.build_seconds, built.ptxas_lines()
        lib = built.lib
        lib.mk_model_size.restype = ctypes.c_int
        lib.mk_shared_size.restype = ctypes.c_int
        lib.mk_configure.restype = ctypes.c_int
        lib.mk_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.mk_step.restype = ctypes.c_int
        lib.mk_kernel_info.argtypes = [ctypes.c_void_p]
        lib.mk_kernel_info.restype = ctypes.c_int
        self.lib = lib
        if lib.mk_model_size() != ctypes.sizeof(model_struct_type(dims)):
            raise RuntimeError("MkModel layout differs between megakernel.cuh and the wrapper")
        self._records: Dict[Tuple[int, int], Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
        self._configured = set()  # device indices

    def record(self, m: Model, dev: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The record of `m` on the CUDA device `dev` and its height table
        (None on a plane), by the model's identity. Domain randomization
        changes only the per-env inputs, so a randomized model has one
        record too."""
        key = (id(m), dev.index)
        rec = self._records.get(key)
        if rec is not None:
            return rec
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a model's kernel record is made at its first eager launch on a device, not inside "
                               "a CUDA graph capture: run the step once eagerly before capturing it")
        with torch.cuda.device(dev):
            if dev.index not in self._configured:
                err = self.lib.mk_configure()
                if err:
                    raise RuntimeError(f"mk_configure failed: CUDA error {err}")
                self._configured.add(dev.index)
            table = hfield_table(m) if m.spec.floor_is_hfield else None
            # a blocking copy after the table's work: both are on the card
            # for any stream's launch
            rec = self._records[key] = (model_record(m, self.dense, dev), table)
        weakref.finalize(m, self._records.pop, key, None)
        return rec

    def info(self) -> Dict[str, int]:
        """Local memory, registers, shared memory and occupancy of the
        built kernel."""
        out = (ctypes.c_int * 9)()
        err = self.lib.mk_kernel_info(out)
        if err:
            raise RuntimeError(f"mk_kernel_info failed: CUDA error {err}")
        info = dict(local_bytes_per_thread=out[0], registers_per_thread=out[1],
                    max_threads_per_block=out[2], blocks_per_sm=out[3], sms=out[4],
                    shared_bytes_per_block=out[5], lanes_per_env=out[6], block_size=out[7],
                    shared_bytes_per_env=out[8])
        info["envs_per_block"] = info["block_size"] // info["lanes_per_env"]
        info["resident_envs_per_sm"] = info["blocks_per_sm"] * info["envs_per_block"]
        info["resident_warps_per_sm"] = info["blocks_per_sm"] * info["block_size"] / 32
        return info


_KERNELS: Dict[Tuple, _Kernel] = {}


def kernel(spec: ModelSpec, dense: bool = False) -> _Kernel:
    """The built kernel for this model shape (built at first use). `dense`
    builds it on the degenerate partition."""
    dims = kernel_dims(spec, dense)
    key = tuple(sorted(dims.items()))
    if key not in _KERNELS:
        _KERNELS[key] = _Kernel(dims, dense)
    return _KERNELS[key]


def build_launches() -> Dict[Tuple, int]:
    """Each built library's launches since the last reset, keyed by its
    `kernel_dims` as sorted items (a reader recovers the dims with
    `dict(key)`)."""
    return {key: k.launches for key, k in _KERNELS.items()}


class Captured:
    """The counted launches made while a CUDA graph was captured (`capture`):
    for each, the function that counts it and every tensor whose device
    address the launch baked into the graph (for the physics kernel, the
    model's record among them). The graph's memory pool does not see the
    pointers ctypes passes, so the holder of the graph keeps this object
    with it. The task kernels (`envs/task_kernel.py`) record here too."""

    def __init__(self):
        self.launches: List[Tuple[Callable[[], None], List[torch.Tensor]]] = []

    def count_replay(self) -> None:
        """Count the captured launches once, as a replay of the graph runs
        them."""
        for count, _ in self.launches:
            count()


_capturing: Optional[Captured] = None


@contextlib.contextmanager
def capture():
    """Inside the block, a counted launch (`launched`) is recorded in the
    `Captured` it yields and not counted: under a CUDA graph's capture a
    kernel runs only when the graph is replayed."""
    global _capturing
    outer, _capturing = _capturing, Captured()
    try:
        yield _capturing
    finally:
        _capturing = outer


def launched(count: Callable[[], None], held: Sequence[torch.Tensor] = ()) -> None:
    """Count one launch with `count()`, or inside `capture` keep `held` (the
    tensors whose addresses the launch baked in) and count it at each
    replay."""
    if _capturing is not None:
        _capturing.launches.append((count, list(held)))
    else:
        count()


def _count(k: _Kernel, m: Model) -> None:
    global launches, launches_hfield, launches_dense
    launches += 1
    k.launches += 1
    launches_hfield += int(m.spec.floor_is_hfield)
    launches_dense += int(k.dims["NROOT"] == 0)


def megakernel_step(m: Model, d: Data, ctrl: torch.Tensor, n_substeps: int,
                    dense: bool = False) -> Data:
    """n_substeps substeps of every env in one launch of the CUDA kernel.
    Takes CUDA tensors only (`forward.step` routes CPU tensors to the plain
    version). `dense` chooses the build as in `kernel`."""
    if not d.qpos.is_cuda:
        raise TypeError(f"the CUDA kernel takes CUDA tensors, got qpos on {d.qpos.device}")
    k = kernel(m.spec, dense)
    record, hfield = k.record(m, d.qpos.device)
    inputs, outputs = kernel_tensors(m, d, ctrl, n_substeps, hfield)
    # on the current stream of the tensors' device, which must be the
    # current device (a launch on another device's stream is refused)
    err = k.lib.mk_step(record.data_ptr(), pointer_array(inputs + outputs), d.qpos.shape[0], n_substeps,
                        torch.cuda.current_stream(d.qpos.device).cuda_stream)
    if err:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    launched(functools.partial(_count, k, m), [record] + inputs + outputs)
    return data_from_outputs(d, ctrl, outputs)
