"""Operations and bytes of one launch of the port's physics megakernel, and
the data-dependent rows it works on: a frozen copy of the port's
`tools/count_kernel_ops.py:megakernel_work`, of `physics/megakernel.py`'s
`partition` and `kernel_dims` (the block-arrow partition the count follows)
and of `chip_smoke.py`'s `active_rows`, on the reference's frozen
`physics/structure.py`. A later change of the port's kernel or its tables
does not move this count; the kernel's roofline share is the least time it
gives over the kernel's measured time.

The count is of the cheapest known form of each stage (see
`megakernel_work`), the bound the least time for the function, so a share
of it can only read low, never above 100%.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.physics import structure
from benchmark.reference.physics.types import ModelSpec


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


def megakernel_work(m, n_envs: int, n_substeps: int, active_contacts: float, active_limits: float,
                    dense: bool = False):
    """(bytes, f32 operations, f32 operations of the dense form) the
    kernel's function needs for one launch.

    Bytes: each per-env input read once and each output written once, and
    on a heightfield the height table once per launch (all envs share it).
    Operations: counted from the loops of csrc/megakernel.cuh, one per add,
    multiply, divide, sqrt, sin or cos, with the data-dependent rows (active
    contacts and joint limits) at this run's average. The bound is the least
    time for the function, so each stage is counted in the cheapest of its
    known forms, whether or not the source takes it: the block-arrow
    factorization, products and solves on the model's partition (`dense`:
    on the degenerate one), contact rows as three base rows on the foot's
    support, and the contact curvature as the lesser of four facet rank-1
    updates and the folded 3 x 3 form with W J formed once per support
    column (the source recomputes W J per entry, 17 operations in place of
    6). The third number is the same function
    in the dense form (packed 30 x 30 Cholesky twice, four dense facet rows
    per contact), which earlier tables of PERF.md were counted in."""
    s = m.spec
    d = kernel_dims(s)
    nq, nv, nu, nb, nj = s.nq, s.nv, s.nu, s.nbody, s.njnt
    # qpos qvel ctrl warmstart | qpos0 gain0 bias0-2 frictionloss armature mass ipos mu
    floats_in = nq + nv + nu + nv + nq + 4 * nu + 2 * nv + nb + 3 * nb + 1
    floats_out = nq + 3 * nv + s.nsite * 12 + nu + s.ncon_max + s.nsensordata
    nbytes = 4 * n_envs * (floats_in + floats_out)
    if s.floor_is_hfield:
        nbytes += 4 * s.hfield_nrow * s.hfield_ncol

    anc = m.ancestor_mask.cpu().numpy()
    pred = structure.dof_pred_mask(s)
    dof_body = list(s.dof_bodyid)
    rot, qmul, qmat = 27, 28, 30  # quat_rot, quat_mul, quat_mat
    hinge = sum(1 for j in range(nj) if s.jnt_type[j] == 3)
    ops = 0
    ops += (nb - 1) * (rot + 3 + qmul) + hinge * (3 * rot + qmul + 8 + 9) + 14  # FK
    ops += nb * (rot + 3 + qmul + qmat) + nb * 7 + 3  # xipos, ximat, CoM
    ops += hinge * 12 + 3 * 15 + qmat  # cdof
    ops += nb * (3 + 5 + 9 * 3 * 5 + 9 * 4) + (nb - 1) * 13  # body and composite inertias
    ops += sum(30 + 12 * int(anc[dof_body[i], : i + 1].sum()) for i in range(nv)) + nv  # M
    ops += 12 * int(anc.sum()) + 12 * int(pred.sum()) + nv * (27 + 6)  # cvel, cdof_dot
    ops += 12 * int(anc.sum()) + nb * (2 * 33 + 27 + 6) + (nb - 1) * 6 + nv * 14  # RNE
    ops += nu * 8  # servos
    nfoot, nvert, frame = len(s.collide_geom_ids), d["NVERT"], 27  # frame: 2 cross, dot, sqrt, 3 div
    if s.floor_is_hfield:
        # hfield_height_normal: cell coordinates 8, height 8, slopes 6, unit normal 8, offsets 2
        height_normal = 32
        ops += rot + 3 + nfoot * (rot + 3 + qmul) + nfoot * nvert * (rot + 3 + height_normal + 3)
        ops += s.ncon_max * (height_normal + 6 + frame)  # the chosen vertices: normal again, point, frame
    else:
        ops += (nfoot + 1) * (rot + 3 + qmul) + nfoot * nvert * (rot + 8) + frame
    nlim_act, ncon_act = active_limits, active_contacts
    foot_dofs = float(np.mean([anc[s.geom_bodyid[g]].sum() for g in s.collide_geom_ids]))
    ops += d["NFRIC"] * 3 + d["NLIM"] * 30 + s.ncon_max * 40  # row constants, impedances
    ops += 2 * nv + 3 * nv + 2 * 7 + 30 + 10  # integrate
    last = s.nsite * (rot + qmul + qmat) + len(s.sensors) * 30 + 12 * int(anc[s.site_bodyid[0]].sum())
    rows_active = d["NFRIC"] + nlim_act + 4 * ncon_act

    # ---- the solver in the dense form: packed Cholesky, dense facet rows
    chol = sum((nv - k) + (nv - k - 1) * (nv - k) for k in range(nv)) + nv
    solve = 2 * nv * nv
    dense_rows = 4 * ncon_act
    jx = d["NFRIC"] + nlim_act + dense_rows * 2 * nv  # one J x over the active rows
    dense_ops = chol + solve  # qacc_smooth
    dense_ops += ncon_act * (4 * foot_dofs * (9 + 3 + 5 + 2) + 24)  # contact Jacobian rows
    dense_ops += 2 * (2 * nv * nv + 3 * nv + jx + rows_active * 8)  # two start costs
    dense_ops += 2 * nv * nv + 2 * nv + jx + rows_active * 6  # gradient
    dense_ops += dense_rows * (foot_dofs * (foot_dofs + 1))  # Hessian rank-1 updates
    dense_ops += chol + solve + jx + 2 * nv * nv + 4 * nv  # Newton direction, line data
    dense_ops += s.ls_iterations * (rows_active * 10 + 6)  # linesearch

    # ---- the solver in the block-arrow form of the source
    part = partition(s, dense)
    r, lens = part.root, [e - a for a, e in part.chains]
    tri = lambda n: n * (n + 1) // 2
    fac = lambda n: sum(2 + (n - k - 1) + (n - k - 1) * (n - k) for k in range(n))  # sqrt, 1/x, scale, updates
    chol = sum(fac(n) + sum(r + 2 * r * (n - k - 1) for k in range(n)) for n in lens)  # chains, panels
    chol += 2 * tri(r) * sum(lens) + fac(r)  # Schur complement, root
    tri_solve = lambda n: n * (n - 1) + n  # one triangular solve
    solve = sum(2 * tri_solve(n) + 4 * r * n for n in lens) + 2 * tri_solve(r)
    nba = d["NBA"] if not dense else tri(nv)
    symv = 2 * (2 * nba - nv)
    base = 6 * foot_dofs  # three base rows of one contact times a vector
    jx = d["NFRIC"] + nlim_act + ncon_act * (base + 8)
    ba_ops = chol + solve  # qacc_smooth
    ba_ops += ncon_act * (foot_dofs * 27 + base + 8)  # base rows on the support, facet velocities
    ba_ops += nv + symv + 2 * nv + 2 * jx + 2 * rows_active * 8  # two start costs (no quadratic term at qacc_smooth)
    ba_ops += nv + symv + jx + rows_active * 6 + ncon_act * 16  # residuals, g and h, facets folded
    ba_ops += 2 * (d["NFRIC"] + nlim_act) + ncon_act * base  # gradient and Hessian diagonal, gathered per dof
    # contact curvature on the support triangle: facet rank-1 updates, or W J
    # per column (W is 3 x 3 with t1t2 = 0: 11) and 6 per entry
    ba_ops += ncon_act * min(4 * foot_dofs * (foot_dofs + 1), 11 * foot_dofs + 6 * tri(int(round(foot_dofs))))
    ba_ops += chol + solve + nv + jx + symv + 4 * nv  # Newton direction, line data
    ba_ops += s.ls_iterations * (rows_active * 10 + 6)  # linesearch

    total = lambda solver: n_envs * ((ops + solver) * n_substeps + last)
    return nbytes, total(ba_ops), total(dense_ops)


def active_rows(m, d):
    """Mean active contacts and joint-limit rows per env in this run's
    step (contacts of the last substep, limits at the step's end), the
    data-dependent part of the kernel's work."""
    lj = [int(j) for j in structure.limited_hinges(m.spec)]
    q = d.qpos[:, [m.spec.jnt_qposadr[j] for j in lj]]
    dist = torch.minimum(q - m.jnt_range[lj, 0], m.jnt_range[lj, 1] - q)
    limits = float((dist < m.jnt_margin[lj]).float().sum(1).mean())
    contacts = float((d.contact_dist < 0).float().sum(1).mean())
    return contacts, limits
