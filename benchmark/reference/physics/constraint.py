"""Constraint rows with static shape, MuJoCo soft-constraint semantics,
batched over envs. Counterpart of
`open_duck_playground_tpu/physics/constraint.py`.

Row layout:
  [0, nfric)                  dof frictionloss rows (always active)
  [nfric, nfric+nlimit)       joint limit rows (active iff violated)
  [nfric+nlimit, nefc)        contact pyramid facets, 4 per contact slot,
                              active iff dist < 0
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.physics import maths, structure
from benchmark.reference.physics.types import Contact, Model

MINVAL = 1e-15
MINIMP, MAXIMP = 0.0001, 0.9999


class EfcRows(NamedTuple):
    J: torch.Tensor  # (B, nefc, nv)
    aref: torch.Tensor  # (B, nefc)
    D: torch.Tensor  # (B, nefc) inverse regularizer, 0 on inactive rows
    R: torch.Tensor  # (B, nefc)
    frictionloss: torch.Tensor  # (B, nefc) > 0 marks a friction (Huber) row


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=MINVAL), 0.0, 1.0)
    a = 1.0 / torch.pow(mid, power - 1)
    b = 1.0 / torch.pow(1 - mid, power - 1)
    y = torch.where(x < mid, a * torch.pow(x, power), 1 - b * torch.pow(1 - x, power))
    return torch.clamp(dmin + y * (dmax - dmin), MINIMP, MAXIMP)


def kb(solref: torch.Tensor, solimp: torch.Tensor):
    """Stiffness and damping from solref (standard positive form, or the
    direct negative form K = -solref0, B = -solref1)."""
    tc, zeta = solref[..., 0], solref[..., 1]
    dmax = solimp[..., 1]
    k_std = 1.0 / torch.clamp(dmax * dmax * tc * tc * zeta * zeta, min=MINVAL)
    b_std = 2.0 / torch.clamp(dmax * tc, min=MINVAL)
    direct = (tc <= 0) | (zeta <= 0)
    return torch.where(direct, -tc, k_std), torch.where(direct, -zeta, b_std)


def make_constraints(m: Model, qpos, qvel, cdof, com, contact: Contact) -> EfcRows:
    s = m.spec
    B, dtype, dev = qpos.shape[0], qpos.dtype, qpos.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)

    # dof friction rows (always active)
    fd = list(s.friction_dofs)
    e_fric = torch.as_tensor(structure.one_hot_dofs(s, s.friction_dofs), dtype=dtype, device=dev)
    imp_f = impedance(m.dof_solimp[fd], zeros(len(fd)))
    _, b_f = kb(m.dof_solref[fd], m.dof_solimp[fd])
    aref_f = -b_f * qvel[:, fd]
    r_f = torch.clamp((1 - imp_f) / imp_f * m.dof_invweight0[fd], min=MINVAL)
    J_f = e_fric.expand(B, len(fd), s.nv)
    D_f = (1.0 / r_f).expand(B, len(fd))
    fl_f = m.dof_frictionloss[:, fd]

    # joint limit rows (one per limited hinge, active iff dist < margin)
    lj = [int(j) for j in structure.limited_hinges(s)]
    lq = [s.jnt_qposadr[j] for j in lj]
    ld = [s.jnt_dofadr[j] for j in lj]
    e_lim = torch.as_tensor(structure.one_hot_dofs(s, tuple(ld)), dtype=dtype, device=dev)
    q = qpos[:, lq]
    lo, hi = m.jnt_range[lj, 0], m.jnt_range[lj, 1]
    dist_lo, dist_hi = q - lo, hi - q
    sign = torch.where(dist_lo < dist_hi, 1.0, -1.0).to(dtype)
    dist = torch.minimum(dist_lo, dist_hi)
    margin = m.jnt_margin[lj]
    active_l = dist < margin
    pos_l = dist - margin
    imp_l = impedance(m.jnt_solimp[lj], pos_l)
    k_l, b_l = kb(m.jnt_solref[lj], m.jnt_solimp[lj])
    aref_l = -b_l * sign * qvel[:, ld] - k_l * imp_l * pos_l
    r_l = torch.clamp((1 - imp_l) / imp_l * m.dof_invweight0[ld], min=MINVAL)
    J_l = torch.where(active_l[..., None], sign[..., None] * e_lim, 0.0)
    aref_l = torch.where(active_l, aref_l, 0.0)
    D_l = torch.where(active_l, 1.0 / r_l, 0.0)
    fl_l = zeros(B, len(lj))

    # contact pyramid facets (4 per slot)
    ncon = s.ncon_max
    foot_bodies = [s.geom_bodyid[g] for g in s.collide_geom_ids]
    slot_body = [b for b in foot_bodies for _ in range(s.points_per_foot)]
    floor_b = s.geom_bodyid[s.floor_geom_id]
    mask = m.ancestor_mask.to(dtype)[slot_body]  # (ncon, nv)
    # translational point jacobian per slot: (B, ncon, 3, nv)
    jp = mask[None, :, None, :] * (
        cdof[:, None, :, 3:]
        + maths.cross(cdof[:, None, :, :3], (contact.pos - com[:, None, :])[:, :, None, :])
    ).transpose(-1, -2)
    n = contact.frame[:, :, 0]  # (B, ncon, 3)
    t = contact.frame[:, :, 1:]  # (B, ncon, 2, 3)
    mu = contact.friction[..., :2]  # (B, ncon, 2)
    sgn = torch.tensor([1.0, -1.0], dtype=dtype, device=dev)
    # facet order (+t1, -t1, +t2, -t2), as MuJoCo
    dirs = (
        n[:, :, None, None, :]
        + sgn[None, None, None, :, None] * mu[..., None, None] * t[:, :, :, None, :]
    ).reshape(B, ncon, 4, 3)
    J_c = torch.einsum("ncfk,nckv->ncfv", dirs, jp)  # (B, ncon, 4, nv)
    dist_c = contact.dist
    active_c = dist_c < 0.0
    imp_c = impedance(contact.solimp, dist_c)
    k_c, b_c = kb(contact.solref, contact.solimp)
    vel_c = torch.matmul(J_c, qvel[:, None, :, None])[..., 0]  # (B, ncon, 4)
    aref_c = -b_c[..., None] * vel_c - (k_c * imp_c * dist_c)[..., None]
    invw = m.body_invweight0[slot_body, 0] + m.body_invweight0[floor_b, 0]
    mu2 = mu**2
    diag = (2.0 * mu2 * (1.0 + mu2) * invw[:, None])[..., None]  # (B, ncon, 2, 1)
    diag = diag.expand(B, ncon, 2, 2).reshape(B, ncon, 4)
    r_c = torch.clamp((1 - imp_c[..., None]) / imp_c[..., None] * diag, min=MINVAL)
    J_c = torch.where(active_c[..., None, None], J_c, 0.0).reshape(B, ncon * 4, s.nv)
    aref_c = torch.where(active_c[..., None], aref_c, 0.0).reshape(B, -1)
    D_c = torch.where(active_c[..., None], 1.0 / r_c, 0.0).reshape(B, -1)
    r_c = r_c.reshape(B, -1)
    fl_c = zeros(B, ncon * 4)

    return EfcRows(
        J=torch.cat([J_f, J_l, J_c], 1),
        aref=torch.cat([aref_f, aref_l, aref_c], 1),
        D=torch.cat([D_f, D_l, D_c], 1),
        R=torch.cat([r_f.expand(B, len(fd)), r_l, r_c], 1),
        frictionloss=torch.cat([fl_f, fl_l, fl_c], 1),
    )
