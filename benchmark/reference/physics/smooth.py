"""Smooth (unconstrained) dynamics: mass matrix, bias forces, passive forces
and position-servo actuation, batched over envs. Roles of mj_crb / mj_rne /
mj_passive / mj_fwdActuation in the dense form of
`open_duck_playground_tpu/physics/smooth.py`.
"""

from __future__ import annotations

import torch

from benchmark.reference.physics import maths
from benchmark.reference.physics.types import Model


def body_inertias(m: Model, xipos, ximat, com):
    """Spatial inertia of every body about the CoM: (B, nbody, 6, 6)."""
    inertia = m.body_inertia.expand(xipos.shape)
    return maths.inertia_matrix(m.body_mass, inertia, xipos - com[:, None, :], ximat)


def mass_matrix(m: Model, cdof, xipos, ximat, com):
    """Dense joint-space inertia M (B, nv, nv) = sum_b J_b^T I_b J_b with
    J_b the ancestry-masked cdof, armature on the diagonal."""
    ibody = body_inertias(m, xipos, ximat, com)
    mask = m.ancestor_mask.to(cdof.dtype)  # (nbody, nv)
    jb = mask[None, :, :, None] * cdof[:, None, :, :]  # (B, nbody, nv, 6)
    ij = torch.einsum("nbij,nbvj->nbvi", ibody, jb)
    qm = torch.einsum("nbvi,nbwi->nvw", jb, ij)
    return qm + torch.diag_embed(m.dof_armature)


def rne_bias(m: Model, cdof, cdof_dot, cvel, qvel, xipos, ximat, com):
    """qfrc_bias (B, nv) = C(q, qvel) + gravity (mj_rne with qacc = 0)."""
    dtype = cdof.dtype
    gravity_acc = torch.cat([torch.zeros(3, dtype=dtype, device=cdof.device), -m.gravity])
    mask = m.ancestor_mask.to(dtype)
    cacc = gravity_acc + torch.matmul(mask, cdof_dot * qvel[..., None])
    ibody = body_inertias(m, xipos, ximat, com)
    iv = torch.einsum("nbij,nbj->nbi", ibody, cvel)
    f = torch.einsum("nbij,nbj->nbi", ibody, cacc) + maths.motion_cross_force(cvel, iv)
    fsum = torch.matmul(mask.T, f)  # (B, nv, 6)
    return torch.einsum("nvk,nvk->nv", cdof, fsum)


def passive_force(m: Model, qvel):
    """qfrc_passive: viscous joint damping (the duck has no springs)."""
    return -m.dof_damping * qvel


def actuation(m: Model, qpos, qvel, ctrl):
    """Position servos (affine gain/bias): force = gain0*ctrl + bias0 +
    bias1*length + bias2*velocity, ctrl clamped to ctrlrange and force to
    forcerange. Returns (actuator_force (B,nu), qfrc (B,nv))."""
    s = m.spec
    trn_j = [s.jnt_qposadr[j] for j in s.actuator_trnid]
    trn_d = [s.jnt_dofadr[j] for j in s.actuator_trnid]
    length = qpos[:, trn_j]
    velocity = qvel[:, trn_d]
    c = torch.clamp(ctrl, m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1])
    force = (
        m.actuator_gainprm[..., 0] * c
        + m.actuator_biasprm[..., 0]
        + m.actuator_biasprm[..., 1] * length
        + m.actuator_biasprm[..., 2] * velocity
    )
    force = torch.clamp(force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1])
    qfrc = torch.zeros(qvel.shape, dtype=force.dtype, device=force.device)
    qfrc[:, trn_d] = force
    return force, qfrc
