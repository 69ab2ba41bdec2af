"""Forward kinematics and CoM-centred spatial quantities, batched over envs.

Roles of MuJoCo's mj_kinematics / mj_comPos / mj_comVel. Bodies are walked
one tree level at a time, every env at once. Counterpart of
`open_duck_playground_tpu/physics/kinematics.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.physics import maths, structure
from benchmark.reference.physics.types import FREE, HINGE, Model


def _const(m: Model, x: np.ndarray, dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=m.device)


def kinematics(m: Model, qpos: torch.Tensor):
    """qpos (B, nq) -> (xpos, xquat, xanchor, xaxis, xipos, ximat,
    site_xpos, site_xmat), each with the leading env axis. The randomized
    fields of `m` must already carry it (`Model.expand_batch`)."""
    s = m.spec
    B = qpos.shape[0]
    dtype, dev = qpos.dtype, qpos.device
    xpos = torch.zeros((B, s.nbody, 3), dtype=dtype, device=dev)
    xquat = torch.zeros((B, s.nbody, 4), dtype=dtype, device=dev)
    xquat[..., 0] = 1.0
    xanchor = torch.zeros((B, s.njnt, 3), dtype=dtype, device=dev)
    xaxis = torch.zeros((B, s.njnt, 3), dtype=dtype, device=dev)
    xaxis[..., 2] = 1.0

    for level in structure.tree_levels(s):
        ids = list(level)
        par = [s.body_parentid[b] for b in level]
        pos = xpos[:, par] + maths.quat_rotate(xquat[:, par], m.body_pos[ids])
        quat = maths.quat_mul(xquat[:, par], m.body_quat[ids])

        maxj = max(s.body_jntnum[b] for b in level)
        for k in range(maxj):
            sub = [i for i, b in enumerate(level) if s.body_jntnum[b] > k]
            jids = [s.body_jntadr[level[i]] + k for i in sub]
            free = [(i, j) for i, j in zip(sub, jids) if s.jnt_type[j] == FREE]
            hinge = [(i, j) for i, j in zip(sub, jids) if s.jnt_type[j] == HINGE]
            if free:
                fi = [i for i, _ in free]
                fj = [j for _, j in free]
                fpos = torch.stack([qpos[:, a : a + 3] for a in (s.jnt_qposadr[j] for j in fj)], 1)
                fquat = maths.quat_normalize(
                    torch.stack([qpos[:, a + 3 : a + 7] for a in (s.jnt_qposadr[j] for j in fj)], 1)
                )
                pos[:, fi] = fpos
                quat[:, fi] = fquat
                xanchor[:, fj] = fpos
            if hinge:
                hi = [i for i, _ in hinge]
                hj = [j for _, j in hinge]
                hq = [s.jnt_qposadr[j] for j in hj]
                anchors = pos[:, hi] + maths.quat_rotate(quat[:, hi], m.jnt_pos[hj])
                axes_w = maths.quat_rotate(quat[:, hi], m.jnt_axis[hj])
                angles = qpos[:, hq] - m.qpos0[:, hq]
                quat_new = maths.quat_mul(
                    quat[:, hi], maths.axis_angle_to_quat(m.jnt_axis[hj], angles)
                )
                pos_new = anchors - maths.quat_rotate(quat_new, m.jnt_pos[hj])
                pos[:, hi] = pos_new
                quat[:, hi] = quat_new
                xanchor[:, hj] = anchors
                xaxis[:, hj] = axes_w
        xpos[:, ids] = pos
        xquat[:, ids] = quat

    xipos = xpos + maths.quat_rotate(xquat, m.body_ipos)
    ximat = maths.quat_to_mat(maths.quat_mul(xquat, m.body_iquat))

    site_body = list(s.site_bodyid)
    site_xpos = xpos[:, site_body] + maths.quat_rotate(xquat[:, site_body], m.site_pos)
    site_xmat = maths.quat_to_mat(maths.quat_mul(xquat[:, site_body], m.site_quat))
    return xpos, xquat, xanchor, xaxis, xipos, ximat, site_xpos, site_xmat


def com_cdof(m: Model, xquat, xanchor, xaxis, xipos):
    """Robot subtree CoM (B,3) and per-dof motion vectors cdof (B,nv,6),
    MuJoCo layout (angular, linear), centred at the CoM."""
    s = m.spec
    B, dtype, dev = xipos.shape[0], xipos.dtype, xipos.device
    in_tree = m.ancestor_mask.any(dim=1)
    w = m.body_mass * in_tree
    com = (w[..., None] * xipos).sum(1) / w.sum(1)[..., None]

    cdof = torch.zeros((B, s.nv, 6), dtype=dtype, device=dev)
    hj = structure.hinge_joints(s)
    if hj.size:
        hd = [s.jnt_dofadr[j] for j in hj]
        ax = xaxis[:, hj]
        lin = maths.cross(ax, com[:, None, :] - xanchor[:, hj])
        cdof[:, hd] = torch.cat([ax, lin], dim=-1)

    fj = structure.free_joint(s)
    if fj >= 0:
        d = s.jnt_dofadr[fj]
        b = s.jnt_bodyid[fj]
        eye = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
        cdof[:, d : d + 3] = torch.cat([torch.zeros_like(eye), eye], dim=-1)
        rb = maths.quat_to_mat(xquat[:, b])  # rotational axes are body-frame
        axes = rb.transpose(-1, -2)  # rows = body axes in world
        lin = maths.cross(axes, (com - xanchor[:, fj])[:, None, :])
        cdof[:, d + 3 : d + 6] = torch.cat([axes, lin], dim=-1)
    return com, cdof


def com_vel(m: Model, cdof, qvel):
    """cvel (B,nbody,6) and cdof_dot (B,nv,6) through static predecessor
    masks (mj_comVel semantics as masked matmuls)."""
    s = m.spec
    dtype = cdof.dtype
    vdof = cdof * qvel[..., None]
    anc = m.ancestor_mask.to(dtype)
    cvel = torch.matmul(anc, vdof)
    pred = _const(m, structure.dof_pred_mask(s), dtype)
    carrier = torch.matmul(pred, vdof)
    ftm = _const(m, structure.free_trans_mask(s), dtype)
    cdof_dot = maths.motion_cross(carrier, cdof) * ftm[:, None]
    return cvel, cdof_dot
