"""Sensors of the duck's 15 site-based sensors, batched over envs.
Counterpart of `open_duck_playground_tpu/physics/sensors.py`."""

from __future__ import annotations

import torch

from benchmark.reference.physics import maths
from benchmark.reference.physics.types import Model


def body_cacc(m: Model, cdof, cdof_dot, qvel, qacc):
    """Post-dynamics body spatial accelerations (mj_rnePostConstraint role):
    cacc_b = [0; -g] + sum over dofs above b of cdof_dot*qvel + cdof*qacc."""
    a0 = torch.cat([torch.zeros(3, dtype=cdof.dtype, device=cdof.device), -m.gravity])
    mask = m.ancestor_mask.to(cdof.dtype)
    return a0 + torch.einsum(
        "bv,nvk->nbk", mask, cdof_dot * qvel[..., None] + cdof * qacc[..., None]
    )


def sensor_data(m: Model, xquat, site_xpos, site_xmat, com, cvel, cacc) -> torch.Tensor:
    s = m.spec
    B = site_xpos.shape[0]
    out = torch.zeros((B, s.nsensordata), dtype=site_xpos.dtype, device=site_xpos.device)
    for kind, objid, adr, dim in s.sensors:
        b = s.site_bodyid[objid]
        p = site_xpos[:, objid]
        rot = site_xmat[:, objid]  # world <- site
        rot_t = rot.transpose(-1, -2)
        w = cvel[:, b, :3]
        v_p = cvel[:, b, 3:] + maths.cross(w, p - com)
        if kind == "gyro":
            val = _mv(rot_t, w)
        elif kind == "velocimeter":
            val = _mv(rot_t, v_p)
        elif kind == "accelerometer":
            a_p = cacc[:, b, 3:] + maths.cross(cacc[:, b, :3], p - com) + maths.cross(w, v_p)
            val = _mv(rot_t, a_p)
        elif kind == "framezaxis":
            val = rot[..., :, 2]
        elif kind == "framexaxis":
            val = rot[..., :, 0]
        elif kind == "framelinvel":
            val = v_p
        elif kind == "frameangvel":
            val = w
        elif kind == "framepos":
            val = p
        elif kind == "framequat":
            val = maths.quat_mul(xquat[:, b], m.site_quat[objid])
        else:  # pragma: no cover
            raise NotImplementedError(kind)
        out[:, adr : adr + dim] = val
    return out


def _mv(A, x):
    return torch.matmul(A, x[..., None])[..., 0]
