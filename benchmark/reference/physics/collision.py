"""Collision of the convex foot hulls against a plane or heightfield floor,
batched.

Fixed-slot contacts: the `points_per_foot` deepest hull vertices of each
foot, active iff dist < 0. On a heightfield every contact has the normal of
the triangle under its vertex. Counterpart of
`open_duck_playground_tpu/physics/collision.py`.
"""

from __future__ import annotations

import torch

from benchmark.reference.physics import maths
from benchmark.reference.physics.types import Contact, Model


def combine_params(m: Model, foot_gid: int, floor_gid: int):
    """MuJoCo contact-parameter mixing: the higher geom_priority wins
    outright; equal priority takes the elementwise max friction and the
    mean solref/solimp. Returns (friction (…,3), solref (2,), solimp (5,));
    friction carries the env axis when geom_friction does."""
    pf = int(m.geom_priority[foot_gid])
    pl = int(m.geom_priority[floor_gid])
    gf = m.geom_friction
    if pl > pf:
        fric, solref, solimp = gf[..., floor_gid, :], m.geom_solref[floor_gid], m.geom_solimp[floor_gid]
    elif pf > pl:
        fric, solref, solimp = gf[..., foot_gid, :], m.geom_solref[foot_gid], m.geom_solimp[foot_gid]
    else:
        fric = torch.maximum(gf[..., foot_gid, :], gf[..., floor_gid, :])
        solref = 0.5 * (m.geom_solref[foot_gid] + m.geom_solref[floor_gid])
        solimp = 0.5 * (m.geom_solimp[foot_gid] + m.geom_solimp[floor_gid])
    # geom friction is (slide, torsion, roll); contact friction is
    # (tangent1, tangent2, torsional) = (slide, slide, torsion)
    friction = torch.stack([fric[..., 0], fric[..., 0], fric[..., 1]], dim=-1)
    return friction, solref, solimp


def hfield_heights(m: Model) -> torch.Tensor:
    """(nrow, ncol) heights of the heightfield in its geom's frame,
    `data * size[2]` in the model's dtype. The CUDA kernel reads this table."""
    return m.hfield_data * m.hfield_size[2]


def _hfield_height_normal(m: Model, x: torch.Tensor, y: torch.Tensor):
    """Height and unit triangle normal of the heightfield under the points
    (x, y) of its frame, any shape. MuJoCo grid: data (nrow, ncol) in
    [0, 1]; x spans [-sx, sx] over columns, y spans [-sy, sy] over rows;
    z = data * size[2]. Cells split into two triangles along the (+x, +y)
    diagonal; points outside the grid take the border cell."""
    s = m.spec
    sx, sy = m.hfield_size[0], m.hfield_size[1]
    ncol, nrow = s.hfield_ncol, s.hfield_nrow
    dx = 2 * sx / (ncol - 1)
    dy = 2 * sy / (nrow - 1)
    fx = torch.clamp((x + sx) / dx, 0.0, ncol - 1.001)
    fy = torch.clamp((y + sy) / dy, 0.0, nrow - 1.001)
    fi, fj = torch.floor(fx), torch.floor(fy)
    # a NaN coordinate (a blown-up env, kept for the quarantine) reads a
    # cell inside the table and still gives a NaN height
    i, j = fi.long().clamp(0, ncol - 2), fj.long().clamp(0, nrow - 2)
    u, v = fx - fi, fy - fj
    z = hfield_heights(m)
    z00, z10, z01, z11 = z[j, i], z[j, i + 1], z[j + 1, i], z[j + 1, i + 1]
    lower = u + v <= 1.0  # triangle (00, 10, 01), else (11, 10, 01)
    h_lo = z00 + u * (z10 - z00) + v * (z01 - z00)
    h_hi = z11 + (1 - u) * (z01 - z11) + (1 - v) * (z10 - z11)
    h = torch.where(lower, h_lo, h_hi)
    nx = torch.where(lower, -(z10 - z00) / dx, (z01 - z11) / dx)
    ny = torch.where(lower, -(z01 - z00) / dy, (z10 - z11) / dy)
    n = torch.stack([nx, ny, torch.ones_like(nx)], dim=-1)
    return h, n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def collide(m: Model, xpos, xquat) -> Contact:
    """Fixed-slot contact set of every foot against the floor."""
    s = m.spec
    k = s.points_per_foot
    B, dtype, dev = xpos.shape[0], xpos.dtype, xpos.device

    floor_b = s.geom_bodyid[s.floor_geom_id]
    floor_pos = xpos[:, floor_b] + maths.quat_rotate(
        xquat[:, floor_b], m.geom_pos[s.floor_geom_id]
    )
    floor_quat = maths.quat_mul(xquat[:, floor_b], m.geom_quat[s.floor_geom_id])
    n = maths.quat_rotate(floor_quat, torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))

    dists, poss, frames, fric, srefs, simps = [], [], [], [], [], []
    for fi, gid in enumerate(s.collide_geom_ids):
        b = s.geom_bodyid[gid]
        gpos = xpos[:, b] + maths.quat_rotate(xquat[:, b], m.geom_pos[gid])
        gquat = maths.quat_mul(xquat[:, b], m.geom_quat[gid])
        verts = gpos[:, None, :] + maths.quat_rotate(gquat[:, None, :], m.foot_hull[fi])
        rel = verts - floor_pos[:, None, :]
        if s.floor_is_hfield:
            # the heightfield is axis-aligned in the floor body's frame
            # (identity on the duck scenes)
            h, n_vert = _hfield_height_normal(m, rel[..., 0], rel[..., 1])
            d = (rel[..., 2] - h) * n_vert[..., 2]  # height above, onto the normal
        else:
            d = torch.matmul(rel, n[:, :, None])[..., 0]
        neg_d, idx = torch.topk(-d, k, dim=-1)
        pick = idx[..., None].expand(B, k, 3)
        vsel = torch.gather(verts, 1, pick)
        dist = -neg_d
        normal = torch.gather(n_vert, 1, pick) if s.floor_is_hfield else n[:, None, :].expand(B, k, 3)

        pos = vsel - 0.5 * dist[..., None] * normal
        # tangent frame, mju_makeFrame convention: reference axis = the world
        # axis least aligned with the normal, t1 = n x r, t2 = n x t1
        ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
        ey = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
        r = torch.where(
            (torch.abs(normal[..., 0]) <= torch.abs(normal[..., 1]))[..., None], ex, ey
        )
        t1 = maths.cross(normal, r)
        t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
        t2 = maths.cross(normal, t1)
        frame = torch.stack([normal, t1, t2], dim=-2)

        friction, solref, solimp = combine_params(m, gid, s.floor_geom_id)
        dists.append(dist)
        poss.append(pos)
        frames.append(frame)
        fric.append(friction.reshape(-1, 1, 3).expand(B, k, 3))
        srefs.append(solref.expand(B, k, 2))
        simps.append(solimp.expand(B, k, 5))

    return Contact(
        dist=torch.cat(dists, 1),
        pos=torch.cat(poss, 1),
        frame=torch.cat(frames, 1),
        friction=torch.cat(fric, 1),
        solref=torch.cat(srefs, 1),
        solimp=torch.cat(simps, 1),
    )


def feet_contact_flags(m: Model, contact_dist: torch.Tensor) -> torch.Tensor:
    """(B, nfoot) bool contact flags from fixed-slot contact distances."""
    k = m.spec.points_per_foot
    nfoot = len(m.spec.collide_geom_ids)
    d = contact_dist.reshape(contact_dist.shape[:-1] + (nfoot, k))
    return (d < 0).any(dim=-1)
