"""Quaternion, rotation and spatial-algebra primitives.

Every function broadcasts over leading batch dims and keeps the input dtype.
Quaternions use MuJoCo's (w, x, y, z) order. Motion vectors are 6-vectors
(angular, linear); force vectors are (torque, force).
Counterpart of `open_duck_playground_tpu/physics/maths.py`.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, (…,4)x(…,4)->(…,4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v (…,3) by quaternion q (…,4): R(q) @ v."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(…,4) -> (…,3,3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (…,3) + angle (…,) -> quaternion (…,4)."""
    half = 0.5 * angle
    s = torch.sin(half)
    axis, s = torch.broadcast_tensors(axis, s[..., None])
    return torch.cat([torch.cos(half)[..., None].expand(s.shape[:-1] + (1,)), axis * s], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Integrate q by a local-frame angular velocity over dt (exponential
    map, mju_quatIntegrate semantics), then normalize."""
    angle = torch.linalg.vector_norm(omega_local, dim=-1)
    small = angle < 1e-12
    safe = torch.where(small, torch.ones_like(angle), angle)
    axis = omega_local / safe[..., None]
    dq = axis_angle_to_quat(axis, angle * dt)
    ident = dq.new_tensor([1.0, 0.0, 0.0, 0.0])
    dq = torch.where(small[..., None], ident, dq)
    out = quat_mul(q, dq)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial cross product of motion vectors v x m (…,6)."""
    vang, vlin = v[..., :3], v[..., 3:]
    mang, mlin = m[..., :3], m[..., 3:]
    return torch.cat(
        [cross(vang, mang), cross(vang, mlin) + cross(vlin, mang)], dim=-1
    )


def motion_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product v x* f of a motion and a force vector."""
    vang, vlin = v[..., :3], v[..., 3:]
    ftor, flin = f[..., :3], f[..., 3:]
    return torch.cat(
        [cross(vang, ftor) + cross(vlin, flin), cross(vang, flin)], dim=-1
    )


def skew(v: torch.Tensor) -> torch.Tensor:
    """(…,3) -> (…,3,3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def inertia_matrix(mass, inertia_diag, ipos, imat) -> torch.Tensor:
    """Spatial inertia (…,6,6) about a world-frame origin.

    mass (…), inertia_diag (…,3) principal moments, ipos (…,3) CoM relative
    to the origin, imat (…,3,3) principal frame -> world. Layout (angular
    first): I = [[Ic + m c^ c^T, m c^], [m c^T, m 1]], c^ = skew(ipos).
    """
    ic = imat @ (inertia_diag[..., :, None] * imat.transpose(-1, -2))
    cx = skew(ipos)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=ipos.dtype, device=ipos.device)
    top_left = ic + m * (cx @ cx.transpose(-1, -2))
    top_right = m * cx
    bot_left = m * cx.transpose(-1, -2)
    bot_right = m * eye
    return torch.cat(
        [
            torch.cat([top_left, top_right], dim=-1),
            torch.cat([bot_left, bot_right], dim=-1),
        ],
        dim=-2,
    )
