"""Primal Newton constraint solver (MuJoCo Newton semantics: exact Hessian,
analytic piecewise-quadratic linesearch), dense, batched over envs.

Minimizes over x = qacc
    L(x) = 1/2 (x-a)^T M (x-a) + sum_i c_i(J_i x - aref_i)
with c_i quadratic-if-violating on unilateral rows and Huber on dof friction
rows. Counterpart of `open_duck_playground_tpu/physics/solver.py`. The
system is ill-conditioned: its products must run in true f32, never TF32
(`forward.pin_f32` asserts that).
"""

from __future__ import annotations

import torch

from benchmark.reference.physics import linalg as LA
from benchmark.reference.physics.constraint import EfcRows
from benchmark.reference.physics.types import Model


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (B,m,n) x (B,n) -> (B,m)."""
    return torch.matmul(A, x[..., None])[..., 0]


def _force_and_hess(efc: EfcRows, jar):
    """Per-row dc/djar (= -force) and d2c/djar2."""
    fl = efc.frictionloss
    is_fric = fl > 0
    quad_f = efc.D * jar
    uni_g = torch.where(jar < 0, quad_f, 0.0)
    uni_h = torch.where(jar < 0, efc.D, 0.0)
    fr_g = torch.clamp(quad_f, -fl, fl)
    fr_h = torch.where(torch.abs(quad_f) < fl, efc.D, 0.0)
    return torch.where(is_fric, fr_g, uni_g), torch.where(is_fric, fr_h, uni_h)


def _cost(efc: EfcRows, M, a_smooth, x):
    jar = _mv(efc.J, x) - efc.aref
    fl = efc.frictionloss
    is_fric = fl > 0
    quad = 0.5 * efc.D * jar * jar
    uni = torch.where(jar < 0, quad, 0.0)
    # Huber: linear beyond |jar| = fl * R
    lin = fl * torch.abs(jar) - 0.5 * fl * fl * efc.R
    fr = torch.where(torch.abs(efc.D * jar) < fl, quad, lin)
    ccost = torch.where(is_fric, fr, uni).sum(-1)
    dx = x - a_smooth
    return 0.5 * torch.sum(dx * _mv(M, dx), -1) + ccost


def solve(m: Model, M, qacc_smooth, warmstart, efc: EfcRows) -> torch.Tensor:
    """qacc (B, nv) after `iterations` Newton steps."""
    s = m.spec
    # start from the better of warmstart and qacc_smooth (mj_warmstart)
    c_w = _cost(efc, M, qacc_smooth, warmstart)
    c_s = _cost(efc, M, qacc_smooth, qacc_smooth)
    x = torch.where((c_w < c_s)[:, None], warmstart, qacc_smooth)
    Jt = efc.J.transpose(-1, -2)

    for _ in range(s.iterations):
        jar = _mv(efc.J, x) - efc.aref
        g_rows, h_rows = _force_and_hess(efc, jar)
        grad = _mv(M, x - qacc_smooth) + _mv(Jt, g_rows)
        H = M + torch.matmul(Jt * h_rows[:, None, :], efc.J)
        dx = -LA.cholesky_solve(H, grad)

        jv = _mv(efc.J, dx)
        mv = _mv(M, dx)
        g0 = torch.sum(dx * _mv(M, x - qacc_smooth), -1)
        hq = torch.sum(dx * mv, -1)
        alpha = torch.zeros_like(g0)
        for _ in range(s.ls_iterations):
            jar_a = jar + alpha[:, None] * jv
            g_rows, h_rows = _force_and_hess(efc, jar_a)
            dphi = g0 + alpha * hq + torch.sum(jv * g_rows, -1)
            ddphi = hq + torch.sum(h_rows * jv * jv, -1)
            alpha = alpha - dphi / torch.clamp(ddphi, min=1e-12)
        x = x + alpha[:, None] * dx
    return x
