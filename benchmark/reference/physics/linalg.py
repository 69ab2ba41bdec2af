"""Dense SPD solves for small matrices (nv <= 30), batched over envs.

Counterpart of `open_duck_playground_tpu/physics/linalg.py`: the same
outer-product Cholesky with its pivot floor, written as a loop over the
static dimension so every env factors in lockstep.
"""

from __future__ import annotations

import torch


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD (…, n, n) matrices."""
    n = M.shape[-1]
    tril = torch.tril(torch.ones((n, n), dtype=M.dtype, device=M.device))
    A = M
    L = torch.zeros_like(M)
    for k in range(n):
        pivot = torch.sqrt(torch.clamp(A[..., k, k], min=1e-12))
        col = (A[..., :, k] / pivot[..., None]) * tril[:, k]
        L[..., :, k] = col
        A = A - col[..., :, None] * col[..., None, :]
    return L


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b, L lower-triangular (…,n,n), b (…,n)."""
    n = L.shape[-1]
    x = torch.zeros_like(b)
    for k in range(n):
        xk = (b[..., k] - torch.sum(L[..., k, :] * x, dim=-1)) / L[..., k, k]
        x[..., k] = xk
    return x


def solve_upper_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b, L lower-triangular."""
    n = L.shape[-1]
    x = torch.zeros_like(b)
    for k in range(n - 1, -1, -1):
        xk = (b[..., k] - torch.sum(L[..., :, k] * x, dim=-1)) / L[..., k, k]
        x[..., k] = xk
    return x


def cholesky_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = M^{-1} b for SPD M (…,n,n), b (…,n)."""
    L = cholesky(M)
    return solve_upper_t(L, solve_lower(L, b))
