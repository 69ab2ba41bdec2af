"""Polynomial reference-gait oracle over a precomputed frame table.
Counterpart of `open_duck_playground_tpu/envs/gait_oracle.py`.

The gait library (command grid dx(6) x dy(4) x dtheta(10), 40 output dims,
degree-15 polynomials, 27 steps per period) is evaluated once, in float64,
at every integer phase step: the power-basis coefficients reach 2e5, so an
f32 evaluation on the card would lose about two digits to cancellation.
The hot path is then a nearest-cell lookup and one row gather.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models import loader


class GaitOracle:
    def __init__(self, device="cuda", dtype=torch.float32):
        arrays, meta = loader.load_gait()
        self.period = float(meta["period"])
        self.fps = float(meta["fps"])
        self.nb_steps_in_period = int(self.period * self.fps)
        table = arrays["table"]  # (dx, dy, dtheta, dim, power) float64
        self.dxs, self.dys, self.dthetas = arrays["dxs"], arrays["dys"], arrays["dthetas"]
        self.ndim = table.shape[3]
        ncoef = table.shape[4]
        tgrid = np.arange(self.nb_steps_in_period) / self.nb_steps_in_period
        powers = tgrid[None, :] ** np.arange(ncoef)[:, None]  # (16, 27)
        frames = np.einsum("xytdk,kp->xytpd", table, powers)  # float64
        # (dx, dy, dtheta, phase, dim)
        self.frames = torch.as_tensor(frames, dtype=dtype, device=device)
        self._dxs = torch.as_tensor(self.dxs, dtype=dtype, device=device)
        self._dys = torch.as_tensor(self.dys, dtype=dtype, device=device)
        self._dthetas = torch.as_tensor(self.dthetas, dtype=dtype, device=device)

    @staticmethod
    def _nearest(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(x, grid[0], grid[-1])
        return torch.argmin(torch.abs(grid - x[..., None]), dim=-1)

    def cell_index(self, dx, dy, dtheta):
        return (
            self._nearest(self._dxs, dx),
            self._nearest(self._dys, dy),
            self._nearest(self._dthetas, dtheta),
        )

    def reference_frame(self, dx, dy, dtheta, i) -> torch.Tensor:
        """(B, 40) frames for commands (dx, dy, dtheta) (B,) at integer phase
        steps i (B,)."""
        if i.is_floating_point():
            raise TypeError("reference_frame expects an integer phase step")
        ix, iy, it = self.cell_index(dx, dy, dtheta)
        p = torch.remainder(i.long(), self.nb_steps_in_period)
        return self.frames[ix, iy, it, p]
