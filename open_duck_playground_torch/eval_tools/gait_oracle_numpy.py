"""Numpy twin of `envs/gait_oracle.py` for host-side deployment and eval
loops (reference poly_reference_motion_numpy.py role). Counterpart of
`open_duck_playground_tpu/eval_tools/gait_oracle_numpy.py`."""

from __future__ import annotations

import pathlib

import numpy as np

from open_duck_playground_torch.models import loader, snapshot


class GaitOracleNumpy:
    """The polynomial gait library: the package's snapshot by default, or
    the `.pkl` at `pkl_path` (the reference's format)."""

    def __init__(self, pkl_path: str | None = None):
        if pkl_path is None:
            arrays, meta = loader.load_gait()
        else:
            arrays, meta = snapshot.gait_arrays(pathlib.Path(pkl_path))
        self.period = float(meta["period"])
        self.fps = float(meta["fps"])
        self.nb_steps_in_period = int(self.period * self.fps)
        self.dxs, self.dys, self.dthetas = arrays["dxs"], arrays["dys"], arrays["dthetas"]
        self.table = arrays["table"]  # (dx, dy, dtheta, dim, power), lowest power first

    def reference_frame(self, dx, dy, dtheta, i):
        ix = int(np.argmin(np.abs(self.dxs - np.clip(dx, self.dxs[0], self.dxs[-1]))))
        iy = int(np.argmin(np.abs(self.dys - np.clip(dy, self.dys[0], self.dys[-1]))))
        it = int(np.argmin(np.abs(self.dthetas - np.clip(dtheta, self.dthetas[0], self.dthetas[-1]))))
        coeffs = self.table[ix, iy, it]  # (40, ncoef)
        t = (i % self.nb_steps_in_period) / self.nb_steps_in_period
        out = coeffs[:, -1].copy()
        for k in range(coeffs.shape[1] - 2, -1, -1):
            out = out * t + coeffs[:, k]
        return out

    # reference-compatible alias
    get_reference_motion = reference_frame
