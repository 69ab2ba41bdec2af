"""Read the model snapshot (`models/data/`, written by `models/snapshot.py`)
into torch tensors on a given device and dtype.

Counterpart of `open_duck_playground_tpu/models/loader.py`, without
C-MuJoCo: the arrays were compiled from MJCF ahead of time, so nothing here
needs `mujoco`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import pathlib
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.physics.types import Model, ModelSpec

DATA_DIR = pathlib.Path(__file__).resolve().parent / "data"

_INT_FIELDS = ("geom_priority",)
_BOOL_FIELDS = ("ancestor_mask",)


@functools.lru_cache(maxsize=8)
def _read(scene: str) -> Tuple[dict, dict]:
    meta = json.loads((DATA_DIR / f"{scene}.json").read_text())
    with np.load(DATA_DIR / f"{scene}.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, meta


def _spec(meta: dict, timestep: Optional[float]) -> ModelSpec:
    kw = {}
    for f in dataclasses.fields(ModelSpec):
        v = meta["spec"][f.name]
        if f.name == "sensors":
            v = tuple(tuple(s) for s in v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[f.name] = v
    if timestep is not None:
        kw["timestep"] = float(timestep)
    return ModelSpec(**kw)


def load_model(
    scene: str = "scene_flat_terrain_backlash",
    device="cuda",
    dtype: torch.dtype = torch.float32,
    timestep: Optional[float] = None,
) -> Model:
    """The frozen `Model` of `scene` (an xml stem, e.g.
    `scene_flat_terrain_backlash`)."""
    arrays, meta = _read(scene)
    spec = _spec(meta, timestep)
    fields = {}
    for f in dataclasses.fields(Model):
        if f.name == "spec":
            continue
        x = arrays[f.name]
        if f.name in _INT_FIELDS:
            t = torch.as_tensor(x, dtype=torch.int32)
        elif f.name in _BOOL_FIELDS:
            t = torch.as_tensor(x, dtype=torch.bool)
        else:
            t = torch.as_tensor(x, dtype=dtype)
        fields[f.name] = t.to(device)
    return Model(spec=spec, **fields)


def load_names(scene: str = "scene_flat_terrain_backlash") -> dict:
    """Name tables of the compiled scene: lists of names per object kind
    (index = id), plus sensor_adr / sensor_dim."""
    return _read(scene)[1]["names"]


def load_gait() -> Tuple[dict, dict]:
    """(arrays, meta) of the gait library: `table` (dx, dy, dtheta, dim,
    power) float64 coefficients, the `dxs`/`dys`/`dthetas` grids, and
    `period`/`fps`."""
    meta = json.loads((DATA_DIR / "gait_coefficients.json").read_text())
    with np.load(DATA_DIR / "gait_coefficients.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, meta
