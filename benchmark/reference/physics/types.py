"""Frozen model and simulation-state containers, batched over a leading env axis.

`Model` holds the compiled robot as torch tensors. Its immutable topology lives
in `ModelSpec` as plain Python data (hashable, so structure helpers can cache
on it). The 8 fields in `RANDOMIZED_FIELDS` may carry a leading env axis
(domain randomization); every other field is shared by all envs.

`Data` is the per-env simulation state. Every tensor in it has a leading env
axis `B`: `qpos` is `(B, nq)`, `site_xmat` is `(B, nsite, 3, 3)`, and so on.
Counterpart of `open_duck_playground_tpu/physics/types.py`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

# MuJoCo joint types the duck scenes use.
FREE = 0
HINGE = 3


@dataclass(frozen=True)
class ModelSpec:
    """Static topology and solver options."""

    nq: int = 0
    nv: int = 0
    nu: int = 0
    nbody: int = 0
    njnt: int = 0
    ngeom: int = 0
    nsite: int = 0
    nsensordata: int = 0

    jnt_type: Tuple[int, ...] = ()
    jnt_bodyid: Tuple[int, ...] = ()
    jnt_qposadr: Tuple[int, ...] = ()
    jnt_dofadr: Tuple[int, ...] = ()
    jnt_limited: Tuple[bool, ...] = ()

    body_parentid: Tuple[int, ...] = ()
    body_jntadr: Tuple[int, ...] = ()
    body_jntnum: Tuple[int, ...] = ()

    dof_bodyid: Tuple[int, ...] = ()
    dof_jntid: Tuple[int, ...] = ()
    # dofs with frictionloss > 0 at compile time (the magnitude is
    # domain-randomized, the set is not)
    friction_dofs: Tuple[int, ...] = ()

    # joint transmission only, one joint per actuator
    actuator_trnid: Tuple[int, ...] = ()

    site_bodyid: Tuple[int, ...] = ()
    geom_bodyid: Tuple[int, ...] = ()

    # (kind, site id, adr, dim); every duck sensor is site-based
    sensors: Tuple[Tuple[str, int, int, int], ...] = ()

    # collision world: foot convex hulls against one floor geom
    collide_geom_ids: Tuple[int, ...] = ()
    floor_geom_id: int = -1
    floor_is_hfield: bool = False
    points_per_foot: int = 4
    hull_nvert: int = 0
    hfield_nrow: int = 0
    hfield_ncol: int = 0

    timestep: float = 0.002
    iterations: int = 1
    ls_iterations: int = 5
    impratio: float = 1.0
    tolerance: float = 1e-8
    ls_tolerance: float = 0.01

    @property
    def ncon_max(self) -> int:
        return len(self.collide_geom_ids) * self.points_per_foot


# Fields domain randomization may batch over envs (reference randomize.py).
RANDOMIZED_FIELDS = (
    "geom_friction",
    "body_ipos",
    "dof_frictionloss",
    "dof_armature",
    "body_mass",
    "qpos0",
    "actuator_gainprm",
    "actuator_biasprm",
)

# Unbatched rank of each randomized field, to tell a batched one apart.
_FIELD_RANK = {
    "geom_friction": 2,
    "body_ipos": 2,
    "dof_frictionloss": 1,
    "dof_armature": 1,
    "body_mass": 1,
    "qpos0": 1,
    "actuator_gainprm": 2,
    "actuator_biasprm": 2,
}


@dataclass(frozen=True)
class Model:
    spec: ModelSpec

    body_pos: torch.Tensor  # (nbody, 3) frame offset in parent
    body_quat: torch.Tensor  # (nbody, 4)
    body_ipos: torch.Tensor  # (nbody, 3) CoM in body frame
    body_iquat: torch.Tensor  # (nbody, 4)
    body_mass: torch.Tensor  # (nbody,)
    body_inertia: torch.Tensor  # (nbody, 3) principal moments
    body_invweight0: torch.Tensor  # (nbody, 2)

    jnt_pos: torch.Tensor  # (njnt, 3)
    jnt_axis: torch.Tensor  # (njnt, 3)
    jnt_range: torch.Tensor  # (njnt, 2)
    jnt_solref: torch.Tensor  # (njnt, 2)
    jnt_solimp: torch.Tensor  # (njnt, 5)
    jnt_margin: torch.Tensor  # (njnt,)

    dof_armature: torch.Tensor  # (nv,)
    dof_damping: torch.Tensor  # (nv,)
    dof_frictionloss: torch.Tensor  # (nv,)
    dof_invweight0: torch.Tensor  # (nv,)
    dof_solref: torch.Tensor  # (nv, 2)
    dof_solimp: torch.Tensor  # (nv, 5)

    qpos0: torch.Tensor  # (nq,)

    actuator_gainprm: torch.Tensor  # (nu, 10)
    actuator_biasprm: torch.Tensor  # (nu, 10)
    actuator_ctrlrange: torch.Tensor  # (nu, 2)
    actuator_forcerange: torch.Tensor  # (nu, 2)

    geom_pos: torch.Tensor  # (ngeom, 3)
    geom_quat: torch.Tensor  # (ngeom, 4)
    geom_friction: torch.Tensor  # (ngeom, 3)
    geom_solref: torch.Tensor  # (ngeom, 2)
    geom_solimp: torch.Tensor  # (ngeom, 5)
    geom_priority: torch.Tensor  # (ngeom,) int32
    geom_margin: torch.Tensor  # (ngeom,)

    site_pos: torch.Tensor  # (nsite, 3)
    site_quat: torch.Tensor  # (nsite, 4)

    foot_hull: torch.Tensor  # (nfoot, hull_nvert, 3) hull vertices, geom frame
    hfield_data: torch.Tensor  # (nrow, ncol), or (1, 1) on a plane
    hfield_size: torch.Tensor  # (4,)

    ancestor_mask: torch.Tensor  # (nbody, nv) bool: dof d moves body b

    gravity: torch.Tensor  # (3,)

    key_qpos: torch.Tensor  # (nq,) "home" keyframe
    key_ctrl: torch.Tensor  # (nu,)

    @property
    def nq(self) -> int:
        return self.spec.nq

    @property
    def nv(self) -> int:
        return self.spec.nv

    @property
    def nu(self) -> int:
        return self.spec.nu

    @property
    def nbody(self) -> int:
        return self.spec.nbody

    @property
    def device(self) -> torch.device:
        return self.body_pos.device

    @property
    def dtype(self) -> torch.dtype:
        return self.body_pos.dtype

    def replace(self, **updates) -> "Model":
        return dataclasses.replace(self, **updates)

    def is_batched(self, name: str) -> bool:
        return getattr(self, name).dim() > _FIELD_RANK[name]

    def expand_batch(self, batch: int) -> "Model":
        """Give every randomized field the leading env axis (a view where it
        had none), so engine code can index them as `(B, ...)`."""
        updates = {}
        for name in RANDOMIZED_FIELDS:
            x = getattr(self, name)
            if not self.is_batched(name):
                updates[name] = x.expand((batch,) + tuple(x.shape))
            elif x.shape[0] != batch:
                raise ValueError(f"{name} has {x.shape[0]} envs, expected {batch}")
        return self.replace(**updates) if updates else self


@dataclass(frozen=True)
class Contact:
    """Fixed-slot contact set: points_per_foot slots per foot, env-batched."""

    dist: torch.Tensor  # (B, ncon) signed distance, < 0 penetrating
    pos: torch.Tensor  # (B, ncon, 3)
    frame: torch.Tensor  # (B, ncon, 3, 3) rows: normal, tangent1, tangent2
    friction: torch.Tensor  # (B, ncon, 3)
    solref: torch.Tensor  # (B, ncon, 2)
    solimp: torch.Tensor  # (B, ncon, 5)


@dataclass(frozen=True)
class Data:
    """Per-env state plus the forward-pass products the env layer reads."""

    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    ctrl: torch.Tensor  # (B, nu)
    qacc: torch.Tensor  # (B, nv)
    qacc_warmstart: torch.Tensor  # (B, nv)

    site_xpos: torch.Tensor  # (B, nsite, 3)
    site_xmat: torch.Tensor  # (B, nsite, 3, 3)
    actuator_force: torch.Tensor  # (B, nu)
    contact_dist: torch.Tensor  # (B, ncon)
    sensordata: torch.Tensor  # (B, nsensordata)

    def replace(self, **updates) -> "Data":
        return dataclasses.replace(self, **updates)

    def fields(self):
        """(name, tensor) pairs in declaration order."""
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)]

    def map(self, fn) -> "Data":
        return Data(**{k: fn(v) for k, v in self.fields()})
