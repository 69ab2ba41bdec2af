"""Domain randomization: per-env physical parameters, giving a Model whose
randomized fields carry the env axis. Counterpart of
`open_duck_playground_tpu/envs/randomize.py`, with the same two fixes over
the upstream reference: the floor-friction draw targets the real floor geom,
and the torso CoM jitter and mass offset go to the first body with positive
mass (trunk_assembly), its mass clamped positive.

The random numbers come in as a `DRDraws`, so a test can hand in the very
numbers the JAX package drew; `DRDraws.sample` draws them from a
`torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference.physics.types import Model, ModelSpec


def _uniform(gen, shape, lo, hi, device):
    u = torch.rand(shape, generator=gen, device=device)
    return lo + u * (hi - lo)


@dataclass(frozen=True)
class DRDraws:
    floor_friction: torch.Tensor  # (B,) U(0.5, 1.0)
    frictionloss_scale: torch.Tensor  # (B, nfric) U(0.9, 1.1)
    armature_scale: torch.Tensor  # (B, nfric) U(1.0, 1.05)
    torso_ipos_offset: torch.Tensor  # (B, 3) U(-0.05, 0.05)
    mass_scale: torch.Tensor  # (B, nbody) U(0.9, 1.1)
    torso_mass_offset: torch.Tensor  # (B,) U(-0.1, 0.1)
    qpos0_offset: torch.Tensor  # (B, nfric) U(-0.03, 0.03)
    kp_scale: torch.Tensor  # (B, nu) U(0.9, 1.1)

    @classmethod
    def sample(cls, generator: torch.Generator, batch: int, spec: ModelSpec) -> "DRDraws":
        dev = generator.device
        nf = len(spec.friction_dofs)
        u = lambda shape, lo, hi: _uniform(generator, (batch,) + shape, lo, hi, dev)
        return cls(
            floor_friction=u((), 0.5, 1.0),
            frictionloss_scale=u((nf,), 0.9, 1.1),
            armature_scale=u((nf,), 1.0, 1.05),
            torso_ipos_offset=u((3,), -0.05, 0.05),
            mass_scale=u((spec.nbody,), 0.9, 1.1),
            torso_mass_offset=u((), -0.1, 0.1),
            qpos0_offset=u((nf,), -0.03, 0.03),
            kp_scale=u((spec.nu,), 0.9, 1.1),
        )


def domain_randomize(model: Model, draws: DRDraws) -> Model:
    """The model with its 8 randomized fields batched over the draws' envs."""
    s = model.spec
    B = draws.floor_friction.shape[0]
    fd = list(s.friction_dofs)
    qadr = [s.jnt_qposadr[s.dof_jntid[d]] for d in fd]
    # the torso = first body with actual mass; body 1 is the massless
    # freejoint stub
    torso = int(torch.nonzero(model.body_mass.cpu() > 1e-9)[0])
    floor = s.floor_geom_id
    ex = lambda x: x.expand((B,) + tuple(x.shape)).clone()

    geom_friction = ex(model.geom_friction)
    geom_friction[:, floor, 0] = draws.floor_friction

    dof_frictionloss = ex(model.dof_frictionloss)
    dof_frictionloss[:, fd] = model.dof_frictionloss[fd] * draws.frictionloss_scale

    dof_armature = ex(model.dof_armature)
    dof_armature[:, fd] = model.dof_armature[fd] * draws.armature_scale

    body_ipos = ex(model.body_ipos)
    body_ipos[:, torso] = model.body_ipos[torso] + draws.torso_ipos_offset

    body_mass = model.body_mass * draws.mass_scale
    new_torso = body_mass[:, torso] + draws.torso_mass_offset
    # a non-positive body mass makes the mass matrix indefinite
    body_mass[:, torso] = torch.maximum(new_torso, 0.05 * model.body_mass[torso])

    qpos0 = ex(model.qpos0)
    qpos0[:, qadr] = qpos0[:, qadr] + draws.qpos0_offset

    kp = model.actuator_gainprm[:, 0] * draws.kp_scale
    actuator_gainprm = ex(model.actuator_gainprm)
    actuator_gainprm[:, :, 0] = kp
    actuator_biasprm = ex(model.actuator_biasprm)
    actuator_biasprm[:, :, 1] = -kp

    return model.replace(
        geom_friction=geom_friction,
        body_ipos=body_ipos,
        dof_frictionloss=dof_frictionloss,
        dof_armature=dof_armature,
        body_mass=body_mass,
        qpos0=qpos0,
        actuator_gainprm=actuator_gainprm,
        actuator_biasprm=actuator_biasprm,
    )
