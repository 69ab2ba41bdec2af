"""Imitation reward against the polynomial reference gait, batched over envs.
Counterpart of `open_duck_playground_tpu/envs/imitation.py`.

Reference frame layout (40 dims): joint pos 0:16, joint vel 16:32, foot
contacts 32:34, base linear vel 34:37, base angular vel 37:40. The frame's
16-joint order includes neck/head/antennas at 5:11, which the robot drops, so
both sides keep legs only: ref[:5]+ref[11:], and of the 14-actuator robot's
joints [:5]+[9:]; on the 10-actuator (no-head) robot every joint is a leg.
"""

from __future__ import annotations

from typing import Optional

import torch

_W_LIN_XY = 1.0
_W_LIN_Z = 1.0
_W_ANG_XY = 0.5
_W_ANG_Z = 0.5
_W_JOINT_POS = 15.0
_W_JOINT_VEL = 1.0e-3
_W_CONTACT = 1.0

# The leg slice of the full robot's home keyframe, the stance the gait
# library was authored for. A variant with another balanced stance (the
# no-head robot) retargets the library's joint targets by its own home pose
# minus this (`ref_jpos_offset`).
GAIT_HOME_LEGS = (0.002, 0.053, -0.63, 1.368, -0.784, -0.003, -0.065, 0.635, 1.379, -0.796)


def legs16(x):
    """The 10 leg entries of a 16-joint reference slice."""
    return torch.cat([x[..., :5], x[..., 11:]], -1)


def _robot_legs(x):
    if x.shape[-1] == 10:  # no-head robot: all joints are legs
        return x
    return torch.cat([x[..., :5], x[..., 9:]], -1)


def imitation_reward(base_qvel, joints_qpos, joints_qvel, contacts, ref_frame, cmd,
                     enabled: bool = True, ref_jpos_offset: Optional[torch.Tensor] = None):
    """(B,) reward of the robot against its reference frames; zero when not
    `enabled`. `ref_jpos_offset` (10 legs, or None) is added to the frame's
    joint positions: the variant's home pose minus GAIT_HOME_LEGS."""
    if not enabled:
        return torch.zeros(base_qvel.shape[:-1], dtype=base_qvel.dtype, device=base_qvel.device)
    lin = base_qvel[..., :3]
    ang = base_qvel[..., 3:6]
    ref_lin = ref_frame[..., 34:37]
    ref_ang = ref_frame[..., 37:40]

    r = _W_LIN_XY * torch.exp(-8.0 * torch.sum(torch.square(lin[..., :2] - ref_lin[..., :2]), -1))
    r = r + _W_LIN_Z * torch.exp(-8.0 * torch.square(lin[..., 2] - ref_lin[..., 2]))
    r = r + _W_ANG_XY * torch.exp(-2.0 * torch.sum(torch.square(ang[..., :2] - ref_ang[..., :2]), -1))
    r = r + _W_ANG_Z * torch.exp(-2.0 * torch.square(ang[..., 2] - ref_ang[..., 2]))
    ref_jpos = legs16(ref_frame[..., 0:16])
    if ref_jpos_offset is not None:
        ref_jpos = ref_jpos + ref_jpos_offset
    r = r - _W_JOINT_POS * torch.sum(torch.square(_robot_legs(joints_qpos) - ref_jpos), -1)
    r = r - _W_JOINT_VEL * torch.sum(
        torch.square(_robot_legs(joints_qvel) - legs16(ref_frame[..., 16:32])), -1
    )
    ref_contacts = (ref_frame[..., 32:34] > 0.5).to(contacts.dtype)
    r = r + _W_CONTACT * torch.sum((contacts == ref_contacts).to(r.dtype), -1)
    r = r * (torch.linalg.vector_norm(cmd[..., :3], dim=-1) > 0.01)
    return torch.nan_to_num(r)
