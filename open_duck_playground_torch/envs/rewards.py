"""Reward and cost terms of the joystick and standing tasks, batched over
envs (leading axis). Counterpart of the terms of
`open_duck_playground_tpu/envs/rewards.py` that the two tasks use; all are
NaN-guarded like the reference."""

from __future__ import annotations

import torch


def _nn(x):
    return torch.nan_to_num(x)


def tracking_lin_vel(cmd, local_vel, sigma):
    """Exp-kernel xy velocity tracking with a 0.1 m/s lateral band."""
    ex = torch.square(cmd[..., 0] - local_vel[..., 0])
    ey = torch.clamp(torch.abs(local_vel[..., 1] - cmd[..., 1]) - 0.1, min=0.0)
    return _nn(torch.exp(-(ex + torch.square(ey)) / sigma))


def tracking_ang_vel(cmd, ang_vel, sigma):
    """Exp-kernel yaw-rate tracking."""
    return _nn(torch.exp(-torch.square(cmd[..., 2] - ang_vel[..., 2]) / sigma))


def yaw_rate_l1(cmd, ang_vel):
    """Linear |yaw-rate error| cost (extension, scale 0 by default)."""
    return _nn(torch.abs(cmd[..., 2] - ang_vel[..., 2]))


def lin_vel_l1(cmd, local_vel):
    """Linear planar-velocity-error cost (extension, scale 0 by default)."""
    return _nn(torch.sum(torch.abs(cmd[..., :2] - local_vel[..., :2]), -1))


def forward_progress(cmd, local_vel):
    """Velocity along the command, capped at and normalized by the commanded
    speed (extension, scale 0 by default)."""
    cn = torch.linalg.vector_norm(cmd[..., :2], dim=-1)
    along = torch.sum(local_vel[..., :2] * cmd[..., :2], -1) / torch.clamp(cn, min=1e-6)
    frac = torch.minimum(torch.clamp(along, min=0.0), cn) / torch.clamp(cn, min=1e-6)
    return _nn(frac * (cn > 0.01))


def torques(actuator_force):
    """Sum of squared actuator torques."""
    return _nn(torch.sum(torch.square(actuator_force), -1))


def action_rate(act, last_act):
    """Squared action delta."""
    return _nn(torch.sum(torch.square(act - last_act), -1))


def alive(batch: int, device=None):
    """Constant survival bonus."""
    return torch.ones(batch, dtype=torch.float32, device=device)


def orientation(torso_zaxis):
    """Squared tilt of the up-vector."""
    return _nn(torch.sum(torch.square(torso_zaxis[..., :2]), -1))


_LEGS = [0, 1, 2, 3, 4, 9, 10, 11, 12, 13]  # 5 left leg, 4 head, 5 right leg


def stand_still(cmd, joints_qpos, joints_qvel, default_pose, ignore_head=False):
    """L1 pose + velocity deviation, gated to near-zero commands. With
    `ignore_head` only the two 5-dof legs count."""
    cmd_norm = torch.linalg.vector_norm(cmd[..., :3], dim=-1)
    if ignore_head:
        joints_qpos, joints_qvel = joints_qpos[..., _LEGS], joints_qvel[..., _LEGS]
        default_pose = default_pose[..., _LEGS]
    pose = torch.sum(torch.abs(joints_qpos - default_pose), -1)
    vel = torch.sum(torch.abs(joints_qvel), -1)
    return _nn(pose + vel) * (cmd_norm < 0.01)


def head_pos(joints_qpos, joints_qvel, cmd, ungated: bool = False):
    """Squared head-joint error (slots 5:9) against the 4 head commands.
    Gated by default to moving commands, as the reference is: the standing
    task samples no locomotion, so there the gated cost is always zero (a
    parity quirk kept on purpose); `ungated` drops the gate."""
    del joints_qvel
    err = _nn(torch.sum(torch.square(joints_qpos[..., 5:9] - cmd[..., 3:]), -1))
    if ungated:
        return err
    return err * (torch.linalg.vector_norm(cmd[..., :3], dim=-1) > 0.01)
