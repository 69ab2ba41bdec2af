"""Reward and cost terms of the duck tasks, batched over envs (leading
axis). Counterpart of `open_duck_playground_tpu/envs/rewards.py`: the terms
the joystick and standing tasks use, then the reference's extra terms that
no task wires in (kept for parity; `eval_tools/rewards_numpy.py` mirrors
all of them). All are NaN-guarded like the reference."""

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


def _legs(x):
    """The 10 leg slots of 14 (5 left leg, 4 head, 5 right leg), by slices:
    a tensor indexed by a Python list copies the list to the card at every
    call, a host synchronization."""
    return torch.cat([x[..., :5], x[..., 9:]], -1)


def stand_still(cmd, joints_qpos, joints_qvel, default_pose, ignore_head=False):
    """L1 pose + velocity deviation, gated to near-zero commands. With
    `ignore_head` only the two 5-dof legs count (all 10 joints of the
    no-head robot)."""
    cmd_norm = torch.linalg.vector_norm(cmd[..., :3], dim=-1)
    if ignore_head and joints_qpos.shape[-1] != 10:  # on the no-head robot every joint is a leg
        joints_qpos, joints_qvel = _legs(joints_qpos), _legs(joints_qvel)
        default_pose = _legs(default_pose)
    pose = torch.sum(torch.abs(joints_qpos - default_pose), -1)
    vel = torch.sum(torch.abs(joints_qvel), -1)
    return _nn(pose + vel) * (cmd_norm < 0.01)


def head_pos(joints_qpos, joints_qvel, cmd, ungated: bool = False):
    """Squared head-joint error (slots 5:9) against the 4 head commands.
    Gated by default to moving commands, as the reference is: the standing
    task samples no locomotion, so there the gated cost is always zero (a
    parity quirk kept on purpose); `ungated` drops the gate. Zero on the
    no-head robot."""
    del joints_qvel
    if joints_qpos.shape[-1] == 10:  # no-head robot: nothing to track
        return torch.zeros(joints_qpos.shape[:-1], dtype=joints_qpos.dtype, device=joints_qpos.device)
    err = _nn(torch.sum(torch.square(joints_qpos[..., 5:9] - cmd[..., 3:]), -1))
    if ungated:
        return err
    return err * (torch.linalg.vector_norm(cmd[..., :3], dim=-1) > 0.01)


# --- extra terms the reference ships but doesn't wire into the two tasks
# (reference rewards.py:37-62,73-74,85-90,120-121,152-241). Per env, a foot
# quantity is (2,) or (2, 3) and a body quantity (3,).


def lin_vel_z(global_linvel):
    return _nn(torch.square(global_linvel[..., 2]))


def ang_vel_xy(global_angvel):
    return _nn(torch.sum(torch.square(global_angvel[..., :2]), -1))


def base_height(h, target):
    return _nn(torch.square(h - target))


def base_y_swing(base_y_speed, freq, amplitude, t, sigma):
    target = amplitude * torch.sin(2 * torch.pi * freq * torch.as_tensor(t))
    return _nn(torch.exp(-torch.square(target - base_y_speed) / sigma))


def energy(qvel, qfrc_actuator):
    return _nn(torch.sum(torch.abs(qvel) * torch.abs(qfrc_actuator), -1))


def joint_pos_limits(qpos, soft_lowers, soft_uppers):
    out = -torch.clamp(qpos - soft_lowers, max=0.0)
    out = out + torch.clamp(qpos - soft_uppers, min=0.0)
    return _nn(torch.sum(out, -1))


def termination(done):
    return done


def joint_deviation(qpos, indices, default_pose, gate=1.0):
    return _nn(torch.sum(torch.abs(qpos[..., indices] - default_pose[..., indices]), -1)) * gate


def pose(qpos, default_pose, weights):
    return _nn(torch.sum(torch.square(qpos - default_pose) * weights, -1))


def feet_slip(contact, global_linvel):
    """Body speed in the plane times each foot's contact, summed."""
    speed = torch.linalg.vector_norm(global_linvel[..., :2], dim=-1)
    return _nn(torch.sum(speed[..., None] * contact, -1))


def feet_clearance(feet_vel, foot_pos, max_foot_height):
    vel_norm = torch.sqrt(torch.linalg.vector_norm(feet_vel[..., :2], dim=-1))
    delta = torch.abs(foot_pos[..., -1] - max_foot_height)
    return _nn(torch.sum(delta * vel_norm, -1))


def feet_height(swing_peak, first_contact, max_foot_height):
    err = swing_peak / max_foot_height - 1.0
    return _nn(torch.sum(torch.square(err) * first_contact, -1))


def feet_air_time(air_time, first_contact, cmd, tmin=0.1, tmax=0.5):
    t = torch.clamp((air_time - tmin) * first_contact, max=tmax - tmin)
    return _nn(torch.sum(t, -1)) * (torch.linalg.vector_norm(cmd[..., :3], dim=-1) > 0.01)


def feet_phase(foot_pos, rz):
    err = torch.sum(torch.square(foot_pos[..., -1] - rz), -1)
    return _nn(torch.exp(-err / 0.01))
