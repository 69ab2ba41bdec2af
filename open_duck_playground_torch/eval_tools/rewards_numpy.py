"""Numpy mirrors of the reward/cost terms, for robot-side / eval-side reward
monitoring without torch. Counterpart of
`open_duck_playground_tpu/eval_tools/rewards_numpy.py`.

Behavioral spec: reference `playground/common/rewards_numpy.py` and
`playground/common/custom_rewards_numpy.py`, literal numpy twins of the
training terms. Here each function mirrors, for one env, its batched torch
counterpart in `envs/rewards.py` / `envs/imitation.py`; the tests hold them
against those and against the JAX package's terms.
"""

from __future__ import annotations

import numpy as np


def _nn(x):
    return np.nan_to_num(x)


def tracking_lin_vel(cmd, local_vel, sigma):
    """Exp-kernel xy velocity tracking with a 0.1 m/s lateral tolerance band
    (rewards_numpy mirror of rewards.py:11-22)."""
    ex = np.square(cmd[0] - local_vel[0])
    ey = np.clip(np.abs(local_vel[1] - cmd[1]) - 0.1, 0.0, None)
    return _nn(np.exp(-(ex + np.square(ey)) / sigma))


def tracking_ang_vel(cmd, ang_vel, sigma):
    """Exp-kernel yaw-rate tracking (rewards.py:25-31)."""
    return _nn(np.exp(-np.square(cmd[2] - ang_vel[2]) / sigma))


def torques(actuator_force):
    """Sum of squared actuator torques (rewards.py:68-69)."""
    return _nn(np.sum(np.square(actuator_force)))


def action_rate(act, last_act):
    """Squared action delta (rewards.py:77-79)."""
    return _nn(np.sum(np.square(act - last_act)))


def alive():
    """Constant survival bonus (rewards.py:124-125)."""
    return np.float32(1.0)


def orientation(torso_zaxis):
    """Squared tilt of the up-vector (rewards.py:45-46)."""
    return _nn(np.sum(np.square(torso_zaxis[:2])))


def stand_still(cmd, joints_qpos, joints_qvel, default_pose, ignore_head=False):
    """L1 pose+velocity deviation, gated to near-zero commands
    (rewards.py:93-117)."""
    cmd_norm = np.linalg.norm(cmd[:3])
    if ignore_head and np.shape(joints_qpos)[-1] == 10:
        ignore_head = False  # no-head robot: all joints are legs
    if ignore_head:
        sel = np.concatenate([np.arange(5), np.arange(9, 14)])
        pose = np.sum(np.abs(joints_qpos[sel] - default_pose[sel]))
        vel = np.sum(np.abs(joints_qvel[sel]))
    else:
        pose = np.sum(np.abs(joints_qpos - default_pose))
        vel = np.sum(np.abs(joints_qvel))
    return _nn(pose + vel) * (cmd_norm < 0.01)


def head_pos(joints_qpos, joints_qvel, cmd, ungated=False):
    """Squared head-joint position error vs the 4 head commands
    (rewards.py:131-147; `ungated` mirrors the extension that fixes the
    upstream dead-gate bug in the standing task)."""
    del joints_qvel
    if np.shape(joints_qpos)[-1] == 10:  # no-head robot: nothing to track
        return np.float32(0.0)
    err = np.sum(np.square(joints_qpos[5:9] - cmd[3:]))
    if ungated:
        return _nn(err)
    move_norm = np.linalg.norm(cmd[:3])
    return _nn(err) * (move_norm > 0.01)


def yaw_rate_l1(cmd, ang_vel):
    """numpy mirror of rewards.yaw_rate_l1 (extension, scale 0.0 default)."""
    return _nn(np.abs(cmd[2] - ang_vel[2]))


def lin_vel_l1(cmd, local_vel):
    """numpy mirror of rewards.lin_vel_l1 (extension, scale 0.0 default)."""
    return _nn(np.sum(np.abs(cmd[:2] - local_vel[:2])))


def forward_progress(cmd, local_vel):
    """numpy mirror of rewards.forward_progress (extension, scale 0.0 by
    default)."""
    cn = np.linalg.norm(cmd[:2])
    along = np.dot(local_vel[:2], cmd[:2]) / max(cn, 1e-6)
    frac = np.clip(along, 0.0, cn) / max(cn, 1e-6)
    return _nn(frac * (cn > 0.01))


def lin_vel_z(global_linvel):
    return _nn(np.square(global_linvel[2]))


def ang_vel_xy(global_angvel):
    return _nn(np.sum(np.square(global_angvel[:2])))


def base_height(h, target):
    return _nn(np.square(h - target))


def base_y_swing(base_y_speed, freq, amplitude, t, sigma):
    target = amplitude * np.sin(2 * np.pi * freq * t)
    return _nn(np.exp(-np.square(target - base_y_speed) / sigma))


def energy(qvel, qfrc_actuator):
    return _nn(np.sum(np.abs(qvel) * np.abs(qfrc_actuator)))


def joint_pos_limits(qpos, soft_lowers, soft_uppers):
    out = -np.clip(qpos - soft_lowers, None, 0.0)
    out += np.clip(qpos - soft_uppers, 0.0, None)
    return _nn(np.sum(out))


def termination(done):
    return done


def joint_deviation(qpos, indices, default_pose, gate=1.0):
    return _nn(np.sum(np.abs(qpos[indices] - default_pose[indices]))) * gate


def pose(qpos, default_pose, weights):
    return _nn(np.sum(np.square(qpos - default_pose) * weights))


def feet_slip(contact, global_linvel):
    return _nn(np.sum(np.linalg.norm(global_linvel[:2], axis=-1) * contact))


def feet_clearance(feet_vel, foot_pos, max_foot_height):
    vel_norm = np.sqrt(np.linalg.norm(feet_vel[..., :2], axis=-1))
    delta = np.abs(foot_pos[..., -1] - max_foot_height)
    return _nn(np.sum(delta * vel_norm))


def feet_height(swing_peak, first_contact, max_foot_height):
    err = swing_peak / max_foot_height - 1.0
    return _nn(np.sum(np.square(err) * first_contact))


def feet_air_time(air_time, first_contact, cmd, tmin=0.1, tmax=0.5):
    t = np.clip((air_time - tmin) * first_contact, None, tmax - tmin)
    return _nn(np.sum(t)) * (np.linalg.norm(cmd[:3]) > 0.01)


def feet_phase(foot_pos, rz):
    err = np.sum(np.square(foot_pos[..., -1] - rz))
    return _nn(np.exp(-err / 0.01))


# --- imitation reward (mirror of envs/imitation.py; reference
# custom_rewards_numpy.py:4-151) ---

_W_LIN_XY = 1.0
_W_LIN_Z = 1.0
_W_ANG_XY = 0.5
_W_ANG_Z = 0.5
_W_JOINT_POS = 15.0
_W_JOINT_VEL = 1.0e-3
_W_CONTACT = 1.0


def imitation_reward(
    base_qvel,
    joints_qpos,
    joints_qvel,
    contacts,
    ref_frame,
    cmd,
    enabled: bool = True,
    ref_jpos_offset=None,
):
    """`ref_jpos_offset`: additive retarget of the reference joint targets
    for robot variants whose balanced stance differs from the gait library's
    authored home pose (see envs/imitation.py:GAIT_HOME_LEGS)."""
    if not enabled:
        return np.float32(0.0)

    legs = lambda x16: np.concatenate([x16[:5], x16[11:]])
    if np.asarray(joints_qpos).shape[-1] == 10:  # no-head: all joints legs
        robot_legs = lambda x10: x10
    else:
        robot_legs = lambda x14: np.concatenate([x14[:5], x14[9:]])

    lin = base_qvel[:3]
    ang = base_qvel[3:6]
    ref_lin = ref_frame[34:37]
    ref_ang = ref_frame[37:40]

    r = _W_LIN_XY * np.exp(-8.0 * np.sum(np.square(lin[:2] - ref_lin[:2])))
    r += _W_LIN_Z * np.exp(-8.0 * np.square(lin[2] - ref_lin[2]))
    r += _W_ANG_XY * np.exp(-2.0 * np.sum(np.square(ang[:2] - ref_ang[:2])))
    r += _W_ANG_Z * np.exp(-2.0 * np.square(ang[2] - ref_ang[2]))
    ref_jpos = legs(ref_frame[0:16])
    if ref_jpos_offset is not None:
        ref_jpos = ref_jpos + np.asarray(ref_jpos_offset)
    r -= _W_JOINT_POS * np.sum(np.square(robot_legs(joints_qpos) - ref_jpos))
    r -= _W_JOINT_VEL * np.sum(
        np.square(robot_legs(joints_qvel) - legs(ref_frame[16:32]))
    )
    ref_contacts = (ref_frame[32:34] > 0.5).astype(np.asarray(contacts).dtype)
    r += _W_CONTACT * np.sum(
        np.asarray(contacts).astype(ref_contacts.dtype) == ref_contacts
    )

    r *= np.linalg.norm(cmd[:3]) > 0.01
    return np.nan_to_num(r)
