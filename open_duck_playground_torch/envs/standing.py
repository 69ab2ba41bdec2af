"""Standing / head-tracking task, every env at once (leading env axis).

Counterpart of `open_duck_playground_tpu/envs/standing.py`: the joystick
task's skeleton with no imitation reward, zero locomotion commands, no
motor-speed slew clamp, obs without `motor_targets` and the imitation phase,
and the rewards orientation, torques, action_rate, alive, stand_still (legs
only) and head_pos. The head_pos cost keeps the reference's gate on moving
commands, so by default it is zero in this task (a parity quirk);
`head_pos_ungated=True` drops the gate. `head_direct_targets=True` (the
joystick task's option, through the inherited step) gives the head servos
the head command.

The draws are the joystick task's (`ResetDraws`, `StepDraws`); only the
command they carry is sampled by `Standing.sample_command`.

On CUDA tensors the inherited step (and the inherited flag `task_kernel`)
runs as the task's two CUDA kernels (`envs/task_kernel.py`), in their
standing build: this task's six terms and its observation layout (no
imitation, no motor targets). The eager body (`Joystick.step` with this
class's `_get_reward`) is the CPU's path and the reference of the tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from open_duck_playground_torch.envs import rewards as R
from open_duck_playground_torch.envs.joystick import (
    Joystick, NoiseConfig, NoiseScales, PushConfig, _u, head_ranges,
)
from open_duck_playground_torch.envs.task_kernel import STANDING_TERMS


def _reward_scales() -> Dict[str, float]:
    return dict(
        orientation=-0.5,
        torques=-1.0e-3,
        action_rate=-0.375,
        stand_still=-0.3,
        alive=20.0,
        head_pos=-2.0,
    )


@dataclass(frozen=True)
class StandingRewardConfig:
    scales: Dict[str, float] = field(default_factory=_reward_scales)
    tracking_sigma: float = 0.01


@dataclass(frozen=True)
class StandingConfig:
    """The reference's standing default_config."""

    ctrl_dt: float = 0.02
    sim_dt: float = 0.002
    episode_length: int = 1000
    action_repeat: int = 1
    action_scale: float = 0.25
    dof_vel_scale: float = 0.05
    history_len: int = 0
    soft_joint_pos_limit_factor: float = 0.95
    noise_config: NoiseConfig = field(
        default_factory=lambda: NoiseConfig(scales=NoiseScales(gyro=0.05, accelerometer=0.005)))
    reward_config: StandingRewardConfig = field(default_factory=StandingRewardConfig)
    push_config: PushConfig = field(default_factory=PushConfig)
    neck_pitch_range: Tuple[float, float] = (-0.34, 1.1)
    head_pitch_range: Tuple[float, float] = (-0.78, 0.78)
    head_yaw_range: Tuple[float, float] = (-2.7, 2.7)
    head_roll_range: Tuple[float, float] = (-0.5, 0.5)
    head_range_factor: float = 1.0
    head_pos_ungated: bool = False
    head_direct_targets: bool = False


class Standing(Joystick):
    """Stand in place while tracking head commands."""

    use_imitation = False
    use_motor_speed_limits = False
    obs_has_motor_targets = False
    obs_has_imitation_phase = False
    reward_terms = STANDING_TERMS

    @staticmethod
    def default_config():
        return StandingConfig()

    def sample_command(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """(B, 7): zero locomotion, 4 head dims; all zero with probability 0.1."""
        head = torch.stack([_u(gen, (batch,), lo, hi) for lo, hi in head_ranges(self._config)], -1)
        cmd = torch.cat([torch.zeros((batch, 3), device=head.device), head], -1)
        zero = torch.rand((batch,), generator=gen, device=gen.device) < 0.1
        return torch.where(zero[:, None], torch.zeros_like(cmd), cmd)

    def _get_reward(self, data, action, info, done, first_contact, contact):
        del done, first_contact, contact
        jq = self.get_actuator_joints_qpos(data.qpos)
        jv = self.get_actuator_joints_qvel(data.qvel)
        cmd = info["command"]
        return {
            "orientation": R.orientation(self.get_gravity(data)),
            "torques": R.torques(data.actuator_force),
            "action_rate": R.action_rate(action, info["last_act"]),
            "alive": R.alive(action.shape[0], action.device),
            "stand_still": R.stand_still(cmd, jq, jv, self._default_actuator, ignore_head=True),
            "head_pos": R.head_pos(jq, jv, cmd, ungated=self._config.head_pos_ungated),
        }
