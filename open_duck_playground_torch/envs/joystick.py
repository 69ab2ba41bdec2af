"""Joystick-following task, every env at once (leading env axis).

Counterpart of `open_duck_playground_tpu/envs/joystick.py` (reset and step
of the training rollout). Replicated reference quirks: the accelerometer
+1.3 x-offset is a no-op in training (not applied); feet_air_time grows
before the reward and is zeroed on contact after it; the command and the
step counter reset when `step > 500`.

Random numbers are injected: `reset` takes a `ResetDraws`, `step` a
`StepDraws` (JAX's threefry and torch's Philox streams cannot agree, so a
test hands both envs the same numbers). Each has a `sample(generator,
batch, env)` constructor. The draw the reference makes for the IMU delay
index is not carried: its result is discarded in the reference's
observation (`del noisy_gravity`).

The class flags (`use_imitation`, `use_motor_speed_limits`,
`obs_has_motor_targets`, `obs_has_imitation_phase`) are the JAX class's;
`envs/standing.py` turns them off. `task_kernel` (the port's) says that the
class's step on CUDA tensors runs as two CUDA kernels around the physics
launch (`envs/task_kernel.py`; `Standing` takes their standing build); the
body of `step` is their plain version, the path of CPU tensors. The
robot has 14 actuators (legs 0:5 and 9:14, head 5:9) or, on
`flat_terrain_no_head`, 10 (legs only): the head's
metric and `head_direct_targets` exist only on the first, the gait
retarget (`_imitation_ref_offset`) only on the second.

Options beyond the reference, off by default: reference-state init
(`rsi_prob`: a reset starts mid-gait from a random frame of the reference
motion with that probability) and direct head targets
(`head_direct_targets`: the head servos take the head command).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import math

import torch

from open_duck_playground_torch.envs import duck_base, imitation, rewards as R, task_kernel
from open_duck_playground_torch.envs.task_kernel import JOYSTICK_TERMS
from open_duck_playground_torch.envs.duck_base import DuckEnv
from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.envs.gait_oracle import GaitOracle
from open_duck_playground_torch.physics import collision as C
from open_duck_playground_torch.physics import forward as F
from open_duck_playground_torch.physics import maths
from open_duck_playground_torch.physics.types import Model
from open_duck_playground_torch.utils import tracing


@dataclass(frozen=True)
class NoiseScales:
    hip_pos: float = 0.03
    knee_pos: float = 0.05
    ankle_pos: float = 0.08
    joint_vel: float = 2.5
    gravity: float = 0.1
    linvel: float = 0.1  # read by nothing, as in the reference
    gyro: float = 0.1
    accelerometer: float = 0.05


@dataclass(frozen=True)
class NoiseConfig:
    level: float = 1.0
    action_min_delay: int = 0  # env steps
    action_max_delay: int = 3
    imu_min_delay: int = 0  # the delayed IMU reading is discarded, as in the reference
    imu_max_delay: int = 3  # IMU history length
    scales: NoiseScales = field(default_factory=NoiseScales)


def _reward_scales() -> Dict[str, float]:
    return dict(
        tracking_lin_vel=2.5,
        tracking_ang_vel=6.0,
        torques=-1.0e-3,
        action_rate=-0.5,
        stand_still=-0.2,
        alive=20.0,
        imitation=1.0,
        progress=0.0,
        yaw_rate_l1=0.0,
        lin_vel_l1=0.0,
    )


@dataclass(frozen=True)
class RewardConfig:
    scales: Dict[str, float] = field(default_factory=_reward_scales)
    tracking_sigma: float = 0.01


@dataclass(frozen=True)
class PushConfig:
    enable: bool = True
    interval_range: Tuple[float, float] = (5.0, 10.0)
    magnitude_range: Tuple[float, float] = (0.1, 1.0)


@dataclass(frozen=True)
class JoystickConfig:
    """The reference's default_config. `episode_length`, `action_repeat`,
    `history_len` and `soft_joint_pos_limit_factor` are read by nothing
    here, as in the reference (the trainer has its own)."""

    ctrl_dt: float = 0.02
    sim_dt: float = 0.002
    episode_length: int = 1000
    action_repeat: int = 1
    action_scale: float = 0.25
    use_imitation: bool = True
    reset_joint_scale_range: Tuple[float, float] = (0.5, 1.5)
    rsi_prob: float = 0.0
    dof_vel_scale: float = 0.05
    history_len: int = 0
    soft_joint_pos_limit_factor: float = 0.95
    max_motor_velocity: float = 5.24  # rad/s
    noise_config: NoiseConfig = field(default_factory=NoiseConfig)
    reward_config: RewardConfig = field(default_factory=RewardConfig)
    push_config: PushConfig = field(default_factory=PushConfig)
    lin_vel_x: Tuple[float, float] = (-0.15, 0.15)
    lin_vel_y: Tuple[float, float] = (-0.2, 0.2)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    neck_pitch_range: Tuple[float, float] = (-0.34, 1.1)
    head_pitch_range: Tuple[float, float] = (-0.78, 0.78)
    head_yaw_range: Tuple[float, float] = (-1.5, 1.5)
    head_roll_range: Tuple[float, float] = (-0.5, 0.5)
    head_range_factor: float = 1.0
    head_direct_targets: bool = False


# ------------------------------------------------------------------ draws
def _u(gen, shape, lo, hi):
    return lo + torch.rand(shape, generator=gen, device=gen.device) * (hi - lo)


def head_ranges(cfg):
    f = cfg.head_range_factor
    return [(lo * f, hi * f) for lo, hi in (cfg.neck_pitch_range, cfg.head_pitch_range,
                                           cfg.head_yaw_range, cfg.head_roll_range)]


def sample_command(gen: torch.Generator, batch: int, cfg: JoystickConfig) -> torch.Tensor:
    """(B, 7): 3 locomotion + 4 head dims, all zero with probability 0.1."""
    ranges = [cfg.lin_vel_x, cfg.lin_vel_y, cfg.ang_vel_yaw] + head_ranges(cfg)
    cmd = torch.stack([_u(gen, (batch,), lo, hi) for lo, hi in ranges], -1)
    zero = torch.rand((batch,), generator=gen, device=gen.device) < 0.1
    return torch.where(zero[:, None], torch.zeros_like(cmd), cmd)


@dataclass(frozen=True)
class ObsNoise:
    """Unit noises in [-1, 1) of one observation (scaled by the env)."""

    gyro: torch.Tensor  # (B, 3)
    accelerometer: torch.Tensor  # (B, 3)
    gravity: torch.Tensor  # (B, 3)
    joint_pos: torch.Tensor  # (B, nu)
    joint_vel: torch.Tensor  # (B, nu)

    @classmethod
    def sample(cls, gen: torch.Generator, batch: int, nu: int) -> "ObsNoise":
        n = lambda k: 2.0 * torch.rand((batch, k), generator=gen, device=gen.device) - 1.0
        return cls(gyro=n(3), accelerometer=n(3), gravity=n(3), joint_pos=n(nu), joint_vel=n(nu))


@dataclass(frozen=True)
class ResetDraws:
    base_dxy: torch.Tensor  # (B, 2) U(-0.05, 0.05)
    yaw: torch.Tensor  # (B,) U(-3.14, 3.14)
    joint_scale: torch.Tensor  # (B, nu) U(reset_joint_scale_range)
    base_vel: torch.Tensor  # (B, 6) U(-0.05, 0.05)
    command: torch.Tensor  # (B, 7)
    push_interval: torch.Tensor  # (B,) U(push interval_range) seconds
    obs: ObsNoise
    # reference-state init, drawn only when the env uses it (imitation on,
    # rsi_prob > 0), so that other runs keep their generator stream
    rsi_gate: Optional[torch.Tensor] = None  # (B,) U[0, 1): RSI where < rsi_prob
    rsi_phase: Optional[torch.Tensor] = None  # (B,) int in [0, nb_steps_in_period)

    @property
    def batch(self) -> int:
        return self.yaw.shape[0]

    @classmethod
    def sample(cls, gen: torch.Generator, batch: int, env: "Joystick") -> "ResetDraws":
        cfg, nu = env.config, env.action_size
        draws = cls(
            base_dxy=_u(gen, (batch, 2), -0.05, 0.05),
            yaw=_u(gen, (batch,), -3.14, 3.14),
            joint_scale=_u(gen, (batch, nu), *env.reset_joint_scale_range),
            base_vel=_u(gen, (batch, 6), -0.05, 0.05),
            command=env.sample_command(gen, batch),
            push_interval=_u(gen, (batch,), *cfg.push_config.interval_range),
            obs=ObsNoise.sample(gen, batch, nu),
        )
        if not env.uses_rsi:
            return draws
        return dataclasses.replace(
            draws,
            rsi_gate=torch.rand((batch,), generator=gen, device=gen.device),
            rsi_phase=torch.randint(0, env.gait.nb_steps_in_period, (batch,), generator=gen,
                                    device=gen.device),
        )


@dataclass(frozen=True)
class StepDraws:
    action_delay: torch.Tensor  # (B,) int in [action_min_delay, action_max_delay)
    push_theta: torch.Tensor  # (B,) U(0, 2 pi)
    push_magnitude: torch.Tensor  # (B,) U(push magnitude_range)
    obs: ObsNoise
    command: torch.Tensor  # (B, 7) taken where the command resamples

    @classmethod
    def sample(cls, gen: torch.Generator, batch: int, env: "Joystick") -> "StepDraws":
        cfg, nu = env.config, env.action_size
        nc = cfg.noise_config
        return cls(
            action_delay=torch.randint(nc.action_min_delay, nc.action_max_delay, (batch,),
                                       generator=gen, device=gen.device),
            push_theta=_u(gen, (batch,), 0.0, 2 * math.pi),
            push_magnitude=_u(gen, (batch,), *cfg.push_config.magnitude_range),
            obs=ObsNoise.sample(gen, batch, nu),
            command=env.sample_command(gen, batch),
        )


# -------------------------------------------------------------------- env
class Joystick(DuckEnv):
    """Track a joystick command (3 locomotion + 4 head dims)."""

    use_imitation = True
    use_motor_speed_limits = True
    obs_has_motor_targets = True
    obs_has_imitation_phase = True
    # on CUDA tensors the step runs as two CUDA kernels around the physics
    # launch (`envs/task_kernel.py`, a build per term set); the tests turn
    # it off on an instance to run the eager body, their reference
    task_kernel = True
    # the reward terms of `_get_reward`, in its order: the term set of the
    # task kernels' build (`task_kernel.kernel_dims`)
    reward_terms = JOYSTICK_TERMS

    def __init__(self, task: str = "flat_terrain", config=None,
                 config_overrides: Optional[Mapping[str, Any]] = None, device="cuda"):
        super().__init__(duck_base.task_to_scene(task), config or self.default_config(),
                         config_overrides, device=device)
        config = self._config
        if hasattr(config, "use_imitation"):
            self.use_imitation = bool(config.use_imitation)
        m = self._model
        dev = self.device
        self._init_q = m.key_qpos.clone()
        if m.spec.floor_is_hfield:
            # the "home" keyframe is authored for the flat floor (z = 0); on
            # a heightfield the feet would spawn up to size[2] inside the
            # terrain and the solver's kick would tip the robot over, so
            # spawn above the tallest terrain point (the feet settle within
            # a few frames under the position servos)
            self._init_q[2] += float(m.hfield_size[2]) + 0.002
        self._default_actuator = m.key_ctrl.clone()
        self.gait = GaitOracle(device=dev) if self.use_imitation else None
        # the gait library's joint targets retargeted onto the no-head
        # robot's own balanced stance; None on the full robot, whose home
        # keyframe is the library's stance
        self._imitation_ref_offset = None
        if self.use_imitation and m.spec.nu == 10:
            home = torch.tensor(imitation.GAIT_HOME_LEGS, dtype=torch.float32, device=dev)
            self._imitation_ref_offset = m.key_ctrl - home
        scale = torch.zeros(m.spec.nu)
        nc = config.noise_config.scales
        for i, name in enumerate(duck_base.JOINTS_ORDER_NO_HEAD):
            if "_hip" in name:
                scale[i] = nc.hip_pos
            elif "_knee" in name:
                scale[i] = nc.knee_pos
            elif "_ankle" in name:
                scale[i] = nc.ankle_pos
        self._qpos_noise_scale = scale.to(dev)
        # the world's down, which the IMU's frame rotates into the gravity
        # observation
        self._down = torch.tensor([0.0, 0.0, -1.0], dtype=m.dtype, device=dev)
        self._metric_keys = [
            ("reward/" if v > 0 else "cost/") + k
            for k, v in config.reward_config.scales.items() if v != 0
        ] + ["swing_peak", "tracking_err/lin_vel", "tracking_err/ang_vel"]
        if self.has_head:
            self._metric_keys.append("tracking_err/head")

    @staticmethod
    def default_config():
        return JoystickConfig()

    @property
    def config(self):
        return self._config

    @property
    def has_head(self) -> bool:
        """The 14-actuator robot: head servos at actuator slots 5:9."""
        return self.action_size == 14

    @property
    def uses_rsi(self) -> bool:
        return self.use_imitation and self._config.rsi_prob > 0.0

    @property
    def reset_joint_scale_range(self) -> Tuple[float, float]:
        return getattr(self._config, "reset_joint_scale_range", (0.5, 1.5))

    def sample_command(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        return sample_command(gen, batch, self._config)

    def reset_draws(self, gen: torch.Generator, batch: int) -> ResetDraws:
        return ResetDraws.sample(gen, batch, self)

    def step_draws(self, gen: torch.Generator, batch: int) -> StepDraws:
        return StepDraws.sample(gen, batch, self)

    # ------------------------------------------------------------ reset
    def reset(self, draws: ResetDraws, model: Optional[Model] = None) -> State:
        model = model if model is not None else self._model
        cfg = self._config
        B, dev, nu = draws.batch, self.device, self.action_size
        f32 = dict(dtype=torch.float32, device=dev)
        qpos = self._init_q.expand(B, -1).clone()
        qvel = torch.zeros((B, model.spec.nv), **f32)

        a = self._floating_base_qpos_addr
        qpos[:, a : a + 2] += draws.base_dxy
        yaw_quat = maths.axis_angle_to_quat(torch.tensor([0.0, 0.0, 1.0], **f32), draws.yaw)
        qpos[:, a + 3 : a + 7] = maths.quat_mul(qpos[:, a + 3 : a + 7], yaw_quat)
        qpos[:, self._actuator_qposadr] = self.get_actuator_joints_qpos(qpos) * draws.joint_scale
        v = self._floating_base_qvel_addr
        qvel[:, v : v + 6] = draws.base_vel
        cmd = draws.command

        i0 = torch.zeros(B, dtype=torch.int32, device=dev)
        if self.uses_rsi:
            i0 = self._reference_state_init(qpos, qvel, cmd, draws)

        ctrl = self.get_actuator_joints_qpos(qpos)
        data = F.init(model, qpos, qvel, ctrl)
        push_interval_steps = torch.round(draws.push_interval / self.dt).to(torch.int32)

        z = lambda *shape: torch.zeros((B,) + shape, **f32)
        if self.use_imitation:
            ref = self.gait.reference_frame(cmd[:, 0], cmd[:, 1], cmd[:, 2], i0)
        else:
            ref = z(0)
        info = {
            "step": torch.zeros(B, dtype=torch.int32, device=dev),
            "command": cmd,
            "last_act": z(nu),
            "last_last_act": z(nu),
            "last_last_last_act": z(nu),
            "motor_targets": self._default_actuator.expand(B, -1).clone(),
            "feet_air_time": z(2),
            "last_contact": torch.zeros((B, 2), dtype=torch.bool, device=dev),
            "swing_peak": z(2),
            "push": z(2),
            "push_step": torch.zeros(B, dtype=torch.int32, device=dev),
            "push_interval_steps": push_interval_steps,
            "action_history": z(cfg.noise_config.action_max_delay * nu),
            "imu_history": z(cfg.noise_config.imu_max_delay * 3),
            "imitation_i": i0,
            "current_reference_motion": ref,
        }
        if self.obs_has_imitation_phase:
            info["imitation_phase"] = self._phase(i0) if self.uses_rsi else z(2)
        metrics = {k: z() for k in self._metric_keys}
        contact = C.feet_contact_flags(model, data.contact_dist)
        obs = self._get_obs(data, info, contact, draws.obs)
        return State(data=data, obs=obs, reward=z(), done=z(), metrics=metrics, info=info)

    def _phase(self, i: torch.Tensor) -> torch.Tensor:
        """(B, 2): cos and sin of the gait phase of frame `i`."""
        ph = i / self.gait.nb_steps_in_period * 2 * math.pi
        return torch.stack([torch.cos(ph), torch.sin(ph)], -1)

    def _reference_state_init(self, qpos, qvel, cmd, draws: ResetDraws) -> torch.Tensor:
        """In place on qpos and qvel: where the gate passes, the leg joints
        (retargeted), their velocities and the base velocity (the frame's
        heading-local linear velocity rotated by the base quaternion, yaw
        included) from the reference frame at a random phase. The head
        joints keep their perturbed reset pose. Returns each env's first
        frame index: the drawn phase where the gate passed, else 0."""
        if draws.rsi_gate is None or draws.rsi_phase is None:
            raise ValueError("rsi_prob > 0: the reset draws need rsi_gate and rsi_phase")
        gate = draws.rsi_gate < self._config.rsi_prob
        i0 = torch.where(gate, draws.rsi_phase, 0).to(torch.int32)
        ref = self.gait.reference_frame(cmd[:, 0], cmd[:, 1], cmd[:, 2], i0)
        jpos, jvel = imitation.legs16(ref[:, 0:16]), imitation.legs16(ref[:, 16:32])
        if self._imitation_ref_offset is not None:
            jpos = jpos + self._imitation_ref_offset
        legs = [i for i in range(self.action_size) if not (self.has_head and 5 <= i < 9)]
        qa = self._actuator_qposadr[legs]
        da = self._actuator_dofadr[legs]
        g = gate[:, None]
        qpos[:, qa] = torch.where(g, jpos, qpos[:, qa])
        qvel[:, da] = torch.where(g, jvel, qvel[:, da])
        a, v = self._floating_base_qpos_addr, self._floating_base_qvel_addr
        base_vel = torch.cat([maths.quat_rotate(qpos[:, a + 3 : a + 7], ref[:, 34:37]), ref[:, 37:40]], -1)
        qvel[:, v : v + 6] = torch.where(g, base_vel, qvel[:, v : v + 6])
        return i0

    # ------------------------------------------------------------- step
    def step(self, state: State, action: torch.Tensor, draws: StepDraws,
             model: Optional[Model] = None) -> State:
        with tracing.span("env.task"):
            if state.data.qvel.is_cuda:
                if self.task_kernel:
                    return task_kernel.step(self, state, action, draws, model)
                task_kernel.count_eager_step()
            model = model if model is not None else self._model
            cfg = self._config
            action = action.to(torch.float32)
            info = dict(state.info)
            B, nu = action.shape

            if self.use_imitation:
                n = self.gait.nb_steps_in_period
                imitation_i = torch.remainder(info["imitation_i"] + 1, n)
                info["imitation_i"] = imitation_i
                if self.obs_has_imitation_phase:
                    info["imitation_phase"] = self._phase(imitation_i)
                cmd = info["command"]
                info["current_reference_motion"] = self.gait.reference_frame(
                    cmd[:, 0], cmd[:, 1], cmd[:, 2], imitation_i)
            else:
                info["imitation_i"] = torch.zeros_like(info["imitation_i"])

            # action delay buffer
            hist = torch.roll(info["action_history"], nu, dims=-1)
            hist[:, :nu] = action
            info["action_history"] = hist
            rows = torch.arange(B, device=action.device)
            action_delayed = hist.reshape(B, -1, nu)[rows, draws.action_delay.long()]

            # random planar push added to the base velocity
            push = torch.stack([torch.cos(draws.push_theta), torch.sin(draws.push_theta)], -1)
            due = torch.remainder(info["push_step"] + 1, info["push_interval_steps"]) == 0
            push = push * due[:, None]
            push = push * cfg.push_config.enable
            a = self._floating_base_qvel_addr
            qvel = state.data.qvel.clone()
            qvel[:, a : a + 2] += push * draws.push_magnitude[:, None]
            data = state.data.replace(qvel=qvel)

            motor_targets = self._default_actuator + action_delayed * cfg.action_scale
            if self.use_motor_speed_limits:
                prev = info["motor_targets"]
                lim = cfg.max_motor_velocity * self.dt
                motor_targets = torch.clamp(motor_targets, prev - lim, prev + lim)
            if self.has_head and cfg.head_direct_targets:
                # the head servos take the head command; the policy's actions
                # move the legs only
                motor_targets = torch.cat([motor_targets[:, :5], info["command"][:, 3:7],
                                           motor_targets[:, 9:]], -1)

            data = F.step(model, data, motor_targets, self.n_substeps)
            info["motor_targets"] = motor_targets

            contact = C.feet_contact_flags(model, data.contact_dist)
            contact_filt = contact | info["last_contact"]
            first_contact = (info["feet_air_time"] > 0.0) * contact_filt
            info["feet_air_time"] = info["feet_air_time"] + self.dt
            p_fz = data.site_xpos[:, self._feet_site_id, -1]
            info["swing_peak"] = torch.maximum(info["swing_peak"], p_fz)

            obs = self._get_obs(data, info, contact, draws.obs)
            done = self._get_termination(data)

            raw = self._get_reward(data, action, info, done, first_contact, contact)
            scales = cfg.reward_config.scales
            total = 0
            for k, v in raw.items():
                total = total + v * scales[k]
            reward = torch.clamp(total * self.dt, 0.0, 10000.0)

            info["push"] = push
            info["step"] = info["step"] + 1
            info["push_step"] = info["push_step"] + 1
            info["last_last_last_act"] = info["last_last_act"]
            info["last_last_act"] = info["last_act"]
            info["last_act"] = action
            cmd_active = info["command"]  # this step's command, before resampling
            resample = info["step"] > 500
            info["command"] = torch.where(resample[:, None], draws.command, info["command"])
            info["step"] = torch.where(done | resample, torch.zeros_like(info["step"]), info["step"])
            info["feet_air_time"] = info["feet_air_time"] * ~contact
            info["last_contact"] = contact
            info["swing_peak"] = info["swing_peak"] * ~contact

            metrics = dict(state.metrics)
            for k, v in raw.items():
                sc = scales[k]
                if sc != 0:
                    metrics[("reward/" if sc > 0 else "cost/") + k] = v if sc > 0 else -v
            metrics["swing_peak"] = torch.mean(info["swing_peak"], -1)
            local_vel = self.get_local_linvel(data)
            gyro = self.get_gyro(data)
            metrics["tracking_err/lin_vel"] = torch.linalg.vector_norm(
                cmd_active[:, :2] - local_vel[:, :2], dim=-1)
            metrics["tracking_err/ang_vel"] = torch.abs(cmd_active[:, 2] - gyro[:, 2])
            if self.has_head:
                head_q = self.get_actuator_joints_qpos(data.qpos)[:, 5:9]
                metrics["tracking_err/head"] = torch.mean(torch.abs(head_q - cmd_active[:, 3:7]), -1)

            return state.replace(data=data, obs=obs, reward=reward, done=done.to(reward.dtype),
                                 metrics=metrics, info=info)

    def _get_termination(self, data) -> torch.Tensor:
        fall = self.get_gravity(data)[:, -1] < 0.0
        return fall | torch.isnan(data.qpos).any(-1) | torch.isnan(data.qvel).any(-1)

    # -------------------------------------------------------------- obs
    def _get_obs(self, data, info, contact, noise: ObsNoise):
        cfg = self._config
        lvl = cfg.noise_config.level
        sc = cfg.noise_config.scales
        gyro = self.get_gyro(data)
        noisy_gyro = gyro + noise.gyro * lvl * sc.gyro
        accelerometer = self.get_accelerometer(data)
        noisy_accel = accelerometer + noise.accelerometer * lvl * sc.accelerometer

        gravity = torch.matmul(data.site_xmat[:, self._site_id].transpose(-1, -2), self._down)
        noisy_gravity = gravity + noise.gravity * lvl * sc.gravity
        # IMU delay buffer: maintained, but the reference's observation does
        # not use the delayed reading
        imu_hist = torch.roll(info["imu_history"], 3, dims=-1)
        imu_hist[:, :3] = noisy_gravity
        info["imu_history"] = imu_hist

        joint_angles = self.get_actuator_angles_with_backlash(data.qpos)
        noisy_joint_angles = joint_angles + noise.joint_pos * lvl * self._qpos_noise_scale
        joint_vel = self.get_actuator_joints_qvel(data.qvel)
        noisy_joint_vel = joint_vel + noise.joint_vel * lvl * sc.joint_vel
        linvel = self.get_local_linvel(data)
        contact_f = contact.to(torch.float32)

        parts = [
            noisy_gyro,
            noisy_accel,
            info["command"],
            noisy_joint_angles - self._default_actuator,
            noisy_joint_vel * cfg.dof_vel_scale,
            info["last_act"],
            info["last_last_act"],
            info["last_last_last_act"],
        ]
        if self.obs_has_motor_targets:
            parts.append(info["motor_targets"])
        parts.append(contact_f)
        if self.obs_has_imitation_phase:
            parts.append(info["imitation_phase"])
        else:
            parts.append(info["current_reference_motion"])
        state = torch.cat(parts, -1)
        a = self._floating_base_qpos_addr
        priv = [
            state,
            gyro,
            accelerometer,
            gravity,
            linvel,
            self.get_global_angvel(data),
            joint_angles - self._default_actuator,
            joint_vel,
            data.qpos[:, a + 2 : a + 3],
            data.actuator_force,
            contact_f,
            data.sensordata[:, self._foot_linvel_sensor_adr],
            info["feet_air_time"],
            info["current_reference_motion"],
        ]
        if self.obs_has_imitation_phase:
            priv += [info["imitation_i"].to(torch.float32)[:, None], info["imitation_phase"]]
        return {"state": state, "privileged_state": torch.cat(priv, -1)}

    # ---------------------------------------------------------- rewards
    def _get_reward(self, data, action, info, done, first_contact, contact):
        del done, first_contact
        cfg = self._config
        sigma = cfg.reward_config.tracking_sigma
        jq = self.get_actuator_joints_qpos(data.qpos)
        jv = self.get_actuator_joints_qvel(data.qvel)
        local_vel = self.get_local_linvel(data)
        gyro = self.get_gyro(data)
        cmd = info["command"]
        imitation_r = imitation.imitation_reward(
            self.get_floating_base_qvel(data.qvel), jq, jv, contact,
            info["current_reference_motion"], cmd, self.use_imitation,
            ref_jpos_offset=self._imitation_ref_offset)
        return {
            "tracking_lin_vel": R.tracking_lin_vel(cmd, local_vel, sigma),
            "tracking_ang_vel": R.tracking_ang_vel(cmd, gyro, sigma),
            "torques": R.torques(data.actuator_force),
            "action_rate": R.action_rate(action, info["last_act"]),
            "alive": R.alive(action.shape[0], action.device),
            "imitation": imitation_r,
            "stand_still": R.stand_still(cmd, jq, jv, self._default_actuator),
            "progress": R.forward_progress(cmd, local_vel),
            "yaw_rate_l1": R.yaw_rate_l1(cmd, gyro),
            "lin_vel_l1": R.lin_vel_l1(cmd, local_vel),
        }
