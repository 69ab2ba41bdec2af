"""Closed-loop evaluation of an exported ONNX policy in C-MuJoCo.
Counterpart of `open_duck_playground_tpu/eval_tools/mujoco_runner.py`.

Cross-engine transfer check (the engine the policy was *trained* in is the
port's batched torch/CUDA one; C-MuJoCo is a different engine — reference
mujoco_infer.py runs the same experiment against MJX-trained policies).
500 Hz sim / 50 Hz policy (decimation 10), keyboard teleop when a viewer is
available, headless scripted mode otherwise; obs traces saved for
plot_saved_obs-style sim-vs-real debugging.

Deliberate reference parity notes:
  - the +1.3 accelerometer x-offset IS applied here (mujoco_infer.py:74)
    though it is a no-op in training obs (joystick.py:500-502);
  - joint angles here do NOT fold backlash (mujoco_infer.py:76), unlike the
    training obs — the same train/eval asymmetry the reference ships.

C-MuJoCo runs on the host's CPU, and `mujoco` is imported only when a runner
is made: the package imports without it (the card's machine has none).

    python -m open_duck_playground_torch.eval_tools.mujoco_runner \
        -o runs/x.onnx --headless_seconds 5
"""

from __future__ import annotations

import argparse
import pickle
import time

import numpy as np

from open_duck_playground_torch.envs import duck_base
from open_duck_playground_torch.eval_tools.gait_oracle_numpy import GaitOracleNumpy
from open_duck_playground_torch.export.onnx_runtime import OnnxPolicy
from open_duck_playground_torch.models.snapshot import compile_mjcf

USE_MOTOR_SPEED_LIMITS = True

COMMANDS_RANGE_X = [-0.15, 0.15]
COMMANDS_RANGE_Y = [-0.2, 0.2]
COMMANDS_RANGE_THETA = [-1.0, 1.0]
NECK_PITCH_RANGE = [-0.34, 1.1]
HEAD_PITCH_RANGE = [-0.78, 0.78]
HEAD_YAW_RANGE = [-1.5, 1.5]
HEAD_ROLL_RANGE = [-0.5, 0.5]


class ClosedLoopRunner:
    def __init__(
        self,
        model_path: str,
        onnx_model_path: str,
        reference_data: str | None = None,
        standing: bool = False,
        accel_x_offset: float = 1.3,
        zero_phase: bool = False,
        head_direct_targets: bool = False,
    ):
        # accel_x_offset replicates the reference's eval-side accelerometer
        # quirk (mujoco_infer.py:74; a no-op in training obs). Pass 0.0 for
        # train/eval-consistent obs — measurably better command tracking.
        self.accel_x_offset = accel_x_offset
        # zero_phase: policies trained with use_imitation=False keep the
        # imitation-phase obs dims frozen at [0, 0] (joystick.py reset/step);
        # feeding them a live cos/sin phase here is out-of-distribution and
        # makes such policies fall on contact. Obs layout is unchanged.
        self.zero_phase = zero_phase
        # mirrors the env's head_direct_targets flag: head servo targets
        # come from the command dims (policies trained with that flag must
        # be evaluated with it)
        self.head_direct_targets = head_direct_targets
        import mujoco

        self._mujoco = mujoco
        self.model = compile_mjcf(model_path, timestep=0.002)
        self.data = mujoco.MjData(self.model)
        # start from the "home" keyframe like training reset does
        # (reference mujoco_infer_base.py:118-128)
        key = self.model.keyframe("home")
        self.data.qpos[:] = key.qpos
        if self.model.nhfield > 0:
            # keyframe is authored for the flat floor: spawn above the
            # tallest terrain point so the feet don't start inside the
            # heightfield (the solver kick would tip the robot over)
            self.data.qpos[2] += float(self.model.hfield_size[0][2]) + 0.002
        self.data.ctrl[:] = key.ctrl
        mujoco.mj_step(self.model, self.data)
        self.sim_dt = 0.002
        self.decimation = 10
        self.standing = standing
        self.head_control_mode = standing

        mj = self.model
        self.num_dofs = mj.nu
        actuator_names = [mj.actuator(i).name for i in range(mj.nu)]
        jid = lambda n: mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_JOINT, n)
        self.actuator_qposadr = np.array(
            [mj.jnt_qposadr[jid(n)] for n in actuator_names]
        )
        self.actuator_dofadr = np.array([mj.jnt_dofadr[jid(n)] for n in actuator_names])
        self.default_actuator = np.array(mj.keyframe("home").ctrl)

        def sensor_slice(name):
            sid = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_SENSOR, name)
            a = mj.sensor_adr[sid]
            return slice(a, a + mj.sensor_dim[sid])

        self.gyro_slice = sensor_slice("gyro")
        self.accel_slice = sensor_slice("accelerometer")
        self.floor_geom = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_GEOM, "floor")
        self.feet_geoms = [
            mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_GEOM, n)
            for n in duck_base.FEET_GEOMS
        ]

        self.policy = OnnxPolicy(onnx_model_path)
        # reference_data: a gait library .pkl; None reads the package's snapshot
        self.gait = None if standing else GaitOracleNumpy(reference_data)

        self.dof_vel_scale = 0.05
        self.action_scale = 0.25
        self.max_motor_velocity = 5.24
        self.phase_frequency_factor = 1.0

        self.last_action = np.zeros(self.num_dofs)
        self.last_last_action = np.zeros(self.num_dofs)
        self.last_last_last_action = np.zeros(self.num_dofs)
        self.motor_targets = self.default_actuator.copy()
        self.prev_motor_targets = self.default_actuator.copy()
        self.commands = [0.0] * 7
        self.imitation_i = 0.0
        self.imitation_phase = np.zeros(2)
        self.saved_obs = []

    # ------------------------------------------------------------------ obs
    def feet_contacts(self) -> np.ndarray:
        out = np.zeros(2)
        for c in range(self.data.ncon):
            con = self.data.contact[c]
            pair = {con.geom1, con.geom2}
            for i, g in enumerate(self.feet_geoms):
                if pair == {g, self.floor_geom} and con.dist < 0:
                    out[i] = 1.0
        return out

    def get_obs(self) -> np.ndarray:
        d = self.data
        gyro = d.sensordata[self.gyro_slice].copy()
        accelerometer = d.sensordata[self.accel_slice].copy()
        accelerometer[0] += self.accel_x_offset
        joint_angles = d.qpos[self.actuator_qposadr]
        joint_vel = d.qvel[self.actuator_dofadr]
        obs = [
            gyro,
            accelerometer,
            np.asarray(self.commands),
            joint_angles - self.default_actuator,
            joint_vel * self.dof_vel_scale,
            self.last_action,
            self.last_last_action,
            self.last_last_last_action,
        ]
        if not self.standing:
            obs.append(self.motor_targets)
        obs.append(self.feet_contacts())
        if not self.standing:
            obs.append(self.imitation_phase)
        return np.concatenate(obs).astype(np.float32)

    # --------------------------------------------------------------- control
    def control_step(self):
        if not self.standing and not self.zero_phase:
            self.imitation_i = (
                self.imitation_i + self.phase_frequency_factor
            ) % self.gait.nb_steps_in_period
            ph = self.imitation_i / self.gait.nb_steps_in_period * 2 * np.pi
            self.imitation_phase = np.array([np.cos(ph), np.sin(ph)])
        obs = self.get_obs()
        self.saved_obs.append(obs)
        action = np.asarray(self.policy.infer(obs))
        self.last_last_last_action = self.last_last_action.copy()
        self.last_last_action = self.last_action.copy()
        self.last_action = action.copy()
        self.motor_targets = self.default_actuator + action * self.action_scale
        if USE_MOTOR_SPEED_LIMITS:
            lim = self.max_motor_velocity * self.sim_dt * self.decimation
            self.motor_targets = np.clip(
                self.motor_targets,
                self.prev_motor_targets - lim,
                self.prev_motor_targets + lim,
            )
        # head override BEFORE the prev copy: the env stores the
        # post-override targets as prev (envs/joystick.py step ordering) —
        # keep the train/eval mirror invariant exact even if the override
        # ever becomes conditional per-step.
        if self.head_direct_targets and self.num_dofs == 14:
            self.motor_targets[5:9] = self.commands[3:7]
        if USE_MOTOR_SPEED_LIMITS:
            self.prev_motor_targets = self.motor_targets.copy()
        self.data.ctrl[:] = self.motor_targets

    def run_headless(self, seconds: float, commands=None) -> dict:
        """Scripted closed-loop rollout; returns summary stats (also the
        harness for automated transfer tests)."""
        mujoco = self._mujoco
        if commands is not None:
            self.commands = list(commands)
        n = int(seconds / self.sim_dt)
        heights = []
        head_errs = []
        yaws = []

        def _yaw():
            qw, qx, qy, qz = self.data.qpos[3:7]
            return float(
                np.arctan2(
                    2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz)
                )
            )

        for counter in range(1, n + 1):
            mujoco.mj_step(self.model, self.data)
            if counter % self.decimation == 0:
                self.control_step()
                heights.append(float(self.data.qpos[2]))
                yaws.append(_yaw())
                if self.num_dofs == 14:
                    # head joints are actuators 5:9, position-commanded by
                    # command dims 3:7 (reference cost_head_pos semantics)
                    head_errs.append(
                        np.abs(
                            self.data.qpos[self.actuator_qposadr[5:9]]
                            - np.asarray(self.commands[3:7])
                        )
                    )
        out = {
            "fell": bool(self.data.qpos[2] < 0.1),
            "mean_height": float(np.mean(heights)),
            "final_xy": self.data.qpos[:2].tolist(),
            # cumulative (unwrapped) base heading change over the rollout,
            # radians — turn-in-place is distinguishable from standing
            # still, and total/seconds approximates the achieved yaw rate
            "total_yaw": round(float(np.sum(np.unwrap(yaws)[1:] - np.unwrap(yaws)[:-1])), 3)
            if len(yaws) > 1
            else 0.0,
            "saved_obs": self.saved_obs,
        }
        if head_errs:
            # settled tracking error: mean |head qpos - commanded| per dim
            # over the last half of the rollout
            tail = np.asarray(head_errs[len(head_errs) // 2 :])
            out["head_track_err"] = [
                round(float(v), 4) for v in tail.mean(axis=0)
            ]
        return out

    # ----------------------------------------------------------------- teleop
    def key_callback(self, keycode):
        if keycode == 72:  # h toggles head mode
            self.head_control_mode = not self.head_control_mode
        if not self.head_control_mode:
            m = {265: (0, COMMANDS_RANGE_X[1]), 264: (0, COMMANDS_RANGE_X[0]),
                 263: (1, COMMANDS_RANGE_Y[1]), 262: (1, COMMANDS_RANGE_Y[0]),
                 81: (2, COMMANDS_RANGE_THETA[1]), 69: (2, COMMANDS_RANGE_THETA[0])}
            self.commands[:3] = [0.0, 0.0, 0.0]
            if keycode in m:
                i, v = m[keycode]
                self.commands[i] = v
            elif keycode == 80:
                self.phase_frequency_factor += 0.1
            elif keycode == 59:
                self.phase_frequency_factor -= 0.1
        else:
            m = {265: (4, HEAD_PITCH_RANGE[1]), 264: (4, HEAD_PITCH_RANGE[0]),
                 263: (5, HEAD_YAW_RANGE[1]), 262: (5, HEAD_YAW_RANGE[0]),
                 81: (6, HEAD_ROLL_RANGE[1]), 69: (6, HEAD_ROLL_RANGE[0])}
            self.commands[3:] = [0.0, 0.0, 0.0, 0.0]
            if keycode in m:
                i, v = m[keycode]
                self.commands[i] = v

    def run_viewer(self):
        import mujoco.viewer

        try:
            with mujoco.viewer.launch_passive(
                self.model,
                self.data,
                show_left_ui=False,
                show_right_ui=False,
                key_callback=self.key_callback,
            ) as viewer:
                counter = 0
                while True:
                    t0 = time.time()
                    mujoco.mj_step(self.model, self.data)
                    counter += 1
                    if counter % self.decimation == 0:
                        self.control_step()
                    viewer.sync()
                    rest = self.model.opt.timestep - (time.time() - t0)
                    if rest > 0:
                        time.sleep(rest)
        except KeyboardInterrupt:
            with open("mujoco_saved_obs.pkl", "wb") as f:
                pickle.dump(self.saved_obs, f)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--onnx_model_path", type=str, required=True)
    parser.add_argument(
        "--model_path",
        type=str,
        default=str(duck_base.XML_DIR / "scene_flat_terrain.xml"),
    )
    parser.add_argument("--reference_data", type=str, default=None,
                        help="gait library .pkl (default: the package's snapshot of it)")
    parser.add_argument("--standing", action="store_true", default=False)
    parser.add_argument("--headless_seconds", type=float, default=None)
    parser.add_argument(
        "--command",
        type=str,
        default=None,
        metavar="VX,VY,WZ[,NP,HP,HY,HR]",
        help="fixed 7-dim command for headless mode, comma-separated "
        "(trailing head dims default to 0), e.g. --command 0.14,0,0",
    )
    parser.add_argument(
        "--accel_x_offset",
        type=float,
        default=1.3,
        help="eval-side accelerometer x offset (reference parity quirk, "
        "mujoco_infer.py:74); pass 0 for train-consistent obs",
    )
    parser.add_argument(
        "--zero_phase",
        action="store_true",
        default=False,
        help="freeze the imitation-phase obs dims at [0,0] for policies "
        "trained with use_imitation=False",
    )
    parser.add_argument(
        "--head_direct_targets",
        action="store_true",
        default=False,
        help="head servo targets from command dims (mirror of the env's "
        "head_direct_targets training flag)",
    )
    args = parser.parse_args(argv)
    runner = ClosedLoopRunner(
        args.model_path,
        args.onnx_model_path,
        args.reference_data,
        args.standing,
        accel_x_offset=args.accel_x_offset,
        zero_phase=args.zero_phase,
        head_direct_targets=args.head_direct_targets,
    )
    commands = None
    if args.command is not None:
        vals = [float(v) for v in args.command.split(",")]
        if len(vals) > 7:
            raise SystemExit("--command takes at most 7 values")
        commands = vals + [0.0] * (7 - len(vals))
    if args.headless_seconds:
        stats = runner.run_headless(args.headless_seconds, commands=commands)
        print({k: v for k, v in stats.items() if k != "saved_obs"})
        with open("mujoco_saved_obs.pkl", "wb") as f:
            pickle.dump(stats["saved_obs"], f)
    else:
        runner.run_viewer()


if __name__ == "__main__":
    main()
