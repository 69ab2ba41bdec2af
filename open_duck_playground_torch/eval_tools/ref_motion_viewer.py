"""Kinematic playback of the polynomial reference gait in the MuJoCo viewer
(reference ref_motion_viewer.py role): validates the gait library against the
robot model visually; keyboard or pygame-gamepad (--joystick) command input.
Headless mode steps the kinematics and reports joint ranges instead.
Counterpart of `open_duck_playground_tpu/eval_tools/ref_motion_viewer.py`;
`mujoco` is imported only when a viewer is made.

    python -m open_duck_playground_torch.eval_tools.ref_motion_viewer --headless_frames 54
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from open_duck_playground_torch.envs import duck_base
from open_duck_playground_torch.eval_tools.gait_oracle_numpy import GaitOracleNumpy
from open_duck_playground_torch.models.snapshot import compile_mjcf

# gait frame layout (poly_reference_motion.py:6-51): 16 joint positions at
# 0:16 in the 16-joint order (5 left leg, 6 neck/head/antennas, 5 right leg)
_LEG16_TO_ACT14 = [0, 1, 2, 3, 4, None, None, None, None, 11, 12, 13, 14, 15]

# command ranges the gait library was fit over (reference constants)
_RANGE_X = (-0.15, 0.15)
_RANGE_Y = (-0.2, 0.2)
_RANGE_THETA = (-1.0, 1.0)


class RefMotionViewer:
    def __init__(
        self,
        task: str = "flat_terrain",
        reference_data: str | None = None,
        use_joystick: bool = False,
    ):
        import mujoco

        self._mujoco = mujoco
        self.model = compile_mjcf(duck_base.XML_DIR / f"{duck_base.task_to_scene(task)}.xml",
                                  timestep=0.002)
        self.data = mujoco.MjData(self.model)
        mujoco.mj_resetDataKeyframe(self.model, self.data, 0)
        # reference_data: a gait library .pkl; None reads the package's snapshot
        self.gait = GaitOracleNumpy(reference_data)
        jid = lambda n: mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_JOINT, n)
        names = [self.model.actuator(i).name for i in range(self.model.nu)]
        self.act_qposadr = np.array([self.model.jnt_qposadr[jid(n)] for n in names])
        self.commands = [0.02, 0.0, 0.0]
        self.i = 0
        # physical gamepad (reference ref_motion_viewer.py:67-86): stick 1 is
        # vx/vy, a second stick (if present) is yaw rate
        self.joystick = self.joystick2 = None
        if use_joystick:
            import pygame

            self._pygame = pygame
            pygame.init()
            pygame.joystick.init()
            if pygame.joystick.get_count() > 0:
                self.joystick = pygame.joystick.Joystick(0)
                self.joystick.init()
                self.commands = [0.0, 0.0, 0.0]
                print("Joystick initialized:", self.joystick.get_name())
                if pygame.joystick.get_count() > 1:
                    self.joystick2 = pygame.joystick.Joystick(1)
                    self.joystick2.init()
                    print("Joystick 2 (theta) initialized:", self.joystick2.get_name())
                else:
                    print("One joystick: yaw-rate stick disabled.")
            else:
                print("No joystick found! Falling back to keyboard.")

    def poll_joystick(self):
        """Map gamepad axes to commands: up on stick 1 = forward at the
        positive x range, down = backward at the (asymmetric) negative range;
        left/right = lateral; second stick x = yaw rate."""
        if self.joystick is None:
            return
        self._pygame.event.pump()
        joy_y = self.joystick.get_axis(1)
        joy_x = self.joystick.get_axis(0)
        joy_z = self.joystick2.get_axis(0) if self.joystick2 is not None else 0.0
        if joy_y < 0:
            vx = -joy_y * _RANGE_X[1]
        else:
            vx = -joy_y * abs(_RANGE_X[0])
        self.commands[0] = float(vx)
        self.commands[1] = float(-joy_x * _RANGE_Y[1])
        self.commands[2] = float(-joy_z * _RANGE_THETA[1])

    def apply_frame(self):
        frame = self.gait.reference_frame(*self.commands, self.i)
        for act_slot, leg16 in enumerate(_LEG16_TO_ACT14):
            if leg16 is not None:
                self.data.qpos[self.act_qposadr[act_slot]] = frame[leg16]
        self._mujoco.mj_forward(self.model, self.data)
        self.i += 1

    def key_callback(self, keycode):
        if self.joystick is not None:  # gamepad owns the commands
            return
        m = {265: (0, 0.1), 264: (0, -0.1), 263: (1, 0.05), 262: (1, -0.05),
             81: (2, 0.3), 69: (2, -0.3)}
        if keycode in m:
            idx, dv = m[keycode]
            self.commands[idx] = float(np.clip(self.commands[idx] + dv, -1.2, 1.2))
            print("commands:", self.commands)

    def run_viewer(self):
        import mujoco.viewer

        with mujoco.viewer.launch_passive(
            self.model, self.data, key_callback=self.key_callback
        ) as viewer:
            while viewer.is_running():
                self.poll_joystick()
                self.apply_frame()
                viewer.sync()
                time.sleep(1.0 / self.gait.fps)

    def run_headless(self, frames: int = 54):
        qs = []
        for _ in range(frames):
            self.apply_frame()
            qs.append(self.data.qpos[self.act_qposadr].copy())
        qs = np.asarray(qs)
        print("joint ranges over playback:")
        for k in range(qs.shape[1]):
            print(f"  act {k}: [{qs[:,k].min():+.3f}, {qs[:,k].max():+.3f}]")
        return qs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="flat_terrain")
    p.add_argument("--headless_frames", type=int, default=None)
    p.add_argument("--joystick", action="store_true", help="pygame gamepad input")
    args = p.parse_args(argv)
    v = RefMotionViewer(args.task, use_joystick=args.joystick)
    if args.headless_frames:
        v.run_headless(args.headless_frames)
    else:
        v.run_viewer()


if __name__ == "__main__":
    main()
