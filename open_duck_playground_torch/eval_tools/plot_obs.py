"""Plot saved observation traces (sim-vs-real debugging, the
plot_saved_obs.py role in the reference). Counterpart of
`open_duck_playground_tpu/eval_tools/plot_obs.py`; matplotlib is imported
only when a plot is drawn. The per-dimension labels double as the deployed
obs-vector spec (reference plot_saved_obs.py:87-194 documents the same
layout dim-by-dim).

Obs layout for the joystick policy (state, 101 dims for nu=14):
    [0:3)    gyro (rad/s)
    [3:6)    accelerometer (m/s^2, +1.3 x-offset applied on the eval path)
    [6:13)   command (vx, vy, wz, neck_pitch, head_pitch, head_yaw, head_roll)
    [13:27)  joint angles - default pose (rad)
    [27:41)  joint velocities * 0.05
    [41:55)  last action
    [55:69)  last last action
    [69:83)  last last last action
    [83:97)  motor targets
    [97:99)  foot contacts (L, R)
    [99:101) imitation phase (cos, sin)

Three views:
  default          one panel per section, all dims of the section overlaid
  --per_joint      action-vs-dof_pos grid, one panel per joint (the
                   reference's first figure: real-robot action tracking)
  --dims a b c     individual labeled dims, one panel each
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

# actuator order of the deployed policy (reference plot_saved_obs.py:36-51)
JOINTS_ORDER = [
    "left_hip_yaw",
    "left_hip_roll",
    "left_hip_pitch",
    "left_knee",
    "left_ankle",
    "neck_pitch",
    "head_pitch",
    "head_yaw",
    "head_roll",
    "right_hip_yaw",
    "right_hip_roll",
    "right_hip_pitch",
    "right_knee",
    "right_ankle",
]

SECTIONS = [
    ("gyro", 0, 3),
    ("accelerometer", 3, 6),
    ("command", 6, 13),
    ("joint_angles_delta", 13, 27),
    ("joint_vel_scaled", 27, 41),
    ("last_action", 41, 55),
    ("last_last_action", 55, 69),
    ("last_last_last_action", 69, 83),
    ("motor_targets", 83, 97),
    ("contacts", 97, 99),
    ("imitation_phase", 99, 101),
]


def dim_names() -> list[str]:
    """Full per-dimension label list for the deployed obs vector."""
    names = ["gyro_x", "gyro_y", "gyro_z", "accelo_x", "accelo_y", "accelo_z"]
    names += [
        f"command_{c}"
        for c in ("vx", "vy", "wz", "neck_pitch", "head_pitch", "head_yaw", "head_roll")
    ]
    for prefix in (
        "pos",
        "vel",
        "last_action",
        "last_last_action",
        "last_last_last_action",
        "motor_targets",
    ):
        names += [f"{prefix}_{j}" for j in JOINTS_ORDER]
    names += ["contact_left", "contact_right", "imitation_phase_cos", "imitation_phase_sin"]
    return names


def load_obs(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f))


def _get_plt(out):
    import matplotlib

    if out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, out):
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120)
        print(f"saved {out}")
    else:
        plt.show()


def plot_sections(paths, out: str | None = None):
    plt = _get_plt(out)
    traces = {p: load_obs(p) for p in paths}
    nsec = len(SECTIONS)
    ncols = 3
    nrows = (nsec + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(16, 3 * nrows))
    for ax, (name, a, b) in zip(axes.ravel(), SECTIONS):
        for path, obs in traces.items():
            ax.plot(obs[:, a:b], alpha=0.7)
        ax.set_title(name)
    for ax in axes.ravel()[nsec:]:
        ax.axis("off")
    _finish(plt, fig, out)


def plot_per_joint(paths, out: str | None = None):
    """Action vs dof-pos per joint (reference plot_saved_obs.py:66-86): the
    primary view for diagnosing real-robot tracking lag/backlash."""
    plt = _get_plt(out)
    traces = {p: load_obs(p) for p in paths}
    n = len(JOINTS_ORDER)
    nrows = int(np.sqrt(n))
    ncols = int(np.ceil(n / nrows))
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(4 * ncols, 3 * nrows), sharex=True, sharey=True
    )
    for k, joint in enumerate(JOINTS_ORDER):
        ax = axes.ravel()[k]
        for path, obs in traces.items():
            ax.plot(obs[:, 41 + k], label=f"action {path}", alpha=0.8)
            ax.plot(obs[:, 13 + k], label=f"dof_pos {path}", alpha=0.8)
        ax.set_title(joint)
        if k == 0:
            ax.legend(fontsize=6)
    for ax in axes.ravel()[n:]:
        ax.axis("off")
    _finish(plt, fig, out)


def plot_dims(paths, dims, out: str | None = None):
    plt = _get_plt(out)
    names = dim_names()
    traces = {p: load_obs(p) for p in paths}
    fig, axes = plt.subplots(len(dims), 1, figsize=(12, 2.5 * len(dims)), squeeze=False)
    for ax, d in zip(axes.ravel(), dims):
        for path, obs in traces.items():
            ax.plot(obs[:, d], label=path, alpha=0.8)
        ax.set_title(f"[{d}] {names[d] if d < len(names) else '?'}")
        ax.legend(fontsize=6)
    _finish(plt, fig, out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("obs_pickles", nargs="+", help="mujoco_saved_obs.pkl paths")
    p.add_argument("--out", default=None, help="write PNG instead of showing")
    p.add_argument(
        "--per_joint",
        action="store_true",
        help="action-vs-dof_pos grid per joint (reference figure 1)",
    )
    p.add_argument(
        "--dims", type=int, nargs="*", default=None, help="plot these labeled dims"
    )
    args = p.parse_args(argv)
    if args.per_joint:
        plot_per_joint(args.obs_pickles, args.out)
    elif args.dims:
        plot_dims(args.obs_pickles, args.dims, args.out)
    else:
        plot_sections(args.obs_pickles, args.out)


if __name__ == "__main__":
    main()
