"""Closed-loop transfer matrix for an exported policy in stock C-MuJoCo.
Counterpart of the repository's root `tools/transfer_matrix.py`.

Runs the 6-row command battery the RESULTS.md transfer tables use — stand,
±x, +y, turn-in-place, and a head-command row — each as a fresh 10 s
headless rollout, and prints one JSON line per row plus a PASS/FAIL verdict
against the round-1 transfer bar (no falls; both signs/axes track; turning
does not translate; head dims settle). C-MuJoCo runs on the host's CPU:

    python -m open_duck_playground_torch.tools.transfer_matrix -o runs/x.onnx \\
        [--model_path .../scene_flat_terrain_backlash.xml] [--json_out f.json]

Without `--model_path` the scene is the one the policy's action count names:
`scene_flat_terrain_no_head.xml` for the robot without its head (10
actuators), else `scene_flat_terrain_backlash.xml`, the root tool's default.
"""

from __future__ import annotations

import argparse
import json

from open_duck_playground_torch.envs import duck_base

ROWS = [
    ("stand", [0.0] * 7, None),
    ("forward 0.14 m/s", [0.14, 0, 0, 0, 0, 0, 0], ("x>", 0.5)),
    ("backward 0.10 m/s", [-0.10, 0, 0, 0, 0, 0, 0], ("x<", -0.3)),
    ("lateral 0.20 m/s", [0, 0.20, 0, 0, 0, 0, 0], ("y>", 0.4)),
    ("turn 1.0 rad/s", [0, 0, 1.0, 0, 0, 0, 0], ("turn", (0.25, 2.0))),
    # head dims are OBSERVATIONS in the joystick task (the reference ships
    # no head-tracking reward there — its joystick.py:419 head override is
    # commented out and cost_head_pos is Standing-only), so the joystick bar
    # is stability under head commands, not tracking. Tracking itself is
    # asserted on the Standing policy (--standing).
    ("head np0.5 hy1.0", [0, 0, 0, 0.5, 0, 1.0, 0], ("r<", 0.5)),
]

STANDING_ROWS = [
    ("stand", [0.0] * 7, None),
    ("head pitch 0.5", [0, 0, 0, 0, 0.5, 0, 0], ("head<", 0.25)),
    ("head yaw 1.0", [0, 0, 0, 0, 0, 1.0, 0], ("head<", 0.25)),
    ("neck 0.5 + yaw 1.0", [0, 0, 0, 0.5, 0, 1.0, 0], ("head<", 0.35)),
]


def _passes(stats: dict, crit) -> bool:
    x, y = stats["final_xy"]
    if stats["fell"]:
        return False
    if crit is None:
        return True
    kind, thr = crit
    if kind == "x>":
        return x > thr
    if kind == "x<":
        return x < thr
    if kind == "y>":
        return abs(y) > thr  # lateral sign depends on yaw drift
    if kind == "r<":  # stay in place: little translation
        return (x * x + y * y) ** 0.5 < thr
    if kind == "turn":  # rotate in place: yaw accrues, no walk
        r_thr, yaw_thr = thr
        return (x * x + y * y) ** 0.5 < r_thr and abs(stats.get("total_yaw", 0.0)) > yaw_thr
    err = stats.get("head_track_err")  # "head<"
    return err is not None and max(err) < thr


NO_HEAD_ACTUATORS = 10


def default_model_path(onnx_path) -> str:
    """The scene of the policy's robot, read from its action count."""
    import numpy as np

    from open_duck_playground_torch.export.onnx_runtime import OnnxPolicy

    policy = OnnxPolicy(onnx_path)
    width = policy.graph["initializers"]["obs_mean"].shape[-1]
    actions = policy.infer(np.zeros(width, np.float32)).shape[-1]
    scene = "scene_flat_terrain_no_head.xml" if actions == NO_HEAD_ACTUATORS else "scene_flat_terrain_backlash.xml"
    return str(duck_base.XML_DIR / scene)


def run_matrix(onnx_path, model_path, seconds=10.0, standing=False, head_direct=False):
    """One dict per row of the battery: its name, whether it passes, and
    the runner's summary (without the observations)."""
    from open_duck_playground_torch.eval_tools.mujoco_runner import ClosedLoopRunner

    results = []
    for name, cmd, crit in STANDING_ROWS if standing else ROWS:
        runner = ClosedLoopRunner(model_path, onnx_path, standing=standing,
                                  head_direct_targets=head_direct)
        stats = runner.run_headless(seconds, commands=cmd)
        stats.pop("saved_obs", None)
        results.append({"row": name, "ok": bool(_passes(stats, crit)), **stats})
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--onnx_model_path", required=True)
    ap.add_argument("--model_path", default=None,
                    help="scene XML (default: the no-head scene for a 10-actuator policy, else the "
                    "backlash scene)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--standing", action="store_true",
                    help="run the Standing-policy battery (head-command tracking rows)")
    ap.add_argument("--head_direct_targets", action="store_true",
                    help="mirror the env's head_direct_targets training flag")
    args = ap.parse_args(argv)

    model_path = args.model_path or default_model_path(args.onnx_model_path)
    results = run_matrix(args.onnx_model_path, model_path, args.seconds,
                         standing=args.standing, head_direct=args.head_direct_targets)
    for r in results:
        print(json.dumps(r))
    n_ok = sum(r["ok"] for r in results)
    print(f"TRANSFER: {n_ok}/{len(results)} rows pass")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
