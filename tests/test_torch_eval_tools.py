"""The port's eval tools and reward terms against the JAX package's.

- The 25 torch reward terms (batched over envs) and the imitation reward
  (14 and 10 actuators) against JAX `envs/rewards.py` / `imitation.py` row by
  row, and the port's `eval_tools.rewards_numpy` against both, on the cases
  of the JAX mirror test (tests/test_eval_tools.py), rtol 2e-5, atol 2e-6.
- `GaitOracleNumpy` (the package's snapshot and the reference's .pkl)
  against JAX's over a grid of commands and frame indices: equal.
- `ClosedLoopRunner` against JAX's on the same .onnx for 1 s: `saved_obs`
  within 1e-6 (both are numpy over one C-MuJoCo, so equal in practice) and
  the same summary, on four scenarios; the passive stand on all five scenes;
  the runner's obs length equals the port env's `state` obs for every task
  x scene; a policy trained one step by the port's CLI on the CPU exported,
  validated and run closed loop.
- `RefMotionViewer.run_headless` against JAX's frames, `plot_obs` under
  Agg, and `tools.transfer_matrix.run_matrix` against the root tool, on the
  backlash scene and on the no-head scene with a 10-actuator policy (whose
  scene the port's tool picks when `--model_path` is not given).
"""

import importlib.util
import json
import pathlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import duck_base as JD
from open_duck_playground_tpu.envs import imitation as JI
from open_duck_playground_tpu.envs import rewards as JR
from open_duck_playground_tpu.eval_tools import gait_oracle_numpy as JG
from open_duck_playground_tpu.eval_tools import mujoco_runner as JMR
from open_duck_playground_tpu.eval_tools import ref_motion_viewer as JRV

from open_duck_playground_torch.cli import runner as cli
from open_duck_playground_torch.envs import duck_base as TD
from open_duck_playground_torch.envs import imitation as TI
from open_duck_playground_torch.envs import rewards as TR
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.eval_tools import gait_oracle_numpy as TG
from open_duck_playground_torch.eval_tools import mujoco_runner as TMR
from open_duck_playground_torch.eval_tools import plot_obs
from open_duck_playground_torch.eval_tools import ref_motion_viewer as TRV
from open_duck_playground_torch.eval_tools import rewards_numpy as RN
from open_duck_playground_torch.export import onnx_export as TE
from open_duck_playground_torch.export import onnx_validate as TV
from open_duck_playground_torch.models.snapshot import compile_mjcf
from open_duck_playground_torch.tools import transfer_matrix as TTM
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 2e-6
ROWS = 3
SCENES = ["flat_terrain", "flat_terrain_backlash", "rough_terrain", "rough_terrain_backlash", "flat_terrain_no_head"]


def _reward_cases():
    """(id, term name, args): numpy arrays with a leading row axis are per
    env; anything else is the same for every env."""
    rng = np.random.default_rng(42)
    f = lambda *shape: rng.normal(size=(ROWS, *shape)).astype(np.float32)
    cmd, vel3, pose14, vel14, pose10 = f(7), f(3), f(14), f(14), f(10)
    return [
        ("tracking_lin_vel", "tracking_lin_vel", (cmd, vel3, 0.2)),
        ("tracking_ang_vel", "tracking_ang_vel", (cmd, vel3, 0.2)),
        ("torques", "torques", (f(14),)),
        ("action_rate", "action_rate", (f(14), f(14))),
        ("alive", "alive", ()),
        ("orientation", "orientation", (f(3),)),
        ("stand_still/legs", "stand_still", (cmd * 0.001, pose14, vel14, f(14), True)),
        ("stand_still/all", "stand_still", (cmd, pose14, vel14, f(14), False)),
        ("stand_still/no_head", "stand_still", (cmd * 0.001, pose10, f(10), f(10), True)),
        ("head_pos", "head_pos", (pose14, vel14, cmd)),
        ("head_pos/ungated", "head_pos", (pose14, vel14, cmd, True)),
        ("head_pos/no_head", "head_pos", (pose10, f(10), cmd, True)),
        ("forward_progress", "forward_progress", (cmd, vel3)),
        ("yaw_rate_l1", "yaw_rate_l1", (cmd, vel3)),
        ("lin_vel_l1", "lin_vel_l1", (cmd, vel3)),
        ("lin_vel_z", "lin_vel_z", (vel3,)),
        ("ang_vel_xy", "ang_vel_xy", (vel3,)),
        ("base_height", "base_height", (np.abs(f()) + 1.0, 1.0)),
        ("base_y_swing", "base_y_swing", (0.1 * f(), 1.5, 0.05, np.abs(f()), 0.2)),
        ("energy", "energy", (f(20), f(20))),
        ("joint_pos_limits", "joint_pos_limits", (pose14, f(14) - 3, f(14) + 3)),
        ("feet_slip", "feet_slip", (f(2) > 0, f(3))),
        ("feet_height", "feet_height", (np.abs(f(2)), f(2) > 0, 0.1)),
        ("feet_air_time", "feet_air_time", (np.abs(f(2)), f(2) > 0, cmd)),
        ("feet_phase", "feet_phase", (f(2, 3), f(2))),
        ("feet_clearance", "feet_clearance", (f(2, 3), f(2, 3), 0.08)),
        ("joint_deviation", "joint_deviation", (pose14, [0, 1, 2, 3, 4], f(14), 1.0)),
        ("pose", "pose", (pose14, f(14), np.abs(f(14)))),
        ("termination", "termination", ((f() > 0).astype(np.float32),)),
        ("imitation_reward", "imitation_reward",
         (f(6), pose14, vel14, (f(2) > 0).astype(np.float32), f(40), cmd)),
        ("imitation_reward/no_head", "imitation_reward",
         (f(6), pose10, f(10), (f(2) > 0).astype(np.float32), f(40), cmd, True, 0.05 * f(10))),
    ]


CASES = _reward_cases()


def _row(args, i):
    return [a[i] if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reward_terms_match_jax(case):
    """The torch term over the batch and the port's numpy mirror row by row,
    each against the JAX term on every row."""
    _, name, args = case
    jax_mod, torch_mod = (JI, TI) if name == "imitation_reward" else (JR, TR)
    jfn, tfn, nfn = getattr(jax_mod, name), getattr(torch_mod, name), getattr(RN, name)
    as_j = lambda x: jnp.asarray(x) if isinstance(x, (np.ndarray, list)) else x
    want = np.array([np.asarray(jfn(*[as_j(a) for a in _row(args, i)])) for i in range(ROWS)], np.float64)
    if name == "alive":
        got = TR.alive(ROWS, "cpu")
    else:
        got = tfn(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    assert tuple(got.shape) == (ROWS,)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=RTOL, atol=ATOL)
    mirror = np.array([nfn(*_row(args, i)) for i in range(ROWS)], np.float64)
    np.testing.assert_allclose(mirror, want, rtol=RTOL, atol=ATOL)


def test_reward_terms_cover_the_jax_module():
    """Every public function of JAX `envs/rewards.py` has its torch term and
    numpy mirror, and the cases above reach each of them."""
    names = {n for n in dir(JR) if not n.startswith("_") and callable(getattr(JR, n))}
    assert len(names) == 25
    assert all(hasattr(TR, n) and hasattr(RN, n) for n in names)
    assert names <= {c[1] for c in CASES}


@pytest.mark.parametrize("source", ["snapshot", "pkl"])
def test_gait_oracle_numpy_matches_jax(source):
    ref = JG.GaitOracleNumpy(str(JD.GAIT_PKL))
    ours = TG.GaitOracleNumpy(None if source == "snapshot" else str(TD.GAIT_PKL))
    assert ours.nb_steps_in_period == ref.nb_steps_in_period == 27
    for dx in np.linspace(-0.2, 0.2, 5):
        for dy in np.linspace(-0.25, 0.25, 4):
            for dth in np.linspace(-1.2, 1.2, 5):
                for i in (0, 7, 26, 40):
                    np.testing.assert_array_equal(ours.reference_frame(dx, dy, dth, i),
                                                  ref.reference_frame(dx, dy, dth, i))


def _export(path, obs_size, act_size, seed=0):
    """An untrained 64 x 64 port policy, as tests/test_eval_tools.py uses."""
    gen = torch.Generator().manual_seed(seed)
    obs = {"state": torch.randn(8, obs_size, generator=gen), "privileged_state": torch.randn(8, 64, generator=gen)}
    cfg = PPOConfig(policy_hidden_layer_sizes=(64, 64), value_hidden_layer_sizes=(64,))
    ts = ppo.init_training_state(obs, act_size, cfg, gen, device="cpu")
    TE.export_policy((ts.normalizer, ts.net), act_size, None, obs_size, str(path))
    return str(path)


@pytest.fixture(scope="module")
def policies(tmp_path_factory):
    out = tmp_path_factory.mktemp("onnx")
    return {(101, 14): _export(out / "joystick.onnx", 101, 14),
            (85, 14): _export(out / "standing.onnx", 85, 14, seed=1),
            (77, 10): _export(out / "no_head.onnx", 77, 10, seed=2)}


SCENARIOS = {
    "joystick/flat_terrain": ("scene_flat_terrain.xml", (101, 14), {}, [0.05, 0, 0, 0, 0, 0, 0]),
    "standing/head_direct_targets": ("scene_flat_terrain.xml", (85, 14),
                                     {"standing": True, "head_direct_targets": True}, [0, 0, 0, 0.3, 0.2, 0.5, 0]),
    "no_head/zero_phase": ("scene_flat_terrain_no_head.xml", (77, 10), {"zero_phase": True},
                           [0.1, 0, 0.2, 0, 0, 0, 0]),
    "joystick/rough_terrain_backlash": ("scene_rough_terrain_backlash.xml", (101, 14), {"accel_x_offset": 0.0},
                                        [0.1, 0.05, 0.3, 0, 0, 0, 0]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_closed_loop_runner_matches_jax(policies, scenario):
    scene, key, kwargs, cmd = SCENARIOS[scenario]
    xml = str(TD.XML_DIR / scene)
    assert xml == str(JD.XML_DIR / scene)
    want = JMR.ClosedLoopRunner(xml, policies[key], **kwargs).run_headless(1.0, commands=cmd)
    got = TMR.ClosedLoopRunner(xml, policies[key], **kwargs).run_headless(1.0, commands=cmd)
    assert len(got["saved_obs"]) == 50 and got["saved_obs"][0].shape == (key[0],)
    assert np.abs(np.asarray(got["saved_obs"]) - np.asarray(want["saved_obs"])).max() <= 1e-6
    strip = lambda s: {k: v for k, v in s.items() if k != "saved_obs"}
    assert strip(got) == strip(want)
    assert ("head_track_err" in got) == (key[1] == 14)


@pytest.mark.parametrize("scene", SCENES)
def test_passive_stand(scene):
    """The home keyframe and the position servos hold the robot up for 2 s
    in C-MuJoCo, with the heightfield spawn lift of the runner."""
    import mujoco

    mj = compile_mjcf(TD.XML_DIR / f"scene_{scene}.xml", timestep=0.002)
    assert mj.opt.timestep == 0.002
    d = mujoco.MjData(mj)
    key = mj.keyframe("home")
    d.qpos[:] = key.qpos
    if mj.nhfield > 0:
        d.qpos[2] += float(mj.hfield_size[0][2]) + 0.002
    d.ctrl[:] = key.ctrl
    for _ in range(1000):
        mujoco.mj_step(mj, d)
    assert d.qpos[2] > 0.12, (scene, float(d.qpos[2]))


@pytest.mark.parametrize("task", ["joystick", "standing"])
def test_runner_obs_matches_the_training_obs(policies, task):
    """A port-trained policy can be deployed: for every scene the runner's
    obs is as long as the port env's `state` obs."""
    sizes = {}
    for scene in SCENES:
        env = (Joystick if task == "joystick" else Standing)(scene, device="cpu")
        state = env.reset(env.reset_draws(torch.Generator().manual_seed(0), 1))
        r = TMR.ClosedLoopRunner(str(TD.XML_DIR / f"scene_{scene}.xml"), policies[(101, 14)],
                                 standing=task == "standing")
        sizes[scene] = (len(r.get_obs()), int(state.obs["state"].shape[-1]))
    assert all(a == b for a, b in sizes.values()), sizes
    want = {"joystick": (101, 77), "standing": (85, 65)}[task]
    assert (sizes["flat_terrain_backlash"][0], sizes["flat_terrain_no_head"][0]) == want


def test_cli_policy_validates_and_runs_closed_loop(tmp_path):
    out = tmp_path / "run"
    argv = ["--task", "flat_terrain", "-o", str(out), "--num_timesteps", "32"]
    for pair in ["num_envs=8", "batch_size=4", "num_minibatches=2", "unroll_length=4", "num_updates_per_batch=1",
                 "episode_length=6", "num_eval_envs=4", "num_evals=1",
                 "network_factory={'policy_hidden_layer_sizes': (16,), 'value_hidden_layer_sizes': (16,)}"]:
        argv += ["--config_override", pair]
    cli.main(argv, device="cpu")
    (onnx,) = sorted(out.glob("*.onnx"))
    summary = TV.validate_file(str(onnx))
    assert summary["inputs"] == {"obs": (1, 101)} and summary["outputs"] == {"continuous_actions": (1, 14)}
    stats = TMR.ClosedLoopRunner(str(TD.XML_DIR / "scene_flat_terrain.xml"), str(onnx)).run_headless(
        1.0, commands=[0.05, 0, 0, 0, 0, 0, 0])
    assert len(stats["saved_obs"]) == 50 and all(np.isfinite(o).all() for o in stats["saved_obs"])
    assert stats["mean_height"] > 0.05


def test_runner_main_writes_its_summary(policies, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    TMR.main(["-o", policies[(101, 14)], "--headless_seconds", "0.2", "--command", "0.1,0,0"])
    assert "'fell': False" in capsys.readouterr().out
    with open(tmp_path / "mujoco_saved_obs.pkl", "rb") as f:
        assert len(pickle.load(f)) == 10


def test_ref_motion_viewer_matches_jax():
    want = JRV.RefMotionViewer().run_headless(frames=27)
    got = TRV.RefMotionViewer().run_headless(frames=27)
    assert got.shape == (27, 14) and np.ptp(got[:, 2]) > 0.01
    np.testing.assert_array_equal(got, want)


def test_plot_obs_writes_pngs(tmp_path):
    obs = np.random.default_rng(0).normal(size=(50, 101))
    p = tmp_path / "obs.pkl"
    with open(p, "wb") as f:
        pickle.dump(list(obs), f)
    plot_obs.plot_sections([str(p)], str(tmp_path / "obs.png"))
    plot_obs.plot_per_joint([str(p)], str(tmp_path / "per_joint.png"))
    plot_obs.plot_dims([str(p)], [0, 13, 41], str(tmp_path / "dims.png"))
    for name in ("obs.png", "per_joint.png", "dims.png"):
        assert (tmp_path / name).stat().st_size > 1000
    assert len(plot_obs.dim_names()) == 101 and plot_obs.load_obs(str(p)).shape == (50, 101)


def test_transfer_matrix_matches_the_root_tool(policies, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("root_transfer_matrix", ROOT / "tools" / "transfer_matrix.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    assert TTM.ROWS == root.ROWS and TTM.STANDING_ROWS == root.STANDING_ROWS
    xml = str(TD.XML_DIR / "scene_flat_terrain_backlash.xml")
    for key, standing in (((101, 14), False), ((85, 14), True)):
        want = root.run_matrix(policies[key], xml, seconds=0.3, standing=standing, head_direct=standing)
        got = TTM.run_matrix(policies[key], xml, seconds=0.3, standing=standing, head_direct=standing)
        assert got == want
    out = tmp_path / "matrix.json"
    rows = TTM.main(["-o", policies[(101, 14)], "--seconds", "0.2", "--json_out", str(out)])
    assert len(rows) == len(TTM.ROWS) and out.stat().st_size > 0
    assert f"TRANSFER: {sum(r['ok'] for r in rows)}/6 rows pass" in capsys.readouterr().out


def test_transfer_matrix_runs_on_the_no_head_scene(policies, tmp_path, capsys):
    """A 10-actuator policy on `scene_flat_terrain_no_head.xml`: the port's
    battery equals the root tool's row for row (the head-command row too,
    whose head dims are observations on this robot), and without
    `--model_path` the port's tool picks the no-head scene from the
    policy's action count."""
    spec = importlib.util.spec_from_file_location("root_transfer_matrix", ROOT / "tools" / "transfer_matrix.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    onnx, xml = policies[(77, 10)], str(TD.XML_DIR / "scene_flat_terrain_no_head.xml")
    assert TTM.default_model_path(onnx) == xml
    assert TTM.default_model_path(policies[(101, 14)]).endswith("scene_flat_terrain_backlash.xml")
    got = TTM.run_matrix(onnx, xml, seconds=0.3)
    assert got == root.run_matrix(onnx, xml, seconds=0.3)
    assert [r["row"] for r in got] == [name for name, _, _ in TTM.ROWS]
    assert all(np.isfinite(r["mean_height"]) and 0.1 < r["mean_height"] < 0.25 for r in got)
    out = tmp_path / "matrix.json"
    rows = TTM.main(["-o", onnx, "--seconds", "0.3", "--json_out", str(out)])
    assert rows == got and json.loads(out.read_text()) == got
    assert f"TRANSFER: {sum(r['ok'] for r in rows)}/6 rows pass" in capsys.readouterr().out
