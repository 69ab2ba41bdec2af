"""The benchmark cell `eval.joystick_rough_backlash` (the heightfield recipe,
`benchmark/configs/joystick_rough_backlash.json`: `Joystick` on
`rough_terrain_backlash` with `rsi_prob=0.5` and the recipe's three tracking
terms) on the CPU, against the benchmark's frozen plain reference
(`benchmark/reference`):

- a run of the cell at a tiny size is `correct`, every number at rounding,
  and not correct with a fault planted: the port steps the plane while the
  reference steps the heightfield;
- the port's `TrainingEnv` and the reference's step the recipe bit for bit
  from the same draws: one reset with reference-state init on per-env
  randomized models, then two control steps;
- the kernel's heightfield body (csrc/megakernel.cuh with -DMK_HFIELD=1,
  built by the host C++ compiler) against the reference's `forward.step`,
  under the gates of test_torch_physics.py;
- the reference's copy of each model snapshot equals the port's;
- the reader of `hfield_launch_share` on the port's launch counters.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, port, trees
from benchmark.metrics import hfield_launch_share
from benchmark.reference.envs import randomize as RR
from benchmark.reference.models import loader as RL
from benchmark.reference.physics import forward as RF

from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics import megakernel as MK

from test_torch_physics import _assert_gates, build_host_kernel, host_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "eval.joystick_rough_backlash"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "joystick_rough_backlash.json").read_text())
SCENE = "scene_rough_terrain_backlash"
SNAPSHOTS = sorted(p.name for p in RL.DATA_DIR.iterdir())


# A run of a cell refuses to print a result in a process that holds JAX (as
# this one does, by conftest.py), so each tiny run has a process of its own.
TINY_RUN = """
import json, sys
from benchmark.harness import port
from benchmark.tests import _tiny
if sys.argv[2] == "plane":  # the port steps the plane, the reference the heightfield
    inner = port.env
    port.env = lambda P, config, device: inner(P, dict(config, task="flat_terrain_backlash"), device)
print(json.dumps(_tiny.run(sys.argv[1])))
"""


@pytest.mark.parametrize("fault", ["none", "plane"])
def test_a_tiny_run_of_the_rough_cell(fault):
    """Correct with every number at rounding, and not correct with a fault
    planted."""
    out = subprocess.run([sys.executable, "-c", TINY_RUN, CELL, fault], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["attempted"] >= 1 and result["failed"] == 0
    failed = [name for name, c in result["checks"].items() if not c["value"] <= c["limit"]]
    if fault == "none":
        assert result["correct"] and not failed, result["checks"]
        for name, c in result["checks"].items():
            assert c["value"] <= 1e-5, (name, c)
    else:
        assert not result["correct"] and failed, result["checks"]


def test_reference_env_steps_the_recipe_as_the_port():
    """One reset with reference-state init and two control steps of the
    port's and the reference's training env from the same draws, per-env
    randomized models, the recipe's overrides on both."""
    torch.set_num_threads(2)
    P = port.modules()
    gen = inputs.generator(7, "cpu")
    ref_env = inputs.reference_env(CONFIG, "cpu")
    env = port.env(P, CONFIG, "cpu")
    assert env.uses_rsi and ref_env.uses_rsi and env.model.spec.floor_is_hfield
    classes = port.classes()
    dr = RR.DRDraws.sample(gen, 6, ref_env.model.spec)
    ref_tenv = inputs.reference_training_env(ref_env, CONFIG, dr)
    tenv = P.wrappers.TrainingEnv(env, CONFIG["ppo"]["episode_length"], dr_draws=trees.recast(dr, classes),
                                  randomization_fn=P.randomize.domain_randomize)
    reset = ref_env.reset_draws(gen, 6)
    assert (reset.rsi_gate < CONFIG["env_overrides"]["rsi_prob"]).any()
    a, b = tenv.reset(trees.recast(reset, classes)), ref_tenv.reset(reset)
    assert (a.info["imitation_i"] != 0).any()
    for _ in range(2):
        action = torch.tanh(torch.randn((6, env.action_size), generator=gen))
        draws = ref_env.step_draws(gen, 6)
        a, b = tenv.step(a, action, trees.recast(draws, classes)), ref_tenv.step(b, action, draws)
        for k in b.obs:
            torch.testing.assert_close(a.obs[k], b.obs[k], rtol=0, atol=0)
        torch.testing.assert_close(a.data.qpos, b.data.qpos, rtol=0, atol=0)
        torch.testing.assert_close(a.data.qvel, b.data.qvel, rtol=0, atol=0)
        torch.testing.assert_close(a.reward, b.reward, rtol=0, atol=0)
        for k in ("reward/progress", "cost/yaw_rate_l1", "cost/lin_vel_l1"):
            assert b.metrics[k].abs().max() > 0, k
            torch.testing.assert_close(a.metrics[k], b.metrics[k], rtol=0, atol=0)


# ------------------------------------------------- the kernel body, host build
@pytest.fixture(scope="module")
def hfield_body(tmp_path_factory):
    tm = TL.load_model(SCENE, device="cpu", dtype=torch.float32)
    assert MK.kernel_dims(tm.spec)["HFIELD"] == 1
    return tm, build_host_kernel(tm.spec, tmp_path_factory.mktemp("mkh_ref"))


def _home_spread(tm, batch):
    """States near the home keyframe spread over +-3 m of the field, on it."""
    rng = np.random.default_rng(8)
    qpos = np.tile(tm.key_qpos.numpy(), (batch, 1)) + 0.01 * rng.standard_normal((batch, tm.spec.nq))
    qpos[:, :2] += rng.uniform(-3.0, 3.0, (batch, 2))
    qvel = 0.1 * rng.standard_normal((batch, tm.spec.nv))
    ctrl = np.tile(tm.key_ctrl.numpy(), (batch, 1)) + 0.05 * rng.standard_normal((batch, tm.spec.nu))
    return [torch.as_tensor(x, dtype=torch.float32) for x in (qpos, qvel, ctrl)]


def _rsi_reset(tm, batch):
    """The recipe's reset (half of it mid-gait), lowered by its spawn lift
    onto the terrain."""
    env = inputs.reference_env(CONFIG, "cpu")
    state = env.reset(env.reset_draws(inputs.generator(9, "cpu"), batch))
    qpos = state.data.qpos.clone()
    qpos[:, 2] -= float(tm.hfield_size[2]) + 0.002
    return qpos, state.data.qvel, state.info["motor_targets"]


@pytest.mark.parametrize("start", [_home_spread, _rsi_reset], ids=["home_spread", "rsi_reset"])
def test_hfield_kernel_body_matches_the_reference(hfield_body, start):
    tm, lib = hfield_body
    rm = RL.load_model(SCENE, device="cpu", dtype=torch.float32)
    qpos, qvel, ctrl = start(tm, 16)
    got = host_step(lib, tm, TF.init(tm, qpos, qvel, ctrl), ctrl, 10)
    want = RF.step(rm, RF.init(rm, qpos, qvel, ctrl), ctrl, 10)
    _assert_gates(got, want, f"heightfield kernel body vs the frozen reference, {start.__name__}")
    assert (want.contact_dist < 0).any()


@pytest.mark.parametrize("name", SNAPSHOTS)
def test_reference_snapshot_equals_the_port(name):
    mine, theirs = RL.DATA_DIR / name, TL.DATA_DIR / name
    if name.endswith(".npz"):
        with np.load(mine) as a, np.load(theirs) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        assert json.loads(mine.read_text()) == json.loads(theirs.read_text())


@pytest.mark.parametrize("counters, share", [
    ({"launches": 40, "launches_hfield": 40}, 100.0),
    ({"launches": 40, "launches_hfield": 10}, 25.0),
    ({"launches": 0, "launches_hfield": 0}, None),
    ({"launches": None, "launches_hfield": None}, None),
    (None, None),
], ids=["all_hfield", "a_quarter", "no_launch", "no_counters", "no_module"])
def test_hfield_launch_share_reads_the_port_counters(monkeypatch, counters, share):
    if counters is None:
        from open_duck_playground_torch import physics

        monkeypatch.delattr(physics, "megakernel")
        monkeypatch.setitem(sys.modules, "open_duck_playground_torch.physics.megakernel", None)
    else:
        for name, value in counters.items():
            if value is None:
                monkeypatch.delattr(MK, name)
            else:
                monkeypatch.setattr(MK, name, value)
    assert hfield_launch_share.read({}) == share
