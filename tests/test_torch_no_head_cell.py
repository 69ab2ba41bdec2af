"""The benchmark cell `eval.joystick_no_head_final` (the final no-head
recipe, `benchmark/configs/joystick_no_head_final.json`: `Joystick` on
`flat_terrain_no_head`, the legs-only robot, with `rsi_prob=0.5` and the
recipe's three tracking terms) on the CPU, against the benchmark's frozen
plain reference (`benchmark/reference`):

- a run of the cell at a tiny size is `correct`, every number at rounding,
  and not correct with a fault planted: the env step returns its state,
  the policy's actions moved by 1e-2, half of the envs acting on zeros, or
  the legs-only gait retarget (the no-head robot's home pose less the gait
  library's, `_imitation_ref_offset`) taken with the library's two legs
  swapped;
- the port's `TrainingEnv` and the reference's step the recipe bit for bit
  from the same draws: a reset with reference-state init on half of the
  envs, then two control steps, on per-env randomized models;
- the reader of `mk_build_share` on stubbed counters, its key the port's
  `megakernel.kernel_dims` of each benchmarked build (1, 1f, 1h, 1n), and
  the port's read-out `megakernel.build_launches()` it reads.
"""

import json
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness import inputs, port, trees
from benchmark.metrics import _kernel_work, mk_build_share
from benchmark.reference.envs import randomize as RR
from benchmark.reference.models import loader as RL

from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import megakernel as MK

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "eval.joystick_no_head_final"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "joystick_no_head_final.json").read_text())


# A run of a cell refuses to print a result in a process that holds JAX (as
# this one does, by conftest.py), so each tiny run has a process of its own.
TINY_RUN = """
import json, sys
import torch
from benchmark.tests import _tiny
from open_duck_playground_torch.envs import imitation, joystick
from open_duck_playground_torch.train import networks
fault = sys.argv[2]
if fault == "state_unchanged":
    joystick.Joystick.step = lambda self, state, action, draws, model=None: state
elif fault == "answer_altered":
    networks.postprocess = lambda raw: torch.tanh(raw) + 1e-2
elif fault == "half_batch":
    def postprocess(raw):
        a = torch.tanh(raw)
        return torch.cat([a[: a.shape[0] // 2], torch.zeros_like(a[a.shape[0] // 2 :])])
    networks.postprocess = postprocess
elif fault == "retarget_legs_swapped":
    home = imitation.GAIT_HOME_LEGS
    imitation.GAIT_HOME_LEGS = home[5:] + home[:5]
print(json.dumps(_tiny.run(sys.argv[1])))
"""


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "answer_altered", "half_batch",
                                   "retarget_legs_swapped"])
def test_a_tiny_run_of_the_no_head_cell(fault):
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
    """A reset with reference-state init on half of the envs and two control
    steps of the port's and the reference's training env from the same
    draws, per-env randomized models, the recipe's overrides on both: the
    port on the CPU runs `Joystick.step`'s eager body, the reference its
    own."""
    torch.set_num_threads(2)
    P = port.modules()
    gen = inputs.generator(7, "cpu")
    ref_env = inputs.reference_env(CONFIG, "cpu")
    env = port.env(P, CONFIG, "cpu")
    assert isinstance(env, Joystick) and not env.has_head and env.uses_rsi and ref_env.uses_rsi
    assert (env.model.spec.nq, env.model.spec.nv, env.action_size) == (17, 16, 10)
    classes = port.classes()
    dr = RR.DRDraws.sample(gen, 6, ref_env.model.spec)
    ref_tenv = inputs.reference_training_env(ref_env, CONFIG, dr)
    tenv = P.wrappers.TrainingEnv(env, CONFIG["ppo"]["episode_length"], dr_draws=trees.recast(dr, classes),
                                  randomization_fn=P.randomize.domain_randomize)
    reset = ref_env.reset_draws(gen, 6)
    gate = reset.rsi_gate < CONFIG["env_overrides"]["rsi_prob"]
    assert gate.any() and not gate.all()
    a, b = tenv.reset(trees.recast(reset, classes)), ref_tenv.reset(reset)
    assert (a.info["imitation_i"][gate] != 0).any()
    torch.testing.assert_close(a.data.qpos, b.data.qpos, rtol=0, atol=0)
    for _ in range(2):
        action = torch.tanh(torch.randn((6, env.action_size), generator=gen))
        draws = ref_env.step_draws(gen, 6)
        a, b = tenv.step(a, action, trees.recast(draws, classes)), ref_tenv.step(b, action, draws)
        for k in b.obs:
            torch.testing.assert_close(a.obs[k], b.obs[k], rtol=0, atol=0)
        torch.testing.assert_close(a.data.qpos, b.data.qpos, rtol=0, atol=0)
        torch.testing.assert_close(a.data.qvel, b.data.qvel, rtol=0, atol=0)
        torch.testing.assert_close(a.reward, b.reward, rtol=0, atol=0)
        for k in ("reward/imitation", "reward/progress", "cost/yaw_rate_l1", "cost/lin_vel_l1"):
            assert b.metrics[k].abs().max() > 0, k
            torch.testing.assert_close(a.metrics[k], b.metrics[k], rtol=0, atol=0)


# ------------------------------------------------------------ mk_build_share
BUILDS = {"1": "scene_flat_terrain_backlash", "1f": "scene_flat_terrain", "1h": "scene_rough_terrain_backlash",
          "1n": "scene_flat_terrain_no_head"}


def _key(scene):
    return tuple(sorted(MK.kernel_dims(TL.load_model(scene, device="cpu", dtype=torch.float32).spec).items()))


def _obs(scene):
    return {"model": types.SimpleNamespace(spec=RL.load_model(scene, device="cpu", dtype=torch.float32).spec)}


@pytest.mark.parametrize("build", list(BUILDS))
def test_mk_build_share_keys_each_build_as_the_port(build):
    scene = BUILDS[build]
    assert tuple(sorted(_kernel_work.kernel_dims(_obs(scene)["model"].spec).items())) == _key(scene)
    others = [_key(s) for b, s in BUILDS.items() if b != build]
    assert _key(scene) not in others


@pytest.mark.parametrize("counts, total, share", [
    ({"1n": 40}, 40, 100.0),
    ({"1": 40}, 40, 0.0),
    ({"1n": 30, "1f": 10}, 40, 75.0),
    ({"1n": 0}, 0, None),
    (None, 40, None),
    ("no_module", 40, None),
], ids=["own_build", "another_build", "a_share", "no_launch", "no_read_out", "no_module"])
def test_mk_build_share_reads_the_port_counters(monkeypatch, counts, total, share):
    obs = _obs(BUILDS["1n"])
    if counts == "no_module":
        from open_duck_playground_torch import physics

        monkeypatch.delattr(physics, "megakernel")
        monkeypatch.setitem(sys.modules, "open_duck_playground_torch.physics.megakernel", None)
    else:
        monkeypatch.setattr(MK, "launches", total)
        if counts is None:
            monkeypatch.delattr(MK, "build_launches")
        else:
            by_key = {_key(BUILDS[b]): n for b, n in counts.items()}
            monkeypatch.setattr(MK, "build_launches", lambda: dict(by_key))
    assert mk_build_share.read(obs) == share


def test_build_launches_reads_each_library_s_count_and_resets(monkeypatch):
    """The read-out returns each built library's own count by its dims,
    and `reset_launches` zeroes it (libraries stood in for: the CPU builds
    none)."""
    libs = {}
    for build in ("1", "1n"):
        key = _key(BUILDS[build])
        lib = MK._Kernel.__new__(MK._Kernel)
        lib.dims, lib.dense, lib.launches = dict(key), False, 0
        libs[key] = lib
    monkeypatch.setattr(MK, "_KERNELS", libs)
    for name in ("launches", "launches_hfield", "launches_dense"):
        monkeypatch.setattr(MK, name, 0)
    model = TL.load_model(BUILDS["1n"], device="cpu", dtype=torch.float32)
    for _ in range(3):
        MK._count(libs[_key(BUILDS["1n"])], model)
    MK._count(libs[_key(BUILDS["1"])], model)
    assert MK.build_launches() == {_key(BUILDS["1"]): 1, _key(BUILDS["1n"]): 3}
    assert MK.launches == 4
    assert mk_build_share.read(_obs(BUILDS["1n"])) == 75.0
    MK.reset_launches()
    assert MK.build_launches() == {_key(BUILDS["1"]): 0, _key(BUILDS["1n"]): 0}
    assert mk_build_share.read(_obs(BUILDS["1n"])) is None
