"""The benchmark cell `eval.standing_flat` (the standing recipe,
`benchmark/configs/standing_flat.json`: `Standing` on `flat_terrain`) on
the CPU, against the benchmark's frozen plain reference
(`benchmark/reference`):

- a run of the cell at a tiny size is `correct`, every number at rounding,
  and not correct with a fault planted: the env step returns its state,
  the policy's actions moved by 1e-2, half of the envs acting on zeros,
  or the port's stand_still cost taken over the head's joints too;
- the port's `TrainingEnv` and the reference's step the recipe bit for bit
  from the same draws: a reset and two control steps on per-env
  randomized models, with the head_pos gate open on half the envs;
- the readers of `tk_roofline` and its work function `_task_work` on
  stubbed counters and traces: the bytes are `chip_smoke.task_bytes`'s
  and the observation widths the kernels' own (their host build).
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from benchmark.harness import inputs, port, trees
from benchmark.metrics import _peaks, _task_work, tk_roofline
from benchmark.reference.envs import randomize as RR

from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing

from task_kernel_check import RECIPE, host_library

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "eval.standing_flat"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "standing_flat.json").read_text())


# A run of a cell refuses to print a result in a process that holds JAX (as
# this one does, by conftest.py), so each tiny run has a process of its own.
TINY_RUN = """
import json, sys
import torch
from benchmark.tests import _tiny
from open_duck_playground_torch.envs import joystick, rewards, standing
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
elif fault == "stand_still_whole_body":
    inner = standing.Standing._get_reward
    def _get_reward(self, data, action, info, done, first_contact, contact):
        raw = inner(self, data, action, info, done, first_contact, contact)
        raw["stand_still"] = rewards.stand_still(info["command"], self.get_actuator_joints_qpos(data.qpos),
                                                 self.get_actuator_joints_qvel(data.qvel), self._default_actuator)
        return raw
    standing.Standing._get_reward = _get_reward
print(json.dumps(_tiny.run(sys.argv[1])))
"""


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "answer_altered", "half_batch",
                                   "stand_still_whole_body"])
def test_a_tiny_run_of_the_standing_cell(fault):
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
    """A reset and two control steps of the port's and the reference's
    training env from the same draws, per-env randomized models: the port
    on the CPU runs `Standing.step`'s eager body, the reference its own."""
    torch.set_num_threads(2)
    P = port.modules()
    gen = inputs.generator(7, "cpu")
    ref_env = inputs.reference_env(CONFIG, "cpu")
    env = port.env(P, CONFIG, "cpu")
    assert isinstance(env, Standing) and env.model.spec.nv == 20
    classes = port.classes()
    dr = RR.DRDraws.sample(gen, 6, ref_env.model.spec)
    ref_tenv = inputs.reference_training_env(ref_env, CONFIG, dr)
    tenv = P.wrappers.TrainingEnv(env, CONFIG["ppo"]["episode_length"], dr_draws=trees.recast(dr, classes),
                                  randomization_fn=P.randomize.domain_randomize)
    reset = ref_env.reset_draws(gen, 6)
    a, b = tenv.reset(trees.recast(reset, classes)), ref_tenv.reset(reset)
    # the head_pos gate open on the even envs: a locomotion command
    cmd = b.info["command"].clone()
    cmd[0::2, :3] = torch.tensor([0.1, -0.05, 0.2])
    a, b = a.replace(info={**a.info, "command": cmd.clone()}), b.replace(info={**b.info, "command": cmd})
    for _ in range(2):
        action = torch.tanh(torch.randn((6, env.action_size), generator=gen))
        draws = ref_env.step_draws(gen, 6)
        a, b = tenv.step(a, action, trees.recast(draws, classes)), ref_tenv.step(b, action, draws)
        for k in b.obs:
            torch.testing.assert_close(a.obs[k], b.obs[k], rtol=0, atol=0)
        torch.testing.assert_close(a.data.qpos, b.data.qpos, rtol=0, atol=0)
        torch.testing.assert_close(a.data.qvel, b.data.qvel, rtol=0, atol=0)
        torch.testing.assert_close(a.reward, b.reward, rtol=0, atol=0)
        for k in ("cost/orientation", "cost/stand_still", "cost/head_pos"):
            assert b.metrics[k].abs().max() > 0, k
            torch.testing.assert_close(a.metrics[k], b.metrics[k], rtol=0, atol=0)


# ------------------------------------------------ tk_roofline and _task_work
@pytest.fixture
def chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", module)  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


BUILDS = {"flat": (Joystick, "flat_terrain_backlash", {}), "rough": (Joystick, "rough_terrain_backlash", RECIPE),
          "no_head": (Joystick, "flat_terrain_no_head", RECIPE), "standing": (Standing, "flat_terrain", {}),
          "standing_no_head": (Standing, "flat_terrain_no_head", {})}


@pytest.mark.parametrize("build", list(BUILDS))
def test_task_work_is_chip_smokes_count_and_the_kernels_widths(build, chip_smoke):
    import types

    cls, task, overrides = BUILDS[build]
    env = cls(task, device="cpu", config_overrides=overrides)
    dims, rows = TK.kernel_dims(env), len(env._metric_keys)
    lib = host_library(dims)
    assert _task_work.obs_sizes(dims) == lib.obs_sizes
    P = types.SimpleNamespace(TK=types.SimpleNamespace(library=lambda d: lib))
    assert _task_work.task_bytes(dims, rows) == chip_smoke.task_bytes(P, dims, rows)
    standing = cls is Standing
    assert _task_work.task_bytes(dims, rows) - _task_work.task_bytes({**dims, "STANDING": 0}, rows) == 8 * standing


def _trace(pre_us, post_us, steps):
    return {"trace": {"kernels": {
        "tk_pre_kernel(TkPre)": {"count": steps, "seconds": steps * pre_us * 1e-6},
        "tk_post_kernel(TkPost)": {"count": steps, "seconds": steps * post_us * 1e-6},
        "mk_kernel(MkArgs)": {"count": steps, "seconds": steps * 600e-6}}},
        "work_shape": {"envs": 128}}


def test_tk_roofline_reads_the_most_launched_build(monkeypatch):
    standing = Standing("flat_terrain", device="cpu")
    joystick = Joystick("flat_terrain_backlash", device="cpu")
    monkeypatch.setattr(TK, "build_launches", {TK.build_key(joystick): 3, TK.build_key(standing): 100})
    share = tk_roofline.read(_trace(4.0, 9.0, 100))
    nbytes = 128 * _task_work.task_bytes(TK.kernel_dims(standing), 10)
    assert share == pytest.approx(100.0 * nbytes / _peaks.HBM_BYTES_PER_S / 13e-6, rel=1e-12)
    assert 0.5 < share < 2.0  # launch latency sets the kernels' time at the eval's batch


@pytest.mark.parametrize("case", ["no_task_kernels", "empty_counter", "no_counter", "no_module"])
def test_tk_roofline_is_none_without_kernels_or_counter(monkeypatch, case):
    obs = _trace(4.0, 9.0, 100)
    monkeypatch.setattr(TK, "build_launches", {((("NU", 14),), 10): 5})
    if case == "no_task_kernels":
        obs["trace"]["kernels"] = {"mk_kernel(MkArgs)": {"count": 100, "seconds": 0.06}}
    elif case == "empty_counter":
        monkeypatch.setattr(TK, "build_launches", {})
    elif case == "no_counter":
        monkeypatch.delattr(TK, "build_launches")
    else:
        from open_duck_playground_torch import envs

        monkeypatch.delattr(envs, "task_kernel")
        monkeypatch.setitem(sys.modules, "open_duck_playground_torch.envs.task_kernel", None)
    assert tk_roofline.read(obs) is None
