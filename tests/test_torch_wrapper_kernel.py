"""The training wrapper's two CUDA kernels (`csrc/wrapper_step.cuh`) against
the eager `TrainingEnv.eager_step`, on the CPU. This file imports no JAX
package module:

    python -m pytest tests/test_torch_wrapper_kernel.py -q

The kernels' body is built by the host's C++ compiler as a test harness
(`csrc/wrapper_step_host.cpp`, the card library's C interface, one env
after another) and driven through the port's own wrapper,
`wrapper_kernel.step`, on CPU tensors. Each case steps a reset state of
`TrainingEnv` or `EvalEnv` a few control steps, both ways from the same
state, and holds every leaf bit for bit (NaN where the eager body has
NaN): on the joystick's flat, no-head and heightfield (reference-state
init) layouts and the standing task's; with half the envs done on the
previous step (the autoreset), an episode limit inside the run (the
truncation), the evaluator's sums frozen after an env's first done, and
NaN and +-inf planted in the task step's `qvel`, observations, `info` and
`metrics` (the quarantine and nan_to_num of bad envs; a non-finite info or
metric leaf of a good env passes through); and with `action_repeat` 2.
The counters: a fused step counts one launch, inside a capture once per
replay; CPU tensors take the eager body and count nothing.
"""

import ctypes

import pytest
import torch

from open_duck_playground_torch.envs import step_graph as SG
from open_duck_playground_torch.envs import wrapper_kernel as WK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv
from open_duck_playground_torch.physics import megakernel as MK
from task_kernel_check import (
    RECIPE, assert_same_bits as assert_same, fused_wrapper_step, plant_non_finite as plant, wrapper_host_library,
)

torch.set_num_threads(1)

B, STEPS, LIMIT = 8, 6, 4
LAYOUTS = {"flat": (Joystick, "flat_terrain_backlash", {}), "no_head": (Joystick, "flat_terrain_no_head", RECIPE),
           "rough": (Joystick, "rough_terrain_backlash", RECIPE), "standing": (Standing, "flat_terrain", {})}
WRAPPERS = {"training": TrainingEnv, "eval": EvalEnv}


@pytest.fixture(scope="module")
def lib():
    """The kernels' body built by the host's C++ compiler (products never
    fused into sums, as on the card)."""
    return wrapper_host_library()


@pytest.fixture(scope="module")
def tasks():
    made = {}

    def get(layout):
        if layout not in made:
            cls, task, overrides = LAYOUTS[layout]
            made[layout] = cls(task, device="cpu", config_overrides=overrides)
        return made[layout]

    return get


def fused_against_eager(wenv, lib, gen, steps=STEPS):
    """`steps` control steps from a reset with the even envs done, fused
    through the host build and eager from the same state, each equal; the
    eager states."""
    state = wenv.reset(wenv.env.reset_draws(gen, B))
    state = state.replace(done=(torch.arange(B) % 2 == 0).to(torch.float32))
    out = []
    for t in range(steps):
        action = 3.0 * torch.rand((B, wenv.action_size), generator=gen) - 1.5
        draws = wenv.step_draws(gen, B)
        want = wenv.eager_step(state, action, draws)
        got = fused_wrapper_step(wenv, state, action, draws, lib)
        assert_same(got, want, f"step {t}")
        out.append(want)
        state = want
    return out


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_kernels_compute_the_eager_wrapper_step(layout, wrapper, tasks, lib, monkeypatch):
    task = tasks(layout)
    plant(task, monkeypatch)
    states = fused_against_eager(WRAPPERS[wrapper](task, LIMIT), lib, torch.Generator().manual_seed(3))
    first = states[0]
    bad = torch.tensor([i in (1, 2, 4) for i in range(B)])
    assert torch.equal(first.done[bad], torch.ones(3)) and bool((first.reward[bad] == 0).all())
    assert bool(torch.isfinite(first.info["last_act"][bad]).all()) and bool(torch.isfinite(first.data.qvel).all())
    assert first.info["last_act"][3, 2] == -float("inf") and bool(torch.isnan(first.metrics[list(first.metrics)[1]][3]))
    assert torch.equal(first.data.qvel[1], first.info["first_data"].qvel[1])
    assert bool((states[LIMIT - 1].info["truncation"] > 0).any()) and bool((states[LIMIT - 1].done == 1).all())
    if wrapper == "eval":
        em = [s.info["eval_metrics"] for s in states]
        assert torch.equal(em[0]["episode_done"][bad], torch.ones(3))
        for t in range(1, STEPS):  # frozen after the first done
            frozen = em[t - 1]["episode_done"] > 0
            assert bool(frozen.any())
            assert torch.equal(em[t]["episode_length"][frozen], em[t - 1]["episode_length"][frozen])
            assert torch.equal(em[t]["episode_reward"][frozen].view(torch.int32),
                               em[t - 1]["episode_reward"][frozen].view(torch.int32))


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_action_repeat_2_runs_its_repeats_between_the_kernels(wrapper, tasks, lib, monkeypatch):
    task = tasks("flat")
    calls, real = [], task.step
    monkeypatch.setattr(task, "step", lambda *args, **kwargs: calls.append(1) or real(*args, **kwargs))
    wenv = WRAPPERS[wrapper](task, 2 * LIMIT, action_repeat=2)
    states = fused_against_eager(wenv, lib, torch.Generator().manual_seed(5), steps=LIMIT + 1)
    assert len(calls) == 2 * 2 * (LIMIT + 1)  # two repeats a step, fused and eager
    assert torch.equal(states[0].info["steps"], torch.full((B,), 2.0))
    assert bool((states[LIMIT - 1].done == 1).all())


def test_a_fused_step_counts_one_launch_and_once_per_replay_in_a_capture(tasks, lib):
    wenv = EvalEnv(tasks("flat"), LIMIT)
    gen = torch.Generator().manual_seed(2)
    state = wenv.reset(wenv.env.reset_draws(gen, B))
    inputs = lambda: (torch.zeros((B, wenv.action_size)), wenv.step_draws(gen, B))
    before = (WK.launches, WK.eager_steps)
    fused_wrapper_step(wenv, state, *inputs(), lib)
    assert (WK.launches - before[0], WK.eager_steps - before[1]) == (1, 0)
    with MK.capture() as captured:
        fused_wrapper_step(wenv, state, *inputs(), lib)
    assert WK.launches - before[0] == 1
    captured.count_replay()
    captured.count_replay()
    assert (WK.launches - before[0], WK.eager_steps - before[1]) == (3, 0)
    with MK.capture() as captured:
        WK.count_eager_step()
    captured.count_replay()
    assert (WK.launches - before[0], WK.eager_steps - before[1]) == (3, 1)
    WK.reset_counts()
    assert (WK.launches, WK.eager_steps) == (0, 0)


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_cpu_tensors_take_the_eager_body_and_count_nothing(wrapper, tasks, monkeypatch):
    wenv = WRAPPERS[wrapper](tasks("flat"), LIMIT)
    gen = torch.Generator().manual_seed(4)
    state = wenv.reset(wenv.env.reset_draws(gen, B))
    monkeypatch.setattr(WK, "step", lambda *a, **k: pytest.fail("the fused step on CPU tensors"))
    before = (WK.launches, WK.eager_steps)
    with torch.no_grad():
        wenv.step(state, torch.zeros((B, wenv.action_size)), wenv.step_draws(gen, B))
    assert (WK.launches, WK.eager_steps) == before


def test_the_table_fits_the_kernel_parameters_and_refuses_what_it_cannot_hold(lib, monkeypatch):
    """The harness's table format is the wrapper's (`WrapperLibrary`
    checks it, and refuses a library whose lanes or kinds differ) and
    WrArgs is under the 4 KB of a launch's parameters; a 64-bit leaf and
    rows past the table's room are refused."""
    assert lib.layout == WK.layout() and ctypes.sizeof(WK.WrArgs) <= 4096
    for name, value in (("LANES", 16), ("FINITE", 8)):
        with monkeypatch.context() as m:
            m.setattr(WK, name, value)
            with pytest.raises(RuntimeError, match="table format"):
                WK.WrapperLibrary(lib.built)
    table = WK._Table(B, torch.device("cpu"))
    with pytest.raises(TypeError):
        table.row("int64", None, torch.zeros((B, 3), dtype=torch.int64))
    with pytest.raises(TypeError):
        table.row("sanitized int32", None, torch.zeros((B, 3), dtype=torch.int32), WK.SANITIZE)
    with pytest.raises(NotImplementedError):
        for _ in range(WK.MAX_ROWS + 1):
            table.row("row", None, torch.zeros((B, 2)), WK.SANITIZE)
