"""The joystick task's two CUDA kernels (`csrc/task_step.cuh`) against the
eager `Joystick.step`, on the CPU. This file imports no JAX package module:

    python -m pytest tests/test_torch_task_kernel.py -q

The kernels' body is built by the host's C++ compiler as a test harness
(`csrc/task_step_host.cpp`, the card library's C interface, one env after
another) and driven through the port's own wrapper, `task_kernel.step`,
on CPU tensors. Each case steps a reset state (edited where the case
needs: a push due, a command resample, a gait-grid tie, a NaN velocity)
a few control steps, both ways from the same state, with the eager step's
own physics launch replayed in the fused step (`forward.step` recorded,
then returned), so that the comparison sees the task's arithmetic alone:
every integer and bool leaf equal, every float leaf within 4 ulps of its
column's largest magnitude (the sums over a row and the vector norms take
another order than PyTorch's reductions, and the host's `cosf` and `expf`
are not the SLEEF functions of PyTorch's CPU kernels: at most ~2.2 ulps
over 25 steps of 64 envs), NaN where the eager step has NaN. End to end,
through the plain physics itself, the physics state is bit for bit the
eager step's while no push is due. The counters: a fused step counts one
launch, inside a capture once per replay; CPU tensors take the eager body.
"""

import pytest
import torch

from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.physics import forward as F
from open_duck_playground_torch.physics import megakernel as MK
from task_kernel_check import RECIPE, assert_close, host_library

torch.set_num_threads(1)

B, STEPS = 16, 3


def grid_tie(grid: torch.Tensor, k: int) -> float:
    """A float32 command between grid points k and k + 1 at exactly the
    same float32 distance from both (`torch.abs(grid - x)` ties)."""
    x = (grid[k] + grid[k + 1]) / 2
    for _ in range(64):
        d = torch.abs(grid - x)
        if d[k] == d[k + 1]:
            return float(x)
        x = torch.nextafter(x, grid[k + 1] if d[k] < d[k + 1] else grid[k])
    raise AssertionError("no tie point found")


def push_due(env, state):
    info = dict(state.info)
    due = torch.arange(B) % 2 == 0
    info["push_step"] = torch.where(due, info["push_interval_steps"] - 1, info["push_step"])
    return state.replace(info=info)


def resample(env, state):
    info = dict(state.info)
    info["step"] = torch.where(torch.arange(B) % 2 == 0, 500, 499).to(torch.int32)
    return state.replace(info=info)


def tie(env, state):
    g = env.gait
    cmd = state.info["command"].clone()
    cmd[0::2, 0] = grid_tie(g._dxs, 2)
    cmd[1::2, 1] = grid_tie(g._dys, 1)
    cmd[0::4, 2] = grid_tie(g._dthetas, 4)
    cmd[3, :3] = torch.tensor([1.0, -1.0, 5.0])  # beyond the grid: clamped
    return state.replace(info={**state.info, "command": cmd})


def nan_qvel(env, state):
    qvel = state.data.qvel.clone()
    qvel[1] = float("nan")
    qvel[2, 7] = float("inf")
    return state.replace(data=state.data.replace(qvel=qvel))


CASES = {
    "flat": ("flat_terrain_backlash", {}, None),
    "rough": ("rough_terrain_backlash", RECIPE, None),
    "no_head": ("flat_terrain_no_head", RECIPE, None),
    "head_direct_targets": ("flat_terrain_backlash", {"head_direct_targets": True}, None),
    "imitation_off": ("flat_terrain_backlash", {"use_imitation": False}, None),
    "push_due": ("flat_terrain_backlash", {}, push_due),
    "command_resample": ("flat_terrain_backlash", {}, resample),
    "gait_grid_tie": ("flat_terrain_backlash", {}, tie),
    "nan_qvel": ("flat_terrain_backlash", {}, nan_qvel),
}


@pytest.fixture(scope="module")
def envs():
    made = {}

    def get(task, overrides):
        key = (task, tuple(sorted(overrides.items())))
        if key not in made:
            made[key] = Joystick(task, device="cpu", config_overrides=overrides)
        return made[key]

    return get


def inputs(env, gen):
    action = 3.0 * torch.rand((B, env.action_size), generator=gen) - 1.5
    return action, env.step_draws(gen, B)


@pytest.mark.parametrize("case", list(CASES))
def test_the_kernels_compute_the_eager_step(case, envs, monkeypatch):
    task, overrides, edit = CASES[case]
    env = envs(task, overrides)
    lib = host_library(TK.kernel_dims(env))
    gen = torch.Generator().manual_seed(7)
    state = env.reset(env.reset_draws(gen, B))
    if edit is not None:
        state = edit(env, state)
    physics, real = [], F.step

    def recorded(m, d, ctrl, n):
        out = real(m, d, ctrl, n)
        physics.append((d, ctrl, out))
        return out

    def replayed(m, d, ctrl, n):
        d_in, ctrl_in, out = physics[-1]
        assert_close(d.qvel, d_in.qvel, f"{case}: the physics launch's qvel")
        assert_close(ctrl, ctrl_in, f"{case}: the motor targets")
        assert_close(d.replace(qvel=d_in.qvel), d_in, f"{case}: the physics launch's state")
        return out.replace(ctrl=ctrl)

    for t in range(STEPS):
        action, draws = inputs(env, gen)
        monkeypatch.setattr(F, "step", recorded)
        want = env.step(state, action, draws)
        monkeypatch.setattr(F, "step", replayed)
        got = TK.step(env, state, action, draws, lib=lib)
        assert_close(got, want, f"{case}, step {t}")
        state = want
    if case == "nan_qvel":
        assert bool(want.done[1]) and bool(torch.isfinite(want.reward).all())
        assert not bool(torch.isfinite(want.obs["state"][1]).all())


def test_a_whole_step_through_the_plain_physics_is_the_eager_step(envs):
    """No push due: the physics state is the eager step's bit for bit, the
    rest within the ulps of the other cases."""
    env = envs("flat_terrain_backlash", {})
    lib = host_library(TK.kernel_dims(env))
    gen = torch.Generator().manual_seed(11)
    fused = eager = env.reset(env.reset_draws(gen, B))
    for t in range(STEPS):
        action, draws = inputs(env, gen)
        eager = env.step(eager, action, draws)
        fused = TK.step(env, fused, action, draws, lib=lib)
        for name, want in eager.data.fields():
            assert torch.equal(getattr(fused.data, name), want), (t, name)
        assert_close(fused, eager, f"step {t}")


def test_the_push_and_the_resample_happened(envs):
    """The edited cases do what they are for: where a push is due the base
    velocity moves, and a step counter past 500 takes the new command."""
    env = envs("flat_terrain_backlash", {})
    gen = torch.Generator().manual_seed(7)
    state = resample(env, push_due(env, env.reset(env.reset_draws(gen, B))))
    action, draws = inputs(env, gen)
    out = env.step(state, action, draws)
    due = torch.arange(B) % 2 == 0
    assert bool((out.info["push"][due] != 0).any(-1).all()) and bool((out.info["push"][~due] == 0).all())
    assert torch.equal(out.info["command"][due], draws.command[due])
    assert torch.equal(out.info["command"][~due], state.info["command"][~due])


def test_a_fused_step_counts_one_launch_and_once_per_replay_in_a_capture(envs):
    env = envs("flat_terrain_backlash", {})
    lib = host_library(TK.kernel_dims(env))
    gen = torch.Generator().manual_seed(3)
    state = env.reset(env.reset_draws(gen, B))
    before = (TK.launches, TK.eager_steps)
    TK.step(env, state, *inputs(env, gen), lib=lib)
    assert (TK.launches - before[0], TK.eager_steps - before[1]) == (1, 0)
    with MK.capture() as captured:
        TK.step(env, state, *inputs(env, gen), lib=lib)
    assert TK.launches - before[0] == 1
    captured.count_replay()
    captured.count_replay()
    assert (TK.launches - before[0], TK.eager_steps - before[1]) == (3, 0)
    with MK.capture() as captured:
        TK.count_eager_step()
    captured.count_replay()
    assert (TK.launches - before[0], TK.eager_steps - before[1]) == (3, 1)


def test_cpu_tensors_take_the_eager_body_and_count_nothing(envs):
    env = envs("flat_terrain_backlash", {})
    gen = torch.Generator().manual_seed(3)
    state = env.reset(env.reset_draws(gen, B))
    before = (TK.launches, TK.eager_steps)
    env.step(state, *inputs(env, gen))
    assert (TK.launches, TK.eager_steps) == before


def test_the_record_layout_and_the_observation_widths(envs):
    """The harness's TkRecord is the wrapper's size (`TaskLibrary` checks),
    and the kernels' observation widths are the eager step's."""
    for task, overrides in (("flat_terrain_backlash", {}), ("flat_terrain_no_head", RECIPE),
                            ("flat_terrain_backlash", {"use_imitation": False})):
        env = envs(task, overrides)
        lib = host_library(TK.kernel_dims(env))
        gen = torch.Generator().manual_seed(0)
        obs = env.reset(env.reset_draws(gen, 2)).obs
        assert lib.obs_sizes == (obs["state"].shape[1], obs["privileged_state"].shape[1])
