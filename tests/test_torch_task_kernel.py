"""The joystick task's two CUDA kernels (`csrc/task_step.cuh`) against the
eager `Joystick.step`, on the CPU, in the joystick builds and in the
standing build (`Standing`'s six terms). This file imports no JAX package module:

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
eager step's while no push is due. The standing build is held so against
`Standing.step`'s eager body with and without direct head targets and the
head_pos gate, on commands that open the gate and commands that shut it.
The joystick builds keep the -D flags, the record and the observation
widths they had before the standing build was added; the term set is the
task class's (`reward_terms`), refused where the config's scales differ. The counters: a
fused step counts one launch (and one of its build), inside a capture once
per replay; CPU tensors take the eager body.
"""

import pytest
import torch

from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing
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

    def get(task, overrides, cls=Joystick):
        key = (cls, task, tuple(sorted(overrides.items())))
        if key not in made:
            made[key] = cls(task, device="cpu", config_overrides=overrides)
        return made[key]

    return get


def inputs(env, gen):
    action = 3.0 * torch.rand((B, env.action_size), generator=gen) - 1.5
    return action, env.step_draws(gen, B)


def fused_against_eager(env, state, gen, monkeypatch, where):
    """STEPS control steps from `state`, fused through the host build and
    eager, the eager step's physics launch replayed in the fused one; every
    fused step within the gates of `assert_close`. Returns the eager steps."""
    lib = host_library(TK.kernel_dims(env))
    physics, real = [], F.step

    def recorded(m, d, ctrl, n):
        out = real(m, d, ctrl, n)
        physics.append((d, ctrl, out))
        return out

    def replayed(m, d, ctrl, n):
        d_in, ctrl_in, out = physics[-1]
        assert_close(d.qvel, d_in.qvel, f"{where}: the physics launch's qvel")
        assert_close(ctrl, ctrl_in, f"{where}: the motor targets")
        assert_close(d.replace(qvel=d_in.qvel), d_in, f"{where}: the physics launch's state")
        return out.replace(ctrl=ctrl)

    steps = []
    for t in range(STEPS):
        action, draws = inputs(env, gen)
        monkeypatch.setattr(F, "step", recorded)
        want = env.step(state, action, draws)
        monkeypatch.setattr(F, "step", replayed)
        got = TK.step(env, state, action, draws, lib=lib)
        assert_close(got, want, f"{where}, step {t}")
        steps.append(want)
        state = want
    monkeypatch.setattr(F, "step", real)
    return steps


@pytest.mark.parametrize("case", list(CASES))
def test_the_kernels_compute_the_eager_step(case, envs, monkeypatch):
    task, overrides, edit = CASES[case]
    env = envs(task, overrides)
    gen = torch.Generator().manual_seed(7)
    state = env.reset(env.reset_draws(gen, B))
    if edit is not None:
        state = edit(env, state)
    want = fused_against_eager(env, state, gen, monkeypatch, case)[-1]
    if case == "nan_qvel":
        assert bool(want.done[1]) and bool(torch.isfinite(want.reward).all())
        assert not bool(torch.isfinite(want.obs["state"][1]).all())


def standing_commands(env, state, gen):
    """The head_pos gate open on the even envs (a locomotion command, which
    `Standing.sample_command` never draws) and shut on the odd ones, the
    head command zero on envs 1 and 2, a resample due on every fourth env
    and a push due on every other."""
    cmd = state.info["command"].clone()
    cmd[0::2, :3] = 0.4 * torch.rand((B // 2, 3), generator=gen) - 0.2
    cmd[1:3, 3:] = 0.0
    info = {**state.info, "command": cmd}
    info["step"] = torch.where(torch.arange(B) % 4 == 0, 500, 10).to(torch.int32)
    return push_due(env, state.replace(info=info))


@pytest.mark.parametrize("head_direct_targets", [False, True], ids=["servo_targets", "head_direct_targets"])
@pytest.mark.parametrize("head_pos_ungated", [False, True], ids=["gated", "ungated"])
def test_the_standing_build_computes_the_eager_standing_step(envs, monkeypatch, head_direct_targets,
                                                             head_pos_ungated):
    env = envs("flat_terrain", {"head_direct_targets": head_direct_targets,
                                "head_pos_ungated": head_pos_ungated}, Standing)
    dims = TK.kernel_dims(env)
    assert dims["STANDING"] == 1 and TK.terms(dims) == TK.STANDING_TERMS
    assert (dims["IMITATION"], dims["OBS_MOTOR"], dims["OBS_PHASE"]) == (0, 0, 0)
    gen = torch.Generator().manual_seed(13)
    state = standing_commands(env, env.reset(env.reset_draws(gen, B)), gen)
    first = fused_against_eager(env, state, gen, monkeypatch, "standing")[0]
    head = first.metrics["cost/head_pos"]
    opened = torch.arange(B) % 2 == 0
    assert bool((head[opened] != 0).all())
    if head_pos_ungated:
        assert bool((head[3::2] != 0).all())
    else:
        assert bool((head[~opened] == 0).all())
    assert bool((first.metrics["cost/stand_still"][opened] == 0).all())
    assert bool((first.metrics["cost/stand_still"][~opened] != 0).all())


def test_the_standing_build_on_the_no_head_robot(envs, monkeypatch):
    """Every actuator a leg, head_pos zero."""
    env = envs("flat_terrain_no_head", {}, Standing)
    gen = torch.Generator().manual_seed(17)
    state = standing_commands(env, env.reset(env.reset_draws(gen, B)), gen)
    for out in fused_against_eager(env, state, gen, monkeypatch, "standing, no head"):
        assert bool((out.metrics["cost/head_pos"] == 0).all())


# the -D flags of the joystick builds (but the include path) before the
# standing build was added, and the size of their record
JOYSTICK_FLAGS = {
    "flat_terrain_backlash": (["-DTK_AHIST=3", "-DTK_GDIM=40", "-DTK_GDT=10", "-DTK_GDX=6", "-DTK_GDY=4",
                               "-DTK_GPH=27", "-DTK_IHIST=3", "-DTK_IMITATION=1", "-DTK_KPTS=4", "-DTK_NFOOT=2",
                               "-DTK_NQ=31", "-DTK_NSENS=46", "-DTK_NSITE=5", "-DTK_NU=14", "-DTK_NV=30",
                               "-DTK_OBS_MOTOR=1", "-DTK_OBS_PHASE=1"], 632),
    "flat_terrain_no_head": (["-DTK_AHIST=3", "-DTK_GDIM=40", "-DTK_GDT=10", "-DTK_GDX=6", "-DTK_GDY=4",
                              "-DTK_GPH=27", "-DTK_IHIST=3", "-DTK_IMITATION=1", "-DTK_KPTS=4", "-DTK_NFOOT=2",
                              "-DTK_NQ=17", "-DTK_NSENS=46", "-DTK_NSITE=4", "-DTK_NU=10", "-DTK_NV=16",
                              "-DTK_OBS_MOTOR=1", "-DTK_OBS_PHASE=1"], 552),
}
JOYSTICK_FIELDS = [
    "gait", "gait_x", "gait_y", "gait_t", "default_act", "qpos_noise", "ref_offset", "reward_scale", "down", "dt",
    "action_scale", "motor_lim", "dof_vel_scale", "level", "sc_gyro", "sc_accel", "sc_gravity", "sc_jvel", "sigma",
    "act_qadr", "act_dadr", "backlash_qadr", "metric_row", "foot_vel", "feet_site", "imu_site", "fb_qadr", "fb_dadr",
    "s_gyro", "s_accel", "s_up", "s_linvel", "s_angvel", "row_swing", "row_lin", "row_ang", "row_head",
    "speed_limit", "head_direct", "push_enable"]


@pytest.mark.parametrize("task, overrides", [("flat_terrain_backlash", {}), ("rough_terrain_backlash", RECIPE),
                                             ("flat_terrain_no_head", RECIPE)],
                         ids=["flat", "rough", "no_head"])
def test_the_joystick_builds_are_unchanged_by_the_standing_build(envs, task, overrides):
    """Same -D flags (so the same library), the same record and the ten
    terms; the standing build differs in its flag, its terms and the
    record's gate flag."""
    import ctypes

    env = envs(task, overrides)
    dims = TK.kernel_dims(env)
    flags, size = JOYSTICK_FLAGS["flat_terrain_no_head" if env.action_size == 10 else "flat_terrain_backlash"]
    assert TK.build_flags(dims)[:-1] == flags
    assert ctypes.sizeof(TK.record_type(dims)) == size
    assert [name for name, _, _ in TK.record_fields(dims)] == JOYSTICK_FIELDS
    assert TK.terms(dims) == TK.JOYSTICK_TERMS
    standing = TK.kernel_dims(envs("flat_terrain", {}, Standing))
    assert "-DTK_STANDING=1" in TK.build_flags(standing)
    assert [name for name, _, _ in TK.record_fields(standing)] == JOYSTICK_FIELDS + ["head_ungated"]


@pytest.mark.parametrize("terms", ["standing_on_joystick", "unknown"])
def test_the_term_set_is_the_task_class_s_and_its_config_s(envs, monkeypatch, terms):
    """Each class declares its terms; a build is refused where they are not
    a set the kernels compute or not the config's reward scales."""
    joystick, standing = envs("flat_terrain_backlash", {}), envs("flat_terrain", {}, Standing)
    assert (Joystick.reward_terms, Standing.reward_terms) == (TK.JOYSTICK_TERMS, TK.STANDING_TERMS)
    assert set(standing.config.reward_config.scales) == set(TK.term_set(standing))
    monkeypatch.setattr(joystick, "reward_terms",
                        TK.STANDING_TERMS if terms == "standing_on_joystick" else ("alive",), raising=False)
    with pytest.raises(NotImplementedError):
        TK.kernel_dims(joystick)


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


def test_build_launches_counts_each_build_and_resets(envs):
    """One count per fused step under the key of its build: its dims and the
    rows of its metrics table, from which a reader recovers the term set."""
    TK.reset_counts()
    joystick, standing = envs("flat_terrain_backlash", {}), envs("flat_terrain", {}, Standing)
    gen = torch.Generator().manual_seed(5)
    for env, n in ((joystick, 2), (standing, 3)):
        lib = host_library(TK.kernel_dims(env))
        state = env.reset(env.reset_draws(gen, B))
        for _ in range(n):
            state = TK.step(env, state, *inputs(env, gen), lib=lib)
    with MK.capture() as captured:
        TK.step(standing, state, *inputs(standing, gen), lib=host_library(TK.kernel_dims(standing)))
    captured.count_replay()
    keys = {env: TK.build_key(env) for env in (joystick, standing)}
    assert TK.build_launches == {keys[joystick]: 2, keys[standing]: 4} and TK.launches == 6
    assert dict(keys[standing][0]) == TK.kernel_dims(standing) and keys[standing][1] == 10
    assert TK.terms(dict(keys[standing][0])) == TK.STANDING_TERMS
    TK.reset_counts()
    assert (TK.launches, TK.eager_steps, TK.build_launches) == (0, 0, {})


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
    for task, overrides, cls in (("flat_terrain_backlash", {}, Joystick), ("flat_terrain_no_head", RECIPE, Joystick),
                                 ("flat_terrain_backlash", {"use_imitation": False}, Joystick),
                                 ("flat_terrain", {}, Standing), ("flat_terrain_no_head", {}, Standing)):
        env = envs(task, overrides, cls)
        lib = host_library(TK.kernel_dims(env))
        gen = torch.Generator().manual_seed(0)
        obs = env.reset(env.reset_draws(gen, 2)).obs
        assert lib.obs_sizes == (obs["state"].shape[1], obs["privileged_state"].shape[1])
