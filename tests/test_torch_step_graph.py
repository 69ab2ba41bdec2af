"""The env step's index tables and the dispatch of `EvalEnv.step`, on the
CPU (the CUDA graph itself: `tests/test_torch_gpu_graph.py`, on the card):

- the env's index tables are long tensors, made once on its device, and
  every read through them gives, bit for bit, what indexing with the
  Python lists gives: the three `duck_base` getters (an empty backlash slot
  table on the robots without backlash joints included), the feet height,
  the foot linear velocity and the gravity observation, and whole
  `Joystick.step`s, on the joystick backlash task, on standing and on the
  no-head robot;
- the standing task's `stand_still` takes the 10 leg slots by slices, as
  indexing with their list did, bit for bit;
- `EvalEnv.step` on CPU tensors runs its body eagerly: no graph is kept
  and the span `env.graph` never opens;
- `ppo.run_eval` on the CPU runs its draws and policy eagerly (no graph of
  `ppo.eval_actor`, the span `act.graph` never opens) and draws in its
  order: the eval numbers and the generator's state are those of the
  eager loop with every draw taken from a twin generator in that order
  (reset, then per step the action noise and the step draws);
- the trees `StepGraphs` keys on flatten and rebuild exactly, and their
  spec changes with a leaf's shape or dtype.
"""

import copy

import pytest
import torch

from open_duck_playground_torch.envs import duck_base
from open_duck_playground_torch.envs import rewards as R
from open_duck_playground_torch.envs import step_graph as SG
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv
from open_duck_playground_torch.models import loader
from open_duck_playground_torch.train import ppo, running_stats as RS
from open_duck_playground_torch.train.config import PPOConfig
from open_duck_playground_torch.utils import tracing

torch.set_num_threads(1)

CPU = torch.device("cpu")
B = 4
TASKS = [(Joystick, "flat_terrain_backlash"), (Standing, "flat_terrain"), (Joystick, "flat_terrain_no_head")]
TABLES = ("_actuator_qposadr", "_actuator_dofadr", "_backlash_qposadr", "_backlash_actuator_slot",
          "_feet_site_id", "_foot_linvel_sensor_adr")


def list_tables(env, task):
    """The index tables as Python lists, built from the model's spec and
    names as the env built them before they were tensors."""
    s, names = env.model.spec, loader.load_names(duck_base.task_to_scene(task))
    return {
        "_actuator_qposadr": [s.jnt_qposadr[j] for j in env.actuator_joint_ids],
        "_actuator_dofadr": [s.jnt_dofadr[j] for j in env.actuator_joint_ids],
        "_backlash_qposadr": [s.jnt_qposadr[j] for j in env.backlash_joint_ids],
        "_backlash_actuator_slot": [env.actuator_names.index(n.removesuffix("_backlash"))
                                    for n in env.backlash_joint_names],
        "_feet_site_id": [names["site"].index(n) for n in duck_base.FEET_SITES],
        "_foot_linvel_sensor_adr": [i for site in duck_base.FEET_SITES
                                    for i in range(*env._sensor_slices[f"{site}_global_linvel"])],
    }


def listed(env):
    """The env with the list tables in place of its tensors, and the
    world's down made as a fresh tensor, as `_get_obs` made it."""
    twin = copy.copy(env)
    for name, values in env.list_tables.items():
        setattr(twin, name, values)
    twin._down = torch.tensor([0.0, 0.0, -1.0], dtype=env.model.dtype)
    return twin


@pytest.fixture(scope="module", params=TASKS, ids=[task for _, task in TASKS])
def stepped(request):
    """(env, a state two control steps into episodes under random actions,
    an action, step draws)."""
    cls, task = request.param
    env = cls(task, device=CPU)
    env.list_tables = list_tables(env, task)
    gen = torch.Generator().manual_seed(11)
    state = env.reset(env.reset_draws(gen, B))
    for _ in range(2):
        action = 2 * torch.rand((B, env.action_size), generator=gen) - 1
        state = env.step(state, action, env.step_draws(gen, B))
    action = 2 * torch.rand((B, env.action_size), generator=gen) - 1
    return env, state, action, env.step_draws(gen, B)


def test_the_index_tables_are_long_tensors_on_the_env_device(stepped):
    env = stepped[0]
    for name in TABLES:
        table = getattr(env, name)
        assert isinstance(table, torch.Tensor) and table.dtype == torch.long and table.device == CPU, name
        assert table.tolist() == env.list_tables[name], name
    has_backlash = env.backlash_joint_names != []
    assert (env._backlash_actuator_slot.numel() > 0) == has_backlash
    assert env._backlash_qposadr.numel() == env._backlash_actuator_slot.numel()
    assert env._down.dtype == env.model.dtype and env._down.tolist() == [0.0, 0.0, -1.0]


def test_the_getters_equal_list_indexing(stepped):
    env, state, _, _ = stepped
    twin = listed(env)
    qpos, qvel = state.data.qpos, state.data.qvel
    assert torch.equal(env.get_actuator_joints_qpos(qpos), qpos[:, twin._actuator_qposadr])
    assert torch.equal(env.get_actuator_joints_qvel(qvel), qvel[:, twin._actuator_dofadr])
    angles = qpos[:, twin._actuator_qposadr]
    angles[:, twin._backlash_actuator_slot] += qpos[:, twin._backlash_qposadr]
    assert torch.equal(env.get_actuator_angles_with_backlash(qpos), angles)
    for getter in ("get_actuator_joints_qpos", "get_actuator_joints_qvel", "get_actuator_angles_with_backlash"):
        x = qvel if getter == "get_actuator_joints_qvel" else qpos
        assert torch.equal(getattr(env, getter)(x), getattr(twin, getter)(x)), getter


def test_the_feet_height_foot_velocity_and_gravity_equal_list_indexing(stepped):
    env, state, _, _ = stepped
    twin = listed(env)
    d = state.data
    assert torch.equal(d.site_xpos[:, env._feet_site_id, -1], d.site_xpos[:, twin._feet_site_id, -1])
    assert torch.equal(d.sensordata[:, env._foot_linvel_sensor_adr], d.sensordata[:, twin._foot_linvel_sensor_adr])
    xmat = d.site_xmat[:, env._site_id].transpose(-1, -2)
    assert torch.equal(torch.matmul(xmat, env._down), torch.matmul(xmat, torch.tensor([0.0, 0.0, -1.0])))


def test_a_whole_step_equals_the_step_with_list_indexing(stepped):
    env, state, action, draws = stepped
    got = env.step(state, action, draws)
    want = listed(env).step(state, action, draws)
    got_leaves, want_leaves = [], []
    assert SG.flatten(got, got_leaves) == SG.flatten(want, want_leaves)
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, want_leaves))


def test_stand_still_takes_the_legs_by_slices_as_list_indexing_does():
    gen = torch.Generator().manual_seed(4)
    q, v, pose = torch.randn((8, 14), generator=gen), torch.randn((8, 14), generator=gen), torch.randn(14, generator=gen)
    legs = [0, 1, 2, 3, 4, 9, 10, 11, 12, 13]
    for x in (q, v, pose):
        assert torch.equal(R._legs(x), x[..., legs])
    cmd = torch.zeros((8, 7))
    want = (torch.sum(torch.abs(q[:, legs] - pose[legs]), -1) + torch.sum(torch.abs(v[:, legs]), -1)) * 1.0
    assert torch.equal(R.stand_still(cmd, q, v, pose, ignore_head=True), want)


def test_eval_step_on_the_cpu_runs_eagerly_and_never_opens_env_graph():
    env = Joystick("flat_terrain_backlash", device=CPU)
    eval_env = EvalEnv(env, episode_length=1000)
    gen = torch.Generator().manual_seed(2)
    state = eval_env.reset(env.reset_draws(gen, 2))
    tracing.reset()
    with torch.no_grad():  # as `ppo.run_eval` steps: on the card the graph's warm-up, capture, replay
        for _ in range(3):
            state = eval_env.step(state, torch.zeros((2, env.action_size)), eval_env.step_draws(gen, 2))
    spans = tracing.snapshot()
    assert "env.graph" not in spans and spans["env.wrapper"]["calls"] == 3 and spans["env.task"]["calls"] == 3
    assert len(eval_env._graphs) == 0


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "deterministic"])
def test_run_eval_on_the_cpu_acts_eagerly_and_draws_in_its_order(deterministic):
    env = Joystick("flat_terrain_backlash", device=CPU)
    gen = torch.Generator().manual_seed(6)
    probe = EvalEnv(env, episode_length=1000).reset(env.reset_draws(gen, 2))
    ts = ppo.init_training_state(probe.obs, env.action_size, PPOConfig(), gen, device=CPU)
    variables = (RS.update(ts.normalizer, probe.obs), ts.net)
    eval_env = EvalEnv(env, episode_length=1000)
    gen.manual_seed(7)
    tracing.reset()
    got = ppo.run_eval(eval_env, variables, 3, 4, deterministic, gen)
    spans = tracing.snapshot()
    assert "act.graph" not in spans and spans["policy"]["calls"] == spans["env.draws"]["calls"] == 4
    assert len(eval_env.act_graphs) == 0
    # the eager loop, its draws from a twin generator in run_eval's order
    twin = torch.Generator().manual_seed(7)
    reset = env.reset_draws(twin, 3)
    steps = [ppo.eval_draws(eval_env, 3, deterministic, twin) for _ in range(4)]
    noise = None if deterministic else torch.stack([z for z, _ in steps])
    draws = ppo.EvalDraws(reset=reset, action_noise=noise, env=[d for _, d in steps])
    assert got == ppo.run_eval(EvalEnv(env, episode_length=1000), variables, 3, 4, deterministic, None, draws)
    assert torch.equal(gen.get_state(), twin.get_state())


def test_step_graphs_run_the_body_eagerly_off_the_card():
    graphs = SG.StepGraphs()
    calls = []

    def body(x, extra):
        calls.append(extra)
        return {"y": x + 1}

    x = torch.zeros(3)
    with torch.no_grad():
        assert torch.equal(graphs(body, (x, x), object())["y"], x + 1)  # CPU tensors
        assert torch.equal(graphs(body, (x, 1.5), object())["y"], x + 1)  # a leaf that is not a tensor
    assert torch.equal(graphs(body, (x, x), object())["y"], x + 1)  # grad enabled
    assert len(calls) == 3 and len(graphs) == 0


def test_a_tree_flattens_and_rebuilds_exactly():
    env = Joystick("flat_terrain_backlash", device=CPU)
    eval_env = EvalEnv(env, episode_length=1000)
    gen = torch.Generator().manual_seed(3)
    state = eval_env.reset(env.reset_draws(gen, 2))
    args = (state, torch.zeros((2, env.action_size)), eval_env.step_draws(gen, 2), [torch.ones(3)])
    leaves = []
    spec = SG.flatten(args, leaves)
    assert {t.get_device() for t in leaves} == {-1} and hash(spec) == hash(SG.flatten(args, []))
    rebuilt = SG.unflatten(spec, iter(leaves))
    again = []
    assert SG.flatten(rebuilt, again) == spec and all(a is b for a, b in zip(leaves, again))
    assert type(rebuilt[0]) is type(state) and type(rebuilt[0].data) is type(state.data)
    assert type(rebuilt[3]) is list and list(rebuilt[0].info) == list(state.info)
    shorter = (state.replace(reward=state.reward[:1]),) + args[1:]
    recast = (state.replace(reward=state.reward.double()),) + args[1:]
    assert SG.flatten(shorter, []) != spec and SG.flatten(recast, []) != spec
