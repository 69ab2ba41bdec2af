"""The CUDA graph of the evaluator's draws and policy (`ppo.eval_actor`,
replayed by `ppo.run_eval` in front of the env step's own graph) on the
card; each test skips without one. This file imports no JAX package
module:

    python -m pytest tests/test_torch_gpu_act_graph.py -q

- A whole `run_eval` (128 envs x 1000 control steps) through both graphs
  against the eager loop: the same eval numbers, every step's action and
  draws, and the generator's state afterwards, bit for bit. The eager
  loop is `run_eval` with the draws given, taken from a twin generator in
  `run_eval`'s order, on an eval env whose step is its eager body
  (`EvalEnv.eager_step`, the wrapper in PyTorch operations). `Joystick`
  on the plane, `Joystick` on the heightfield recipe with reference-state
  init, `Standing`, each stochastic and deterministic;
- two evals on one graph, with a new normalizer object, the parameters
  changed in place and the generator re-seeded between them, against the
  eager loop;
- an action and draws returned at one step do not change under later
  steps;
- a replayed control step (both graphs) makes no host synchronization;
- one capture per key: a second batch size captures a second graph, and
  the span `act.graph` closes once per replay while `policy` and
  `env.draws` close only in each key's warm-up and capture.
"""

import json
import pathlib

import pytest
import torch

from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv
from open_duck_playground_torch.train import config as pconfig, ppo
from open_duck_playground_torch.train import running_stats as RS
from open_duck_playground_torch.utils import tracing

from test_torch_gpu_graph import assert_same, leaves

pytestmark = pytest.mark.gpu

ROUGH = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "joystick_rough_backlash.json"
N, LENGTH = 128, 1000
TASKS = ["flat_terrain_backlash", "rough_terrain_backlash", "standing_flat_terrain"]


def make_env(task, dev):
    if task == "standing_flat_terrain":
        return Standing("flat_terrain", device=dev)
    if task == "rough_terrain_backlash":
        config = json.loads(ROUGH.read_text())
        env = Joystick(config["task"], config_overrides=config["env_overrides"], device=dev)
        assert env.uses_rsi and env.model.spec.floor_is_hfield
        return env
    return Joystick(task, device=dev)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph and the CUDA kernel have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=TASKS)
def task(request, cuda):
    """(task env, policy variables of random weights and a moved
    normalizer) at the eval's shape."""
    env = make_env(request.param, cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    probe = EvalEnv(env, LENGTH).reset(env.reset_draws(gen, 64))
    ts = ppo.init_training_state(probe.obs, env.action_size, pconfig.PPOConfig(), gen, device=cuda)
    normalizer = RS.update(ts.normalizer, probe.obs)  # a mean and std that are not 0 and 1
    return env, (normalizer, ts.net)


def recorded(eval_env):
    """Keeps each step's action and draws, by reference, as the
    benchmark's eval loop keeps them."""
    steps = []
    step = eval_env.step

    def keep(state, action, draws):
        steps.append((action, draws))
        return step(state, action, draws)

    eval_env.step = keep
    return steps


def eager_eval(env, variables, n, length, deterministic, twin):
    """`run_eval` with every draw given, drawn from `twin` in `run_eval`'s
    order, on an eval env whose step is its eager body: (eval numbers,
    each step's (action, draws))."""
    eval_env = EvalEnv(env, LENGTH)
    eval_env.step = eval_env.eager_step
    reset = env.reset_draws(twin, n)
    noise, step_draws = [], []
    for _ in range(length):
        z, d = ppo.eval_draws(eval_env, n, deterministic, twin)
        noise.append(z)
        step_draws.append(d)
    draws = ppo.EvalDraws(reset=reset, action_noise=None if deterministic else torch.stack(noise),
                          env=step_draws)
    steps = recorded(eval_env)
    return ppo.run_eval(eval_env, variables, n, length, deterministic, None, draws=draws), steps


def assert_eval_equal(got, want, steps, want_steps):
    assert got == want
    assert len(steps) == len(want_steps)
    for t, (a, b) in enumerate(zip(steps, want_steps)):
        assert_same(a, b, f"step {t}: action and draws")


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "deterministic"])
def test_run_eval_through_both_graphs_is_the_eager_loop_bit_for_bit(cuda, task, deterministic):
    env, variables = task
    eval_env = EvalEnv(env, LENGTH)
    steps = recorded(eval_env)
    gen = torch.Generator(device=cuda).manual_seed(3)
    twin = torch.Generator(device=cuda).manual_seed(3)
    tracing.reset()
    got = ppo.run_eval(eval_env, variables, N, LENGTH, deterministic, gen)
    calls = {name: s["calls"] for name, s in tracing.snapshot().items()}
    assert calls["act.graph"] == LENGTH - 1 and calls["policy"] == calls["env.draws"] == 2
    assert len(eval_env.act_graphs) == 1
    want, want_steps = eager_eval(env, variables, N, LENGTH, deterministic, twin)
    assert_eval_equal(got, want, steps, want_steps)
    assert torch.equal(gen.get_state(), twin.get_state())
    assert got["eval/avg_episode_length"] > 0


def test_two_evals_on_one_graph_follow_a_new_normalizer_new_parameters_and_a_new_seed(cuda):
    env = make_env("flat_terrain_backlash", cuda)
    gen = torch.Generator(device=cuda).manual_seed(21)
    twin = torch.Generator(device=cuda).manual_seed(21)
    probe = EvalEnv(env, LENGTH).reset(env.reset_draws(torch.Generator(device=cuda).manual_seed(1), 64))
    ts = ppo.init_training_state(probe.obs, env.action_size, pconfig.PPOConfig(),
                                 torch.Generator(device=cuda).manual_seed(2), device=cuda)
    eval_env = EvalEnv(env, LENGTH)
    steps = recorded(eval_env)
    length = 200
    for i in range(2):
        if i:  # as a training step and a restore leave them: parameters moved in place, a new normalizer
            with torch.no_grad():
                for p in ts.net.parameters():
                    p.add_(0.05 * torch.randn(p.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(7)))
            ts.normalizer = RS.update(ts.normalizer, probe.obs)
            gen.manual_seed(99)
            twin.manual_seed(99)
        steps.clear()
        variables = (ts.normalizer, ts.net)
        got = ppo.run_eval(eval_env, variables, N, length, False, gen)
        want, want_steps = eager_eval(env, variables, N, length, False, twin)
        assert_eval_equal(got, want, steps, want_steps)
        assert torch.equal(gen.get_state(), twin.get_state())
    assert len(eval_env.act_graphs) == 1


def test_a_returned_action_and_draws_do_not_change_under_later_steps(cuda):
    env = make_env("flat_terrain_backlash", cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    probe = EvalEnv(env, LENGTH).reset(env.reset_draws(gen, 8))
    ts = ppo.init_training_state(probe.obs, env.action_size, pconfig.PPOConfig(), gen, device=cuda)
    eval_env = EvalEnv(env, LENGTH)
    steps = recorded(eval_env)
    ppo.run_eval(eval_env, (ts.normalizer, ts.net), N, 5, False, gen)
    held = steps[2]  # the first step after the capture's
    kept = [t.clone() for t in leaves(held)[1]]
    ppo.run_eval(eval_env, (ts.normalizer, ts.net), N, 15, False, gen)
    now = leaves(held)[1]
    assert len(now) == 10 and all(torch.equal(a, b) for a, b in zip(now, kept))
    assert not torch.equal(held[0], steps[-1][0])


def test_a_replayed_control_step_makes_no_host_synchronization(cuda):
    env = make_env("flat_terrain_backlash", cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    eval_env = EvalEnv(env, LENGTH)
    probe = eval_env.reset(env.reset_draws(gen, 8))
    ts = ppo.init_training_state(probe.obs, env.action_size, pconfig.PPOConfig(), gen, device=cuda)
    act = ppo.eval_actor(eval_env, ts.net, N, False, gen)
    with torch.no_grad():
        state = eval_env.reset(env.reset_draws(gen, N))
        for _ in range(3):  # warm-up, capture, replay
            state = eval_env.step(state, *act(state.obs, ts.normalizer))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = eval_env.step(state, *act(state.obs, ts.normalizer))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert len(eval_env.act_graphs) == 1 and bool(torch.isfinite(state.reward).all())


def test_a_second_batch_size_captures_a_second_graph(cuda):
    env = make_env("flat_terrain_backlash", cuda)
    gen = torch.Generator(device="cuda").manual_seed(8)  # a generator made for "cuda", no index given
    probe = EvalEnv(env, LENGTH).reset(env.reset_draws(gen, 8))
    ts = ppo.init_training_state(probe.obs, env.action_size, pconfig.PPOConfig(), gen, device=cuda)
    eval_env = EvalEnv(env, LENGTH)
    variables = (ts.normalizer, ts.net)
    tracing.reset()
    ppo.run_eval(eval_env, variables, N, 10, False, gen)
    assert len(eval_env.act_graphs) == 1
    ppo.run_eval(eval_env, variables, 64, 10, False, gen)
    assert len(eval_env.act_graphs) == 2
    ppo.run_eval(eval_env, variables, N, 10, False, gen)
    assert len(eval_env.act_graphs) == 2 and len(eval_env._graphs) == 2
    # both graphs warm up and capture on one side stream: one cuBLAS workspace
    assert eval_env.act_graphs.streams is eval_env._graphs.streams and len(eval_env.act_graphs.streams) == 1
    calls = {name: s["calls"] for name, s in tracing.snapshot().items()}
    assert calls["act.graph"] == 9 + 9 + 10  # each key's first step is its warm-up
    assert calls["policy"] == calls["env.draws"] == 4
