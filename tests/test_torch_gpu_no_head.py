"""The final no-head recipe (`joystick_no_head_final`: `Joystick` on
`flat_terrain_no_head`, the legs-only robot, with `rsi_prob=0.5` and the
recipe's three tracking terms, `benchmark/configs/joystick_no_head_final.json`)
through the evaluator's two CUDA graphs on the card; each test skips without
one. This file imports no JAX package module:

    python -m pytest tests/test_torch_gpu_no_head.py -q

- One whole eval (128 envs x 1000 control steps from a reset with
  reference-state init, under a policy of random weights) of the graphed
  `EvalEnv.step` (the wrapper's and the task's kernels, the physics launch)
  against its eager body `EvalEnv.eager_step` (the wrapper in PyTorch
  operations), bit for bit at every step, with falls and autoresets;
- a whole `ppo.run_eval` through both graphs against the eager loop, bit
  for bit (`test_torch_gpu_act_graph.py`'s comparison on this recipe);
- the fused task step of the NU=10 build against the task's eager body
  over a whole eval of random actions from the recipe's reset: the physics
  state and the done flags bit for bit, observations and rewards within
  the task kernels' 4 ulps;
- `ppo.run_eval`, twice: one graph captured for both evals, and per control
  step one launch of the kernel's build 1n (`megakernel.build_launches()`),
  one fused step of the task's NU=10 build and one of the wrapper's kernels,
  no eager body;
- a replayed step makes no host synchronization.
"""

import json
import pathlib

import pytest
import torch

from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs import wrapper_kernel as WK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.wrappers import EvalEnv
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.train import config as pconfig, ppo
from open_duck_playground_torch.utils import tracing

from task_kernel_check import assert_close, eager
from test_torch_gpu_act_graph import assert_eval_equal, eager_eval, recorded
from test_torch_gpu_graph import assert_same

pytestmark = pytest.mark.gpu

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "joystick_no_head_final.json"
N, LENGTH = 128, 1000


@pytest.fixture(scope="module")
def no_head():
    """(eval env, policy variables, device) of the recipe at the eval's
    shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph and the CUDA kernel have no CPU mode")
    dev = torch.device("cuda")
    config = json.loads(CONFIG.read_text())
    env = EvalEnv(Joystick(config["task"], config_overrides=config["env_overrides"], device=dev), LENGTH)
    assert env.env.uses_rsi and not env.env.has_head and env.action_size == 10
    gen = torch.Generator(device=dev).manual_seed(11)
    probe = env.reset(env.env.reset_draws(gen, 1))
    ts = ppo.init_training_state(probe.obs, env.action_size, pconfig.PPOConfig(), gen, device=dev)
    return env, (ts.normalizer, ts.net), dev


def rsi_reset(env, gen):
    draws = env.env.reset_draws(gen, N)
    state = env.reset(draws)
    assert (draws.rsi_gate < 0.5).any() and (state.info["imitation_i"] != 0).any()
    return state


def test_a_whole_eval_replays_the_eager_step_bit_for_bit(no_head):
    env, variables, dev = no_head
    gen = torch.Generator(device=dev).manual_seed(3)
    policy = ppo.make_policy(variables)
    with torch.no_grad():
        graphed = eager = rsi_reset(env, gen)
        falls = 0
        for t in range(LENGTH):
            noise, step_draws = ppo.eval_draws(env, N, False, gen)
            action, _ = policy(graphed.obs, noise)
            graphed = env.step(graphed, action, step_draws)
            eager = env.eager_step(eager, action, step_draws)
            assert_same(graphed, eager, f"step {t}")
            falls += int(graphed.done.sum())
    assert falls > 0  # autoresets to the reset's state crossed the replays


def test_run_eval_through_both_graphs_is_the_eager_loop_bit_for_bit(no_head):
    env, variables, dev = no_head
    eval_env = EvalEnv(env.env, LENGTH)
    steps = recorded(eval_env)
    gen = torch.Generator(device=dev).manual_seed(8)
    twin = torch.Generator(device=dev).manual_seed(8)
    got = ppo.run_eval(eval_env, variables, N, LENGTH, False, gen)
    assert len(eval_env.act_graphs) == 1 and len(eval_env._graphs) == 1
    want, want_steps = eager_eval(env.env, variables, N, LENGTH, False, twin)
    assert_eval_equal(got, want, steps, want_steps)
    assert torch.equal(gen.get_state(), twin.get_state())


def test_the_fused_recipe_step_is_the_eager_body_over_a_whole_eval(no_head):
    env, _, dev = no_head
    env = EvalEnv(env.env, LENGTH)
    gen = torch.Generator(device=dev).manual_seed(6)
    with torch.no_grad():
        fused = slow = rsi_reset(env, gen)
        falls = 0
        for t in range(LENGTH):
            action = 3.0 * torch.rand((N, env.action_size), generator=gen, device=dev) - 1.5
            draws = env.step_draws(gen, N)
            fused = env.step(fused, action, draws)
            with eager(env.env):
                slow = env.eager_step(slow, action, draws)
            assert_same(fused.data, slow.data, f"step {t}: the physics state")
            assert torch.equal(fused.done, slow.done), f"step {t}: done"
            assert_close({"obs": fused.obs, "reward": fused.reward}, {"obs": slow.obs, "reward": slow.reward},
                         f"step {t}")
            falls += int(fused.done.sum())
    assert falls > 0


def test_run_eval_launches_build_1n_and_the_nu10_task_build_once_per_step(no_head):
    env, variables, dev = no_head
    env = EvalEnv(env.env, LENGTH)
    gen = torch.Generator(device=dev).manual_seed(4)
    physics = tuple(sorted(MK.kernel_dims(env.env.model.spec).items()))
    task = TK.build_key(env.env)
    assert dict(physics)["NV"] == 16 and dict(task[0])["NU"] == 10
    before = (MK.launches, MK.build_launches().get(physics, 0), TK.build_launches.get(task, 0), TK.eager_steps,
              WK.launches, WK.eager_steps)
    tracing.reset()
    for _ in range(2):
        out = ppo.run_eval(env, variables, N, LENGTH, False, gen)
    assert len(env._graphs) == 1
    after = (MK.launches, MK.build_launches()[physics], TK.build_launches[task], TK.eager_steps, WK.launches,
             WK.eager_steps)
    assert tuple(a - b for a, b in zip(after, before)) == (2 * LENGTH, 2 * LENGTH, 2 * LENGTH, 0, 2 * LENGTH, 0)
    calls = {name: s["calls"] for name, s in tracing.snapshot().items()}
    assert calls["env.wrapper"] == 2 * LENGTH and calls["env.graph"] == 2 * LENGTH - 1
    assert calls["env.task"] == 2 and calls["env.physics"] == 2  # the warm-up and the capture
    assert out["eval/avg_episode_length"] > 0


def test_a_replayed_step_makes_no_host_synchronization(no_head):
    env, variables, dev = no_head
    gen = torch.Generator(device=dev).manual_seed(5)
    policy = ppo.make_policy(variables)
    with torch.no_grad():
        state = rsi_reset(env, gen)
        for _ in range(3):
            noise, step_draws = ppo.eval_draws(env, N, False, gen)
            state = env.step(state, policy(state.obs, noise)[0], step_draws)
        noise, step_draws = ppo.eval_draws(env, N, False, gen)
        action = policy(state.obs, noise)[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = env.step(state, action, step_draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(state.reward).all())
