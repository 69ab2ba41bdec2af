"""The heightfield recipe (`joystick_rough_backlash`: `Joystick`
on `rough_terrain_backlash` with `rsi_prob=0.5` and the recipe's three
tracking terms, `benchmark/configs/joystick_rough_backlash.json`) through
the evaluator's CUDA graph on the card; each test skips without one. This
file imports no JAX package module:

    python -m pytest tests/test_torch_gpu_rough.py -q

- One whole eval (128 envs x 1000 control steps from a reset with
  reference-state init, under a policy of random weights) of the graphed
  `EvalEnv.step` against its eager body `EvalEnv.eager_step` (the wrapper
  in PyTorch operations, not its two kernels), bit for bit at
  every step;
- `ppo.run_eval` on it, twice: one graph captured for both evals, one
  launch of the kernel's heightfield build counted per control step, the
  span `env.graph` once per replay;
- a replayed step makes no host synchronization.
"""

import json
import pathlib

import pytest
import torch

from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.wrappers import EvalEnv
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.train import config as pconfig, ppo
from open_duck_playground_torch.utils import tracing

from test_torch_gpu_graph import assert_same

pytestmark = pytest.mark.gpu

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "joystick_rough_backlash.json"
N, LENGTH = 128, 1000


@pytest.fixture(scope="module")
def rough():
    """(eval env, policy variables, device) of the recipe at the eval's
    shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph and the CUDA kernel have no CPU mode")
    dev = torch.device("cuda")
    config = json.loads(CONFIG.read_text())
    env = EvalEnv(Joystick(config["task"], config_overrides=config["env_overrides"], device=dev), LENGTH)
    assert env.env.uses_rsi and env.env.model.spec.floor_is_hfield
    gen = torch.Generator(device=dev).manual_seed(11)
    probe = env.reset(env.env.reset_draws(gen, 1))
    ts = ppo.init_training_state(probe.obs, env.action_size, pconfig.PPOConfig(), gen, device=dev)
    return env, (ts.normalizer, ts.net), dev


def test_a_whole_eval_replays_the_eager_step_bit_for_bit(rough):
    env, variables, dev = rough
    gen = torch.Generator(device=dev).manual_seed(3)
    policy = ppo.make_policy(variables)
    with torch.no_grad():
        draws = env.env.reset_draws(gen, N)
        graphed = eager = env.reset(draws)
        assert (draws.rsi_gate < 0.5).any() and (graphed.info["imitation_i"] != 0).any()
        falls = 0
        for t in range(LENGTH):
            noise, step_draws = ppo.eval_draws(env, N, False, gen)
            action, _ = policy(graphed.obs, noise)
            graphed = env.step(graphed, action, step_draws)
            eager = env.eager_step(eager, action, step_draws)
            assert_same(graphed, eager, f"step {t}")
            falls += int(graphed.done.sum())
    assert falls > 0  # autoresets to the reset's state crossed the replays


def test_run_eval_captures_once_and_counts_one_hfield_launch_per_step(rough):
    env, variables, dev = rough
    env = EvalEnv(env.env, LENGTH)
    gen = torch.Generator(device=dev).manual_seed(4)
    before = (MK.launches, MK.launches_hfield)
    tracing.reset()
    for _ in range(2):
        out = ppo.run_eval(env, variables, N, LENGTH, False, gen)
    assert len(env._graphs) == 1
    assert (MK.launches - before[0], MK.launches_hfield - before[1]) == (2 * LENGTH, 2 * LENGTH)
    calls = {name: s["calls"] for name, s in tracing.snapshot().items()}
    assert calls["env.wrapper"] == 2 * LENGTH and calls["env.graph"] == 2 * LENGTH - 1
    assert calls["env.task"] == 2 and calls["env.physics"] == 2  # the warm-up and the capture
    assert out["eval/avg_episode_length"] > 0


def test_a_replayed_step_makes_no_host_synchronization(rough):
    env, variables, dev = rough
    gen = torch.Generator(device=dev).manual_seed(5)
    policy = ppo.make_policy(variables)
    with torch.no_grad():
        state = env.reset(env.env.reset_draws(gen, N))
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
