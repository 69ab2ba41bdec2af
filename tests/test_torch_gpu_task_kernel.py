"""The task's two CUDA kernels (`envs/task_kernel.py`, `csrc/task_step.cu`)
on the card, in the joystick and standing builds; each test skips without
one. This file
imports no JAX package module:

    python -m pytest tests/test_torch_gpu_task_kernel.py -q

- The fused step against the eager body (the same env with its class flag
  `task_kernel` turned off on the instance), each on its own trajectory,
  over 50 control steps of random actions, with pushes due at the first:
  at 128 and 8192 envs, on the nominal and a domain-randomized model, and
  at 128 envs on the heightfield and no-head recipes; `Standing` at 128
  envs randomized and 8192 nominal. The physics state
  and every integer and bool leaf are bit for bit the eager step's (the
  launch before the physics rounds as PyTorch's kernels do, so the
  physics launch gets the same inputs); the observations, rewards and
  metrics within 4 ulps of each column's largest magnitude (sums over a
  row and the vector norms take another order than PyTorch's
  reductions);
- the eval's CUDA graph of `EvalEnv.step` replays its own eager body bit
  for bit, and `task_kernel.launches` rises once per replay;
- a fused step makes no host synchronization;
- `Standing` takes the fused path, its own build: it counts a fused step
  of that build and no eager one, and its step equals the CPU's eager body
  from the same state with the card's physics launch replayed, with the
  head_pos gate open on half the envs, gated and ungated;
- an env's record is refused inside a capture.
"""

import pytest
import torch

from open_duck_playground_torch.envs import step_graph as SG
from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv
from open_duck_playground_torch.physics import forward as F
from task_kernel_check import RECIPE, assert_close, eager, leaves, unequal_bits

pytestmark = pytest.mark.gpu

STEPS = 50


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the task kernels have no CPU mode")
    return torch.device("cuda")


def assert_same(got, want, where):
    unequal = unequal_bits(got, want)
    assert not unequal, f"{where}: leaves {unequal} differ"


def push_due(state, n):
    info = dict(state.info)
    due = torch.arange(n, device=info["push_step"].device) % 2 == 0
    info["push_step"] = torch.where(due, info["push_interval_steps"] - 1, info["push_step"])
    return state.replace(info=info)


CASES = [(Joystick, "flat_terrain_backlash", {}, 128, False), (Joystick, "flat_terrain_backlash", {}, 128, True),
         (Joystick, "flat_terrain_backlash", {}, 8192, False), (Joystick, "flat_terrain_backlash", {}, 8192, True),
         (Joystick, "rough_terrain_backlash", RECIPE, 128, False), (Joystick, "flat_terrain_no_head", RECIPE, 128, False),
         (Standing, "flat_terrain", {}, 128, True), (Standing, "flat_terrain", {}, 8192, False)]
IDS = ["flat-128-nominal", "flat-128-randomized", "flat-8192-nominal", "flat-8192-randomized",
       "rough-128-nominal", "no_head-128-nominal", "standing-128-randomized", "standing-8192-nominal"]


@pytest.mark.parametrize("cls, task, overrides, n, randomized", CASES, ids=IDS)
def test_the_fused_step_is_the_eager_step_over_50_steps(cuda, cls, task, overrides, n, randomized):
    env = cls(task, device=cuda, config_overrides=overrides)
    gen = torch.Generator(device=cuda).manual_seed(5)
    model = domain_randomize(env.model, DRDraws.sample(gen, n, env.model.spec)) if randomized else env.model
    fused = slow = push_due(env.reset(env.reset_draws(gen, n), model=model), n)
    before = (TK.launches, TK.eager_steps)
    with torch.no_grad():
        for t in range(STEPS):
            action = 3.0 * torch.rand((n, env.action_size), generator=gen, device=cuda) - 1.5
            draws = env.step_draws(gen, n)
            fused = env.step(fused, action, draws, model=model)
            with eager(env):
                slow = env.step(slow, action, draws, model=model)
            assert_same(fused.data, slow.data, f"{task}, step {t}: the physics state")
            assert_close(fused, slow, f"{task}, step {t}")
    torch.cuda.synchronize()
    assert (TK.launches - before[0], TK.eager_steps - before[1]) == (STEPS, STEPS)


def test_the_eval_graph_replays_its_eager_body_and_counts_once_per_replay(cuda):
    env = EvalEnv(Joystick("flat_terrain_backlash", device=cuda), 30)
    gen = torch.Generator(device=cuda).manual_seed(9)
    n = 128
    graphed = slow = env.reset(env.env.reset_draws(gen, n))
    before = (TK.launches, TK.eager_steps)
    with torch.no_grad():
        for t in range(20):  # warm-up, capture and its replay, 18 replays
            action = 3.0 * torch.rand((n, env.action_size), generator=gen, device=cuda) - 1.5
            draws = env.step_draws(gen, n)
            graphed = env.step(graphed, action, draws)
            slow = env.eager_step(slow, action, draws)
            assert_same(graphed, slow, f"step {t}")
    torch.cuda.synchronize()
    assert len(env._graphs) == 1
    assert (TK.launches - before[0], TK.eager_steps - before[1]) == (40, 0)


def test_a_fused_step_makes_no_host_synchronization(cuda):
    env = Joystick("flat_terrain_backlash", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    state = env.reset(env.reset_draws(gen, 128))
    action = torch.zeros((128, env.action_size), device=cuda)
    with torch.no_grad():
        state = env.step(state, action, env.step_draws(gen, 128))  # builds, the record
        draws = env.step_draws(gen, 128)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = env.step(state, action, draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(state.reward).all())


@pytest.mark.parametrize("overrides", [{}, {"head_pos_ungated": True, "head_direct_targets": True}],
                         ids=["gated", "ungated-head_direct_targets"])
def test_standing_takes_the_fused_path(cuda, monkeypatch, overrides):
    env = Standing("flat_terrain", device=cuda, config_overrides=overrides)
    host = Standing("flat_terrain", device="cpu", config_overrides=overrides)
    gen = torch.Generator(device=cuda).manual_seed(4)
    n = 64
    state = env.reset(env.reset_draws(gen, n))
    cmd = state.info["command"].clone()  # the head_pos gate open on the even envs
    cmd[0::2, :3] = 0.4 * torch.rand((n // 2, 3), generator=gen, device=cuda) - 0.2
    state = state.replace(info={**state.info, "command": cmd})
    action = 3.0 * torch.rand((n, env.action_size), generator=gen, device=cuda) - 1.5
    draws = env.step_draws(gen, n)
    physics, real = [], F.step

    def recorded(m, d, ctrl, k):
        out = real(m, d, ctrl, k)
        physics.append(out)
        return out

    monkeypatch.setattr(F, "step", recorded)
    key = TK.build_key(env)
    assert dict(key[0])["STANDING"] == 1
    before = (TK.launches, TK.eager_steps, TK.build_launches.get(key, 0))
    with torch.no_grad():
        out = env.step(state, action, draws)
    torch.cuda.synchronize()
    assert (TK.launches - before[0], TK.eager_steps - before[1], TK.build_launches[key] - before[2]) == (1, 0, 1)
    assert bool((out.metrics["cost/head_pos"][0::2] != 0).all())

    cpu = lambda tree: SG.unflatten(leaves(tree)[0], iter([t.cpu() for t in leaves(tree)[1]]))
    monkeypatch.setattr(F, "step", lambda m, d, ctrl, k: cpu(physics[0]).replace(ctrl=ctrl))
    want = host.step(cpu(state), action.cpu(), cpu(draws))
    assert_close(cpu(out), want, "Standing on the card against its eager body on the CPU")


def test_a_record_is_refused_inside_a_capture(cuda):
    env = Joystick("flat_terrain_backlash", device=cuda)
    TK.library(TK.kernel_dims(env))  # built and loaded outside the capture
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="first eager step"):
        with torch.cuda.graph(graph):
            TK.record(env, cuda)
