"""The CUDA graph of the evaluator's env step (`EvalEnv.step` under no
grad, `envs/step_graph.py`) on the card; each test skips without one.
This file imports no JAX package module:

    python -m pytest tests/test_torch_gpu_graph.py -q

- The graph against the eager body (`EvalEnv.eager_step`: the wrapper in
  PyTorch operations, not its two kernels), bit for bit, over
  200 control steps at 128 envs on `flat_terrain_backlash`, standing
  `flat_terrain` and the heightfield task `rough_terrain_backlash`, with an
  episode length of 30 so that truncations, dones and autoresets cross the
  replays, under random actions;
- a state returned at step t is unchanged after steps t+1 ... t+10;
- each replay, like each eager step, is a fused step of the task's own
  build of the task kernels (`task_kernel.build_launches`: the standing
  build for `Standing`), and no step runs the task's eager body;
- `megakernel.launches` (and the built kernel's own count, and
  `launches_hfield` on the heightfield) rise by 1 per replay; the span
  `env.graph` closes once per replay and `env.task` and `env.physics` only
  in the warm-up and the capture;
- a replayed step makes no host synchronization;
- a second batch size captures a second graph, and the first one still
  replays;
- two models of one kernel build, one launched eagerly between the other's
  capture and its replay, each step their own model (a launch carries its
  model's record by pointer), and no record is made inside a capture.
"""

import pytest
import torch

from open_duck_playground_torch.envs import step_graph as SG
from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.utils import tracing

pytestmark = pytest.mark.gpu

N = 128
TASKS = [(Joystick, "flat_terrain_backlash"), (Standing, "flat_terrain"), (Joystick, "rough_terrain_backlash")]
IDS = [task for _, task in TASKS]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph and the CUDA kernel have no CPU mode")
    return torch.device("cuda")


def leaves(tree):
    out = []
    spec = SG.flatten(tree, out)
    return spec, out


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want, where):
    (gspec, g), (wspec, w) = leaves(got), leaves(want)
    assert gspec == wspec, where
    unequal = [i for i, (a, b) in enumerate(zip(g, w)) if not torch.equal(bits(a), bits(b))]
    assert not unequal, f"{where}: leaves {unequal} differ"


class Episodes:
    """An `EvalEnv` of `task` and its inputs: a reset of `n` envs and, per
    control step, a random action in [-1.5, 1.5) and the step draws."""

    def __init__(self, cls, task, dev, n=N, episode_length=30, seed=5):
        self.env = EvalEnv(cls(task, device=dev), episode_length)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.n, self.dev = n, dev

    def reset(self):
        return self.env.reset(self.env.env.reset_draws(self.gen, self.n))

    def inputs(self):
        action = 3.0 * torch.rand((self.n, self.env.action_size), generator=self.gen, device=self.dev) - 1.5
        return action, self.env.step_draws(self.gen, self.n)


@pytest.mark.parametrize("cls, task", TASKS, ids=IDS)
def test_the_graph_replays_the_eager_step_bit_for_bit(cuda, cls, task):
    ep = Episodes(cls, task, cuda)
    graphed = eager = ep.reset()
    dones = truncations = 0
    task_env = ep.env.env
    build = TK.build_key(task_env)
    before = (TK.build_launches.get(build, 0), TK.eager_steps)
    with torch.no_grad():
        for t in range(200):
            action, draws = ep.inputs()
            graphed = ep.env.step(graphed, action, draws)
            eager = ep.env.eager_step(eager, action, draws)
            assert_same(graphed, eager, f"{task}, step {t}")
            dones += int(graphed.done.sum())
            truncations += int(graphed.info["truncation"].sum())
    torch.cuda.synchronize()
    assert len(ep.env._graphs) == 1
    assert truncations > 0 and dones > truncations  # episodes cut at their length, and falls
    # one fused step of the task's build per control step each way: the
    # graph's warm-up, its capture's replay and 198 replays; 200 eager bodies
    assert (TK.build_launches[build] - before[0], TK.eager_steps - before[1]) == (400, 0)
    assert ("STANDING", 1) in build[0] if cls is Standing else dict(build[0]).get("STANDING") is None


def test_a_returned_state_does_not_change_under_later_steps(cuda):
    ep = Episodes(Joystick, "flat_terrain_backlash", cuda)
    state = ep.reset()
    with torch.no_grad():
        for _ in range(3):  # warm-up, capture, replay
            state = ep.env.step(state, *ep.inputs())
        held = state
        kept = [t.clone() for t in leaves(held)[1]]
        for _ in range(10):
            state = ep.env.step(state, *ep.inputs())
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(leaves(held)[1], kept))
    assert not torch.equal(held.data.qpos, state.data.qpos)


@pytest.mark.parametrize("cls, task", [TASKS[0], TASKS[2]], ids=[IDS[0], IDS[2]])
def test_each_replay_counts_one_launch_and_the_task_runs_only_eagerly(cuda, cls, task):
    ep = Episodes(cls, task, cuda)
    state = ep.reset()
    kernel = MK.kernel(ep.env.env.model.spec)
    before = (MK.launches, MK.launches_hfield, kernel.launches)
    tracing.reset()
    with torch.no_grad():
        for _ in range(7):  # warm-up, capture and its replay, 5 replays
            state = ep.env.step(state, *ep.inputs())
    torch.cuda.synchronize()
    hfield = int(ep.env.env.model.spec.floor_is_hfield)
    assert (MK.launches - before[0], MK.launches_hfield - before[1], kernel.launches - before[2]) == (7, 7 * hfield, 7)
    calls = {name: s["calls"] for name, s in tracing.snapshot().items()}
    assert calls == {"env.wrapper": 7, "env.graph": 6, "env.task": 2, "env.physics": 2}
    assert bool(torch.isfinite(state.obs["state"]).all())


@pytest.mark.parametrize("cls, task", TASKS, ids=IDS)
def test_a_replayed_step_makes_no_host_synchronization(cuda, cls, task):
    ep = Episodes(cls, task, cuda)
    state = ep.reset()
    with torch.no_grad():
        for _ in range(3):
            state = ep.env.step(state, *ep.inputs())
        action, draws = ep.inputs()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = ep.env.step(state, action, draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(state.reward).all())


def test_a_second_batch_size_captures_a_second_graph(cuda):
    ep = Episodes(Joystick, "flat_terrain_backlash", cuda)
    small = Episodes(Joystick, "flat_terrain_backlash", cuda, n=64)
    small.env = ep.env
    with torch.no_grad():
        state = ep.reset()
        for _ in range(3):
            state = ep.env.step(state, *ep.inputs())
        assert len(ep.env._graphs) == 1
        state_small = small.reset()
        for _ in range(3):
            state_small = small.env.step(state_small, *small.inputs())
        assert len(ep.env._graphs) == 2
        before = MK.launches
        action, draws = ep.inputs()
        graphed = ep.env.step(state, action, draws)
        assert len(ep.env._graphs) == 2 and MK.launches == before + 1
        assert_same(graphed, ep.env.eager_step(state, action, draws), "the first graph after the second")
    assert state_small.reward.shape == (64,)


@pytest.mark.parametrize("cls, task", [TASKS[0], TASKS[2]], ids=[IDS[0], IDS[2]])
def test_two_models_of_one_build_each_step_their_own(cuda, cls, task):
    """Model B is the env's model A with one body offset moved (a structure
    table, not a randomized field). B launched eagerly between the capture
    of A's step and its replay: the replay is A's eager step bit for bit
    and counts one launch, and B's launch is the one it made before A's
    graph existed, bit for bit, and not A's."""
    ep = Episodes(cls, task, cuda)
    model_a = ep.env._model
    body_pos = model_a.body_pos.clone()
    body_pos[2, 2] += 1e-3
    model_b = model_a.replace(body_pos=body_pos)
    kernel = MK.kernel(model_a.spec)
    assert MK.kernel(model_b.spec) is kernel
    state = ep.reset()
    d, n = state.data, ep.env.env.n_substeps
    with torch.no_grad():
        b_first = MK.megakernel_step(model_b, d, d.ctrl, n)
        for _ in range(2):  # warm-up, capture and its replay
            state = ep.env.step(state, *ep.inputs())
        b = MK.megakernel_step(model_b, d, d.ctrl, n)
        action, draws = ep.inputs()
        before = (MK.launches, kernel.launches)
        graphed = ep.env.step(state, action, draws)
        assert (MK.launches - before[0], kernel.launches - before[1]) == (1, 1)
        eager = ep.env.eager_step(state, action, draws)
        a = MK.megakernel_step(model_a, d, d.ctrl, n)
    assert len(ep.env._graphs) == 1
    assert_same(graphed, eager, f"{task}: A's replay after B's launch")
    assert_same(b, b_first, f"{task}: B after A's graph")
    assert not torch.equal(a.qpos, b.qpos)


def test_no_record_is_made_inside_a_capture(cuda):
    ep = Episodes(Joystick, "flat_terrain_backlash", cuda)
    d, n = ep.reset().data, ep.env.env.n_substeps
    fresh = ep.env._model.replace(body_pos=ep.env._model.body_pos.clone())
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad():
        MK.megakernel_step(ep.env._model, d, d.ctrl, n)  # the build, loaded and configured
        with pytest.raises(RuntimeError, match="first eager launch"):
            with torch.cuda.graph(graph):
                MK.megakernel_step(fresh, d, d.ctrl, n)
