"""The training wrapper's two CUDA kernels (`envs/wrapper_kernel.py`,
`csrc/wrapper_step.cu`) on the card; each test skips without one. This
file imports no JAX package module:

    python -m pytest tests/test_torch_gpu_wrapper_kernel.py -q

- On the three benchmarked configurations (the joystick on the plane, the
  heightfield recipe with reference-state init, standing on the plane), at
  128 and 8192 envs: the fused `TrainingEnv.step` (eager) and the graphed
  `EvalEnv.step` against the eager body (`eager_step`) from the same
  state, every leaf bit for bit (NaN where the body has NaN), over 12
  control steps with an episode limit of 5, half the envs done at the
  first, and NaN and +-inf planted in the task step's outputs (the
  quarantine and nan_to_num);
- one fused step counted per eager step and per replay, and the eager
  body counted as eager;
- a fused step makes no host synchronization.
"""

import pytest
import torch

from open_duck_playground_torch.envs import wrapper_kernel as WK
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv
from task_kernel_check import RECIPE, assert_same_bits, plant_non_finite

pytestmark = pytest.mark.gpu

STEPS, LIMIT = 12, 5
CASES = [(Joystick, "flat_terrain_backlash", {}), (Joystick, "rough_terrain_backlash", RECIPE),
         (Standing, "flat_terrain", {})]
IDS = ["flat", "rough", "standing"]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the wrapper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("wrapper", [TrainingEnv, EvalEnv], ids=["training", "eval_graph"])
@pytest.mark.parametrize("n", [128, 8192])
@pytest.mark.parametrize("cls, task, overrides", CASES, ids=IDS)
def test_the_fused_wrapper_step_is_the_eager_body(cuda, monkeypatch, cls, task, overrides, n, wrapper):
    env = cls(task, device=cuda, config_overrides=overrides)
    plant_non_finite(env, monkeypatch)
    wenv = wrapper(env, LIMIT)
    gen = torch.Generator(device=cuda).manual_seed(7)
    state = wenv.reset(env.reset_draws(gen, n))
    state = state.replace(done=(torch.arange(n, device=cuda) % 2 == 0).to(torch.float32))
    before, truncated = (WK.launches, WK.eager_steps), []
    with torch.no_grad():
        for t in range(STEPS):
            action = 3.0 * torch.rand((n, env.action_size), generator=gen, device=cuda) - 1.5
            draws = wenv.step_draws(gen, n)
            got = wenv.step(state, action, draws)
            want = wenv.eager_step(state, action, draws)
            assert_same_bits(got, want, f"{task}, {n} envs, step {t}")
            truncated.append(want.info["truncation"].sum())
            state = want
    torch.cuda.synchronize()
    assert float(sum(truncated)) > 0
    assert (WK.launches - before[0], WK.eager_steps - before[1]) == (STEPS, STEPS)
    if wrapper is EvalEnv:
        assert len(wenv._graphs) == 1


def test_a_fused_wrapper_step_makes_no_host_synchronization(cuda):
    wenv = EvalEnv(Joystick("flat_terrain_backlash", device=cuda), LIMIT)
    gen = torch.Generator(device=cuda).manual_seed(2)
    state = wenv.reset(wenv.env.reset_draws(gen, 128))
    action = torch.zeros((128, wenv.action_size), device=cuda)
    with torch.no_grad():
        state = wenv._step(state, action, wenv.step_draws(gen, 128))  # builds, the task's record
        draws = wenv.step_draws(gen, 128)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = wenv._step(state, action, draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(state.info["eval_metrics"]["episode_reward"]).all())
