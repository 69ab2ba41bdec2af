"""What the joystick task kernels' checks share: the tests on the CPU
(`test_torch_task_kernel.py`, `test_torch_envs.py`), the card tests
(`test_torch_gpu_task_kernel.py`) and `chip_smoke.py`'s task phase; and
the wrapper kernels' (`test_torch_wrapper_kernel.py`,
`test_torch_gpu_wrapper_kernel.py`, `test_torch_ppo.py`,
`test_torch_rollout.py`): `wrapper_host_library`, `fused_wrapper_step`,
`assert_same_bits` and `plant_non_finite`. This module imports no JAX
package module.

A fused step is held against the eager `Joystick.step`: every integer and
bool leaf equal, every float leaf within `ULPS` of its column's largest
finite magnitude in the eager step (the kernels sum a row and take the
vector norms in another order than PyTorch's reductions), NaN where the
eager step has NaN.
"""

import contextlib
import math

import torch

from open_duck_playground_torch import cuda_build
from open_duck_playground_torch.envs import step_graph as SG
from open_duck_playground_torch.envs import task_kernel as TK
from open_duck_playground_torch.envs import wrapper_kernel as WK

ULPS = 4
EPS = torch.finfo(torch.float32).eps
# the rough recipe's overrides (RESULTS.md round 5), also run on no-head
RECIPE = {"rsi_prob": 0.5, "reward_config.scales.progress": 6.0,
          "reward_config.scales.yaw_rate_l1": -3.0, "reward_config.scales.lin_vel_l1": -2.0}
_LIBRARIES = {}


def host_library(dims):
    """The kernels' body built by the host's C++ compiler for `dims`
    (`csrc/task_step_host.cpp`, products never fused into sums, as on the
    card), loaded once per process."""
    key = tuple(sorted(dims.items()))
    if key not in _LIBRARIES:
        built = cuda_build.build("task_step_host.cpp", [*TK.build_flags(dims), "-ffp-contract=off"],
                                 headers=TK.HEADERS, host=True)
        _LIBRARIES[key] = TK.TaskLibrary(built, dims)
    return _LIBRARIES[key]


def wrapper_host_library():
    """The wrapper kernels' body built by the host's C++ compiler
    (`csrc/wrapper_step_host.cpp`, products never fused into sums, as on
    the card), loaded once per process."""
    if "wrapper" not in _LIBRARIES:
        built = cuda_build.build("wrapper_step_host.cpp", [f"-I{cuda_build.CSRC}", "-ffp-contract=off"],
                                 headers=WK.HEADERS, host=True)
        _LIBRARIES["wrapper"] = WK.WrapperLibrary(built)
    return _LIBRARIES["wrapper"]


def fused_wrapper_step(wenv, state, action, draws, lib=None):
    """`wenv`'s step (a TrainingEnv or EvalEnv) through the wrapper kernels
    of `lib` (the card's library unless given), as `TrainingEnv._step`
    calls them on CUDA tensors."""
    return WK.step(wenv.task_steps, state, action, draws, wenv._action_repeat, wenv._episode_length, lib=lib)


@contextlib.contextmanager
def eager(env):
    """The env's step on its eager body (the class flag off on the instance)."""
    env.task_kernel = False
    try:
        yield env
    finally:
        del env.task_kernel


def leaves(tree):
    out = []
    return SG.flatten(tree, out), out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def unequal_bits(got, want):
    """The leaves of `got` that are not `want`'s bit for bit, by index."""
    (gspec, g), (wspec, w) = leaves(got), leaves(want)
    if gspec != wspec:
        raise ValueError("the two trees differ in structure")
    return [i for i, (a, b) in enumerate(zip(g, w)) if not torch.equal(_bits(a), _bits(b))]


def ulps_off(a, b) -> float:
    """How far float tensor `a` lies from `b`, in ulps of each column's
    largest finite magnitude in `b` (rows along the leading axis); inf
    where the NaNs differ."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return math.inf
    if not b.numel():
        return 0.0
    a2, b2 = a.double().reshape(len(a), -1), b.double().reshape(len(b), -1)
    scale = b2.nan_to_num(0.0, 0.0, 0.0).abs().amax(0).clamp(min=1e-30)
    return float(((a2 - b2).nan_to_num(0.0).abs() / (EPS * scale)).max())


def mismatches(got, want, ulps=ULPS):
    """(leaf index, dtype, ulps off) of each leaf of `got` that is not
    `want`'s: an integer or bool leaf unequal (ulps off None), a float leaf
    more than `ulps` off."""
    (gspec, g), (wspec, w) = leaves(got), leaves(want)
    if gspec != wspec:
        raise ValueError("the two trees differ in structure")
    out = []
    for i, (a, b) in enumerate(zip(g, w)):
        if not b.is_floating_point():
            if not torch.equal(a, b):
                out.append((i, b.dtype, None))
        elif (off := ulps_off(a, b)) > ulps:
            out.append((i, b.dtype, off))
    return out


def worst_ulps(got, want) -> float:
    """The most ulps any float leaf of `got` lies from `want`'s."""
    (_, g), (_, w) = leaves(got), leaves(want)
    return max((ulps_off(a, b) for a, b in zip(g, w) if b.is_floating_point()), default=0.0)


def assert_close(got, want, where):
    bad = mismatches(got, want)
    assert not bad, f"{where}: leaves (index, dtype, ulps off) {bad}"


def assert_same_bits(got, want, where):
    """Same tree; every leaf bit for bit, NaN where `want` has NaN."""
    gl, wl = [], []
    assert SG.flatten(got, gl) == SG.flatten(want, wl), f"{where}: the trees differ"
    for i, (a, b) in enumerate(zip(gl, wl)):
        if b.is_floating_point():
            nan = torch.isnan(b)
            assert torch.equal(torch.isnan(a), nan), f"{where}: leaf {i}'s NaNs differ"
            a, b = a[~nan], b[~nan]
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f"{where}: leaf {i} differs"


def plant_non_finite(task, monkeypatch):
    """The task's step with NaN and +-inf planted in its outputs: env 1 in
    `qvel`, env 2 in `obs["state"]`, env 4 in `obs["privileged_state"]` (bad
    envs), and in an `info` and a `metrics` leaf of bad envs 1 and 2 and of
    good env 3."""
    real = task.step

    def planted(state, action, draws, model=None):
        out = real(state, action, draws, model=model)
        nan, inf = float("nan"), float("inf")
        qvel, obs = out.data.qvel.clone(), {k: v.clone() for k, v in out.obs.items()}
        # in place on views: a CUDA graph captures a fill, not a copy of a host scalar
        qvel[1, 3].fill_(nan)
        obs["state"][2, 5].fill_(inf)
        obs["privileged_state"][4, 0].fill_(-inf)
        info = dict(out.info)
        last_act = info["last_act"] = info["last_act"].clone()
        last_act[1, 0].fill_(nan)
        last_act[2, 1].fill_(-inf)
        last_act[3, 2].fill_(-inf)
        metrics = dict(out.metrics)
        first, second = list(metrics)[:2]
        metrics[first], metrics[second] = metrics[first].clone(), metrics[second].clone()
        metrics[first][1].fill_(inf)
        metrics[first][2].fill_(nan)
        metrics[second][3].fill_(nan)
        return out.replace(data=out.data.replace(qvel=qvel), obs=obs, info=info, metrics=metrics)

    monkeypatch.setattr(task, "step", planted)
