"""What the joystick task kernels' checks share: the tests on the CPU
(`test_torch_task_kernel.py`, `test_torch_envs.py`), the card tests
(`test_torch_gpu_task_kernel.py`) and `chip_smoke.py`'s task phase. This
module imports no JAX package module.

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
