"""The task kernels' share of their roofline, in %: the least time of one
fused task step (the bytes of `tk_pre` and `tk_post` at the cell's envs,
`_task_work.task_bytes` of the build the process launched most, over the
HBM peak) over the mean device seconds of the two kernels per fused step
in the trace (one `tk_post` launch per step). The build and the rows of
its metrics table come from the port's counter `build_launches`
(`envs/task_kernel.py`). None where the trace holds no task kernel or the
port has no such counter."""

from benchmark.metrics import _peaks, _task_work


def read(obs):
    try:
        from open_duck_playground_torch.envs import task_kernel
    except ImportError:
        return None
    builds = getattr(task_kernel, "build_launches", None)
    if not builds:
        return None
    k = obs["trace"]["kernels"]
    steps = sum(v["count"] for name, v in k.items() if "tk_post" in name)
    seconds = sum(v["seconds"] for name, v in k.items() if "tk_pre" in name or "tk_post" in name)
    if not steps or seconds <= 0:
        return None
    dims, nmetrics = max(builds, key=builds.get)
    least = obs["work_shape"]["envs"] * _task_work.task_bytes(dict(dims), nmetrics) / _peaks.HBM_BYTES_PER_S
    return 100.0 * least / (seconds / steps)
