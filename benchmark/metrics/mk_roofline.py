"""The physics kernel's share of its roofline, in %: the least time of one
launch (the larger of its operations over the f32 peak and its bytes over
the HBM peak, `_kernel_work.megakernel_work` at the cell's envs and
substeps and the active contacts and limit rows of the window's last
states) over the mean device time of `mk_kernel` in the trace."""

from benchmark.metrics import _kernel_work, _peaks


def read(obs):
    k = obs["trace"]["kernels"]
    hits = [v for name, v in k.items() if "mk_kernel" in name]
    count = sum(v["count"] for v in hits)
    if not count:
        return None
    shape, active = obs["work_shape"], obs["active"]
    nbytes, ops, _ = _kernel_work.megakernel_work(obs["model"], shape["envs"], shape["substeps"],
                                                  active["contacts"], active["limits"])
    least = max(ops / _peaks.F32_FLOPS, nbytes / _peaks.HBM_BYTES_PER_S)
    return 100.0 * least / (sum(v["seconds"] for v in hits) / count)
