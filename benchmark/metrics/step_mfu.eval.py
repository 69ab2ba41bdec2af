"""The eval control steps' share of the card's f32 peak, in %: the
operations `_step_work.eval_steps_ops` counts for the traced unit's
control steps over their untraced seconds times 67 TFLOP/s."""

from benchmark.metrics import _peaks, _step_work


def read(obs):
    wall = obs["timed"].get("step_s")
    if not wall:
        return None
    ops = _step_work.eval_steps_ops(obs["model"], obs["work_shape"], obs["active"])
    return 100.0 * ops / (wall * _peaks.F32_FLOPS)
