"""The port's own spans (`open_duck_playground_torch/utils/tracing.py`), as
the run's process holds them when the readers run: set-up, the untraced
stretch and the one control step whose host syncs are counted (a span adds
nothing while the profiler records, so the traced unit is not in them).
Each span keeps its calls, its host self seconds (less its child spans')
and the self seconds of its first call. A program without the module, or a
span that never closed often enough, gives None."""


def snapshot() -> dict:
    try:
        from open_duck_playground_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.snapshot()


def steady_ms(name: str):
    """Host self ms per call of the span `name`, its first call (the cold
    start) left out."""
    s = snapshot().get(name)
    if s is None or s["calls"] < 2:
        return None
    return 1e3 * (s["self_s"] - s["first_self_s"]) / (s["calls"] - 1)


def first_s(name: str):
    """Host self seconds of the first call of the span `name`."""
    s = snapshot().get(name)
    return None if s is None else s["first_self_s"]
