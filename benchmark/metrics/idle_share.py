"""The card's idle share over the traced unit of work, in %: 1 - its device
busy seconds (the union of kernel and copy intervals in the trace) over the
untraced wall seconds of the same work (a training step; `trace_steps` eval
control steps)."""


def read(obs):
    busy, wall = obs["trace"]["busy_s"], obs["timed"].get("step_s")
    if not wall or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
