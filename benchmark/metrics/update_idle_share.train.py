"""The card's idle share in the update, in %: 1 - device busy seconds of
the traced step's update span over the untraced update's seconds (the
profiler lengthens the traced wall time, so the untraced one is the
denominator)."""


def read(obs):
    span = obs["trace"]["spans"].get("update")
    update_s = obs["timed"].get("update_s")
    if not span or not update_s or span["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - span["busy_s"] / update_s)
