"""Seconds of set-up's `ppo.init_training_state` (networks and Adam): the
port's span `ppo.init`, self time of its first call."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.first_s("ppo.init")
