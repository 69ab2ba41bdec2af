"""Seconds of the first env reset (in the eval, set-up's probe reset of one
env: the first launch of each of its kernels): the port's span
`env.reset`, self time of its first call."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.first_s("env.reset")
