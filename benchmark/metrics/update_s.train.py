"""Seconds of the update (the epochs of SGD steps: loss, GAE, autograd,
clip and Adam) per training step: the trainer's own `phase_hook`,
synchronized, mean over the trace run's untraced stretch."""


def read(obs):
    return obs["timed"].get("update_s")
