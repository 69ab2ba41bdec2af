"""Seconds of the rollout (`ppo.generate_unroll`: policy, env step,
normalizer moments) per training step: the trainer's own `phase_hook`,
synchronized, mean over the trace run's untraced stretch."""


def read(obs):
    return obs["timed"].get("rollout_s")
