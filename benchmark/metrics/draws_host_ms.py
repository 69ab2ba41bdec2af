"""Host ms per control step of the random draws: the port's span
`env.draws` (in the eval the action noise and the env's step draws of
`ppo.eval_draws`), self time, mean over its calls but the first."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.steady_ms("env.draws")
