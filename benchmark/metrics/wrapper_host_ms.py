"""Host ms per control step of the wrapper: the port's span `env.wrapper`
(`EvalEnv.step` and the `TrainingEnv.step` inside it: autoreset, NaN
quarantine, episode sums) less the task inside it, mean over its calls
but the first."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.steady_ms("env.wrapper")
