"""Host ms per control step of the task: the port's span `env.task`
(`Joystick.step`: action delay, pushes, gait frame, obs, reward) less the
physics inside it, mean over its calls but the first."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.steady_ms("env.task")
