"""Host ms per control step of the physics call: the port's span
`env.physics` (`forward.step`: the megakernel's packing, launch and
unpacking), self time, mean over its calls but the first."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.steady_ms("env.physics")
