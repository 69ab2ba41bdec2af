"""Host ms per control step of the policy: the port's span `policy` (the
normalizer, the actor MLP, the tanh-Normal sample and its log-prob), self
time, mean over its calls but the first."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.steady_ms("policy")
