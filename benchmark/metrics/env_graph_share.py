"""Share of the env steps that replayed a CUDA graph, in %: calls of the
port's span `env.graph` (one per replay of the graph of `EvalEnv.step`)
over calls of `env.wrapper` (every `EvalEnv.step` and `TrainingEnv.step`),
x 100, over set-up, the untraced stretch and the sync-count step. None in
a program without either span."""

from benchmark.metrics import _spans


def read(obs):
    spans = _spans.snapshot()
    graph, wrapper = spans.get("env.graph"), spans.get("env.wrapper")
    if graph is None or wrapper is None or not wrapper["calls"]:
        return None
    return 100.0 * graph["calls"] / wrapper["calls"]
