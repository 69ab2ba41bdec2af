"""Share of the evaluator's control steps that drew their random numbers
and acted through a CUDA graph, in %: calls of the port's span `act.graph`
(one per replay of the graph of `ppo.eval_actor`) over those calls and the
calls of `env.draws` (each eager draw of a control step, a graph's warm-up
and capture included), x 100, over set-up, the untraced stretch and the
sync-count step. None in a program where `act.graph` never closed."""

from benchmark.metrics import _spans


def read(obs):
    spans = _spans.snapshot()
    graph = spans.get("act.graph")
    if graph is None or not graph["calls"]:
        return None
    draws = spans.get("env.draws", {"calls": 0})
    return 100.0 * graph["calls"] / (graph["calls"] + draws["calls"])
