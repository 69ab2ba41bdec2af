"""The reader of `env_graph_share.eval` on hand-made snapshots of the
port's spans: 100 x calls of `env.graph` over calls of `env.wrapper`, and
nothing to read where either span never closed (a program without the
graph, as the parent of the graph's change is)."""

import pytest

from benchmark.harness import manifest
from benchmark.metrics import _spans


def span(calls):
    return {"calls": calls, "self_s": 1e-3 * calls, "first_self_s": 1e-3}


@pytest.fixture
def read():
    return manifest.metric_reader(manifest.BENCH_DIR, "env_graph_share.eval")


@pytest.mark.parametrize("graph, wrapper, share", [
    (9999, 10001, 100.0 * 9999 / 10001),  # the warm-up and the capture of one key run eagerly
    (0, 5, 0.0),
    (4, 4, 100.0),
])
def test_the_share_is_replays_over_env_steps(monkeypatch, read, graph, wrapper, share):
    spans = {"env.wrapper": span(wrapper), "env.graph": span(graph), "policy": span(7)}
    monkeypatch.setattr(_spans, "snapshot", lambda: spans)
    assert read({}) == pytest.approx(share, rel=1e-12)


@pytest.mark.parametrize("spans", [
    {},
    {"env.wrapper": span(10)},  # the parent: no graph, no span
    {"env.graph": span(10)},
    {"env.graph": span(0), "env.wrapper": span(0)},
])
def test_nothing_to_read_without_both_spans(monkeypatch, read, spans):
    monkeypatch.setattr(_spans, "snapshot", lambda: spans)
    assert read({}) is None
