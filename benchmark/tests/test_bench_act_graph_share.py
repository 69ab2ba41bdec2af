"""The reader of `act_graph_share.eval` on hand-made snapshots of the
port's spans: 100 x calls of `act.graph` over those calls and the calls of
`env.draws`, and nothing to read where `act.graph` never closed (a program
without the graph, as the parent of the graph's change is)."""

import pytest

from benchmark.harness import manifest
from benchmark.metrics import _spans


def span(calls):
    return {"calls": calls, "self_s": 1e-3 * calls, "first_self_s": 1e-3}


@pytest.fixture
def read():
    return manifest.metric_reader(manifest.BENCH_DIR, "act_graph_share.eval")


@pytest.mark.parametrize("graph, draws, share", [
    (14999, 2, 100.0 * 14999 / 15001),  # the warm-up and the capture of one key draw eagerly
    (5, 0, 100.0),
    (3, 3, 50.0),
])
def test_the_share_is_replays_over_control_steps(monkeypatch, read, graph, draws, share):
    spans = {"act.graph": span(graph), "env.draws": span(draws), "env.wrapper": span(graph + draws)}
    monkeypatch.setattr(_spans, "snapshot", lambda: spans)
    assert read({}) == pytest.approx(share, rel=1e-12)


def test_a_graph_with_no_eager_draw_reads_100(monkeypatch, read):
    monkeypatch.setattr(_spans, "snapshot", lambda: {"act.graph": span(7)})
    assert read({}) == 100.0


@pytest.mark.parametrize("spans", [
    {},
    {"env.draws": span(10), "policy": span(10)},  # the parent: no graph, no span
    {"act.graph": span(0), "env.draws": span(4)},
])
def test_nothing_to_read_without_a_replay(monkeypatch, read, spans):
    monkeypatch.setattr(_spans, "snapshot", lambda: spans)
    assert read({}) is None
