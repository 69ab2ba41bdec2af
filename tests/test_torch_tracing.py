"""The port's spans (`open_duck_playground_torch/utils/tracing.py`) on the
CPU:

- a span's self time leaves out its children's (on a hand-driven clock,
  exactly), its first call is kept apart, a same-name span opened inside it
  counts once, and a span on another thread is no child of this thread's;
- under `torch.profiler` a span opens its `odp::` range and leaves the
  aggregates as they were;
- one control step of `ppo.run_eval` on a tiny joystick records one call of
  each of the five step spans, and one tiny `ppo.training_step`
  num_updates_per_batch x num_minibatches calls of each `sgd.*` span;
- each `program_span` metric of BENCHMARK.json has its reader, which reads
  a finite number from the spans and nothing where its span never closed.

Each test clears the aggregates first: pytest-xdist runs many files in one
process.
"""

import math
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import manifest
from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig
from open_duck_playground_torch.utils import tracing

CPU = torch.device("cpu")
STEP_SPANS = ("policy", "env.draws", "env.wrapper", "env.task", "env.physics")
SGD_SPANS = ("sgd.minibatch", "sgd.loss", "sgd.backward", "sgd.optimizer")


class Clock:
    """A `perf_counter_ns` that moves only when told, in whole seconds."""

    def __init__(self):
        self.ns = 0

    def __call__(self) -> int:
        return self.ns

    def advance(self, seconds: int) -> None:
        self.ns += seconds * 10**9


@pytest.fixture
def clock(monkeypatch):
    tracing.reset()
    c = Clock()
    monkeypatch.setattr(tracing, "_perf_ns", c)
    return c


def totals(name):
    s = tracing.snapshot()[name]
    return s["calls"], s["self_s"], s["first_self_s"]


def test_self_time_leaves_out_the_children(clock):
    with tracing.span("parent"):
        clock.advance(1)
        with tracing.span("child"):
            clock.advance(2)
            with tracing.span("grandchild"):
                clock.advance(4)
        clock.advance(8)
        with tracing.span("child"):
            clock.advance(16)
    assert totals("parent") == (1, 9.0, 9.0)
    assert totals("child") == (2, 18.0, 2.0)
    assert totals("grandchild") == (1, 4.0, 4.0)


def test_the_first_call_is_kept_apart(clock):
    for seconds in (5, 1, 2):
        with tracing.span("step"):
            clock.advance(seconds)
    calls, self_s, first = totals("step")
    assert (calls, self_s, first) == (3, 8.0, 5.0)
    assert (self_s - first) / (calls - 1) == 1.5  # the steady mean the readers take


def test_a_same_name_span_inside_an_open_one_counts_once(clock):
    with tracing.span("env.wrapper"):
        clock.advance(1)
        with tracing.span("env.wrapper"):  # EvalEnv.step -> TrainingEnv.step
            clock.advance(2)
            with tracing.span("env.task"):
                clock.advance(4)
            clock.advance(8)
        clock.advance(16)
    assert totals("env.wrapper") == (1, 27.0, 27.0)
    assert totals("env.task") == (1, 4.0, 4.0)
    # a re-entry below another span is transparent too: its time is that span's
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("a"):
                clock.advance(32)
    assert totals("a") == (1, 0.0, 0.0) and totals("b") == (1, 32.0, 32.0)


def test_a_span_on_another_thread_is_no_child(clock):
    def other():
        with tracing.span("other"):
            clock.advance(2)

    with tracing.span("main"):
        clock.advance(1)
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
    assert totals("main") == (1, 3.0, 3.0)
    assert totals("other") == (1, 2.0, 2.0)


def test_under_the_profiler_a_span_is_a_range_and_adds_nothing(clock):
    with tracing.span("env.task"):
        clock.advance(1)
    before = tracing.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("env.task"):
            with tracing.span("env.physics"):
                torch.ones(3).add_(1)
    assert tracing.snapshot() == before
    names = [e.name for e in prof.events()]
    assert names.count("odp::env.task") == 1 and names.count("odp::env.physics") == 1
    with tracing.span("env.task"):
        clock.advance(2)
    assert totals("env.task") == (2, 3.0, 1.0)


def test_one_eval_control_step_records_each_step_span_once():
    env = Joystick("flat_terrain_backlash", device=CPU)
    eval_env = EvalEnv(env, episode_length=1000)
    gen = torch.Generator().manual_seed(0)
    probe = eval_env.reset(env.reset_draws(gen, 1))
    ts = ppo.init_training_state(probe.obs, env.action_size, PPOConfig(), gen, device=CPU)
    tracing.reset()
    ppo.run_eval(eval_env, (ts.normalizer, ts.net), 2, 1, False, gen)
    spans = tracing.snapshot()
    assert set(spans) == set(STEP_SPANS) | {"env.reset"}
    assert all(s["calls"] == 1 and s["self_s"] > 0 for s in spans.values())


def test_one_training_step_records_each_sgd_span_per_sgd_step():
    cfg = PPOConfig(num_envs=4, batch_size=2, num_minibatches=2, unroll_length=2, num_updates_per_batch=3)
    env = Joystick("flat_terrain_backlash", device=CPU)
    train_env = TrainingEnv(env, cfg.episode_length)
    gen = torch.Generator().manual_seed(1)
    state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=CPU)
    tracing.reset()
    ppo.training_step(ts, train_env, env, state, cfg, gen)
    spans = tracing.snapshot()
    steps = cfg.unroll_length * cfg.k_unrolls
    assert {name: spans[name]["calls"] for name in SGD_SPANS} == {name: 3 * 2 for name in SGD_SPANS}
    assert {name: spans[name]["calls"] for name in STEP_SPANS} == {
        "policy": steps, "env.draws": 1, "env.wrapper": steps, "env.task": steps, "env.physics": steps}


def span_metrics():
    return [m for m in manifest.load()["per_layer"] if m["source"] == "program_span"]


def test_the_benchmark_reads_seven_program_spans():
    # seven spans, the share of the env steps the env step's graph replayed
    # and the share of the control steps that drew and acted through a graph
    assert sorted(m["name"] for m in span_metrics()) == sorted(
        ["policy_host_ms.eval", "draws_host_ms.eval", "wrapper_host_ms.eval", "task_host_ms.eval",
         "physics_host_ms.eval", "ppo_init_s.eval", "reset_first_s.eval", "env_graph_share.eval",
         "act_graph_share.eval"])


@pytest.mark.parametrize("metric", [m["name"] for m in span_metrics()])
def test_each_span_metric_reads_a_finite_number(clock, metric):
    read = manifest.metric_reader(manifest.BENCH_DIR, metric)
    assert read({}) is None  # no span closed: nothing to read, as in a program without them
    for name in (*STEP_SPANS, "env.graph", "act.graph", "ppo.init", "env.reset"):
        for seconds in (3, 1, 1):
            with tracing.span(name):
                clock.advance(seconds)
    value = read({})
    assert isinstance(value, float) and math.isfinite(value) and value > 0
    kind = metric.split(".")[0]
    assert value == {"ppo_init_s": 3.0, "reset_first_s": 3.0, "env_graph_share": 100.0,
                     "act_graph_share": 50.0}.get(kind, 1e3)  # act.graph as often as env.draws
