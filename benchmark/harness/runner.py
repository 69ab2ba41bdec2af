"""One run of one cell: set-up, the measured window (or, with `trace`, the
untraced stretch and the traced unit that the per-layer readers take
their numbers from), the peak of device memory, then, with the port's
state freed, the check that decides `correct`.

`run` returns the result's fields and the compared numbers; `run.py`
prints them. The CPU tests call `run` with `device="cpu"`, tiny sizes and
`need_card=False`; every measurement on the card goes through `run.py`."""

from __future__ import annotations

import gc
import os
import sys
import time
from typing import Dict, Optional

import torch

from benchmark.harness import check, manifest
from benchmark.metrics import _kernel_work, _trace

FORBIDDEN = ("jax", "jaxlib", "flax", "open_duck_playground_tpu")
TRACE_ATTEMPTS = 3


class RunError(RuntimeError):
    """A run that must print no result."""


def process_start() -> float:
    """The process's start on `time.time()`'s clock (Linux: from
    /proc/self/stat and /proc/uptime), or the time now."""
    try:
        ticks = int(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19])
        uptime = float(open("/proc/uptime").read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Top-level names in `sys.modules` that no benchmark run may hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def require_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")


def prepare(workload: str, bench_dir=manifest.BENCH_DIR, config_overrides: Optional[dict] = None,
            traffic_overrides: Optional[dict] = None):
    """(manifest cell, configuration, traffic, limits) of `workload`, a cell
    of BENCHMARK.json or of `parked.json`."""
    man = manifest.load(bench_dir, parked=True)
    cell = manifest.cell(man, workload)
    config = manifest.config_of(bench_dir, cell)
    config["ppo"] = {**config["ppo"], **(config_overrides or {})}
    traffic = {**manifest.read_json(bench_dir, "traffic", cell["traffic"]), **(traffic_overrides or {})}
    manifest.loop_class(bench_dir, traffic["loop"])
    return cell, config, traffic, manifest.limits_of(bench_dir, workload)


def make_loop(config: dict, traffic: dict, seed: int, device, bench_dir=manifest.BENCH_DIR):
    """The loop of the mix's kind (`harness/loops/<loop>.py`), built."""
    return manifest.loop_class(bench_dir, traffic["loop"])(config, traffic, seed, device)


def observe(loop, seconds: float, dev: torch.device) -> dict:
    """The trace run's readings: the untraced stretch, the traced unit's
    summary (traced again where the profiler lost a launch), the env
    step's host syncs and the window's active rows."""
    timed = loop.timed_phases(seconds)
    for _ in range(TRACE_ATTEMPTS):
        span, close = _trace.span_function()

        def unit():
            loop.traced_unit(span)
            close()

        summary = _trace.summary(_trace.profiled(unit, dev))
        if summary["untraced_launches"] == 0:
            break
    model = loop.ref_env.model
    syncs = _trace.host_syncs(loop.one_env_step(), dev)
    for site, n in sorted(syncs["sites"].items()):
        print(f"host sync of the env step: {n} at {site}", file=sys.stderr)
    return {"kind": loop.kind, "timed": timed, "trace": summary, "host_syncs": syncs["count"],
            "work_shape": loop.work_shape(), "model": model,
            "active": dict(zip(("contacts", "limits"), _kernel_work.active_rows(model, loop.final_data())))}


def run(workload: str, seed: int, seconds: float, trace: bool, bench_dir=manifest.BENCH_DIR,
        device="cuda", config_overrides: Optional[dict] = None, traffic_overrides: Optional[dict] = None,
        need_card: bool = True, started: Optional[float] = None) -> dict:
    started = process_start() if started is None else started
    cell, config, traffic, limits = prepare(workload, bench_dir, config_overrides, traffic_overrides)
    if need_card:
        require_card(cell["chips"])
    dev = torch.device(device)
    loop = make_loop(config, traffic, seed, dev, bench_dir)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop.timings.restart(process_start_to_setup=time.time() - started)
    loop.setup()
    setup_s = time.time() - started
    print("setup " + " ".join(f"{k}={v:.3f}" for k, v in loop.timings.parts.items()), file=sys.stderr)
    e2e = {m["name"]: m for m in cell["end_to_end"]}
    metrics, breakdown, extra = {}, None, {}
    if not trace:
        w = loop.window(seconds)
        metrics["setup_s"] = {"value": setup_s, "unit": e2e["setup_s"]["unit"]}
        rate = traffic["rate_metric"]
        metrics[rate] = {"value": w["work"] / w["seconds"], "unit": e2e[rate]["unit"]}
        attempted, failed = w["units"], w["failed"]
    else:
        obs = observe(loop, seconds, dev)
        for m in cell["per_layer"]:
            value = manifest.metric_reader(bench_dir, m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        attempted, failed = obs["timed"]["units"], 0
        breakdown = {"device_ops": obs["trace"]["device_ops"], "idle_gaps": obs["trace"]["idle_gaps"]}
        extra = {"busy_s": obs["trace"]["busy_s"], "window_s": obs["trace"]["window_s"]}
    found = forbidden_modules()
    if found:
        raise RunError(f"modules the benchmark may not load are in sys.modules: {found}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    loop.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.verdict(loop.numbers(dev), limits)
    if forbidden_modules():
        raise RunError(f"modules the benchmark may not load are in sys.modules: {forbidden_modules()}")
    device_block = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                    "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                    "count": cell["chips"], "memory_peak_bytes": int(peak), **extra}
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_block}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": c["value"], "limit": c["limit"]} for name, c in checks.items()}
    return result
