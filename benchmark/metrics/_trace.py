"""Trace arithmetic of the benchmark: a frozen copy of the port's
`tools/benchutil.py` (`_profiled`, `coverage`, `_union_us`, `host_syncs`),
so that a later change of the port's tools does not move the yardstick.

A traced unit of work runs inside `profiled`: `torch.profiler` with CPU and
CUDA activities, 0.1 s of idle host time at both ends of the window and a
lead-in launch before it (the profiler keeps a device event only if its
start, mapped from the card's clock onto the host's, lies in the window, and
can lose the first launch of a window). Each device event is placed by the
host call that launched it (the runtime call of the same correlation id),
not by its start on the device's clock. `summary` reduces the events to
device busy seconds (the union of kernel and copy intervals), the traced
window's length, busy and wall seconds per harness span, kernel seconds by
name, the longest idle gaps labelled by the span in progress, and how whole
the trace is (`coverage`)."""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional

import torch

SPAN = "bench::"
WINDOW = SPAN + "window"
COPY_PREFIXES = ("Memcpy", "Memset")
SYNC_REPORT = "called a synchronizing CUDA operation"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemsetAsync", "cudaMemcpyAsync")
TRACE_MARGIN_S = 0.1
LEAD_IN = "bench_lead_in"


def profiled(fn, dev: torch.device, margin: float = TRACE_MARGIN_S):
    """The profiler's events of one `fn()` (which opens its own spans with
    `span_function`), inside the `WINDOW` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        with record_function(LEAD_IN):
            torch.ones(1, device=dev)
            torch.cuda.synchronize(dev)
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize(dev)
        time.sleep(margin)
    return prof.events()


def span_function():
    """(span(name), close()): `span(name)` ends the span in progress and
    opens `bench::<name>`; `close()` ends the last one."""
    from torch.profiler import record_function

    current: List = [None]

    def close():
        if current[0] is not None:
            current[0].__exit__(None, None, None)
            current[0] = None

    def span(name: str):
        close()
        current[0] = record_function(SPAN + name)
        current[0].__enter__()

    return span, close


def coverage(events, span=None) -> dict:
    """The host calls that put work on the card (inside `span`, a host
    interval in us), those with no device event of their correlation id,
    and the least time from such a call to its device event's start."""
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == torch.autograd.DeviceType.CPU and e.name in LAUNCH_CALLS
             and (span is None or span[0] <= e.time_range.start <= span[1])}
    starts = {e.id: e.time_range.start for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.id in calls}
    gaps = [starts[i] - calls[i] for i in starts]
    return {"launch_calls": len(calls), "untraced_launches": len(calls) - len(starts),
            "least_launch_to_start_us": min(gaps) if gaps else None}


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summary(events, top: int = 10) -> dict:
    """Busy and window seconds, per-span busy and wall seconds, kernels by
    name, the `top` device operations and idle gaps, and `coverage`."""
    host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in host and not getattr(e, "is_user_annotation", False)]
    if not any(not e.name.startswith(COPY_PREFIXES) for e in device):
        raise RuntimeError("torch.profiler saw no kernel on the card: CUPTI gave no device events")
    launches = {e.id: e.time_range.start for e in events if e.id
                and e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(("cuda", "cu"))}
    launched_at = lambda e: launches.get(e.id, e.time_range.start)
    ranges: Dict[str, list] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(SPAN):
            ranges.setdefault(e.name[len(SPAN):], []).append((e.time_range.start, e.time_range.end))
    (w0, w1), = ranges.pop("window")
    inside = [e for e in device if w0 <= launched_at(e) <= w1]
    clip = lambda e: (e.time_range.start, min(e.time_range.end, max(w1, e.time_range.start)))
    busy = union_us([clip(e) for e in inside])
    spans = {}
    for name, rs in ranges.items():
        mine = [e for e in inside if any(a <= launched_at(e) <= b for a, b in rs)]
        spans[name] = {"busy_s": union_us([clip(e) for e in mine]) / 1e6,
                       "wall_s": sum(b - a for a, b in rs) / 1e6}
    kernels: Dict[str, list] = {}
    for e in inside:
        kernels.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))
    label = lambda t: next((n for n, rs in ranges.items() if any(a <= t <= b for a, b in rs)), "other")
    busy_runs = merged([clip(e) for e in inside])
    gaps = [(label(a1), (b0 - a1) / 1e6) for (_, a1), (b0, _) in zip(busy_runs, busy_runs[1:])]
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6, "spans": spans,
            "kernels": {n: {"count": len(d), "seconds": sum(d) / 1e6} for n, d in kernels.items()},
            "device_ops": [[n, sum(d) / 1e6] for n, d in ranked[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]],
            **coverage(events, (w0, w1))}


def host_syncs(fn, dev: torch.device) -> Optional[dict]:
    """Host synchronizations of one `fn()`, counted under
    `torch.cuda.set_sync_debug_mode("warn")`: how many, and how many at each
    source line that made one (`file:line`). None on the CPU."""
    if dev.type != "cuda":
        return None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites: Dict[str, int] = {}
    for w in caught:
        if SYNC_REPORT in str(w.message):
            key = f"{w.filename}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return {"count": sum(sites.values()), "sites": sites}
