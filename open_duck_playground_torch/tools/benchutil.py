"""What the bench and profiling tools share: the device a run measures, a
synchronize for its clock, the card's name and power limit, a timer, and
the trace of a section on the card (kernel launches, host synchronizations,
device busy time and idle share, the top kernels, and where the program's
own spans of `utils/tracing.py` launch and leave the card idle)."""

from __future__ import annotations

import contextlib
import subprocess
import time
import warnings
from typing import Dict, Optional, Sequence

import torch

from open_duck_playground_torch.utils import tracing


def measured_device(device) -> torch.device:
    """`device` as a torch.device; raises SystemExit for a card that is not
    there, so a measurement never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card (tests pass device='cpu')")
    return dev


def synchronizer(dev: torch.device):
    """A function that waits for `dev`'s queued work (nothing on the CPU)."""
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def card(dev: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[dev.index or 0] if len(lines) > (dev.index or 0) else lines[0]


def seconds_per_call(fn, dev: torch.device, reps: int = 1, warmup: int = 1) -> float:
    """Seconds per call of `fn` over `reps` calls after `warmup` untimed
    ones: on the card CUDA events around the window, which the card is
    synchronized before and after; on the CPU the host clock."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / reps


# --- where a section's time goes on the card --------------------------------
#
# A traced function takes `mark`, and wraps its parts in `with mark(name):`.
# `no_marks` is what it gets when it is timed; `device_trace` and
# `host_syncs` hand it their own. The marks share the profiler prefix of the
# program's spans (`tracing.PREFIX`); `device_trace` reports the two apart.

SECTION = tracing.PREFIX
COPY_PREFIXES = ("Memcpy", "Memset")
SYNC_REPORT = "called a synchronizing CUDA operation"


def no_marks(name: str):
    return contextlib.nullcontext()


# The host calls that put work on the card: each has one device event of
# the same correlation id when the trace is whole.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemsetAsync", "cudaMemcpyAsync")
# The profiler keeps a device event only if its start, mapped from the
# card's clock onto the host's, lies inside the profiling window; that
# mapping can be off by milliseconds. It can also lose the device event of
# the first launch in its window. Either drops kernels of a traced call
# (tools/profile_window.py). So the window opens with idle host time and a
# lead-in launch of its own, and closes with idle host time.
TRACE_MARGIN_S = 0.1
LEAD_IN = "odp_lead_in"


def _profiled(fn, dev: torch.device, mark, margin: float = TRACE_MARGIN_S, lead_in: bool = True):
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        if lead_in:
            with record_function(LEAD_IN):
                torch.ones(1, device=dev)
                torch.cuda.synchronize(dev)
        with record_function(SECTION + "whole"):
            fn(mark)
            torch.cuda.synchronize(dev)
        time.sleep(margin)
    return prof.events()


def coverage(events, span=None) -> dict:
    """How whole a trace is: its host calls that put work on the card
    (`LAUNCH_CALLS`; with `span`, a (start, end) on the host's clock in us,
    only those made inside it), those of them with no device event of their
    correlation id (`untraced_launches`), and the least time from such a
    call to the start of its device event, in us on the host's clock
    (`least_launch_to_start_us`; work cannot start before its launch, so a
    negative value is the error of the profiler's clock mapping)."""
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == torch.autograd.DeviceType.CPU and e.name in LAUNCH_CALLS
             and (span is None or span[0] <= e.time_range.start <= span[1])}
    starts = {e.id: e.time_range.start for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.id in calls}
    gaps = [starts[i] - calls[i] for i in starts]
    return {"launch_calls": len(calls), "untraced_launches": len(calls) - len(starts),
            "least_launch_to_start_us": min(gaps) if gaps else None}


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _section_stats(ranges, device_events, launched_at, top: int) -> dict:
    """Launches, copies, device busy and wall ms and the idle share of the
    device events launched inside `ranges` (host intervals, us);
    `launched_at(e)` is the host time of e's launch."""
    inside = [e for e in device_events if any(a <= launched_at(e) <= b for a, b in ranges)]
    kernels = [e for e in inside if not e.name.startswith(COPY_PREFIXES)]
    wall = sum(b - a for a, b in ranges)
    busy = _union_us([(e.time_range.start, min(e.time_range.end, max(b for _, b in ranges)))
                      for e in inside])
    by_name: Dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    return {"kernel_launches": len(kernels), "copies": len(inside) - len(kernels),
            "device_busy_ms": busy / 1e3, "wall_ms": wall / 1e3,
            "idle_share": 1 - busy / wall if wall > 0 else None,
            "top_kernels": [{"name": n, "ms": sum(d) / 1e3, "count": len(d)} for n, d in ranked]}


def span_stats(spans: Dict[str, list], window, device_events, launched_at, top: int) -> dict:
    """The device events launched inside `window` (a host interval, us) by
    the innermost of the program's spans (`spans`: name -> host intervals,
    us) open at their launch, "other" outside every span: per span its
    kernel launches, copies and device ms (they add up to the window's);
    the share of the kernel launches made inside some span; and the `top`
    idle gaps of the card (ms), each labelled by the innermost span open on
    the host when the gap began."""
    intervals = sorted((a, b, name) for name, rs in spans.items() for a, b in rs)

    def innermost(t) -> str:
        label = "other"
        for a, b, name in intervals:
            if a > t:
                break
            if t <= b:  # of the ranges around t, the latest to start is nested in the others
                label = name
        return label

    inside = [e for e in device_events if window[0] <= launched_at(e) <= window[1]]
    by_span: Dict[str, dict] = {}
    for e in inside:
        stats = by_span.setdefault(innermost(launched_at(e)), {"kernel_launches": 0, "copies": 0, "device_ms": 0.0})
        stats["copies" if e.name.startswith(COPY_PREFIXES) else "kernel_launches"] += 1
        stats["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
    kernels = sum(s["kernel_launches"] for s in by_span.values())
    outside = by_span.get("other", {}).get("kernel_launches", 0)
    runs: list = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in inside):
        if runs and a <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], b)
        else:
            runs.append([a, b])
    gaps = sorted(([innermost(a1), (b0 - a1) / 1e3] for (_, a1), (b0, _) in zip(runs, runs[1:])),
                  key=lambda g: -g[1])
    return {"spans": by_span, "launches_in_spans": (kernels - outside) / kernels if kernels else None,
            "idle_gaps": gaps[:top]}


def device_trace(fn, dev: torch.device, top: int = 10, named: Sequence[str] = ()) -> Optional[dict]:
    """Where `fn(mark)`'s time goes on the card, from `torch.profiler` with
    CPU and CUDA activities: kernel launches, copies, device busy time (the
    union of the kernel and copy intervals), wall time of the host range,
    the device's idle share (1 - busy / wall) and the `top` kernels by
    device time. `whole` is one run with no marks; `sections` a second run
    in which each `mark(name)` is a profiler range with the card
    synchronized at both ends, so that its kernels run inside it (sections
    may nest; each counts what its host code launched). For each substring
    in `named`, the whole run also reports the launches and device ms of
    the kernels whose names hold it. `whole["placed_by_launch"]` is the
    share of device events matched to their launching host call, and
    `whole` also holds the whole run's `coverage`. `spans` is the whole
    run by the program's own spans (`span_stats`). Raises if
    the profiler saw no kernel: CUPTI gave no device events, and no share
    can be read. None on the CPU: there is no device to trace."""
    if dev.type != "cuda":
        return None
    from torch.profiler import record_function

    marked: Dict[str, None] = {}

    def sync_mark(name):
        marked[name] = None

        @contextlib.contextmanager
        def cm():
            torch.cuda.synchronize(dev)
            with record_function(SECTION + name):
                yield
                torch.cuda.synchronize(dev)

        return cm()

    out = {}
    for key, mark in (("whole", no_marks), ("sections", sync_mark)):
        events = _profiled(fn, dev, mark)
        # a record_function range (the optimizer's step, the sections) also
        # shows as a device-side annotation under its host name: not a kernel
        host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name not in host and not getattr(e, "is_user_annotation", False)]
        if not any(not e.name.startswith(COPY_PREFIXES) for e in device):
            raise RuntimeError("torch.profiler saw no kernel on the card: CUPTI gave no device events")
        # a kernel or copy is placed by the host call that launched it (the
        # runtime call of the same correlation id), not by its start on the
        # device's clock, which the profiler maps onto the host's only to a
        # few microseconds
        launches = {e.id: e.time_range.start for e in events if e.id
                    and e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(("cuda", "cu"))}
        launched_at = lambda e: launches.get(e.id, e.time_range.start)
        ranges: Dict[str, list] = {}
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(SECTION):
                ranges.setdefault(e.name[len(SECTION):], []).append((e.time_range.start, e.time_range.end))
        if key == "whole":
            whole = ranges.pop("whole")
            out["whole"] = _section_stats(whole, device, launched_at, top)
            out["whole"]["placed_by_launch"] = sum(e.id in launches for e in device) / len(device)
            out["whole"].update(coverage(events, whole[0]))
            out["spans"] = span_stats(ranges, whole[0], device, launched_at, top)
            out["named"] = {}
            for part in named:
                hits = [e.time_range.end - e.time_range.start for e in device if part in e.name]
                out["named"][part] = {"kernel_launches": len(hits), "device_ms": sum(hits) / 1e3}
        else:
            out["sections"] = {name: _section_stats(ranges[name], device, launched_at, top)
                               for name in marked if name in ranges}
    return out


def host_syncs(fn, dev: torch.device) -> Optional[dict]:
    """Host synchronizations of one `fn(mark)`, counted under
    `torch.cuda.set_sync_debug_mode("warn")`: the whole run, and each
    `mark(name)` section (sections may nest; each counts what runs inside
    it). None on the CPU."""
    if dev.type != "cuda":
        return None
    sections: Dict[str, int] = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # the mode's own first-use notice also speaks of synchronizing
        # operations: count only the reports of one
        syncs = lambda: sum(SYNC_REPORT in str(w.message) for w in caught)

        @contextlib.contextmanager
        def count(name):
            before = syncs()
            yield
            sections[name] = sections.get(name, 0) + syncs() - before

        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(count)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return {"whole": syncs(), "sections": sections}
