"""Measure what one SM of the card sustains on f32 dependency chains.

    python -m open_duck_playground_torch.tools.issue_bench [--csv out.csv]

Counterpart of `tools/vpu_issue_bench.py` (its Pallas kernel `_build`,
`pl.pallas_call` at :100) with a hand-written CUDA kernel,
`csrc/issue_probe.cu`. The physics megakernel is one long dependent chain
per thread, so its operations bound at the data-sheet peak says little; this
tool measures the rate the card really issues such chains at, by variant
(`fma`, `add`, `exp`, `sqrt_div`), independent chains per thread (1-16) and
resident warps per SM (one block per SM, 1-32 warps).

Timing is the two-point slope between two trip counts, so launch and set-up
cancel: CUDA events give seconds, the kernel's own `clock64` readings give
SM cycles. Each config prints one JSON line: f32 operations per clock per
SM (an FMA counts 2), the clock the slope implies, and the share of the
data sheet's 67 TFLOP/s.

`run` is the kernel's wrapper: a CUDA tensor launches the kernel, a CPU
tensor goes through `plain`, the same recurrences in torch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from open_duck_playground_torch import cuda_build

TPU_KERNEL = "tools/vpu_issue_bench.py:100"
SOURCE = "issue_probe.cu"
ROUNDS = 32  # unrolled rounds per trip, as the TPU tool
VARIANTS = ("fma", "add", "exp", "sqrt_div")
CHAINS = (1, 2, 4, 8, 16)
# f32 operations per round and chain: FMA = multiply + add; exp = multiply,
# exponential, add; sqrt_div = add, square root, divide
OPS_PER_ROUND = {"fma": 2, "add": 1, "exp": 3, "sqrt_div": 3}
F32_FLOPS = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
X0 = 0.5

# (variant, chains, warps per SM). fma over chains with one warp per
# scheduler; fma over warps at one chain per thread (the megakernel's
# layout); the peak candidates; the other variants at 1 and 8 chains; the
# sqrt/divide chain at the megakernel's ~2 warps per SM.
CONFIGS: Tuple[Tuple[str, int, int], ...] = (
    *(("fma", c, 4) for c in CHAINS),
    *(("fma", 1, w) for w in (1, 2, 8, 16)),
    ("fma", 8, 16), ("fma", 8, 32),
    ("add", 1, 4), ("add", 8, 4),
    ("exp", 1, 4), ("exp", 8, 4),
    ("sqrt_div", 1, 4), ("sqrt_div", 8, 4), ("sqrt_div", 1, 2), ("sqrt_div", 1, 16),
)

# Kernel launches since the last reset; one per `run` on a card.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def constants(chains: int) -> np.ndarray:
    """(2, chains) f32: the a and b of each chain, the TPU tool's values."""
    c = np.arange(chains)
    return np.stack([0.9993 + 7e-5 * c, 1e-4 * (c + 1)]).astype(np.float32)


def plain(variant: str, x: torch.Tensor, trips: int) -> torch.Tensor:
    """The plain version: `trips * ROUNDS` rounds of the recurrence on
    x (chains, n), accumulated in f64, returned in x's dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}, have {VARIANTS}")
    ab = torch.as_tensor(constants(x.shape[0]), device=x.device).double()
    a, b = ab[0][:, None], ab[1][:, None]
    y = x.double()
    for _ in range(trips * ROUNDS):
        if variant == "fma":
            y = y * a + b
        elif variant == "add":
            y = y + b
        elif variant == "exp":
            y = torch.exp(-0.5 * y) + 0.25
        else:
            y = a / torch.sqrt(y + b)
    return y.to(x.dtype)


def reference(variant: str, chains: int, trips: int) -> torch.Tensor:
    """(chains,) f64: each chain after `trips` trips from X0, on the CPU."""
    return plain(variant, torch.full((chains, 1), X0, dtype=torch.float64), trips)[:, 0]


_LIB: Optional[cuda_build.Library] = None


def library() -> cuda_build.Library:
    """The built probe (nvcc at first use)."""
    global _LIB
    if _LIB is None:
        built = cuda_build.build(SOURCE)
        built.lib.probe_rounds.restype = ctypes.c_int
        built.lib.probe_run.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        built.lib.probe_run.restype = ctypes.c_int
        if built.lib.probe_rounds() != ROUNDS:
            raise RuntimeError("ROUNDS differs between issue_probe.cu and the wrapper")
        _LIB = built
    return _LIB


def run(variant: str, x: torch.Tensor, trips: int, threads: int = 128,
        cycles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`trips` trips of `variant` on x (chains, n) f32. On the card: one
    launch of blocks of `threads` threads (n must be a multiple), each
    block's loop cycles written into `cycles` (n / threads, int64) when
    given. On the CPU: the plain version."""
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}, have {VARIANTS}")
    if trips < 0:
        raise ValueError("trips must be >= 0")
    if not x.is_cuda:
        return plain(variant, x, trips)
    chains, n = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("the probe takes a contiguous float32 tensor")
    if chains not in CHAINS:
        raise ValueError(f"{chains} chains, built for {CHAINS}")
    if threads < 1 or threads > 1024 or n % threads:
        raise ValueError(f"{n} threads do not split into blocks of {threads}")
    blocks = n // threads
    if cycles is None:
        cycles = torch.empty(blocks, dtype=torch.int64, device=x.device)
    elif cycles.device != x.device or cycles.dtype != torch.int64 or cycles.numel() != blocks \
            or not cycles.is_contiguous():
        raise TypeError(f"cycles must be {blocks} contiguous int64 on {x.device}")
    ab = torch.as_tensor(constants(chains), device=x.device)
    out = torch.empty_like(x)
    lib = library().lib
    with torch.cuda.device(x.device):
        err = lib.probe_run(VARIANTS.index(variant), chains, x.data_ptr(), ab.data_ptr(),
                            out.data_ptr(), cycles.data_ptr(), trips, blocks, threads,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"issue probe launch failed: CUDA error {err}")
    launches += 1
    return out


def _time(variant: str, x: torch.Tensor, trips: int, threads: int, reps: int) -> Tuple[float, float]:
    """(seconds, mean SM cycles) of one launch, the best of `reps`."""
    cycles = torch.empty(x.shape[1] // threads, dtype=torch.int64, device=x.device)
    run(variant, x, trips, threads, cycles)  # warm
    best = (float("inf"), 0.0)
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(variant, x, trips, threads, cycles)
        end.record()
        torch.cuda.synchronize()
        best = min(best, (start.elapsed_time(end) * 1e-3, float(cycles.double().mean())))
    return best


def measure(variant: str, chains: int, warps_per_sm: int, i1: int = 20_000, i2: int = 100_000,
            reps: int = 3, device="cuda") -> Dict:
    """One config: one block of `warps_per_sm` warps on every SM, timed at
    two trip counts; the slope gives the sustained rate."""
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads = 32 * warps_per_sm
    x = torch.full((chains, sms * threads), X0, dtype=torch.float32, device=dev)
    (t1, c1), (t2, c2) = _time(variant, x, i1, threads, reps), _time(variant, x, i2, threads, reps)
    ops_per_sm = (i2 - i1) * ROUNDS * chains * threads * OPS_PER_ROUND[variant]
    dt, dc = t2 - t1, c2 - c1
    return {
        "variant": variant,
        "chains": chains,
        "warps_per_sm": warps_per_sm,
        "trips": [i1, i2],
        "dt_ms": dt * 1e3,
        "cycles": dc,
        "ops_per_clock_per_sm": ops_per_sm / dc,
        "cycles_per_round": dc / ((i2 - i1) * ROUNDS),
        "clock_ghz": dc / dt * 1e-9,
        "clock_source": "clock64 slope over CUDA-event slope",
        "tflops": ops_per_sm * sms / dt * 1e-12,
        "share_of_67_tflops": ops_per_sm * sms / dt / F32_FLOPS,
    }


def run_configs(configs=CONFIGS, i1: int = 20_000, i2: int = 100_000, device="cuda",
                emit=None) -> List[Dict]:
    rows = []
    for variant, chains, warps in configs:
        rows.append(measure(variant, chains, warps, i1, i2, device=device))
        if emit is not None:
            emit(rows[-1])
    return rows


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                        "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("issue_bench: no CUDA device; the probe measures the card only", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}; name, power limit, sm clock, max sm clock: {card()}",
          file=sys.stderr)
    rows = run_configs(emit=lambda r: print(json.dumps(r), flush=True))
    peak = max(rows, key=lambda r: r["ops_per_clock_per_sm"])
    print(f"\npeak sustained f32 operations per clock per SM: {peak['ops_per_clock_per_sm']:.1f} "
          f"({peak['variant']}, {peak['chains']} chains, {peak['warps_per_sm']} warps per SM, "
          f"{100 * peak['share_of_67_tflops']:.1f}% of 67 TFLOP/s)", file=sys.stderr)
    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
