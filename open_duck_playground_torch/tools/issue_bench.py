"""Measure what one SM of the card sustains on f32 dependency chains.

    python -m open_duck_playground_torch.tools.issue_bench [--csv out.csv]
        [--operands registers constant] [--sass]

Counterpart of `tools/vpu_issue_bench.py` (its Pallas kernel `_build`,
`pl.pallas_call` at :100) with a hand-written CUDA kernel,
`csrc/issue_probe.cu`. The physics megakernel is one long dependent chain
per thread, so its operations bound at the data-sheet peak says little; this
tool measures the rate the card really issues such chains at, by variant
(the TPU tool's `fma`, `add`, `exp`, `col`, `narrow`, and `sqrt_div`),
independent chains per thread (1-16), resident warps per SM (one block per
SM, 1-32 warps) and where the FMA's constants live (`--operands`: per-lane
values in registers, as the megakernel's operands are, or kernel parameters
in uniform registers, the default).

Timing is the two-point slope between two trip counts, so launch and set-up
cancel: CUDA events give seconds, the kernel's own clock64 and %globaltimer
readings give SM cycles and nanoseconds. Each config prints one JSON line:
f32 operations per clock per SM (an FMA counts 2, `narrow` counts its busy
lanes only), the SM clock from the kernel's timers and from the events'
slope, the share of the data sheet's 67 TFLOP/s, and the SMs its blocks ran
on (a config whose blocks shared an SM raises). `--sass` prints, for the
`fma` loop at 1 and 8 chains, the machine code's instructions per trip and
the FFMA's source operands (cuobjdump on the built library).

`run` is the kernel's wrapper: a CUDA tensor launches the kernel, a CPU
tensor goes through `plain`, the same recurrences in torch. After the first
use of a variant and chain count on a card it neither synchronises nor
copies from the host: the constants stay on the device and the timer
scratch is cached.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from open_duck_playground_torch import cuda_build

TPU_KERNEL = "tools/vpu_issue_bench.py:100"
SOURCE = "issue_probe.cu"
ROUNDS = 32  # unrolled rounds per trip, as the TPU tool
VARIANTS = ("fma", "add", "exp", "col", "narrow", "sqrt_div")  # the order of issue_probe.cu
CHAINS = (1, 2, 4, 8, 16)
# Where an FMA's a and b live (the order of issue_probe.cu): per-lane values
# in registers (an FFMA reads three registers, as the megakernel's FMAs on
# per-lane data do), or kernel parameters the compiler keeps in uniform
# registers (an FFMA reads two registers). The kernel takes the second: one
# chain per thread then issues at the full rate, not half (PERF.md, section 6).
OPERANDS = ("registers", "constant")
DEFAULT_OPERANDS = "constant"
NARROW_LANES = 4  # busy lanes of each warp in `narrow`
TIMERS = ("sm", "clock_start", "clock_end", "ns_start", "ns_end")  # per block
# f32 operations per round and chain: FMA = multiply + add; exp = multiply,
# exponential, add; sqrt_div = add, square root, divide
OPS_PER_ROUND = {"fma": 2, "add": 1, "exp": 3, "col": 2, "narrow": 2, "sqrt_div": 3}
COL_AB = (0.9997, 1.3e-4)  # the TPU tool's one a, b of `col`
F32_FLOPS = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
X0 = 0.5

# (variant, chains, warps per SM). fma over chains with one warp per
# scheduler; fma over warps at one chain per thread (the megakernel's
# layout); the peak candidates; the other variants at 1 and 8 chains, col
# and narrow at the TPU tool's chain counts; the sqrt/divide chain at the
# megakernel's ~2 warps per SM.
CONFIGS: Tuple[Tuple[str, int, int], ...] = (
    *(("fma", c, 4) for c in CHAINS),
    *(("fma", 1, w) for w in (1, 2, 8, 16)),
    ("fma", 8, 16), ("fma", 8, 32),
    ("add", 1, 4), ("add", 8, 4),
    ("exp", 1, 4), ("exp", 8, 4),
    ("col", 2, 4), ("col", 4, 4), ("col", 8, 4),
    ("narrow", 1, 4), ("narrow", 8, 4),
    ("sqrt_div", 1, 4), ("sqrt_div", 8, 4), ("sqrt_div", 1, 2), ("sqrt_div", 1, 16),
)

# Kernel launches since the last reset; one per `run` on a card.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def constants(variant: str, chains: int) -> np.ndarray:
    """(2, chains) f32: the a and b of each chain, the TPU tool's values
    (`col`: one a, b for all)."""
    if variant == "col":
        return np.repeat(np.float32(COL_AB)[:, None], chains, axis=1)
    c = np.arange(chains)
    return np.stack([0.9993 + 7e-5 * c, 1e-4 * (c + 1)]).astype(np.float32)


def plain(variant: str, x: torch.Tensor, trips: int) -> torch.Tensor:
    """The plain version: `trips * ROUNDS` rounds of the recurrence on
    x (chains, n), accumulated in f64, returned in x's dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}, have {VARIANTS}")
    ab = torch.as_tensor(constants(variant, x.shape[0]), device=x.device).double()
    a, b = ab[0][:, None], ab[1][:, None]
    y = x.double()
    for _ in range(trips * ROUNDS):
        if variant == "add":
            y = y + b
        elif variant == "exp":
            y = torch.exp(-0.5 * y) + 0.25
        elif variant == "sqrt_div":
            y = a / torch.sqrt(y + b)
        else:  # fma, col, narrow
            y = y * a + b
    return y.to(x.dtype)


def reference(variant: str, chains: int, trips: int) -> torch.Tensor:
    """(chains,) f64: each chain after `trips` trips from X0, on the CPU."""
    return plain(variant, torch.full((chains, 1), X0, dtype=torch.float64), trips)[:, 0]


def per_block(variant: str, threads: int) -> int:
    """Elements a block of `threads` threads carries: one a thread, or for
    `narrow` NARROW_LANES a warp."""
    return threads // 32 * NARROW_LANES if variant == "narrow" else threads


def blocks_for(variant: str, n: int, threads: int) -> int:
    """Blocks of `threads` threads that carry n elements; raises where they
    do not split evenly."""
    if threads < 1 or threads > 1024 or (variant == "narrow" and threads % 32):
        raise ValueError(f"{threads} threads per block ({variant} takes whole warps)")
    if n % per_block(variant, threads):
        raise ValueError(f"{n} elements do not split into blocks of {per_block(variant, threads)}")
    return n // per_block(variant, threads)


_LIB: Optional[cuda_build.Library] = None
# (variant, chains, device) -> (the constants on the device, on the host, and their addresses)
_CONSTANTS: Dict[Tuple[str, int, torch.device], Tuple[torch.Tensor, np.ndarray, int, int]] = {}
_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}  # (device, blocks) -> timers


def library() -> cuda_build.Library:
    """The built probe (nvcc at first use)."""
    global _LIB
    if _LIB is None:
        built = cuda_build.build(SOURCE)
        lib = built.lib
        for name in ("probe_rounds", "probe_narrow_lanes", "probe_timers", "probe_smem_bytes"):
            getattr(lib, name).restype = ctypes.c_int
        lib.probe_run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        lib.probe_run.restype = ctypes.c_int
        if (lib.probe_rounds(), lib.probe_narrow_lanes(), lib.probe_timers()) != \
                (ROUNDS, NARROW_LANES, len(TIMERS)):
            raise RuntimeError("ROUNDS, NARROW_LANES or TIMERS differ between issue_probe.cu and the wrapper")
        _LIB = built
    return _LIB


def _device_constants(variant: str, chains: int, device: torch.device) -> Tuple[int, int]:
    """Pointers to the constants on `device`, (2, chains, 32), and on the
    host, (2, chains). The copy to the device is made once, at first use, and
    is the wrapper's only synchronisation."""
    key = (variant, chains, device)
    if key not in _CONSTANTS:
        host = constants(variant, chains)
        per_lane = torch.as_tensor(np.repeat(host[:, :, None], 32, axis=2), device=device)
        _CONSTANTS[key] = (per_lane, host, per_lane.data_ptr(), host.ctypes.data)
    return _CONSTANTS[key][2:]


def _scratch(device: torch.device, blocks: int) -> torch.Tensor:
    key = (device, blocks)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.empty((blocks, len(TIMERS)), dtype=torch.int64, device=device)
    return _SCRATCH[key]


def run(variant: str, x: torch.Tensor, trips: int, threads: int = 128,
        timers: Optional[torch.Tensor] = None, operands: str = DEFAULT_OPERANDS) -> torch.Tensor:
    """`trips` trips of `variant` on x (chains, n) f32. On the card: one
    launch of blocks of `threads` threads, each block alone on its SM
    (n must split into blocks: `blocks_for`); each block's TIMERS are
    written into `timers` (blocks, 5) int64 when given, else into a cached
    scratch. On the CPU: the plain version."""
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}, have {VARIANTS}")
    if operands not in OPERANDS:
        raise ValueError(f"operands {operands!r}, have {OPERANDS}")
    if trips < 0:
        raise ValueError("trips must be >= 0")
    if not x.is_cuda:
        return plain(variant, x, trips)
    chains, n = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("the probe takes a contiguous float32 tensor")
    if chains not in CHAINS:
        raise ValueError(f"{chains} chains, built for {CHAINS}")
    blocks = blocks_for(variant, n, threads)
    if timers is None:
        timers = _scratch(x.device, blocks)
    elif timers.device != x.device or timers.dtype != torch.int64 or \
            timers.shape != (blocks, len(TIMERS)) or not timers.is_contiguous():
        raise TypeError(f"timers must be ({blocks}, {len(TIMERS)}) contiguous int64 on {x.device}")
    ab_dev, ab_host = _device_constants(variant, chains, x.device)
    out = torch.empty_like(x)
    dev = x.device.index
    # the current stream's handle as an int, as Triton and Inductor read it:
    # `torch.cuda.current_stream(...)` builds a Stream object, several us a launch
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = library().lib.probe_run(VARIANTS.index(variant), chains, OPERANDS.index(operands), dev,
                                  x.data_ptr(), ab_dev, ab_host, out.data_ptr(), timers.data_ptr(), trips,
                                  blocks, threads, stream)
    if err:
        raise RuntimeError(f"issue probe launch failed: CUDA error {err}")
    launches += 1
    return out


def _time(variant: str, x: torch.Tensor, trips: int, threads: int, reps: int,
          operands: str) -> Tuple[float, np.ndarray]:
    """(seconds, TIMERS of every block) of one launch, the fastest of `reps`."""
    timers = torch.empty((x.shape[1] // per_block(variant, threads), len(TIMERS)), dtype=torch.int64,
                         device=x.device)
    run(variant, x, trips, threads, timers, operands)  # warm
    best: Tuple[float, Optional[np.ndarray]] = (float("inf"), None)
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(variant, x, trips, threads, timers, operands)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) * 1e-3
        if seconds < best[0]:
            best = (seconds, timers.cpu().numpy())
    return best


def rates(variant: str, chains: int, warps_per_sm: int, operands: str, trips: Sequence[int],
          seconds: Sequence[float], timers: Sequence[np.ndarray]) -> Dict:
    """One config's JSON line from its two launches (`trips` i1 < i2, event
    seconds, TIMERS per block). Raises if two blocks of either launch ran
    on one SM: the rate per SM would be wrong."""
    blocks = len(timers[0])
    for t in timers:
        sms = np.unique(t[:, 0])
        if len(sms) != len(t):
            raise RuntimeError(f"{variant}/{chains}/{warps_per_sm}: {len(t)} blocks of a one-block-per-SM "
                               f"launch ran on {len(sms)} SMs")
    (i1, i2), (t1, t2) = trips, seconds
    cycles = [float((t[:, 2] - t[:, 1]).mean()) for t in timers]
    ns = [float((t[:, 4] - t[:, 3]).mean()) for t in timers]
    dc, dns, dt = cycles[1] - cycles[0], ns[1] - ns[0], t2 - t1
    ops_per_sm = (i2 - i1) * ROUNDS * chains * per_block(variant, 32 * warps_per_sm) * OPS_PER_ROUND[variant]
    return {
        "variant": variant,
        "chains": chains,
        "warps_per_sm": warps_per_sm,
        "operands": operands,
        "trips": [i1, i2],
        "dt_ms": dt * 1e3,
        "cycles": dc,
        "ops_per_clock_per_sm": ops_per_sm / dc,
        "cycles_per_round": dc / ((i2 - i1) * ROUNDS),
        "clock_ghz_kernel": dc / dns,  # clock64 slope over %globaltimer slope, in the kernel
        "clock_ghz_events": dc / (dt * 1e9),  # clock64 slope over the CUDA events' slope
        "tflops": ops_per_sm * blocks / dt * 1e-12,
        "share_of_67_tflops": ops_per_sm * blocks / dt / F32_FLOPS,
        "blocks": blocks,
        "distinct_sms": int(min(len(np.unique(t[:, 0])) for t in timers)),
    }


def measure(variant: str, chains: int, warps_per_sm: int, i1: int = 20_000, i2: int = 100_000,
            reps: int = 3, device="cuda", operands: str = DEFAULT_OPERANDS) -> Dict:
    """One config: one block of `warps_per_sm` warps on every SM, timed at
    two trip counts; the slope gives the sustained rate."""
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads = 32 * warps_per_sm
    x = torch.full((chains, sms * per_block(variant, threads)), X0, dtype=torch.float32, device=dev)
    (t1, c1), (t2, c2) = (_time(variant, x, i, threads, reps, operands) for i in (i1, i2))
    return rates(variant, chains, warps_per_sm, operands, (i1, i2), (t1, t2), (c1, c2))


def run_configs(configs=CONFIGS, i1: int = 20_000, i2: int = 100_000, device="cuda",
                operands: str = DEFAULT_OPERANDS, emit=None) -> List[Dict]:
    rows = []
    for variant, chains, warps in configs:
        rows.append(measure(variant, chains, warps, i1, i2, device=device, operands=operands))
        if emit is not None:
            emit(rows[-1])
    return rows


# --- the machine code -------------------------------------------------------

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_KERNEL = re.compile(r"probe_kernel\D*Li(\d+)ELi(\d+)ELi(\d+)E")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
_OPCODE = {"fma": "FFMA", "col": "FFMA", "narrow": "FFMA", "add": "FADD"}


def parse_functions(text: str) -> Dict[str, List[Tuple[int, str]]]:
    """`cuobjdump -sass` (or `nvdisasm`) output -> {mangled function name:
    [(address, instruction)]}, with branch targets given by label rewritten
    to addresses."""
    functions: Dict[str, List[Tuple[int, str]]] = {}
    body: List[Tuple[int, str]] = []
    labels: Dict[str, int] = {}
    pending: List[str] = []

    def close():
        for i, (addr, instr) in enumerate(body):
            b = _BRANCH.search(instr)
            if b and b.group(1):
                body[i] = (addr, instr.replace(f"`({b.group(1)})", hex(labels[b.group(1)])))

    for line in text.splitlines():
        f = _FUNCTION.search(line)
        if f:
            close()
            body, labels, pending = [], {}, []
            functions[f.group(1)] = body
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = _INSTR.search(line)
        if ins:
            addr = int(ins.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            body.append((addr, ins.group(2)))
    close()
    return functions


def parse_sass(text: str) -> Dict[Tuple[str, int, str], List[Tuple[int, str]]]:
    """The probe's kernels of `cuobjdump -sass` output: {(variant, chains,
    operands): [(address, instruction)]}."""
    kernels = {}
    for name, body in parse_functions(text).items():
        k = _KERNEL.search(name)
        if k:
            kernels[(VARIANTS[int(k.group(1))], int(k.group(2)), OPERANDS[int(k.group(3))])] = body
    return kernels


def _split(instr: str) -> Tuple[str, List[str]]:
    """(opcode without modifiers, operands) of one instruction."""
    words = instr.split(None, 1) if not instr.startswith("@") else instr.split(None, 2)[1:]
    return words[0].split(".")[0], re.split(r",\s*", words[1]) if len(words) > 1 else []


def hot_loop(instrs: List[Tuple[int, str]], opcode: str) -> List[Tuple[int, str]]:
    """The body of the backward branch that holds the most `opcode`
    instructions."""

    def n_op(body):
        return sum(_split(i)[0] == opcode for _, i in body)

    best: List[Tuple[int, str]] = []
    for addr, instr in instrs:
        b = _BRANCH.search(instr)
        if b and b.group(2) and int(b.group(2), 16) <= addr:
            body = [(a, i) for a, i in instrs if int(b.group(2), 16) <= a <= addr]
            if n_op(body) > n_op(best):
                best = body
    return best


def loop_report(instrs: List[Tuple[int, str]], variant: str, chains: int) -> Dict:
    """The hot loop of one kernel (the backward branch whose body holds the
    most of the variant's operation): instructions per trip by opcode, and
    the operation's source operands."""
    op = _OPCODE[variant]
    best = hot_loop(instrs, op)
    counts = Counter(_split(i)[0] for _, i in best)
    trips = counts[op] / (ROUNDS * chains)
    sources = [_split(i)[1][1:] for _, i in best if _split(i)[0] == op]
    return {
        "opcode": op,
        "loop_instructions": len(best),
        "trips_per_loop": trips,
        "instructions_per_trip": len(best) / trips if trips else None,
        "per_trip_by_opcode": {k: v / trips for k, v in sorted(counts.items())} if trips else {},
        "ops_with_constant_bank_source": sum(any(s.startswith("c[") for s in src) for src in sources),
        "register_sources_with_reuse": sum(".reuse" in s for src in sources for s in src),
        "first": [i for _, i in best if _split(i)[0] == op][:4],
    }


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found beside nvcc")


def sass_report(cases: Sequence[Tuple[str, int]] = (("fma", 1), ("fma", 8)),
                operands: Sequence[str] = OPERANDS) -> List[Dict]:
    """`loop_report` of each (variant, chains) in each operand placement,
    read from the built library's machine code."""
    r = subprocess.run([cuobjdump(), "-sass", str(library().path)], capture_output=True, text=True,
                       check=True, timeout=300)
    kernels = parse_sass(r.stdout)
    return [{"variant": v, "chains": c, "operands": o, **loop_report(kernels[(v, c, o)], v, c)}
            for v, c in cases for o in operands]


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                        "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csv", default=None)
    ap.add_argument("--operands", nargs="+", choices=OPERANDS, default=[DEFAULT_OPERANDS])
    ap.add_argument("--sass", action="store_true", help="print the fma loop's machine code per trip")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("issue_bench: no CUDA device; the probe measures the card only", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}; name, power limit, sm clock, max sm clock: {card()}",
          file=sys.stderr)
    if args.sass:
        for r in sass_report(operands=args.operands):
            print(json.dumps({"sass": True, **r}), flush=True)
    rows = [r for o in args.operands
            for r in run_configs(operands=o, emit=lambda r: print(json.dumps(r), flush=True))]
    peak = max(rows, key=lambda r: r["ops_per_clock_per_sm"])
    print(f"\npeak sustained f32 operations per clock per SM: {peak['ops_per_clock_per_sm']:.1f} "
          f"({peak['variant']}, {peak['chains']} chains, {peak['warps_per_sm']} warps per SM, "
          f"{peak['operands']}, {100 * peak['share_of_67_tflops']:.1f}% of 67 TFLOP/s)", file=sys.stderr)
    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
