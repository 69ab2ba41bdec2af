"""The benchmark of `open_duck_playground_torch` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` (from the repository's root, on the
machine it is started on) and prints, as the last line of its standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics; with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `checks`: each number the
reference compared, beside its limit. The same numbers are the last lines
of its standard error. It exits with another code than 0 and prints no
result when there is no card (or fewer than the cell asks for), when a run
loaded JAX or the JAX package, or when anything else fails.

Kernel builds stay inside the checkout: the port builds its CUDA kernels
into `build/kernels/`, and the caches of Triton and of PyTorch's extension
builds are pointed at `build/bench_cache/`. The process keeps one thread of
CPU work (`OMP_NUM_THREADS=1`, one intra-op and one inter-op thread of
PyTorch): the port's work is on the card, and idle worker threads spinning
beside the launching thread on a shared host slow it by a varying amount.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import torch

    from benchmark.harness import runner  # after the caches are set

    started = runner.process_start()
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    ap = argparse.ArgumentParser(description="one cell of BENCHMARK.json on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    except runner.RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
