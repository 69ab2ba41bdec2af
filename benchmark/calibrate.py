"""Readings the limits of `correct` are set from (`benchmark/limits/`), for
one cell, on the card, at the cell's own size, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...] \\
        [--evals <k>] [--out chiprun_out/calibrate_<cell>.json]

For each seed it builds the cell as a run does and drives what the check
compares: the recorded training steps of set-up, or `--evals` whole evals
as the window runs them. Then, with the port's state freed, it reads:

  - `sound`: the port against the reference (the lower readings), and the
    pooled per-env gaps of the env step at several quantiles;
  - on the control seeds, `control`: the reference in TF32 (float32
    products through the tensor cores, the precision below the
    configuration's true f32) put in the port's place, against the
    reference; in the eval, each kept step at the eval's own shape;
  - on the control seeds, faults planted in the reference put in the
    port's place: `state_unchanged` (every control step returns its state;
    in training the update also leaves the parameters as they were),
    `answer_altered` (the reset's observations and every action moved by
    `--alter`), `block` (qvel of one block of 8 envs moved by `--alter` at
    every checked step: the first 8 envs of the sample in training, envs
    120-127 in the eval); in training `half_batch` (each SGD step's loss a
    mean over half of its minibatch) and `skip_minibatches` (every other
    minibatch of each epoch left out).

Prints one JSON line per seed and variant, and a summary: per number the
largest sound reading and the least reading of each other variant."""

from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUANTILES = (0.9, 0.99, 0.995, 0.999, 1.0)
BLOCK = 8


def _with(ns, **kw):
    return types.SimpleNamespace(**{**vars(ns), **kw})


def _moved_block(o, rows: slice, delta: float):
    import torch

    qvel = o.qvel.clone()
    qvel[rows] += delta
    return _with(o, qvel=qvel)


def train_variants(loop, config, traffic, dev, alter: float, control: bool):
    import torch

    from benchmark.harness import check

    rec = loop.record
    numbers = lambda cand, ref: check.train_numbers(cand, ref, rec, traffic)
    ref = check.train_reference(rec, config, traffic, dev)
    prog = check.program_outputs(rec)
    out = {"sound": numbers(prog, ref)}
    gaps = check.pooled_gaps([o for s in prog.steps for o in s.env], [o for s in ref.steps for o in s.env], dev)
    quantiles = {f: {str(q): check.quantile(g, q) for q in QUANTILES} for f, g in gaps.items()}
    if control:
        out["control"] = numbers(check.train_reference(rec, config, traffic, dev, "tf32"), ref)
        for fault in ("half_batch", "skip_minibatches"):
            out[fault] = numbers(check.train_reference(rec, config, traffic, dev, fault=fault), ref)
        states_in = [rec.state0] + [x for st in rec.steps for x in st.states][:-1]
        T = len(rec.steps[0].states)
        unchanged = [_with(s, env=[check.env_out(x) for x in states_in[i * T : (i + 1) * T]],
                           params=[p.clone() for p in rec.params0]) for i, s in enumerate(ref.steps)]
        out["state_unchanged"] = numbers(_with(ref, steps=unchanged), ref)
        altered = [_with(s, actions=s.actions + alter) for s in ref.steps]
        out["answer_altered"] = numbers(_with(ref, steps=altered, reset_obs={k: v + alter for k, v in
                                                                             ref.reset_obs.items()}), ref)
        block = [_with(s, env=[_moved_block(o, slice(0, BLOCK), alter) for o in s.env]) for s in ref.steps]
        out["block"] = numbers(_with(ref, steps=block), ref)
    return out, quantiles


def eval_variants(loop, config, traffic, dev, alter: float, control: bool):
    from benchmark.harness import check

    recs = loop.records
    judge = lambda prec="f32", per_step=False: check.eval_reference(
        recs, config, loop.params0, loop.normalizer0, loop.deterministic, dev, prec, per_step)
    numbers = lambda cands, refs: check.eval_numbers(cands, refs, recs, traffic)
    ref = judge()
    prog = check.eval_program_outputs(recs)
    out = {"sound": numbers(prog, ref)}
    gaps = check.pooled_gaps([s.env for c in prog for s in c.steps], [s.env for r in ref for s in r.steps], dev)
    quantiles = {f: {str(q): check.quantile(g, q) for q in QUANTILES} for f, g in gaps.items()}
    if control:
        out["control"] = numbers(judge("tf32", per_step=True), ref)
        n = loop.num_envs
        each = lambda fn: [_with(r, steps=[fn(s) for s in r.steps]) for r in ref]
        unchanged = [_with(r, steps=[_with(s, env=check.env_out(rec.steps[t].state))
                                     for s, t in zip(r.steps, sorted(rec.steps))]) for r, rec in zip(ref, recs)]
        out["state_unchanged"] = numbers(unchanged, ref)
        out["answer_altered"] = numbers([_with(r, reset_obs={k: v + alter for k, v in r.reset_obs.items()},
                                               steps=[_with(s, action=s.action + alter) for s in r.steps])
                                         for r in ref], ref)
        out["block"] = numbers(each(lambda s: _with(s, env=_moved_block(s.env, slice(n - BLOCK, n), alter))), ref)
    return out, quantiles


def main(argv=None) -> int:
    import torch

    from benchmark.harness import runner

    ap = argparse.ArgumentParser(description="readings for the limits of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--evals", type=int, default=6, help="eval cells: whole evals per seed, as a window runs them")
    ap.add_argument("--alter", type=float, default=1e-2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runner.require_card(1)
    dev = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        cell, config, traffic, _ = runner.prepare(args.workload)
        loop = runner.make_loop(config, traffic, seed, dev)
        t0 = time.time()
        loop.setup()
        if loop.kind == "eval":
            for _ in range(args.evals):
                loop.evaluate(loop.length, traffic["checked_steps_per_eval"])
            loop.replay()
        loop.free()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.time()
        variants = train_variants if loop.kind == "train" else eval_variants
        found, quantiles = variants(loop, config, traffic, dev, args.alter, seed in args.control_seeds)
        t2 = time.time()
        for name, numbers in found.items():
            row = {"workload": args.workload, "seed": seed, "variant": name, "numbers": numbers,
                   "program_s": t1 - t0, "reference_s": t2 - t1}
            if name == "sound":
                row["quantiles"] = quantiles
            rows.append(row)
            print(json.dumps(row), flush=True)
        del loop
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for row in rows:
        for name, v in row["numbers"].items():
            s = summary.setdefault(name, {})
            key = row["variant"]
            if key == "sound":
                s["lower"] = max(s.get("lower", 0.0), v)
            else:
                s[key] = min(s.get(key, float("inf")), v)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(dev), "seeds": args.seeds,
           "control_seeds": args.control_seeds, "summary": summary}
    print(json.dumps(out), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"rows": rows, **out}, indent=1))
    return 0


if __name__ == "__main__":
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
