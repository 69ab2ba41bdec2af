"""Dry run of data-parallel PPO on the CPU: n processes joined by gloo each
run two full training steps of `ppo.train` (rollout with per-env domain
randomization, normalizer, GAE, minibatch SGD) on their shard of the envs,
and the result is held against a one-process run of the same seed.

    python -m open_duck_playground_torch.parallel.dryrun [--n 2]   # n cards, NCCL
    python -m open_duck_playground_torch.parallel.dryrun --n 2 --device cpu   # gloo

Counterpart of leg 1 of `__graft_entry__.dryrun_multichip`: toy widths and
`k_unrolls` 1 and 2. Its leg 2 (the Pallas kernel under a sharded program)
has no counterpart: each rank launches the CUDA kernel on its own card's
shard. On the card (the default) rank r runs on `cuda:r` over NCCL, the
one-process run on `cuda:0`, the physics through the kernel; with
`--device cpu` the processes join over gloo and the physics is the plain
engine (`forward.step_reference`, the physics of a CPU tensor).

Tolerance: `RTOL`, `ATOL`, those of the JAX package's two-process test
(tests/test_multihost.py); the two runs differ only in the order of float
sums (all-reduces, per-rank partial sums of the loss and its gradient).
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import queue as queue_lib
import socket
import time
from typing import Dict, Sequence

import numpy as np
import torch

from open_duck_playground_torch.tools import benchutil

RTOL, ATOL = 2e-4, 2e-5
TASK = "flat_terrain_backlash"
TRAINING_STEPS = 2
# toy widths; batch_size follows from k_unrolls (batch * minibatches = k * envs)
TOY = dict(num_envs=16, episode_length=8, unroll_length=2, num_minibatches=2, num_updates_per_batch=2,
           num_evals=1, seed=7, policy_hidden_layer_sizes=(32, 32), value_hidden_layer_sizes=(32, 32))


def toy_config(k_unrolls: int) -> dict:
    return {**TOY, "batch_size": k_unrolls * TOY["num_envs"] // TOY["num_minibatches"]}


def run(k_unrolls: int, mesh=None, device="cuda") -> Dict[str, np.ndarray]:
    """Two training steps on `device` (the mesh's, under a mesh); returns
    the parameters, the normalizer's mean and std, and the loss (the mean
    over both steps), on the host."""
    from open_duck_playground_torch.envs.joystick import Joystick
    from open_duck_playground_torch.envs.randomize import domain_randomize
    from open_duck_playground_torch.train import ppo
    from open_duck_playground_torch.train.config import PPOConfig

    dev = mesh.device if mesh is not None else torch.device(device)
    cfg = PPOConfig(**toy_config(k_unrolls))
    _, (normalizer, net), metrics = ppo.train(
        Joystick(TASK, device=dev), num_timesteps=TRAINING_STEPS * cfg.steps_per_training_step,
        config=cfg, device=dev, randomization_fn=domain_randomize, mesh=mesh)
    out = {f"param/{name}": p.detach().cpu().numpy() for name, p in net.named_parameters()}
    for field in ("mean", "std"):
        out.update({f"normalizer/{field}/{k}": v.cpu().numpy() for k, v in getattr(normalizer, field).items()})
    out["count"] = np.asarray(float(normalizer.count))
    out["total_loss"] = np.asarray(metrics["training/total_loss"])
    return out


def _worker(rank: int, world: int, port: int, k_unrolls: int, device: str, results, timeout_s: float) -> None:
    import torch.distributed as dist

    from open_duck_playground_torch.parallel import mesh as M

    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
    M.initialize_multihost(f"127.0.0.1:{port}", world, rank, dev, datetime.timedelta(seconds=timeout_s))
    try:
        results.put((rank, run(k_unrolls, M.make_mesh(dev))))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A port the OS had free a moment ago (bound, then closed)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(n: int, k_unrolls: int, device: str = "cuda",
                  timeout_s: float = 600.0) -> Sequence[Dict[str, np.ndarray]]:
    """`run` in n spawned processes over an NCCL group, rank r on card r
    (a gloo group on `cpu`); their results by rank."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(rank, n, port, k_unrolls, device, results, timeout_s))
             for rank in range(n)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < n:
            try:
                rank, res = results.get(timeout=1.0)
                out[rank] = res
            except queue_lib.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    raise RuntimeError(f"dry run: {n - len(out)} of {n} processes gave no result "
                                       f"(exit codes {[p.exitcode for p in procs]})") from None
        for p in procs:
            p.join(timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dry run: processes exited with {bad}")
    return [out[r] for r in range(n)]


def margin(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / (ATOL + RTOL |want|): below 1 is within tolerance."""
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want)), initial=0.0))


def dryrun_multigpu(n: int, k_unrolls: Sequence[int] = (1, 2), device: str = "cuda",
                    timeout_s: float = 600.0) -> dict:
    """Per k in `k_unrolls`: n >= 2 processes against one process, on n
    cards (NCCL) or, with `device="cpu"`, on the CPU (gloo); a missing card
    raises SystemExit, never a fall-back to the CPU. Raises unless every rank
    ends with the same parameters and normalizer and the loss, parameters
    and normalizer are within (RTOL, ATOL) of the one-process run. Returns
    per k the worst `margin` and its key."""
    if n < 2:
        raise ValueError(f"a dry run needs 2 or more processes, got {n}")
    benchutil.measured_device(device)
    report = {}
    for k in k_unrolls:
        want = run(k, device="cuda:0" if device == "cuda" else device)
        ranks = run_processes(n, k, device, timeout_s)
        for r, res in enumerate(ranks[1:], 1):
            for key, v in res.items():
                if not np.array_equal(v, ranks[0][key]):
                    raise AssertionError(f"k={k}: rank {r} and rank 0 differ in {key}")
        got = ranks[0]
        if set(got) != set(want):
            raise AssertionError(f"k={k}: results differ in their keys")
        margins = {key: margin(got[key], want[key]) for key in want}
        worst = max(margins, key=margins.get)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=f"k={k} {key}")
        report[k] = {"worst_margin": margins[worst], "worst_key": worst,
                     "loss": float(got["total_loss"]), "loss_one_process": float(want["total_loss"])}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    print(dryrun_multigpu(args.n, device=args.device))
    print(f"dryrun_multigpu OK on {args.n} processes ({args.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
