#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (a phase that has several kernels prints several):
  1. device: the card's name and power limit;
  2. build: nvcc builds, side by side, the physics megakernel for the plane
     scene, for the heightfield scene (-DMK_HFIELD=1), for the plane scene
     on the degenerate (dense) partition, for the robot without backlash
     joints on the plane (flat_terrain) and for the robot without its head
     (flat_terrain_no_head), the issue-rate probe, and the plane and
     heightfield builds again with -lineinfo, from csrc/ into
     build/kernels/; each megakernel line carries lanes per env, shared
     bytes per block, local bytes per thread and resident warps per SM;
  3. kernel_vs_plain, kernel_timing: each megakernel build against its plain
     version (`forward.step_reference`) at 8192 domain-randomized envs,
     substep by substep along the kernel's trajectory and over 10 substeps
     in one launch, with times (also at 4x the envs) and the card's least
     time for the same work; the heightfield run spreads the envs over
     +-3 m of rough terrain and must see active contacts on tilted
     triangles; the degenerate partition runs the same check at 1024 envs,
     and the plane build at the evaluator's shape (128 envs, nominal model);
  3b. task_kernels: the task's two kernels (tk_pre, tk_post) at the eval's
     and the rollout's batch (128 and 8192 envs), in the joystick build
     (joystick / flat_terrain_backlash) and in the standing build
     (standing / flat_terrain): one fused step
     against the eager body from the same state (physics state, integer
     and bool leaves bit for bit, floats within tests/task_kernel_check.py's
     ULPS of each column's
     scale), their device ms (a CUDA graph of the two, replayed under CUDA
     events), the eager body's ms less its physics launch, the bytes-bound
     ms; their launches per control step are phase profile's;
  3c. wrapper_kernels: the wrapper's two kernels (wr_pre, wr_post) at the
     eval's and the rollout's batch on joystick / flat_terrain_backlash,
     with the task's step stood in for by one real step's outputs (NaN and
     inf planted in them, half the envs done before): the fused wrapper step
     of `EvalEnv` against its eager body, every leaf bit for bit; their
     device ms (a replay of a CUDA graph of the two), the eager body's ms,
     the bytes-bound ms and ptxas's registers;
  4. rollout: the training rollout (TrainingEnv + Joystick on
     flat_terrain_backlash, the 128x4 policy in the loop), 8192 envs x 5
     control steps, every physics step through the plane kernel;
  5. issue_probe: `tools.issue_bench` over its configs (each checks that
     its blocks ran on distinct SMs, and gives the SM clock from the
     kernel's own timers and from the events), the FMA configs again with
     the constants in the other operand placement, the fma loop's machine
     code per trip (cuobjdump), every variant, chain count and placement
     against its plain version at a small trip count, and row 2's timing
     with the wrapper under `torch.cuda.set_sync_debug_mode("error")`;
  6. ppo_step: `train.ppo.training_step` on Joystick("rough_terrain_backlash")
     at the full PPO config (8192 envs, unroll 20, 4 x 32 minibatches of
     256), 2 steps after a warm-up step, every physics step through the
     heightfield kernel; then 10 pairs of steps with the normalizer's
     moments summed in f64 (the default) and in f32, in alternating order,
     and `accumulate_moments` alone in each dtype;
  7. cli: `cli.runner.main` at the full PPO config on joystick /
     flat_terrain_backlash into a temporary directory: an initial eval, one
     training step and an eval (num_evals=2), then a resume from the last
     checkpoint (num_evals=3: an eval at the restored step, one training
     step, an eval); every checkpoint and .onnx file is checked, each .onnx
     through the numpy runtime against the torch deterministic action, and
     the resume must continue env_steps, Adam's step and the generator;
     eval (128 envs x 1000 control steps) and training physics through the
     plane kernel;
  8. standing: one full-width training step of standing / flat_terrain with
     head_direct_targets (the head servos must take the head commands),
     every physics step through the flat_terrain build and every env step
     a fused step of the task kernels' standing build;
  9. no_head: `cli.runner.main` at the full PPO config on joystick /
     flat_terrain_no_head with the no-head training recipe (rsi_prob 0.5,
     progress 6, yaw_rate_l1 -3, lin_vel_l1 -2): one training step and an
     eval (num_evals=1), in f32 and again with bf16_matmuls; each .onnx
     against the torch deterministic action of its checkpoint, every
     physics step through the no-head build; and the time of a reset of
     8192 envs with and without reference-state init;
 10. deploy: the part of the deployment path that runs without C-MuJoCo
     (this machine has no mujoco): every .onnx of phases 7 and 9 through
     the port's validator (`export.onnx_validate`) before its temporary
     directory goes, with the ms per file; the native C++ runtime
     (`export.native_runtime`), built with the host's g++, against the numpy
     runtime and the torch deterministic action of each file's checkpoint on
     its 128 eval observations (within 1e-5), with the us per `infer` of
     both on the host CPU; the 25 reward terms and the imitation reward on
     the card at 8192 rows against `eval_tools.rewards_numpy` row by row
     (rtol 2e-5, atol 2e-6); the numpy gait oracle against the torch one
     (within one f32 ulp); and the eval tools' modules import without
     mujoco or matplotlib;
 11. bench: the three bench tools through their own `main(argv)`, each
     printing its JSON line as it comes: `tools.bench_rollout` at 4096 and
     8192 envs (50 control steps x 2 timed runs, after 2 warm-up runs),
     `tools.bench_physics` on flat_terrain_backlash, flat_terrain,
     rough_terrain_backlash and flat_terrain_no_head (4096 envs x 50
     launches), and `tools.bench_ppo_sustained` on flat_terrain_backlash at
     327,680 steps (two periods of one full-width training step, three
     evals);
 12. mesh: one full-width training step of `ppo.train` on
     flat_terrain_backlash from the same seed, four times in turns: without
     a mesh, twice with a one-rank NCCL mesh (`parallel.mesh.make_mesh
     ("cuda")`), without again; parameters and normalizer must agree within
     1e-6 (a one-rank all-reduce is an identity), and each run's rollout
     and update seconds are printed;
 13. profile: the profiling tools through their own `main(argv)`:
     `tools.profile_step` (4096 envs x 50 steps: physics, env step,
     run_eval's control step with the env step's CUDA graph and with its
     body eager, gait oracle, each traced; 95% of each control step's
     launches inside the program's spans; under the graph the task and the
     physics launch nothing, the body eager launches from both),
     `tools.profile_train_step`
     at the full config (its eval cut to 128 envs x 200 steps; one control
     step and one SGD step traced: launches, host syncs, idle share, top
     kernels, by layer; each trace must hold a device event for every
     launch, `benchutil.coverage`), every `tools.profile_epoch` variant (the ones that
     compute the production epoch, the CUDA-graph ones included, within a
     relative 1e-5 of its parameters), `tools.profile_shuffle` (every
     permuting strategy equals the production minibatches bit for bit), and
     `tools.count_kernel_ops`: its FFMA classes against `issue_bench`'s
     reading of the probe's loops, then `--slots` on every megakernel build
     and `--by_line` on rows 1 and 1h (whose -lineinfo census must equal
     the production build's); each megakernel row gets its census;
 14. learn: `cli.runner.main` at the full PPO config on joystick /
     flat_terrain_backlash, seed 0, num_evals=2: the initial eval, 40
     training steps (6,553,600 env steps) and an eval. The second eval's
     reward must be at least 3x the first and at least LEARN_BAR, a bar
     set at 70% of the lower of three seeds' readings at that point
     (PERF.md, "Training outcome on the card"); the line prints both
     readings and the bar. A trainer that runs but no longer learns (a
     broken optimizer, reward or normalizer) fails here. The run's own
     `metrics.jsonl` must log the kernel launches counted here, and every
     env step of the run must be a fused task step (`task_kernel`) and a
     fused wrapper step (`wrapper_kernel`).
Then the kernel table, the nvidia-smi line, and `{"ok": true, ...}` last.
Exits non-zero, printing no result, without a CUDA card or when a phase
fails. Needs no network; the kernel builds count against the run.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

N_ENVS = 8192
N_ENVS_DENSE = 1024  # the degenerate partition's check: no training path runs it
N_SUBSTEPS = 10
CLI_TASK = "flat_terrain_backlash"
CLI_STEPS = 163_840  # one training step at the full PPO config
BENCH_STEPS, BENCH_REPS = 50, 2  # bench_rollout, cut from bench.py's 500 x 3 to fit the run
# bench_physics: the scenes it runs, each with the kernel build it launches
BENCH_PHYSICS_BUILDS = {"flat_terrain_backlash": "megakernel_step", "flat_terrain": "megakernel_step_flat_terrain",
                        "rough_terrain_backlash": "megakernel_step_hfield",
                        "flat_terrain_no_head": "megakernel_step_flat_terrain_no_head"}
MESH_TOLERANCE = 1e-6
# task: the task kernels at the eval's and the rollout's batch; a fused
# step's observations, rewards and metrics within tests/task_kernel_check.py's
# ULPS of each column's largest magnitude of the eager step's (sums over a
# row in another order than PyTorch's reductions), the physics state and
# every integer and bool leaf bit for bit
TASK_ENVS = (128, 8192)
# profile: the profiling tools through their main(argv). profile_step at
# 4096 envs, cut from the JAX tool's 500 chained steps to 50 (3 timed runs);
# profile_train_step at the full config, its eval cut from 1000 control
# steps to 200 and timed once; every profile_epoch variant, 1 warm-up + 2
# timed epochs, each variant that computes the production epoch within a
# relative 1e-5 of its parameters (max |a - b| over max |b|, all parameters)
# after one epoch from the same state and draws (float sums in another
# order; the graph variants' capturable Adam rounds otherwise), and each graph
# variant within 1e-5 of the same epoch run eagerly with its own Adam;
# count_kernel_ops --slots on every megakernel build, --by_line on rows 1
# and 1h (their -lineinfo builds made in phase build)
PROFILE_STEPS, PROFILE_STEP_REPS = 50, 3
PROFILE_EVAL_STEPS, PROFILE_TRAIN_REPS = 200, 2
PROFILE_EPOCH_TOLERANCE = 1e-5
PROFILE_BY_LINE = ("megakernel_step", "megakernel_step_hfield")
CENSUS_BUILDS = {"megakernel_step": ("flat_terrain_backlash", False),
                 "megakernel_step_flat_terrain": ("flat_terrain", False),
                 "megakernel_step_hfield": ("rough_terrain_backlash", False),
                 "megakernel_step_dense": ("flat_terrain_backlash", True),
                 "megakernel_step_flat_terrain_no_head": ("flat_terrain_no_head", False)}
# learn: 40 training steps between the two evals; the second eval's reward
# must reach LEARN_GAIN x the first and LEARN_BAR, which is 70% of the lowest
# of seeds 0, 1, 2's readings at 6,553,600 env steps through the CLI
# (PERF.md, "Training outcome on the card", NVIDIA H100 80GB HBM3, 700 W)
LEARN_STEPS = 40 * CLI_STEPS
LEARN_GAIN = 3.0
LEARN_BAR = 73.0
# ppo_step: training steps of f64 moment sums (running_stats' default) against
# f32, in alternating pairs; calls of accumulate_moments alone per turn
MOMENTS_PAIRS, MOMENTS_CALLS = 10, 200
# RESULTS.md's no-head recipe (the last round), as the CLI takes it
NO_HEAD_RECIPE = ["rsi_prob=0.5", "reward_config.scales.progress=6.0",
                  "reward_config.scales.yaw_rate_l1=-3.0", "reward_config.scales.lin_vel_l1=-2.0"]
ONNX_TOLERANCE = 1e-5
# deploy: reward terms on the card against their numpy mirrors (the JAX
# package's own mirror test's tolerances), rows of each; single-observation
# inference passes per file; the torch gait oracle's table is the f64
# frames rounded to f32, so it is held within one f32 ulp (relative 2^-23)
# of the numpy oracle's f64 frames (frame values reach 32, so an absolute
# gate would be an ulp there and too loose near 0)
REWARD_RTOL, REWARD_ATOL, DEPLOY_REWARD_ROWS = 2e-5, 2e-6, 8192
DEPLOY_INFER_REPS = 10
GAIT_RTOL = 2.0 ** -23
# Per-env gates of the kernel against its plain version, (p90, max), the
# interpret-mode test's tolerances (test_megakernel_interpret.py). The
# kernel steps the envs one substep per launch, 10 times; each substep is
# held against one plain substep from the same state, and every env of every
# substep must be within max. The one 10-substep launch must give exactly
# that trajectory, and p90 holds for it against 10 free-running plain
# substeps (a few envs part later).
#
# An env at an edge: where the 1-iteration Newton step is discontinuous
# (a constraint row at the edge of its active set), two f32 evaluations that
# differ in the last bit may land on different sides, and one substep then
# differs by more than max; on a heightfield a hull vertex on the edge of a
# triangle does the same to its contact normal. Such an env passes only if the plain version is
# shown to jump there itself: re-run from its input perturbed at rounding
# scale (EDGE_COPIES copies, relative EDGE_SCALE), its own result moves by
# at least max, and one of those plain results is within max of the
# kernel's in every field.
GATES = {"qpos": (1e-5, 1e-4), "qvel": (1e-3, 1e-2)}
DERIVED_P90 = {"sensordata": 5e-2, "site_xpos": 1e-4, "actuator_force": 1e-2}
EDGE_COPIES, EDGE_SCALE = 256, 1e-6
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn on the card, CUDA events around `reps` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def per_env_err(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    return (a - b).abs().reshape(a.shape[0], -1).amax(1).double().cpu().numpy()


def edge_check(m, d, ctrl, k1, env: int, gen: torch.Generator) -> dict:
    """The plain version around one env's input: its own jump under
    perturbations at rounding scale, and how near its nearest result comes
    to the kernel's (per field, the same copy for every field)."""
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.physics.types import RANDOMIZED_FIELDS

    sel = torch.full((EDGE_COPIES,), env, device=ctrl.device)
    mm = m.replace(**{f: getattr(m, f)[sel] for f in RANDOMIZED_FIELDS if m.is_batched(f)})
    dd = d.map(lambda x: x[sel])

    def perturb(x):
        noise = torch.randn(x.shape, generator=gen, device=x.device)
        noise[0] = 0  # copy 0 is the unperturbed input
        return x * (1 + EDGE_SCALE * noise)

    p = F.step_reference(mm, dd.replace(qpos=perturb(dd.qpos), qvel=perturb(dd.qvel)), ctrl[sel], 1)
    jump = {f: float(per_env_err(getattr(p, f), getattr(p, f)[:1]).max()) for f in GATES}
    err = np.stack([per_env_err(getattr(p, f), getattr(k1, f)[sel]) / GATES[f][1] for f in GATES])
    best = int(err.max(0).argmin())
    nearest = {f: float(err[i, best] * GATES[f][1]) for i, f in enumerate(GATES)}
    ok = any(jump[f] >= GATES[f][1] for f in GATES) and all(err[:, best] < 1)
    return {"env": env, "plain_jump": jump, "nearest_plain": nearest, "ok": ok}


def active_rows(m, d):
    """Mean active contacts and joint-limit rows per env in this run's
    step (contacts of the last substep, limits at the step's end), the
    data-dependent part of the kernel's work."""
    from open_duck_playground_torch.physics import structure

    lj = [int(j) for j in structure.limited_hinges(m.spec)]
    q = d.qpos[:, [m.spec.jnt_qposadr[j] for j in lj]]
    dist = torch.minimum(q - m.jnt_range[lj, 0], m.jnt_range[lj, 1] - q)
    limits = float((dist < m.jnt_margin[lj]).float().sum(1).mean())
    contacts = float((d.contact_dist < 0).float().sum(1).mean())
    return contacts, limits


def load_modules():
    """The port's modules, imported after the card is known to be there."""
    import importlib.util
    import types

    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.envs import (joystick, randomize, standing, step_graph, task_kernel,
                                                 wrapper_kernel, wrappers)
    from open_duck_playground_torch.export import onnx_export, onnx_runtime, onnx_validate
    from open_duck_playground_torch.models import loader
    from open_duck_playground_torch.physics import collision, forward, kinematics, megakernel
    from open_duck_playground_torch.parallel import dryrun, mesh
    from open_duck_playground_torch.tools import (bench_physics, bench_ppo_sustained, bench_rollout,
                                                  count_kernel_ops, issue_bench, profile_epoch, profile_shuffle,
                                                  profile_step, profile_train_step)
    from open_duck_playground_torch.train import checkpoint, config, networks, ppo, running_stats

    # the task kernels' comparison with the eager step, shared with their tests
    spec = importlib.util.spec_from_file_location(
        "task_kernel_check", pathlib.Path(__file__).resolve().parent / "tests" / "task_kernel_check.py")
    task_kernel_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(task_kernel_check)

    return types.SimpleNamespace(
        J=joystick, R=randomize, S=standing, SG=step_graph, TK=task_kernel, TKC=task_kernel_check, W=wrappers,
        WK=wrapper_kernel,
        loader=loader,
        C=collision, F=forward, K=kinematics, MK=megakernel, IB=issue_bench, cfg=config, N=networks, ppo=ppo,
        RS=running_stats, cli=runner, CKPT=checkpoint, onnx_export=onnx_export,
        onnx_runtime=onnx_runtime, onnx_validate=onnx_validate, M=mesh, dryrun=dryrun,
        bench_rollout=bench_rollout, bench_physics=bench_physics, bench_sustained=bench_ppo_sustained,
        CK=count_kernel_ops, profile_step=profile_step, profile_train_step=profile_train_step,
        profile_epoch=profile_epoch, profile_shuffle=profile_shuffle)


def build_phase(P, models, lineinfo):
    """nvcc on every kernel source at once: one process per library.
    `models` maps a kernel's name to (model, dense partition?); the builds
    named in `lineinfo` are built a second time with -lineinfo, for phase
    `profile`'s census by source line."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(models) + len(lineinfo) + 1) as pool:
        futures = {name: pool.submit(P.MK.kernel, m.spec, dense) for name, (m, dense) in models.items()}
        lines = {name: pool.submit(P.CK.lineinfo_library, models[name][0].spec, models[name][1])
                 for name in lineinfo}
        probe = pool.submit(P.IB.library)
        kernels = {name: f.result() for name, f in futures.items()}
        lines = {name: f.result() for name, f in lines.items()}
        probe = probe.result()
    wall = time.perf_counter() - t0
    for name, lib in lines.items():
        emit({"phase": "build", "kernel": name, "lineinfo": True, "library": lib.path.name,
              "nvcc_seconds": round(lib.build_seconds, 3)})
    for name, k in kernels.items():
        info = k.info()
        emit({"phase": "build", "kernel": name, "nvcc_seconds": round(k.build_seconds, 3),
              "flags": P.MK.dim_flags(k.dims), **info,
              "occupancy": info["resident_warps_per_sm"] / 64, "ptxas": k.ptxas})
        # the degenerate partition keeps its one long chain's scratch (3 x nv
        # floats) in thread-local arrays; the block-arrow builds keep none
        local_limit = 1024 if k.dense else 256
        if (info["lanes_per_env"] < 2 or info["local_bytes_per_thread"] > local_limit
                or info["resident_warps_per_sm"] < 8):
            raise SystemExit(f"{name}: the env's working set is not in shared memory across lanes: {info}")
    regs = [int(l.split("Used ")[1].split(" registers")[0]) for l in probe.ptxas_lines() if "Used " in l]
    emit({"phase": "build", "kernel": "issue_probe", "nvcc_seconds": round(probe.build_seconds, 3),
          "instantiations": len(regs), "registers_per_thread_max": max(regs),
          "stack_bytes_max": max(int(l.split(" bytes stack")[0]) for l in probe.ptxas_lines()
                                 if "bytes stack" in l),
          "shared_bytes_reserved_per_block": probe.lib.probe_smem_bytes(),
          "occupancy": "set by the launch: one block of 1-32 warps per SM, alone on its SM"})
    emit({"phase": "build", "kernel": "all", "parallel_wall_seconds": round(wall, 3)})
    return kernels


def start_state(P, model, gen, hfield: bool, n_envs: int = N_ENVS, randomize: bool = True):
    """Domain-randomized envs (the nominal model where not `randomize`, as
    the evaluator runs it) near the home keyframe (qpos 0.01, qvel 0.1
    normal). On the heightfield the base is spread uniformly over +-3 m in x
    and y and lifted as the env's spawn is (hfield_size[2] + 0.002)."""
    dev = model.device
    m = P.R.domain_randomize(model, P.R.DRDraws.sample(gen, n_envs, model.spec)) if randomize else model
    rng = np.random.default_rng(0)
    kq, kc = model.key_qpos.cpu().numpy(), model.key_ctrl.cpu().numpy()
    qpos = np.tile(kq, (n_envs, 1)) + 0.01 * rng.standard_normal((n_envs, kq.size))
    qvel = 0.1 * rng.standard_normal((n_envs, model.spec.nv))
    if hfield:
        qpos[:, :2] += rng.uniform(-3.0, 3.0, (n_envs, 2))
        qpos[:, 2] += float(model.hfield_size[2]) + 0.002
    ctrl = np.tile(kc, (n_envs, 1))
    qpos, qvel, ctrl = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (qpos, qvel, ctrl))
    return m, P.F.init(m, qpos, qvel, ctrl), ctrl


def terrain_contacts(P, m, d):
    """Envs with an active contact, and active contacts whose normal is off
    +z, over states `d` (the plain collision code)."""
    mm = m.expand_batch(d.qpos.shape[0])
    xpos, xquat = P.K.kinematics(mm, d.qpos)[:2]
    con = P.C.collide(mm, xpos, xquat)
    active = con.dist < 0
    tilted = active & (con.frame[:, :, 0, 2] < 1 - 1e-6)
    return int(active.any(1).sum()), int(tilted.sum()), int(active.sum())


def kernel_phase(P, name, model, gen, replaces, timing_reps, dense=False, n_envs=N_ENVS,
                 randomize=True):
    """kernel_vs_plain and kernel_timing of one megakernel build; returns
    its row of the kernel table. The first launch, with the counts at 0
    just before it, is the degenerate partition's whole path (`launches` of
    its row); the other builds' rows get their launches from the training
    paths later. `randomize=False` runs the nominal model, every env on the
    same fields, as the evaluator does."""
    MK, F = P.MK, P.F
    dev = model.device
    hfield = model.spec.floor_is_hfield
    m, d0, ctrl = start_state(P, model, gen, hfield, n_envs, randomize)
    step = lambda mm, dd, cc, n: MK.megakernel_step(mm, dd, cc, n, dense)
    MK.reset_launches()
    got = step(m, d0, ctrl, N_SUBSTEPS)
    torch.cuda.synchronize()
    path_launches = MK.launches_dense if dense else None
    want = F.step_reference(m, d0, ctrl, N_SUBSTEPS)

    check = {f: {"per_substep_max": []} for f in GATES}
    edges, failures = [], []
    edge_gen = torch.Generator(device=dev).manual_seed(1)
    d = d0
    touching = tilted = contacts = 0
    for sub in range(N_SUBSTEPS):  # the kernel's own trajectory, substep by substep
        if hfield:
            a, b, c = terrain_contacts(P, m, d)
            touching, tilted, contacts = max(touching, a), tilted + b, contacts + c
        k1 = step(m, d, ctrl, 1)
        p1 = F.step_reference(m, d, ctrl, 1)
        over = np.zeros(n_envs, bool)
        for f, (_, max_gate) in GATES.items():
            e = per_env_err(getattr(k1, f), getattr(p1, f))
            check[f]["per_substep_max"].append(float(e.max()))
            over |= e >= max_gate
        for env in np.nonzero(over)[0]:
            edges.append({"substep": sub, **edge_check(m, d, ctrl, k1, int(env), edge_gen)})
            if not edges[-1]["ok"]:
                failures.append(f"substep {sub} env {env}: over max and not at an edge")
        d = k1
    for f, (p90_gate, _) in GATES.items():
        e = per_env_err(getattr(got, f), getattr(want, f))
        same = bool(torch.equal(getattr(got, f), getattr(d, f)))
        check[f].update(p90=float(np.percentile(e, 90)), free_running_max=float(e.max()),
                        one_launch_equals_substeps=same)
        if not (np.percentile(e, 90) < p90_gate and same):
            failures.append(f)
    for f, gate in DERIVED_P90.items():
        e = per_env_err(getattr(got, f), getattr(want, f))
        check[f] = {"p90": float(np.percentile(e, 90)), "max": float(e.max())}
        if not np.percentile(e, 90) < gate:
            failures.append(f)
    finite = all(torch.isfinite(x).all().item() for _, x in got.fields())
    terrain = {}
    if hfield:
        # else the phase tested a plane
        terrain = {"envs_with_active_contact": touching, "active_contact_substeps": contacts,
                   "active_contacts_with_tilted_normal": tilted}
        if touching == 0 or tilted == 0:
            failures.append("no active contact on a tilted triangle")
    emit({"phase": "kernel_vs_plain", "kernel": name, "envs": n_envs, "randomized": randomize,
          "substeps": N_SUBSTEPS,
          "gates": {"p90_max": GATES, "derived_p90": DERIVED_P90,
                    "edge_copies": EDGE_COPIES, "edge_scale": EDGE_SCALE},
          "errors": check, "edges": edges, **terrain, "finite": finite,
          "ok": not failures and finite})
    if failures or not finite:
        raise SystemExit(f"{name} disagrees with its plain version: {failures}")

    ms = cuda_ms(lambda: step(m, d0, ctrl, N_SUBSTEPS), timing_reps)
    plain_ms = cuda_ms(lambda: F.step_reference(m, d0, ctrl, N_SUBSTEPS), 2)
    active_contacts, active_limits = active_rows(m, got)
    nbytes, nops, dense_ops = P.CK.megakernel_work(m, n_envs, N_SUBSTEPS, active_contacts, active_limits,
                                                   dense)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / F32_FLOPS
    bound_ms = max(bytes_ms, ops_ms)
    # the same launch at 4x the envs: where the card is full, the time per
    # env stays; where latency, not work, sets the time, it falls
    m4 = P.R.domain_randomize(model, P.R.DRDraws.sample(gen, 4 * n_envs, model.spec)) if randomize else model
    d4 = d0.map(lambda x: x.repeat((4,) + (1,) * (x.dim() - 1)))
    ctrl4 = ctrl.repeat(4, 1)
    ms4 = cuda_ms(lambda: step(m4, d4, ctrl4, N_SUBSTEPS), 3)
    emit({"phase": "kernel_timing", "kernel": name, "envs": n_envs, "ms": ms, "plain_ms": plain_ms,
          "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": bound_ms,
          "roofline_share": bound_ms / ms, "us_per_1k_envs": 1e3 * ms / (n_envs / 1e3),
          f"ms_at_{4 * n_envs}_envs": ms4,
          f"us_per_1k_envs_at_{4 * n_envs}": 1e3 * ms4 / (4 * n_envs / 1e3),
          "f32_ops": nops, "dense_f32_ops": dense_ops, "dense_ops_ms": 1e3 * dense_ops / F32_FLOPS})
    # one substep of kernel and plain version from the same state, edges included
    max_abs_err = max(max(check[f]["per_substep_max"]) for f in GATES)
    return {
        "name": name,
        "route": "cuda",
        "source": "open_duck_playground_torch/csrc/megakernel.cu",
        "replaces": replaces,
        "launches": path_launches,
        "max_abs_err": max_abs_err,
        "tolerance": {f: g[1] for f, g in GATES.items()},
        "envs": n_envs,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes a physics step",
        "edge_env_substeps": len(edges),
        "qpos_p90": check["qpos"]["p90"],
        "qvel_p90": check["qvel"]["p90"],
        "bytes": nbytes,
        "f32_ops": nops,
        "dense_f32_ops": dense_ops,
        "active_contacts_per_env": active_contacts,
        "active_limits_per_env": active_limits,
    }


def task_bytes(P, d, nmetrics: int) -> int:
    """Bytes the two task launches read and write per env, each counted
    once: the pre launch's inputs (the gait frame it gathers among them)
    and outputs, and the post launch's, of the physics outputs only the
    entries it reads (the feet's heights, the IMU's frame, 19 sensor
    values; the standing terms' orientation reads 2 more)."""
    U, V, Q, IH, F2 = d["NU"], d["NV"], d["NQ"], d["IHIST"], d["NFOOT"]
    nref = d["GDIM"] if d["IMITATION"] else 0
    nsens = 19 + 2 * int(bool(d.get("STANDING")))
    nstate, npriv = P.TK.library(d).obs_sizes
    pre = 4 * (U + V + 1 + 7 + d["AHIST"] * U + 2 + U + 2 + nref) + 8 + 4 * (
        1 + 2 * d["IMITATION"] * d["OBS_PHASE"] + nref + d["AHIST"] * U + 2 + V + U)
    post_in = 4 * (Q + V + F2 + 9 + U + F2 * d["KPTS"] + nsens + U + 7 + 3 * U + U + 1 + 2 * d["OBS_PHASE"] + nref
                   + 2 * F2 + 2 + 3 * IH + 9 + 2 * U + 7)
    post_out = 4 * (nstate + npriv + 2 + 2 * F2 + 3 * IH + 2 + 7 + nmetrics) + F2
    return pre + post_in + post_out


def task_phase(P, gen, smi) -> dict:
    """The task kernels (row 3) at the eval's and the rollout's batch, in
    the joystick build and in the standing build: one fused step against
    the eager body from the same state, the kernels' device ms (a CUDA
    graph of the fused step with its physics launch stubbed by the
    launch's own outputs, so that the graph holds the two kernels alone,
    replayed under CUDA events: no profiler here, whose traces early in
    the process cost phase profile its device events), the eager body's ms
    less its physics launch (`plain_ms`) and the bytes-bound ms; returns
    the row (the joystick build's, the standing build's under `standing`)."""
    builds = {"joystick": lambda: P.J.Joystick(CLI_TASK, device=gen.device),
              "standing": lambda: P.S.Standing("flat_terrain", device=gen.device)}
    per_build, failures = {}, []
    for build, make_env in builds.items():
        per_build[build] = task_batches(P, gen, make_env)
        failures += [f"{build} at {n} envs" for n, b in per_build[build].items() if not b["ok"]]
    emit({"phase": "task_kernels", "builds": {k: list(v.values()) for k, v in per_build.items()},
          "ulps_gate": P.TKC.ULPS, "ms_is": "a replay of a CUDA graph of the two kernels", "ok": not failures,
          "card": smi})
    if failures:
        raise SystemExit(f"the task kernels disagree with the eager step: {failures}")

    def row(per_batch):
        first, last = (per_batch[n] for n in TASK_ENVS)
        return {"envs": list(TASK_ENVS), "ms": [first["ms"], last["ms"]],
                "plain_ms": [first["plain_ms"], last["plain_ms"]], "bound_ms": [first["bound_ms"], last["bound_ms"]],
                "bound_by": "bytes", "max_ulps": max(first["max_ulps"], last["max_ulps"])}

    return {"name": "task_step", "route": "cuda", "source": "open_duck_playground_torch/csrc/task_step.cu",
            "replaces": P.TK.TPU_KERNEL, **row(per_build["joystick"]), "standing": row(per_build["standing"]),
            "library_ms": None, "library_note": "no single PyTorch call computes a task step"}


def task_batches(P, gen, make_env) -> dict:
    """The task phase's measurements of one build at each of TASK_ENVS."""
    dev = gen.device
    TK, F, TKC = P.TK, P.F, P.TKC
    per_batch = {}
    for n in TASK_ENVS:
        env = make_env()
        state = env.reset(env.reset_draws(gen, n))
        action = 3.0 * torch.rand((n, env.action_size), generator=gen, device=dev) - 1.5
        draws = env.step_draws(gen, n)
        step = lambda: env.step(state, action, draws)
        with torch.no_grad():
            fused = step()
            with TKC.eager(env):
                slow = step()
            physics_same = not TKC.unequal_bits(fused.data, slow.data)
            ints_same = all(dtype.is_floating_point for _, dtype, _ in TKC.mismatches(fused, slow))
            ulps = TKC.worst_ulps(fused, slow)
            physics = F.step
            try:  # the two kernels alone: the physics launch's outputs stand in for it
                F.step = lambda m, d, ctrl, k: fused.data.replace(ctrl=ctrl)
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    step()
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with P.MK.capture(), torch.cuda.graph(graph):
                    step()
                ms = cuda_ms(graph.replay, 200)
            finally:
                F.step = physics
            with TKC.eager(env):
                step_ms = cuda_ms(step, 10)
            physics_ms = cuda_ms(lambda: F.step(env.model, state.data, state.info["motor_targets"],
                                                env.n_substeps), 10)
        nbytes = n * task_bytes(P, TK.kernel_dims(env), len(env._metric_keys))
        per_batch[n] = {"envs": n, "dims": TK.kernel_dims(env), "ms": ms, "plain_ms": step_ms - physics_ms,
                        "eager_step_ms": step_ms, "physics_ms": physics_ms, "bytes": nbytes,
                        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "physics_same": physics_same,
                        "ints_same": ints_same, "max_ulps": ulps,
                        "ok": physics_same and ints_same and ulps <= TKC.ULPS}
    return per_batch


def wrapper_bytes(state) -> int:
    """Bytes the two wrapper launches read and write per env of `state` (a
    stepped EvalEnv state), each counted once: the pre launch's done and
    step count, one of the reset's and the state's row of every Data field
    and observation leaf, and its outputs; the post launch's task outputs
    and its own (the reset's rows where an env is bad not counted), the
    float leaves of info and metrics, and the evaluator's sums."""
    per_env = lambda t: t[0].numel() * t.element_size()
    rows = sum(per_env(t) for _, t in state.data.fields()) + sum(per_env(t) for t in state.obs.values())
    info = {k: v for k, v in state.info.items()
            if k not in ("first_data", "first_obs", "eval_metrics", "steps", "truncation")}
    floats = sum(per_env(t) for t in [*info.values(), *state.metrics.values()] if t.is_floating_point())
    sums = 4 * (3 + len(state.info["eval_metrics"]["episode_metrics"]))
    return (8 + 2 * rows + 4) + (2 * rows + 2 * floats + 12 + 16 + 2 * sums)


def wrapper_phase(P, gen, smi) -> dict:
    """The wrapper kernels (row 4) at the eval's and the rollout's batch:
    `EvalEnv`'s fused step against its eager body from the same state, the
    task's step stood in for by one real step's outputs with NaN and inf
    planted (so that a graph of the fused step holds the two kernels
    alone), every leaf bit for bit; the kernels' device ms (that graph
    replayed under CUDA events), the eager body's ms, the bytes-bound ms;
    returns the row."""
    import types

    WK, TKC = P.WK, P.TKC
    per_batch, failures = {}, []
    for n in TASK_ENVS:
        env = P.J.Joystick(CLI_TASK, device=gen.device)
        wenv = P.W.EvalEnv(env, 1000)
        state = wenv.reset(env.reset_draws(gen, n))
        state = state.replace(done=(torch.arange(n, device=gen.device) % 2 == 0).to(torch.float32))
        action = 3.0 * torch.rand((n, env.action_size), generator=gen, device=gen.device) - 1.5
        draws = wenv.step_draws(gen, n)
        with torch.no_grad():
            TKC.plant_non_finite(env, types.SimpleNamespace(setattr=setattr))  # this env only
            nstate = wenv.task_steps(state, action, draws)  # one real step, planted
            wenv.task_steps = lambda s, a, d: nstate
            fused, slow = TKC.fused_wrapper_step(wenv, state, action, draws), wenv.eager_step(state, action, draws)
            try:
                TKC.assert_same_bits(fused, slow, f"the wrapper at {n} envs")
                same = True
            except AssertionError as err:
                same, failures = False, failures + [str(err)]
            graph = torch.cuda.CUDAGraph()  # after the eager fused step above: the library is loaded
            with P.MK.capture(), torch.cuda.graph(graph):
                TKC.fused_wrapper_step(wenv, state, action, draws)
            ms = cuda_ms(graph.replay, 200)
            plain_ms = cuda_ms(lambda: wenv.eager_step(state, action, draws), 20)
        nbytes = n * wrapper_bytes(fused)
        per_batch[n] = {"envs": n, "ms": ms, "plain_ms": plain_ms, "bytes_per_env": nbytes // n,
                        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "same_bits": same}
    ptxas = WK.library().built.ptxas_lines()
    emit({"phase": "wrapper_kernels", "batches": list(per_batch.values()), "ptxas": ptxas,
          "ms_is": "a replay of a CUDA graph of the two kernels", "ok": not failures, "card": smi})
    if failures:
        raise SystemExit(f"the wrapper kernels disagree with the eager body: {failures}")
    first, last = (per_batch[n] for n in TASK_ENVS)
    return {"name": "wrapper_step", "route": "cuda", "source": "open_duck_playground_torch/csrc/wrapper_step.cu",
            "replaces": WK.TPU_KERNEL, "envs": list(TASK_ENVS), "ms": [first["ms"], last["ms"]],
            "plain_ms": [first["plain_ms"], last["plain_ms"]], "bound_ms": [first["bound_ms"], last["bound_ms"]],
            "bound_by": "bytes", "bytes_per_env": first["bytes_per_env"], "ptxas": ptxas,
            "library_ms": None, "library_note": "no single PyTorch call computes a wrapper step"}


def rollout_phase(P, gen, smi, steps: int) -> int:
    """The training rollout on the plane scene; returns the kernel launches."""
    dev = gen.device
    cfg = P.cfg.PPOConfig()
    env = P.J.Joystick("flat_terrain_backlash", device=dev)
    wrapped = P.W.TrainingEnv(env, cfg.episode_length,
                              dr_draws=P.R.DRDraws.sample(gen, cfg.num_envs, env.model.spec),
                              randomization_fn=P.R.domain_randomize)
    state = wrapped.reset(env.reset_draws(gen, cfg.num_envs))
    obs_sizes = {k: v.shape[-1] for k, v in state.obs.items()}
    net = P.N.PPONetworks.init(obs_sizes, env.action_size, cfg.policy_hidden_layer_sizes, gen, device=dev)
    normalizer = P.RS.init(obs_sizes, device=dev)

    def rollout_step(state):
        with torch.no_grad():
            logits = net.policy_logits(P.RS.normalize(normalizer, state.obs))
            action = P.N.postprocess(P.N.sample_raw(logits, P.N.normal_noise(gen, logits)))
        return wrapped.step(state, action, env.step_draws(gen, cfg.num_envs))

    for _ in range(3):  # warm-up: allocator, cuBLAS handles
        state = rollout_step(state)
    state = wrapped.reset(env.reset_draws(gen, cfg.num_envs))
    torch.cuda.synchronize()
    P.MK.reset_launches()
    t0 = time.perf_counter()
    rewards = []
    for _ in range(steps):
        state = rollout_step(state)
        rewards.append(state.reward)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, launches_hfield = P.MK.launches, P.MK.launches_hfield
    obs_ok = all(torch.isfinite(v).all().item() and v.shape[0] == cfg.num_envs
                 for v in state.obs.values())
    rew = torch.stack(rewards)
    rew_ok = bool(torch.isfinite(rew).all().item())
    emit({"phase": "rollout", "task": "flat_terrain_backlash", "envs": cfg.num_envs, "steps": steps,
          "kernel_launches": launches, "seconds": seconds,
          "env_steps_per_s": cfg.num_envs * steps / seconds,
          "ms_per_control_step": 1e3 * seconds / steps,
          "obs_shapes": {k: list(v.shape) for k, v in state.obs.items()},
          "mean_reward": float(rew.mean()), "done_frac": float(state.done.mean()),
          "obs_finite": obs_ok, "reward_finite": rew_ok, "card": smi})
    if launches != steps or launches_hfield != 0 or not (obs_ok and rew_ok):
        raise SystemExit(f"rollout failed: {launches} launches ({launches_hfield} heightfield), "
                         f"obs ok {obs_ok}, reward ok {rew_ok}")
    return launches


# The probe against its plain version: every variant, chain count and
# operand placement, one warp per scheduler, PROBE_CHECK_TRIPS trips (128
# rounds) from starts in [0.5, 0.6). The plain version accumulates in f64;
# the kernel rounds every round to f32, half an ulp of 0.5-1 (3e-8 to
# 6e-8), which over 128 rounds of `fma` or `add` adds up to 3.8e-6 to
# 7.6e-6 if every rounding falls the same way. `exp` and `sqrt_div` contract
# to a fixed point and forget earlier roundings.
PROBE_CHECK_TRIPS, PROBE_TOLERANCE = 4, 1e-5
PROBE_ROW = ("fma", 8, 16, 64)  # variant, chains, warps per SM, trips of the row's timing


def probe_phase(P, gen, smi) -> dict:
    IB = P.IB
    dev = gen.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    IB.reset_launches()
    rows = IB.run_configs(device=dev, emit=lambda r: emit({"phase": "issue_probe", "card": smi, **r}))
    launches = IB.launches  # the tool's own path, before any comparison launch
    if launches == 0:
        raise SystemExit("issue_probe: the tool launched no kernel")
    # the FMA configs (fma, col, narrow) again with a and b in the other place
    # (`measure` raises if two blocks of any config shared an SM), and the
    # loop's machine code
    placed = []
    for operands in IB.OPERANDS:
        if operands != IB.DEFAULT_OPERANDS:
            placed += IB.run_configs([c for c in IB.CONFIGS if c[0] in ("fma", "col", "narrow")], device=dev,
                                     operands=operands,
                                     emit=lambda r: emit({"phase": "issue_probe", "card": smi, **r}))
    sass = IB.sass_report()
    for r in sass:
        emit({"phase": "issue_probe", "sass": True, **r})

    errs = {}
    for variant in IB.VARIANTS:
        for chains in IB.CHAINS:
            x = 0.5 + 0.1 * torch.rand((chains, sms * IB.per_block(variant, 128)), generator=gen, device=dev)
            want = IB.plain(variant, x, PROBE_CHECK_TRIPS)
            for operands in IB.OPERANDS:
                got = IB.run(variant, x, PROBE_CHECK_TRIPS, operands=operands)
                errs[f"{variant}/{chains}/{operands}"] = float((got - want).abs().max())
    torch.cuda.synchronize()
    max_err = max(errs.values())

    variant, chains, warps, trips = PROBE_ROW
    x = torch.full((chains, sms * 32 * warps), IB.X0, device=dev)

    def row_run():
        return IB.run(variant, x, trips, 32 * warps)

    row_run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronising call in `run` raises
    for _ in range(20):
        row_run()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the wrapper's host time per launch: 200 launches queued, host clock
    t0 = time.perf_counter()
    for _ in range(200):
        row_run()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    ms = cuda_ms(row_run, 20)
    # the wrapper as it was before its redesign: a host-to-device copy of the
    # constants, which synchronises, before every launch
    ms_copy = cuda_ms(lambda: (torch.as_tensor(IB.constants(variant, chains), device=dev), row_run()), 20)
    plain_ms = cuda_ms(lambda: IB.plain(variant, x, trips), 2)
    nops = x.numel() * trips * IB.ROUNDS * IB.OPS_PER_ROUND[variant]
    # x in, x out, the constants, each block's timers
    nbytes = 4 * (2 * x.numel() + 2 * chains) + 8 * len(IB.TIMERS) * sms
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / F32_FLOPS
    peak = max(rows + placed, key=lambda r: r["ops_per_clock_per_sm"])
    by_placement = {f"{r['variant']}/{r['chains']}/{r['warps_per_sm']}/{r['operands']}": r["ops_per_clock_per_sm"]
                    for r in rows + placed if r["variant"] in ("fma", "col", "narrow")}
    clocks = {k: [min(r[k] for r in rows), max(r[k] for r in rows)] for k in ("clock_ghz_kernel", "clock_ghz_events")}
    emit({"phase": "issue_probe", "summary": True, "configs": len(rows), "launches": launches,
          "peak_ops_per_clock_per_sm": peak["ops_per_clock_per_sm"],
          "peak_config": [peak["variant"], peak["chains"], peak["warps_per_sm"], peak["operands"]],
          "peak_share_of_67_tflops": peak["share_of_67_tflops"],
          "placement": {"configs": len(rows) + len(placed), "blocks_per_launch": sms,
                        "every_block_on_its_own_sm": all(r["distinct_sms"] == r["blocks"] for r in rows + placed)},
          "clock_ghz_range": clocks, "fma_ops_per_clock_by_variant_chains_warps_operands": by_placement,
          "sass": [{k: r[k] for k in ("variant", "chains", "operands", "instructions_per_trip",
                                      "per_trip_by_opcode")} for r in sass],
          "kernel_vs_plain": {"trips": PROBE_CHECK_TRIPS, "tolerance": PROBE_TOLERANCE,
                              "max_abs_err": max_err, "by_variant_chains_operands": errs},
          "ok": max_err < PROBE_TOLERANCE, "card": smi})
    if not max_err < PROBE_TOLERANCE:
        raise SystemExit(f"issue probe disagrees with its plain version: {errs}")
    return {
        "name": "issue_probe",
        "route": "cuda",
        "source": "open_duck_playground_torch/csrc/issue_probe.cu",
        "replaces": IB.TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max_err,
        "tolerance": PROBE_TOLERANCE,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call iterates a scalar recurrence in registers",
        "timed_config": dict(zip(("variant", "chains", "warps_per_sm", "trips"), PROBE_ROW)),
        "ms_with_a_host_copy_per_launch": ms_copy,
        "host_us_per_run": host_us,
        "bytes": nbytes,
        "f32_ops": nops,
    }


def ppo_phase(P, gen, smi) -> int:
    """Full-width PPO training steps on rough terrain; returns the
    heightfield kernel's launches over the measured steps."""
    dev = gen.device
    ppo = P.ppo
    cfg = P.cfg.PPOConfig(num_evals=1)
    env = P.J.Joystick("rough_terrain_backlash", device=dev)
    train_env = P.W.TrainingEnv(env, cfg.episode_length,
                                dr_draws=P.R.DRDraws.sample(gen, cfg.num_envs, env.model.spec),
                                randomization_fn=P.R.domain_randomize)
    state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=dev)
    marks = []

    def hook(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    ts, state, _ = ppo.training_step(ts, train_env, env, state, cfg, gen)  # warm-up
    before = [p.detach().clone() for p in ts.net.parameters()]
    torch.cuda.synchronize()
    P.MK.reset_launches()
    n_steps = 2
    steps = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        ts, state, metrics = ppo.training_step(ts, train_env, env, state, cfg, gen, phase_hook=hook)
        (_, t_roll), (_, t_upd) = marks[-2:]
        steps.append({"rollout_seconds": t_roll - t0, "update_seconds": t_upd - t_roll,
                      **{k: float(v) for k, v in metrics.items()}})
    launches, launches_hfield = P.MK.launches, P.MK.launches_hfield
    seconds = sum(s["rollout_seconds"] + s["update_seconds"] for s in steps)
    control_steps = n_steps * cfg.k_unrolls * cfg.unroll_length
    frames = (n_steps + 1) * cfg.steps_per_training_step
    changed = all(not torch.equal(a, b.detach()) for a, b in zip(before, ts.net.parameters()))
    finite = all(np.isfinite(v) for s in steps for v in s.values()) and all(
        torch.isfinite(p).all().item() for p in ts.net.parameters())
    count = float(ts.normalizer.count)
    ok = (launches == control_steps and launches_hfield == control_steps and finite and changed
          and count == frames and ts.env_steps == frames)
    moments = moments_dtype_ab(P, ts, train_env, env, state, cfg, gen, hook, marks)
    emit({"phase": "ppo_step", "task": "rough_terrain_backlash", "envs": cfg.num_envs,
          "unroll_length": cfg.unroll_length, "num_minibatches": cfg.num_minibatches,
          "num_updates_per_batch": cfg.num_updates_per_batch, "batch_size": cfg.batch_size,
          "policy": list(cfg.policy_hidden_layer_sizes), "value": list(cfg.value_hidden_layer_sizes),
          "training_steps": n_steps, "control_steps": control_steps, "kernel_launches": launches,
          "heightfield_kernel_launches": launches_hfield, "steps": steps,
          "seconds_per_training_step": seconds / n_steps,
          "rollout_share": sum(s["rollout_seconds"] for s in steps) / seconds,
          "update_share": sum(s["update_seconds"] for s in steps) / seconds,
          "env_steps_per_s": n_steps * cfg.steps_per_training_step / seconds,
          "params_changed": changed, "finite": finite, "normalizer_count": count,
          "frames_seen": frames, "env_steps": ts.env_steps, "moments_dtype_ab": moments, "ok": ok,
          "card": smi})
    if not ok:
        raise SystemExit(f"ppo_step failed: {launches} launches for {control_steps} control steps, "
                         f"finite {finite}, params changed {changed}, normalizer count {count} "
                         f"for {frames} frames")
    return launches_hfield


def moments_dtype_ab(P, ts, train_env, env, state, cfg, gen, hook, marks) -> dict:
    """What the normalizer's f64 moment sums cost the single-card path
    against f32 (the port's sums before data parallelism): MOMENTS_PAIRS
    pairs of whole training steps, the order alternating (f64 f32, f32 f64,
    ...), with rollout and update seconds; the update runs the same code
    under either, so its pairs show the host's spread. Then
    `accumulate_moments` alone on the rollout's obs, MOMENTS_CALLS
    synchronized calls per turn, host clock, in turns f64 f32 f32 f64."""
    zero_f32 = lambda stats: tuple({k: torch.zeros_like(v) for k, v in stats.mean.items()} for _ in range(2))
    zeros = {"f64": P.RS.zero_moments, "f32": zero_f32}  # accumulate_moments sums in the accumulators' dtype
    steps = {name: {"rollout": [], "update": []} for name in zeros}
    for i in range(MOMENTS_PAIRS):
        for name in (("f64", "f32") if i % 2 == 0 else ("f32", "f64")):
            with wrapped(P.RS, "zero_moments", lambda orig: zeros[name]):
                t0 = time.perf_counter()
                ts, state, metrics = P.ppo.training_step(ts, train_env, env, state, cfg, gen, phase_hook=hook)
            (_, t_roll), (_, t_upd) = marks[-2:]
            steps[name]["rollout"].append(t_roll - t0)
            steps[name]["update"].append(t_upd - t_roll)
            if not all(np.isfinite(float(v)) for v in metrics.values()):
                raise SystemExit(f"ppo_step: non-finite metrics with {name} moments: {metrics}")
    calls = {name: [] for name in zeros}
    for name in ("f64", "f32", "f32", "f64"):
        m = zeros[name](ts.normalizer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MOMENTS_CALLS):
            m = P.RS.accumulate_moments(ts.normalizer, m, state.obs)
        torch.cuda.synchronize()
        calls[name].append((time.perf_counter() - t0) / MOMENTS_CALLS * 1e3)
    quartiles = lambda xs: [float(np.percentile(xs, q)) for q in (25, 50, 75)]
    return {"pairs": MOMENTS_PAIRS,
            "seconds_q1_median_q3": {name: {phase: quartiles(xs) for phase, xs in d.items()}
                                     for name, d in steps.items()},
            "steps": steps, "accumulate_ms_per_call": calls, "envs": cfg.num_envs}


@contextlib.contextmanager
def wrapped(module, name, wrapper):
    """`module.name` replaced by `wrapper(original)` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def timed(record: list, on_result=None):
    """A wrapper that appends each call's seconds (card synchronized on both
    sides) to `record`, and hands (args, result) to `on_result`."""

    def wrapper(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.append(time.perf_counter() - t0)
            if on_result is not None:
                on_result(args, out)
            return out

        return call

    return wrapper


def adam_step(optimizer) -> float:
    """Adam's step, 0 before the first (when it holds no state yet)."""
    steps = {float(s["step"]) for s in optimizer.state.values()} or {0.0}
    if len(steps) != 1:
        raise SystemExit(f"Adam's parameters disagree on their step: {sorted(steps)}")
    return steps.pop()


def checkpoint_policy(P, path: pathlib.Path, obs, action_size: int, dev):
    """The deterministic policy of the full checkpoint in `path`."""
    cfg = P.cfg.PPOConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    ts = P.ppo.init_training_state(obs, action_size, cfg, gen, device=dev)
    ts, _ = P.CKPT.restore_training_state(path, ts)
    return P.ppo.make_policy((ts.normalizer, ts.net), deterministic=True)


def phase_timed(phases: list):
    """A wrapper of `ppo.training_step` that appends each call's rollout and
    update seconds (card synchronized at the phase ends) to `phases`."""

    def wrapper(fn):
        def call(*args, **kwargs):
            marks = []

            def hook(name):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, phase_hook=hook, **kwargs)
            phases.append({"rollout_seconds": marks[0] - t0, "update_seconds": marks[1] - marks[0]})
            return out

        return call

    return wrapper


def eval_observations(P, task: str, policy, dev):
    """128 observations of the task's evaluator, 20 control steps into
    episodes under `policy`."""
    cfg = P.cfg.PPOConfig()
    env = P.J.Joystick(task, device=dev)
    ev = P.W.EvalEnv(env, cfg.episode_length)
    egen = torch.Generator(device=dev).manual_seed(7)
    state = ev.reset(env.reset_draws(egen, cfg.num_eval_envs))
    for _ in range(20):
        state = ev.step(state, policy(state.obs)[0], ev.step_draws(egen, cfg.num_eval_envs))
    return state.obs, env.action_size


@dataclass
class DeployInputs:
    """What the phases that write .onnx files hand to the deploy phase:
    each file's validator result (summary or error, ms), and its bytes with
    the observations and torch actions it was checked on."""

    validated: dict = field(default_factory=dict)
    policies: dict = field(default_factory=dict)

    def keep(self, P, f: pathlib.Path, obs: np.ndarray, action: np.ndarray) -> None:
        t0 = time.perf_counter()
        try:
            result = {"summary": P.onnx_validate.validate_file(str(f))}
        except P.onnx_validate.OnnxValidationError as e:
            result = {"error": str(e)}
        result["ms"] = 1e3 * (time.perf_counter() - t0)
        self.validated[f.name] = result
        self.policies[f.name] = (f.read_bytes(), obs, action)


def onnx_errors(P, onnx_files, obs, action_size: int, dev, deploy: DeployInputs) -> dict:
    """Per .onnx file, the largest difference of its actions on `obs` from
    the torch deterministic action of its checkpoint (f32 products, as the
    file's weights are f32). Each file also goes to `deploy`, while it is
    still on disk."""
    out = {}
    for f in onnx_files:
        want = checkpoint_policy(P, f.with_suffix(""), obs, action_size, dev)(obs)[0]
        state = obs["state"].cpu().numpy()
        got = P.onnx_runtime.OnnxPolicy(str(f)).infer(state)
        if got.shape != tuple(want.shape):
            raise SystemExit(f"{f.name}: actions of shape {got.shape}, want {tuple(want.shape)}")
        out[f.name] = float(np.abs(got - want.cpu().numpy()).max())
        deploy.keep(P, f, state, want.cpu().numpy())
    return out


def cli_phase(P, gen, smi, spec, deploy: DeployInputs) -> int:
    """The training CLI end to end at the full PPO config; returns the
    launches over both runs of the plane kernel of `spec` (the task's
    model)."""
    dev = gen.device
    ppo, CKPT = P.ppo, P.CKPT
    cfg = P.cfg.PPOConfig()
    evals, saves, restores, exports, phases = [], [], [], [], []
    eval_metrics, save_log, restore_log = [], [], []

    def on_save(args, _):
        path, ts, gen_state = args
        save_log.append({"path": pathlib.Path(path), "env_steps": ts.env_steps,
                         "adam_step": adam_step(ts.optimizer), "generator": gen_state.clone()})

    def on_restore(args, out):
        ts, gen_state = out
        restore_log.append({"env_steps": ts.env_steps, "adam_step": adam_step(ts.optimizer),
                            "generator": gen_state.clone()})

    common = ["--env", "joystick", "--task", CLI_TASK]
    runs = []
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        out = pathlib.Path(tmp) / "run"
        stack.enter_context(wrapped(ppo, "training_step", phase_timed(phases)))
        stack.enter_context(wrapped(ppo, "run_eval", timed(evals, lambda a, r: eval_metrics.append(r))))
        stack.enter_context(wrapped(CKPT, "save_training_state", timed(saves, on_save)))
        stack.enter_context(wrapped(CKPT, "restore_training_state", timed(restores, on_restore)))
        stack.enter_context(wrapped(P.onnx_export, "export_policy", timed(exports)))
        torch.cuda.synchronize()
        P.MK.reset_launches()
        t0 = time.perf_counter()
        P.cli.main(common + ["-o", str(out), "--num_timesteps", str(CLI_STEPS),
                             "--config_override", "num_evals=2"])
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        first = sorted(p for p in out.iterdir() if p.is_dir())
        first_onnx = sorted(out.glob("*.onnx"))
        last = max(first, key=lambda p: int(p.name.rsplit("_", 1)[1]))
        t0 = time.perf_counter()
        resumed = pathlib.Path(tmp) / "resumed"
        _, (normalizer, net), final_metrics = P.cli.main(
            common + ["-o", str(resumed), "--num_timesteps", str(2 * CLI_STEPS),
                      "--restore_checkpoint_path", str(last), "--config_override", "num_evals=3"])
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        launches, kernel_launches = P.MK.launches, P.MK.kernel(spec).launches
        launches_hfield = P.MK.launches_hfield
        dirs = first + sorted(p for p in resumed.iterdir() if p.is_dir())
        onnx_files = first_onnx + sorted(resumed.glob("*.onnx"))
        stack.close()

        # 128 observations from the eval, under the final policy
        final_policy = ppo.make_policy((normalizer, net), deterministic=True)
        obs, action_size = eval_observations(P, CLI_TASK, final_policy, dev)
        onnx_err = onnx_errors(P, onnx_files, obs, action_size, dev, deploy)
        last = max(dirs, key=lambda p: int(p.name.rsplit("_", 1)[1]))
        final_err = float((checkpoint_policy(P, last, obs, action_size, dev)(obs)[0]
                           - final_policy(obs)[0]).abs().max())

    n_evals = len(evals)
    eval_steps = cfg.episode_length // cfg.action_repeat
    want_launches = (n_evals * eval_steps + len(phases) * cfg.k_unrolls * cfg.unroll_length) * cfg.action_repeat
    first_saves, second = save_log[:2], save_log[2:]
    resume = {
        "restored_env_steps": restore_log[0]["env_steps"] if restore_log else None,
        "restored_adam_step": restore_log[0]["adam_step"] if restore_log else None,
        "resumed_saves": [{"env_steps": s["env_steps"], "adam_step": s["adam_step"]} for s in second],
    }
    sgd_steps = cfg.num_updates_per_batch * cfg.num_minibatches
    failures = []
    if n_evals != 4 or len(phases) != 2:
        failures.append(f"{n_evals} evals and {len(phases)} training steps, want 4 and 2")
    if [s["env_steps"] for s in first_saves] != [0, CLI_STEPS]:
        failures.append("first run: checkpoints not at 0 and one training step")
    if len(first) != 2 or len(first_onnx) != 2 or len(dirs) != 4 or len(onnx_files) != 4:
        failures.append(f"checkpoints {len(first)} then {len(dirs)}, onnx {len(first_onnx)} then {len(onnx_files)}")
    if not (len(restore_log) == 1 and restore_log[0]["env_steps"] == CLI_STEPS
            and restore_log[0]["adam_step"] == sgd_steps):
        failures.append(f"restore: {resume}")
    if [(s["env_steps"], s["adam_step"]) for s in second] != [(CLI_STEPS, sgd_steps), (2 * CLI_STEPS, 2 * sgd_steps)]:
        failures.append(f"resumed run: {resume}")
    elif not (torch.equal(second[0]["generator"], restore_log[0]["generator"])
              and torch.equal(restore_log[0]["generator"], first_saves[1]["generator"])):
        failures.append("the generator state was not restored")
    if max(onnx_err.values()) >= ONNX_TOLERANCE or final_err > 1e-6:
        failures.append(f"onnx {onnx_err}, last checkpoint vs returned net {final_err}")
    finite = all(np.isfinite(v) for m in eval_metrics for v in m.values()) and all(
        np.isfinite(v) for v in final_metrics.values())
    if not finite:
        failures.append("non-finite metrics")
    if launches != want_launches or kernel_launches != launches or launches_hfield != 0:
        failures.append(f"{launches} launches ({kernel_launches} of the {CLI_TASK} build), want {want_launches}")
    emit({"phase": "cli", "task": CLI_TASK, "envs": cfg.num_envs, "eval_envs": cfg.num_eval_envs,
          "eval_control_steps": eval_steps, "runs_seconds": runs, "evals": n_evals,
          "seconds_per_eval": evals, "ms_per_eval_control_step": [1e3 * t / eval_steps for t in evals],
          "training_steps": phases, "checkpoint_save_seconds": saves,
          "checkpoint_restore_seconds": restores, "onnx_export_seconds": exports,
          "kernel_launches": launches, "expected_launches": want_launches,
          "checkpoints": [p.name for p in dirs], "onnx_max_abs_err": onnx_err,
          "onnx_tolerance": ONNX_TOLERANCE, "resume": resume,
          "eval_reward": [m["eval/episode_reward"] for m in eval_metrics],
          "eval_episode_length": [m["eval/avg_episode_length"] for m in eval_metrics],
          "final_training_metrics": final_metrics, "ok": not failures, "card": smi})
    if failures:
        raise SystemExit(f"cli failed: {failures}")
    return launches


def standing_phase(P, gen, smi) -> int:
    """One full-width training step of the standing task on flat_terrain
    with direct head targets (RESULTS.md's standing recipe); returns the
    flat_terrain build's launches."""
    dev = gen.device
    ppo = P.ppo
    cfg = P.cfg.PPOConfig(num_evals=1)
    env = P.S.Standing("flat_terrain", config_overrides={"head_direct_targets": True}, device=dev)
    train_env = P.W.TrainingEnv(env, cfg.episode_length,
                                dr_draws=P.R.DRDraws.sample(gen, cfg.num_envs, env.model.spec),
                                randomization_fn=P.R.domain_randomize)
    state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=dev)
    marks = []

    def hook(name):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    P.MK.reset_launches()
    P.TK.reset_counts()
    t0 = time.perf_counter()
    ts, state, metrics = ppo.training_step(ts, train_env, env, state, cfg, gen, phase_hook=hook)
    launches = P.MK.launches
    kernel_launches = P.MK.kernel(env.model.spec).launches
    fused = P.TK.build_launches.get(P.TK.build_key(env), 0)
    sizes = {k: int(v.shape[-1]) for k, v in state.obs.items()}
    net_in = {cfg.policy_obs_key: ts.net.policy.sizes[0], cfg.value_obs_key: ts.net.value_mlp.sizes[0]}
    metrics = {k: float(v) for k, v in metrics.items()}
    finite = all(np.isfinite(v) for v in metrics.values()) and all(
        torch.isfinite(v).all().item() for v in state.obs.values())
    control_steps = cfg.k_unrolls * cfg.unroll_length
    # the last step's servo targets: the head's are the head commands
    head_targets = bool(torch.equal(state.info["motor_targets"][:, 5:9], state.info["command"][:, 3:7]))
    ok = (launches == kernel_launches == control_steps and P.MK.launches_hfield == 0 and finite
          and net_in == sizes and ts.env_steps == cfg.steps_per_training_step and head_targets
          and fused == P.TK.launches == control_steps and P.TK.eager_steps == 0)
    emit({"phase": "standing", "task": "flat_terrain", "envs": cfg.num_envs, "head_direct_targets": True,
          "rollout_seconds": marks[0] - t0, "update_seconds": marks[1] - marks[0],
          "kernel_launches": launches, "flat_terrain_kernel_launches": kernel_launches,
          "fused_standing_steps": fused, "task_eager_steps": P.TK.eager_steps,
          "obs_sizes": sizes, "network_inputs": net_in, "head_targets_equal_head_commands": head_targets,
          "metrics": metrics, "finite": finite, "ok": ok, "card": smi})
    if not ok:
        raise SystemExit(f"standing failed: {launches} launches ({kernel_launches} of the flat_terrain "
                         f"build) and {fused} fused standing steps ({P.TK.eager_steps} eager) for "
                         f"{control_steps} control steps, finite {finite}, obs {sizes}, "
                         f"network inputs {net_in}, head targets equal head commands {head_targets}")
    return kernel_launches


def reset_seconds(P, gen, task: str, overrides, n_envs: int) -> tuple:
    """Seconds of one reset of `n_envs` envs (host clock, card synchronized,
    after a warm-up reset; the draws are made before the clock starts), and
    the share of envs that start past frame 0 of the gait."""
    env = P.J.Joystick(task, config_overrides=overrides, device=gen.device)
    env.reset(env.reset_draws(gen, n_envs))
    draws = env.reset_draws(gen, n_envs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = env.reset(draws)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, float((state.info["imitation_i"] > 0).float().mean())


def no_head_phase(P, gen, smi, spec, deploy: DeployInputs) -> int:
    """The no-head training recipe through the CLI at the full PPO config,
    in f32 and with bf16 products: one training step and an eval each, the
    checkpoint and .onnx of each checked; returns the no-head build's
    launches over both runs."""
    dev = gen.device
    ppo = P.ppo
    cfg = P.cfg.PPOConfig()
    task = "flat_terrain_no_head"
    runs = {}
    launches = kernel_launches = launches_hfield = 0
    for name, extra in (("f32", []), ("bf16_matmuls", ["bf16_matmuls=True"])):
        phases, evals = [], []
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            out = pathlib.Path(tmp) / name
            stack.enter_context(wrapped(ppo, "training_step", phase_timed(phases)))
            stack.enter_context(wrapped(ppo, "run_eval", timed(evals)))
            argv = ["--env", "joystick", "--task", task, "-o", str(out), "--num_timesteps", str(CLI_STEPS)]
            for pair in ["num_evals=1"] + NO_HEAD_RECIPE + extra:
                argv += ["--config_override", pair]
            torch.cuda.synchronize()
            P.MK.reset_launches()
            t0 = time.perf_counter()
            _, (normalizer, net), metrics = P.cli.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches += P.MK.launches
            kernel_launches += P.MK.kernel(spec).launches
            launches_hfield += P.MK.launches_hfield
            stack.close()
            dirs = sorted(p for p in out.iterdir() if p.is_dir())
            onnx_files = sorted(out.glob("*.onnx"))
            policy = ppo.make_policy((normalizer, net), deterministic=True)
            obs, action_size = eval_observations(P, task, policy, dev)
            onnx_err = onnx_errors(P, onnx_files, obs, action_size, dev, deploy)
            # the returned network's own products against the checkpoint's in f32
            returned_err = float((checkpoint_policy(P, dirs[-1], obs, action_size, dev)(obs)[0]
                                  - policy(obs)[0]).abs().max())
        runs[name] = {
            "seconds": seconds, "training_steps": phases, "seconds_per_eval": evals,
            "matmul_dtype": str(net.policy.matmul_dtype), "action_size": action_size,
            "obs_sizes": {k: int(v.shape[-1]) for k, v in obs.items()},
            "checkpoints": [p.name for p in dirs], "onnx_max_abs_err": onnx_err,
            "returned_policy_vs_f32_checkpoint": returned_err,
            "final_training_metrics": metrics,
            "params_f32": all(p.dtype == torch.float32 for p in net.parameters()),
        }
    eval_steps = cfg.episode_length // cfg.action_repeat
    control_steps = sum(len(r["seconds_per_eval"]) * eval_steps
                        + len(r["training_steps"]) * cfg.k_unrolls * cfg.unroll_length for r in runs.values())
    reset = {}
    for label, overrides in (("rsi_prob=0.5", {"rsi_prob": 0.5}), ("rsi_prob=0", None)):
        t, share = reset_seconds(P, gen, task, overrides, cfg.num_envs)
        reset[label] = {"seconds": t, "share_past_frame_0": share}

    failures = []
    for name, r in runs.items():
        if (len(r["training_steps"]) != 1 or len(r["seconds_per_eval"]) != 1 or len(r["checkpoints"]) != 1
                or len(r["onnx_max_abs_err"]) != 1):
            failures.append(f"{name}: {len(r['training_steps'])} training steps, {len(r['seconds_per_eval'])} "
                            f"evals, {len(r['checkpoints'])} checkpoints, {len(r['onnx_max_abs_err'])} onnx")
        if not r["onnx_max_abs_err"] or max(r["onnx_max_abs_err"].values()) >= ONNX_TOLERANCE:
            failures.append(f"{name}: onnx {r['onnx_max_abs_err']}")
        if r["action_size"] != 10 or not r["params_f32"]:
            failures.append(f"{name}: {r['action_size']} actions, f32 parameters {r['params_f32']}")
        if not all(np.isfinite(v) for v in r["final_training_metrics"].values()):
            failures.append(f"{name}: non-finite metrics")
    if runs["f32"]["returned_policy_vs_f32_checkpoint"] > 1e-6:
        failures.append("f32 run: the returned policy is not its checkpoint's")
    if runs["f32"]["matmul_dtype"] != "None" or runs["bf16_matmuls"]["matmul_dtype"] != "torch.bfloat16":
        failures.append("the runs' networks do not take the products asked for")
    if not (launches == kernel_launches == control_steps and launches_hfield == 0):
        failures.append(f"{launches} launches ({kernel_launches} of the no-head build), want {control_steps}")
    if not 0.4 < reset["rsi_prob=0.5"]["share_past_frame_0"] < 0.6 or reset["rsi_prob=0"]["share_past_frame_0"]:
        failures.append(f"reference-state init: {reset}")
    emit({"phase": "no_head", "task": task, "recipe": NO_HEAD_RECIPE, "envs": cfg.num_envs,
          "runs": runs, "kernel_launches": launches, "no_head_kernel_launches": kernel_launches,
          "expected_launches": control_steps, "onnx_tolerance": ONNX_TOLERANCE,
          "reset_at_8192_envs": reset, "ok": not failures, "card": smi})
    if failures:
        raise SystemExit(f"no_head failed: {failures}")
    return kernel_launches


def bench_phase(P, smi, specs) -> dict:
    """The three bench tools through their `main(argv)`; returns per kernel
    build (name of `specs`) its launches by tool, counted from 0 at each
    tool's call."""
    cfg = P.cfg.PPOConfig()
    launches = {name: {} for name in specs}
    failures, runs = [], []

    def call(label, tool, argv, want):
        """`want`: {build name: launches the tool's run must make}."""
        P.MK.reset_launches()
        t0 = time.perf_counter()
        record = tool.main(argv)
        seconds = time.perf_counter() - t0
        got = {name: P.MK.kernel(spec).launches for name, spec in specs.items()}
        for name, n in got.items():
            if n:
                launches[name][label] = n
        if {k: v for k, v in got.items() if v} != want or P.MK.launches != sum(want.values()):
            failures.append(f"{label}: launches {got}, want {want}")
        runs.append({"tool": label, "seconds": seconds, "launches": {k: v for k, v in got.items() if v}})
        return record

    for envs in (4096, 8192):
        r = call(f"bench_rollout@{envs}", P.bench_rollout,
                 ["--envs", str(envs), "--steps", str(BENCH_STEPS), "--reps", str(BENCH_REPS)],
                 {"megakernel_step": (2 + BENCH_REPS) * BENCH_STEPS})
        if not (np.isfinite(r["value"]) and r["value"] > 0):
            failures.append(f"bench_rollout@{envs}: {r}")
    for task, build in BENCH_PHYSICS_BUILDS.items():
        r = call(f"bench_physics:{task}", P.bench_physics, ["--task", task, "--envs", "4096", "--steps", "50"],
                 {build: (2 + P.bench_physics.REPS) * 50})
        if not (r["finite"] and np.isfinite(r["value"]) and r["value"] > 0):
            failures.append(f"bench_physics:{task}: {r}")
    timesteps = 2 * CLI_STEPS
    eval_steps = cfg.episode_length // cfg.action_repeat
    r = call("bench_ppo_sustained", P.bench_sustained,
             ["--task", CLI_TASK, "--timesteps", str(timesteps)],
             {"megakernel_step": 2 * cfg.k_unrolls * cfg.unroll_length + 3 * eval_steps})
    chunks = r["chunks"]
    rewards = [r["initial_eval_episode_reward"]] + [c["eval_episode_reward"] for c in chunks]
    if ([c["steps"] for c in chunks] != [CLI_STEPS, CLI_STEPS] or not all(np.isfinite(rewards))
            or not r["value"] > 0):
        failures.append(f"bench_ppo_sustained: {r}")
    emit({"phase": "bench", "runs": runs, "bench_rollout": {"steps": BENCH_STEPS, "reps": BENCH_REPS},
          "sustained_eval_rewards": rewards, "ok": not failures, "card": smi})
    if failures:
        raise SystemExit(f"bench failed: {failures}")
    return launches


def reward_cases(n: int, gen: torch.Generator):
    """(name, torch term, numpy term, args) of every reward term and of the
    imitation reward on 14 and 10 joints, at `n` rows: a tensor argument
    has one row per env, anything else is the same for every env."""
    from open_duck_playground_torch.envs import imitation, rewards as RT
    from open_duck_playground_torch.eval_tools import rewards_numpy as RN

    dev = gen.device
    f = lambda *shape: torch.randn((n, *shape), generator=gen, device=dev)
    cmd, vel3, pose14, vel14 = f(7), f(3), f(14), f(14)
    contact = f(2) > 0
    cases = [
        ("tracking_lin_vel", (cmd, vel3, 0.2)),
        ("tracking_ang_vel", (cmd, vel3, 0.2)),
        ("yaw_rate_l1", (cmd, vel3)),
        ("lin_vel_l1", (cmd, vel3)),
        ("forward_progress", (cmd, vel3)),
        ("torques", (f(14),)),
        ("action_rate", (f(14), f(14))),
        ("orientation", (f(3),)),
        ("stand_still", (cmd * 0.001, pose14, vel14, f(14), True)),
        ("stand_still", (cmd, pose14, vel14, f(14), False)),
        ("stand_still", (cmd * 0.001, f(10), f(10), f(10), True)),
        ("head_pos", (pose14, vel14, cmd)),
        ("head_pos", (pose14, vel14, cmd, True)),
        ("head_pos", (f(10), f(10), cmd, True)),
        ("lin_vel_z", (vel3,)),
        ("ang_vel_xy", (vel3,)),
        ("base_height", (f().abs(), 0.15)),
        ("base_y_swing", (0.1 * f(), 1.5, 0.05, f().abs(), 0.2)),
        ("energy", (f(20), f(20))),
        ("joint_pos_limits", (pose14, f(14) - 3, f(14) + 3)),
        ("termination", (contact[:, 0].float(),)),
        ("joint_deviation", (pose14, [0, 1, 2, 3, 4], f(14), 1.0)),
        ("pose", (pose14, f(14), f(14).abs())),
        ("feet_slip", (contact, f(3))),
        ("feet_clearance", (f(2, 3), f(2, 3), 0.08)),
        ("feet_height", (f(2).abs(), contact, 0.1)),
        ("feet_air_time", (f(2).abs(), contact, cmd)),
        ("feet_phase", (f(2, 3), f(2))),
    ]
    out = [(name, getattr(RT, name), getattr(RN, name), args) for name, args in cases]
    out.append(("alive", lambda: RT.alive(n, dev), RN.alive, ()))
    base_qvel, ref_frame = f(6), f(40)
    out.append(("imitation_reward", imitation.imitation_reward, RN.imitation_reward,
                (base_qvel, pose14, vel14, contact.float(), ref_frame, cmd)))
    out.append(("imitation_reward/no_head", imitation.imitation_reward, RN.imitation_reward,
                (base_qvel, f(10), f(10), contact.float(), ref_frame, cmd, True, 0.05 * f(10))))
    return out


def reward_mirror_errors(n: int, gen: torch.Generator) -> dict:
    """Per term, the largest |torch - numpy| / (atol + rtol |numpy|) over
    `n` rows: the batched torch term on the card against the numpy mirror
    row by row; under 1 is within REWARD_RTOL, REWARD_ATOL."""
    out = {}
    for k, (name, torch_fn, np_fn, args) in enumerate(reward_cases(n, gen)):
        got = torch_fn(*args).double().cpu().numpy()
        rows = [a.cpu().numpy() if torch.is_tensor(a) else a for a in args]
        want = np.array([np_fn(*[r[i] if torch.is_tensor(a) else r for a, r in zip(args, rows)])
                         for i in range(n)], np.float64)
        ratio = np.abs(got - want) / (REWARD_ATOL + REWARD_RTOL * np.abs(want))
        out[name if name not in out else f"{name}#{k}"] = float(ratio.max())
    return out


def deploy_phase(P, gen, smi, deploy: DeployInputs) -> None:
    """What of the deployment path runs without C-MuJoCo: every .onnx file
    of the cli and no_head phases through the port's validator (done while
    the files were on disk), the native runtime built with the host's C++
    compiler against the numpy runtime and the torch action of each file's
    checkpoint, the reward terms on the card against their numpy mirrors,
    and the numpy gait oracle against the torch one. Imports no mujoco and
    no matplotlib."""
    import importlib

    from open_duck_playground_torch import cuda_build
    from open_duck_playground_torch.envs.gait_oracle import GaitOracle
    from open_duck_playground_torch.eval_tools.gait_oracle_numpy import GaitOracleNumpy
    from open_duck_playground_torch.export import native_runtime

    failures = []
    # the eval tools load without mujoco or matplotlib (this machine has neither)
    modules = ["eval_tools.mujoco_runner", "eval_tools.ref_motion_viewer", "eval_tools.plot_obs",
               "tools.transfer_matrix", "utils.filters"]
    for m in modules:
        importlib.import_module(f"open_duck_playground_torch.{m}")
    if {"mujoco", "matplotlib"} & set(sys.modules):
        failures.append("importing the eval tools loaded mujoco or matplotlib")

    rejected = {k: v["error"] for k, v in deploy.validated.items() if "error" in v}
    if len(deploy.validated) != 6 or rejected:
        failures.append(f"validator: {len(deploy.validated)} files, want 6; rejected {rejected}")

    t0 = time.perf_counter()
    lib = cuda_build.build(native_runtime.SOURCE, host=True)
    build_seconds = time.perf_counter() - t0
    native = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (blob, obs, action) in deploy.policies.items():
            path = pathlib.Path(tmp) / name
            path.write_bytes(blob)
            cc, py = native_runtime.NativeOnnxPolicy(str(path)), P.onnx_runtime.OnnxPolicy(str(path))
            got_cc = np.stack([cc.infer(o) for o in obs])
            got_py = np.stack([py.infer(o) for o in obs])
            row = {"obs": int(obs.shape[0]), "native_vs_numpy": float(np.abs(got_cc - got_py).max()),
                   "native_vs_torch": float(np.abs(got_cc - action).max()),
                   "numpy_vs_torch": float(np.abs(got_py - action).max())}
            if not native:  # per-call times on the first (the main path's) file
                for label, pol in (("native_us_per_infer", cc), ("numpy_us_per_infer", py)):
                    t0 = time.perf_counter()
                    for _ in range(DEPLOY_INFER_REPS):
                        for o in obs:
                            pol.infer(o)
                    row[label] = 1e6 * (time.perf_counter() - t0) / (DEPLOY_INFER_REPS * obs.shape[0])
            native[name] = row
    worst = max((max(r["native_vs_numpy"], r["native_vs_torch"], r["numpy_vs_torch"])
                 for r in native.values()), default=np.inf)
    if len(native) != 6 or not worst < ONNX_TOLERANCE:
        failures.append(f"native runtime: {native}")

    t0 = time.perf_counter()
    rewards = reward_mirror_errors(DEPLOY_REWARD_ROWS, gen)
    reward_seconds = time.perf_counter() - t0
    if len(rewards) != 31 or not max(rewards.values()) <= 1.0:
        failures.append(f"reward mirrors: {rewards}")

    oracle, oracle_np = GaitOracle(device=gen.device), GaitOracleNumpy()
    grid = np.stack(np.meshgrid(np.linspace(-0.2, 0.2, 5), np.linspace(-0.25, 0.25, 5),
                                np.linspace(-1.2, 1.2, 5), np.arange(0, 2 * oracle.nb_steps_in_period, 3),
                                indexing="ij"), -1).reshape(-1, 4)
    as_t = lambda x, dtype=torch.float32: torch.as_tensor(x, dtype=dtype, device=gen.device)
    got = oracle.reference_frame(as_t(grid[:, 0]), as_t(grid[:, 1]), as_t(grid[:, 2]),
                                 as_t(grid[:, 3], torch.int64)).double().cpu().numpy()
    want = np.stack([oracle_np.reference_frame(dx, dy, dth, int(i)) for dx, dy, dth, i in grid])
    gait_err = float(np.abs(got - want).max())
    gait_ulps = float((np.abs(got - want) / (GAIT_RTOL * np.abs(want) + 1e-30)).max())
    gait_rounded = float((got == want.astype(np.float32)).mean())
    if not gait_ulps <= 1.0:
        failures.append(f"gait oracle: {gait_ulps} f32 ulps, {gait_err} absolute")

    emit({"phase": "deploy", "imports_without_mujoco": modules,
          "validated_files": len(deploy.validated),
          "validate_ms_per_file": {k: v["ms"] for k, v in deploy.validated.items()},
          "summaries": {k: {key: v["summary"][key] for key in ("n_nodes", "n_params", "inputs", "outputs")}
                        for k, v in deploy.validated.items() if "summary" in v},
          "native_build_seconds": build_seconds, "native_built": lib.build_seconds > 0,
          "native": native, "onnx_tolerance": ONNX_TOLERANCE,
          "host_cpus": os.cpu_count(), "note": "infer times are the host CPU's, one observation a call",
          "reward_rows": DEPLOY_REWARD_ROWS, "reward_worst_over_tolerance": rewards,
          "reward_rtol": REWARD_RTOL, "reward_atol": REWARD_ATOL, "reward_seconds": reward_seconds,
          "gait_lookups": len(grid), "gait_max_abs_err": gait_err, "gait_max_f32_ulps": gait_ulps,
          "gait_share_equal_to_f32_rounding": gait_rounded,
          "ok": not failures, "card": smi})
    if failures:
        raise SystemExit(f"deploy failed: {failures}")


def mesh_phase(P, smi, spec) -> int:
    """Full-width training steps from the same seed without a mesh and on a
    one-rank NCCL mesh, in turns (none, mesh, mesh, none); returns the plane
    kernel's launches of all four."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = P.cfg.PPOConfig(num_evals=1)
    env = P.J.Joystick(CLI_TASK, device=dev)

    def train(mesh):
        phases = []
        with wrapped(P.ppo, "training_step", phase_timed(phases)):
            _, (normalizer, net), metrics = P.ppo.train(
                env, num_timesteps=cfg.steps_per_training_step, config=cfg, device=dev,
                randomization_fn=P.R.domain_randomize, mesh=mesh)
        return {"normalizer": normalizer, "net": net, "metrics": metrics, **phases[0]}

    P.MK.reset_launches()
    runs = [("no_mesh", train(None))]
    dist.init_process_group(P.M.backend_for(dev), init_method=f"tcp://127.0.0.1:{P.dryrun.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = P.M.make_mesh("cuda")
        backend = dist.get_backend()
        dist.all_reduce(torch.zeros(1, device=dev))  # NCCL builds its communicator at the first collective
        torch.cuda.synchronize()
        runs += [("mesh", train(mesh)), ("mesh", train(mesh))]
    finally:
        dist.destroy_process_group()
    runs.append(("no_mesh", train(None)))
    launches, kernel_launches = P.MK.launches, P.MK.kernel(spec).launches

    first = runs[0][1]
    diffs = []
    for _, run in runs[1:]:
        diff = {"params": max(float((a - b).detach().abs().max())
                              for a, b in zip(first["net"].parameters(), run["net"].parameters()))}
        for field in ("mean", "std"):
            ref, got = getattr(first["normalizer"], field), getattr(run["normalizer"], field)
            diff[f"normalizer_{field}"] = max(float((ref[k] - got[k]).abs().max()) for k in ref)
        diffs.append(diff)
    control_steps = len(runs) * cfg.k_unrolls * cfg.unroll_length
    finite = all(np.isfinite(v) for _, run in runs for v in run["metrics"].values())
    worst = max(max(d.values()) for d in diffs)
    ok = (worst <= MESH_TOLERANCE and backend == "nccl" and mesh.world_size == 1 and finite
          and launches == kernel_launches == control_steps)
    emit({"phase": "mesh", "task": CLI_TASK, "envs": cfg.num_envs, "backend": backend,
          "world_size": mesh.world_size, "tolerance": MESH_TOLERANCE,
          "turns": [name for name, _ in runs], "max_abs_diff_from_first": diffs,
          "rollout_seconds": [run["rollout_seconds"] for _, run in runs],
          "update_seconds": [run["update_seconds"] for _, run in runs],
          "kernel_launches": launches, "expected_launches": control_steps, "finite": finite, "ok": ok,
          "card": smi})
    if not ok:
        raise SystemExit(f"mesh failed: backend {backend}, differences {diffs}, finite {finite}, "
                         f"{launches} launches ({kernel_launches} of the plane build) for {control_steps}")
    return kernel_launches

def profile_phase(P, smi, specs, rows) -> int:
    """The profiling tools through their `main(argv)`, each printing its
    lines as it comes, with their gates; each megakernel row of `rows`
    (by build name) gets its census, and the task kernels' row
    (`task_step`) the launches of `env.task` in the eager body's traced
    control step. Returns the plane kernel's launches over the tools' runs."""
    t_phase = time.perf_counter()
    failures, runs = [], []

    def call(label, tool, argv):
        P.MK.reset_launches()
        t0 = time.perf_counter()
        record = tool.main(argv)
        got = {name: P.MK.kernel(spec).launches for name, spec in specs.items() if P.MK.kernel(spec).launches}
        runs.append({"tool": label, "seconds": time.perf_counter() - t0, "launches": got})
        emit({"phase": "profile", **runs[-1], "card": smi})
        return record, got

    def traced_ok(label, traced):
        for key, t in traced.items():
            sections = {"whole": t["trace"]["whole"], **t["trace"]["sections"]}
            empty = [name for name, sec in sections.items() if not sec["kernel_launches"] > 0]
            if empty:
                failures.append(f"{label}/{key}: the profiler saw no kernel in {empty}")
            whole = t["trace"]["whole"]
            if whole["untraced_launches"]:
                failures.append(f"{label}/{key}: the trace lost the device events of {whole['untraced_launches']} "
                                f"of {whole['launch_calls']} launches")

    pieces = ("physics", "env_step", "eval_step", "eval_step_eager")
    r, got = call("profile_step", P.profile_step, ["--task", CLI_TASK, "--envs", "4096", "--steps",
                                                   str(PROFILE_STEPS), "--reps", str(PROFILE_STEP_REPS)])
    # timed runs of each piece, and one step in each of the three traced runs
    want = len(pieces) * ((PROFILE_STEP_REPS + 1) * PROFILE_STEPS + 3)
    if got != {"megakernel_step": want} or not r["finite"]:
        failures.append(f"profile_step: launches {got}, want {want}; finite {r['finite']}")
    if [r[k]["megakernel_launches_per_step"] for k in (*pieces, "gait_oracle")] != [1, 1, 1, 1, 0]:
        failures.append(f"profile_step: launches per step {[r[k]['megakernel_launches_per_step'] for k in pieces]}")
    traced_ok("profile_step", {k: r[k] for k in pieces})
    for key in ("eval_step", "eval_step_eager"):
        in_spans = r[key]["trace"]["spans"]["launches_in_spans"]
        if not in_spans >= 0.95:
            failures.append(f"profile_step: {in_spans} of {key}'s launches inside the program's spans")
    # the graphed step launches the env step from one span and the draws and
    # the policy from another, the eager body from its layers (the task: its
    # two kernels)
    graphed, eager = r["layers"], r["layers_eager"]
    if not (graphed["graph_launches"] > 0 and graphed["task_launches"] == graphed["physics_launches"] == 0
            and graphed["act_graph_launches"] > 0 and graphed["policy_launches"] == graphed["draws_launches"] == 0
            and 0 < eager["task_launches"] <= 3 and eager["physics_launches"] > 0 and eager["graph_launches"] == 0
            and eager["policy_launches"] > 0 and eager["draws_launches"] > 0 and eager["act_graph_launches"] == 0):
        failures.append(f"profile_step: launches by span, graphed {graphed}, eager {eager}")
    rows["task_step"]["launches"] = eager["task_launches"]

    cfg = P.cfg.PPOConfig()
    r, got = call("profile_train_step", P.profile_train_step,
                  ["--task", CLI_TASK, "--eval-steps", str(PROFILE_EVAL_STEPS), "--eval-reps", "1",
                   "--reps", str(PROFILE_TRAIN_REPS)])
    T = cfg.unroll_length
    # rollout and env-only rollout (warm-up + reps), two evals, two training
    # steps, the traced control step (once untraced, two profiled, one counted)
    want = 2 * (PROFILE_TRAIN_REPS + 1) * T + 2 * PROFILE_EVAL_STEPS + 2 * T + 4
    physics = r["traced"]["control_step"]["trace"]["named"][P.profile_train_step.PHYSICS_KERNEL]
    if got != {"megakernel_step": want} or not r["finite"] or physics["kernel_launches"] != 1:
        failures.append(f"profile_train_step: launches {got}, want {want}; finite {r['finite']}; "
                        f"physics kernels in one control step {physics}")
    traced_ok("profile_train_step", r["traced"])

    r, _ = call("profile_epoch", P.profile_epoch, ["--warmup", "1", "--reps", "2"])
    for name, v in r["variants"].items():
        if (not v["finite"] or (v["same_function"] and not v["rel_diff"] <= PROFILE_EPOCH_TOLERANCE)
                or not v.get("rel_diff_from_eager_capturable_adam", 0) <= PROFILE_EPOCH_TOLERANCE):
            failures.append(f"profile_epoch {name}: {v}")
    if set(r["variants"]) != set(P.profile_epoch.VARIANTS):
        failures.append(f"profile_epoch ran {sorted(r['variants'])}")

    r, _ = call("profile_shuffle", P.profile_shuffle, [])
    unequal = [k for k, v in r["strategies"].items() if v.get("equal_to_production") is False]
    if unequal or len([v for v in r["strategies"].values() if "equal_to_production" in v]) != 5:
        failures.append(f"profile_shuffle: not the production minibatches: {unequal}")

    agreement = P.CK.probe_agreement()
    emit({"phase": "profile", "tool": "count_kernel_ops", "probe_agreement": agreement, "card": smi})
    for name, (task, dense) in CENSUS_BUILDS.items():
        row = rows[name]
        argv = ["--task", task, "--slots", "--envs", str(row["envs"]),
                "--contacts", str(row["active_contacts_per_env"]), "--limits", str(row["active_limits_per_env"])]
        r, _ = call(f"count_kernel_ops:{name}", P.CK, argv + ["--dense"] * dense + ["--by_line"] * (name in PROFILE_BY_LINE))
        row.update(static_sass_instructions=r["static_instructions"], ffma=r["ffma"]["count"],
                   ffma_three_register_share=r["ffma"]["three_register_share"], ldl_stl=r["ldl_stl"],
                   issue_bound_ms=r["slots"]["issue_bound_ms"],
                   census={"by_class": r["by_class"], "ffma_classes": r["ffma"], "slots": r["slots"],
                           "by_line_top": r.get("by_line", {}).get("top", [])[:5], "note": r["note"]})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "profile", "summary": True, "runs": runs, "seconds": seconds, "ok": not failures, "card": smi})
    if failures:
        raise SystemExit(f"profile failed: {failures}")
    return sum(run["launches"].get("megakernel_step", 0) for run in runs)


def learn_phase(P, smi, spec) -> tuple:
    """The learning gate: a short training run through the CLI at the full
    PPO config must raise the eval reward past its bars. Returns the plane
    kernel's launches over the run and the fused task steps
    (`task_kernel.launches`, two kernel launches each) and the fused
    wrapper steps (`wrapper_kernel.launches`, two launches each)."""
    cfg = P.cfg.PPOConfig()
    evals, eval_metrics = [], []
    with tempfile.TemporaryDirectory() as tmp, \
            wrapped(P.ppo, "run_eval", timed(evals, lambda a, r: eval_metrics.append(r))):
        torch.cuda.synchronize()
        P.MK.reset_launches()
        P.TK.reset_counts()
        P.WK.reset_counts()
        t0 = time.perf_counter()
        P.cli.main(["--env", "joystick", "--task", CLI_TASK, "--seed", "0", "-o", str(pathlib.Path(tmp) / "run"),
                    "--num_timesteps", str(LEARN_STEPS), "--config_override", "num_evals=2"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, kernel_launches = P.MK.launches, P.MK.kernel(spec).launches
        launches_hfield = P.MK.launches_hfield
        task_steps = (P.TK.launches, P.TK.eager_steps)
        wrapper_steps = (P.WK.launches, P.WK.eager_steps)
        logged = [json.loads(line)["kernel_launches"]
                  for line in (pathlib.Path(tmp) / "run" / "metrics.jsonl").read_text().splitlines()]
    eval_steps = cfg.episode_length // cfg.action_repeat
    training_steps = LEARN_STEPS // cfg.steps_per_training_step
    want_launches = (2 * eval_steps + training_steps * cfg.k_unrolls * cfg.unroll_length) * cfg.action_repeat
    rewards = [m["eval/episode_reward"] for m in eval_metrics]
    failures = []
    if len(rewards) != 2 or not all(np.isfinite(v) for m in eval_metrics for v in m.values()):
        failures.append(f"evals {eval_metrics}")
    elif not (rewards[1] >= LEARN_GAIN * rewards[0] and rewards[1] >= LEARN_BAR):
        failures.append(f"eval reward {rewards[0]} -> {rewards[1]}: want x{LEARN_GAIN} and >= {LEARN_BAR}")
    if launches != want_launches or kernel_launches != launches or launches_hfield != 0:
        failures.append(f"{launches} launches ({kernel_launches} of the {CLI_TASK} build), want {want_launches}")
    if task_steps != (launches, 0):  # every env step of the run through the task kernels
        failures.append(f"task steps (fused, eager) {task_steps}, want ({launches}, 0)")
    if wrapper_steps != (launches // cfg.action_repeat, 0):  # every wrapper step through the wrapper kernels
        failures.append(f"wrapper steps (fused, eager) {wrapper_steps}, want ({launches // cfg.action_repeat}, 0)")
    want_logged = [eval_steps * cfg.action_repeat, launches]
    if logged != want_logged:
        failures.append(f"metrics.jsonl logs {logged} kernel launches, want {want_logged}")
    emit({"phase": "learn", "task": CLI_TASK, "seed": 0, "envs": cfg.num_envs, "env_steps": LEARN_STEPS,
          "training_steps": training_steps, "eval_reward": rewards,
          "eval_reward_std": [m["eval/episode_reward_std"] for m in eval_metrics],
          "gain": rewards[1] / rewards[0] if len(rewards) == 2 else None, "gain_min": LEARN_GAIN,
          "bar": LEARN_BAR, "seconds": seconds, "seconds_per_eval": evals,
          "kernel_launches": launches, "expected_launches": want_launches, "logged_launches": logged,
          "task_steps_fused_eager": task_steps, "wrapper_steps_fused_eager": wrapper_steps,
          "ok": not failures, "card": smi})
    if failures:
        raise SystemExit(f"learn failed: {failures}")
    return launches, task_steps[0], wrapper_steps[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2

    P = load_modules()
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    P.F.pin_f32()

    flat = P.loader.load_model(device=dev, dtype=torch.float32, timestep=0.002)
    rough = P.loader.load_model("scene_rough_terrain_backlash", device=dev, dtype=torch.float32,
                                timestep=0.002)
    flat_nb = P.loader.load_model("scene_flat_terrain", device=dev, dtype=torch.float32,
                                  timestep=0.002)
    no_head = P.loader.load_model("scene_flat_terrain_no_head", device=dev, dtype=torch.float32,
                                  timestep=0.002)
    build_phase(P, {"megakernel_step": (flat, False), "megakernel_step_hfield": (rough, False),
                    "megakernel_step_dense": (flat, True),
                    "megakernel_step_flat_terrain": (flat_nb, False),
                    "megakernel_step_flat_terrain_no_head": (no_head, False)},
                lineinfo=PROFILE_BY_LINE)

    gen = torch.Generator(device=dev).manual_seed(0)
    row_flat = kernel_phase(P, "megakernel_step", flat, gen, P.MK.TPU_KERNEL, timing_reps=10)
    row_hfield = kernel_phase(P, "megakernel_step_hfield", rough, gen, P.MK.TPU_KERNEL_HFIELD,
                              timing_reps=10)
    row_dense = kernel_phase(P, "megakernel_step_dense", flat, gen, P.MK.TPU_KERNEL_DENSE,
                             timing_reps=10, dense=True, n_envs=N_ENVS_DENSE)
    row_nb = kernel_phase(P, "megakernel_step_flat_terrain", flat_nb, gen, P.MK.TPU_KERNEL,
                          timing_reps=10)
    row_nh = kernel_phase(P, "megakernel_step_flat_terrain_no_head", no_head, gen, P.MK.TPU_KERNEL,
                          timing_reps=10)
    # the evaluator's shape: 128 envs on the nominal model (per-env fields expanded)
    at_eval = kernel_phase(P, "megakernel_step", flat, gen, P.MK.TPU_KERNEL, timing_reps=50,
                           n_envs=P.cfg.PPOConfig().num_eval_envs, randomize=False)
    row_flat["at_eval_shape"] = {k: at_eval[k] for k in ("envs", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                         "edge_env_substeps", "qpos_p90", "qvel_p90")}
    row_task = task_phase(P, gen, smi)
    row_wrapper = wrapper_phase(P, gen, smi)
    row_flat["launches"] = rollout_phase(P, gen, smi, steps=5)
    row_probe = probe_phase(P, gen, smi)
    row_hfield["launches"] = ppo_phase(P, gen, smi)
    deploy = DeployInputs()
    row_flat["launches_cli"] = cli_phase(P, gen, smi, flat.spec, deploy)
    row_nb["launches"] = standing_phase(P, gen, smi)
    row_nh["launches"] = no_head_phase(P, gen, smi, no_head.spec, deploy)
    deploy_phase(P, gen, smi, deploy)
    bench = bench_phase(P, smi, {"megakernel_step": flat.spec, "megakernel_step_flat_terrain": flat_nb.spec,
                                 "megakernel_step_hfield": rough.spec,
                                 "megakernel_step_flat_terrain_no_head": no_head.spec})
    row_flat["launches_mesh"] = mesh_phase(P, smi, flat.spec)
    row_flat["launches_profile"] = profile_phase(
        P, smi, {"megakernel_step": flat.spec, "megakernel_step_flat_terrain": flat_nb.spec,
                 "megakernel_step_hfield": rough.spec, "megakernel_step_flat_terrain_no_head": no_head.spec},
        {"megakernel_step": row_flat, "megakernel_step_flat_terrain": row_nb, "megakernel_step_hfield": row_hfield,
         "megakernel_step_dense": row_dense, "megakernel_step_flat_terrain_no_head": row_nh,
         "task_step": row_task})
    for row in (row_flat, row_nb, row_hfield, row_nh):
        row["launches_bench"] = bench[row["name"]]
    row_flat["launches_learn"], row_task["fused_steps_learn"], row_wrapper["fused_steps_learn"] = learn_phase(
        P, smi, flat.spec)
    row_task["launches_learn"] = 2 * row_task["fused_steps_learn"]  # tk_pre and tk_post per fused step
    row_wrapper["launches_learn"] = 2 * row_wrapper["fused_steps_learn"]  # wr_pre and wr_post

    for row, label in ((row_flat, "1"), (row_nb, "1f"), (row_hfield, "1h"), (row_dense, "1d"),
                       (row_nh, "1n"), (row_probe, "2"), (row_task, "3"), (row_wrapper, "4")):
        row["row"] = label
    emit({"kernels": [row_flat, row_nb, row_hfield, row_dense, row_nh, row_probe, row_task, row_wrapper],
          "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
