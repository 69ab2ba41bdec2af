#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (a phase that has several kernels prints several):
  1. device: the card's name and power limit;
  2. build: nvcc builds, side by side, the physics megakernel for the plane
     scene, for the heightfield scene (-DMK_HFIELD=1) and for the plane
     scene on the degenerate (dense) partition, and the issue-rate probe,
     from csrc/ into build/kernels/; each megakernel line carries lanes per
     env, shared bytes per block, local bytes per thread and resident warps
     per SM;
  3. kernel_vs_plain, kernel_timing: each megakernel build against its plain
     version (`forward.step_reference`) at 8192 domain-randomized envs,
     substep by substep along the kernel's trajectory and over 10 substeps
     in one launch, with times (also at 4x the envs) and the card's least
     time for the same work; the heightfield run spreads the envs over
     +-3 m of rough terrain and must see active contacts on tilted
     triangles; the degenerate partition runs the same check at 1024 envs;
  4. rollout: the training rollout (TrainingEnv + Joystick on
     flat_terrain_backlash, the 128x4 policy in the loop), 8192 envs x 5
     control steps, every physics step through the plane kernel;
  5. issue_probe: `tools.issue_bench` over its configs, and the probe
     kernel against its plain version at a small trip count;
  6. ppo_step: `train.ppo.training_step` on Joystick("rough_terrain_backlash")
     at the full PPO config (8192 envs, unroll 20, 4 x 32 minibatches of
     256), 2 steps after a warm-up step, every physics step through the
     heightfield kernel.
Then the kernel table, the nvidia-smi line, and `{"ok": true, ...}` last.
Exits non-zero, printing no result, without a CUDA card or when a phase
fails. Needs no network; the kernel builds count against the run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_ENVS = 8192
N_ENVS_DENSE = 1024  # the degenerate partition's check: no training path runs it
N_SUBSTEPS = 10
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


def megakernel_work(m, n_envs: int, n_substeps: int, active_contacts: float, active_limits: float,
                    dense: bool = False):
    """(bytes, f32 operations, f32 operations of the dense form) the
    kernel's function needs for one launch.

    Bytes: each per-env input read once and each output written once, and
    on a heightfield the height table once per launch (all envs share it).
    Operations: counted from the loops of csrc/megakernel.cuh, one per add,
    multiply, divide, sqrt, sin or cos, with the data-dependent rows (active
    contacts and joint limits) at this run's average. The bound is the least
    time for the function, so each stage is counted in the cheapest of its
    known forms, whether or not the source takes it: the block-arrow
    factorization, products and solves on the model's partition (`dense`:
    on the degenerate one), contact rows as three base rows on the foot's
    support, and the contact curvature as the lesser of four facet rank-1
    updates and the folded 3 x 3 form with W J formed once per support
    column (the source recomputes W J per entry, 17 operations in place of
    6). The third number is the same function
    in the dense form (packed 30 x 30 Cholesky twice, four dense facet rows
    per contact), which earlier tables of PERF.md were counted in."""
    from open_duck_playground_torch.physics import megakernel as MK
    from open_duck_playground_torch.physics import structure

    s = m.spec
    d = MK.kernel_dims(s)
    nq, nv, nu, nb, nj = s.nq, s.nv, s.nu, s.nbody, s.njnt
    # qpos qvel ctrl warmstart | qpos0 gain0 bias0-2 frictionloss armature mass ipos mu
    floats_in = nq + nv + nu + nv + nq + 4 * nu + 2 * nv + nb + 3 * nb + 1
    floats_out = nq + 3 * nv + s.nsite * 12 + nu + s.ncon_max + s.nsensordata
    nbytes = 4 * n_envs * (floats_in + floats_out)
    if s.floor_is_hfield:
        nbytes += 4 * s.hfield_nrow * s.hfield_ncol

    anc = m.ancestor_mask.cpu().numpy()
    pred = structure.dof_pred_mask(s)
    dof_body = list(s.dof_bodyid)
    rot, qmul, qmat = 27, 28, 30  # quat_rot, quat_mul, quat_mat
    hinge = sum(1 for j in range(nj) if s.jnt_type[j] == 3)
    ops = 0
    ops += (nb - 1) * (rot + 3 + qmul) + hinge * (3 * rot + qmul + 8 + 9) + 14  # FK
    ops += nb * (rot + 3 + qmul + qmat) + nb * 7 + 3  # xipos, ximat, CoM
    ops += hinge * 12 + 3 * 15 + qmat  # cdof
    ops += nb * (3 + 5 + 9 * 3 * 5 + 9 * 4) + (nb - 1) * 13  # body and composite inertias
    ops += sum(30 + 12 * int(anc[dof_body[i], : i + 1].sum()) for i in range(nv)) + nv  # M
    ops += 12 * int(anc.sum()) + 12 * int(pred.sum()) + nv * (27 + 6)  # cvel, cdof_dot
    ops += 12 * int(anc.sum()) + nb * (2 * 33 + 27 + 6) + (nb - 1) * 6 + nv * 14  # RNE
    ops += nu * 8  # servos
    nfoot, nvert, frame = len(s.collide_geom_ids), d["NVERT"], 27  # frame: 2 cross, dot, sqrt, 3 div
    if s.floor_is_hfield:
        # hfield_height_normal: cell coordinates 8, height 8, slopes 6, unit normal 8, offsets 2
        height_normal = 32
        ops += rot + 3 + nfoot * (rot + 3 + qmul) + nfoot * nvert * (rot + 3 + height_normal + 3)
        ops += s.ncon_max * (height_normal + 6 + frame)  # the chosen vertices: normal again, point, frame
    else:
        ops += (nfoot + 1) * (rot + 3 + qmul) + nfoot * nvert * (rot + 8) + frame
    nlim_act, ncon_act = active_limits, active_contacts
    foot_dofs = float(np.mean([anc[s.geom_bodyid[g]].sum() for g in s.collide_geom_ids]))
    ops += d["NFRIC"] * 3 + d["NLIM"] * 30 + s.ncon_max * 40  # row constants, impedances
    ops += 2 * nv + 3 * nv + 2 * 7 + 30 + 10  # integrate
    last = s.nsite * (rot + qmul + qmat) + len(s.sensors) * 30 + 12 * int(anc[s.site_bodyid[0]].sum())
    rows_active = d["NFRIC"] + nlim_act + 4 * ncon_act

    # ---- the solver in the dense form: packed Cholesky, dense facet rows
    chol = sum((nv - k) + (nv - k - 1) * (nv - k) for k in range(nv)) + nv
    solve = 2 * nv * nv
    dense_rows = 4 * ncon_act
    jx = d["NFRIC"] + nlim_act + dense_rows * 2 * nv  # one J x over the active rows
    dense_ops = chol + solve  # qacc_smooth
    dense_ops += ncon_act * (4 * foot_dofs * (9 + 3 + 5 + 2) + 24)  # contact Jacobian rows
    dense_ops += 2 * (2 * nv * nv + 3 * nv + jx + rows_active * 8)  # two start costs
    dense_ops += 2 * nv * nv + 2 * nv + jx + rows_active * 6  # gradient
    dense_ops += dense_rows * (foot_dofs * (foot_dofs + 1))  # Hessian rank-1 updates
    dense_ops += chol + solve + jx + 2 * nv * nv + 4 * nv  # Newton direction, line data
    dense_ops += s.ls_iterations * (rows_active * 10 + 6)  # linesearch

    # ---- the solver in the block-arrow form of the source
    part = MK.partition(s, dense)
    r, lens = part.root, [e - a for a, e in part.chains]
    tri = lambda n: n * (n + 1) // 2
    fac = lambda n: sum(2 + (n - k - 1) + (n - k - 1) * (n - k) for k in range(n))  # sqrt, 1/x, scale, updates
    chol = sum(fac(n) + sum(r + 2 * r * (n - k - 1) for k in range(n)) for n in lens)  # chains, panels
    chol += 2 * tri(r) * sum(lens) + fac(r)  # Schur complement, root
    tri_solve = lambda n: n * (n - 1) + n  # one triangular solve
    solve = sum(2 * tri_solve(n) + 4 * r * n for n in lens) + 2 * tri_solve(r)
    nba = d["NBA"] if not dense else tri(nv)
    symv = 2 * (2 * nba - nv)
    base = 6 * foot_dofs  # three base rows of one contact times a vector
    jx = d["NFRIC"] + nlim_act + ncon_act * (base + 8)
    ba_ops = chol + solve  # qacc_smooth
    ba_ops += ncon_act * (foot_dofs * 27 + base + 8)  # base rows on the support, facet velocities
    ba_ops += nv + symv + 2 * nv + 2 * jx + 2 * rows_active * 8  # two start costs (no quadratic term at qacc_smooth)
    ba_ops += nv + symv + jx + rows_active * 6 + ncon_act * 16  # residuals, g and h, facets folded
    ba_ops += 2 * (d["NFRIC"] + nlim_act) + ncon_act * base  # gradient and Hessian diagonal, gathered per dof
    # contact curvature on the support triangle: facet rank-1 updates, or W J
    # per column (W is 3 x 3 with t1t2 = 0: 11) and 6 per entry
    ba_ops += ncon_act * min(4 * foot_dofs * (foot_dofs + 1), 11 * foot_dofs + 6 * tri(int(round(foot_dofs))))
    ba_ops += chol + solve + nv + jx + symv + 4 * nv  # Newton direction, line data
    ba_ops += s.ls_iterations * (rows_active * 10 + 6)  # linesearch

    total = lambda solver: n_envs * ((ops + solver) * n_substeps + last)
    return nbytes, total(ba_ops), total(dense_ops)


def load_modules():
    """The port's modules, imported after the card is known to be there."""
    import types

    from open_duck_playground_torch.envs import joystick, randomize, wrappers
    from open_duck_playground_torch.models import loader
    from open_duck_playground_torch.physics import collision, forward, kinematics, megakernel
    from open_duck_playground_torch.tools import issue_bench
    from open_duck_playground_torch.train import config, networks, ppo, running_stats

    return types.SimpleNamespace(
        J=joystick, R=randomize, W=wrappers, loader=loader, C=collision, F=forward, K=kinematics,
        MK=megakernel, IB=issue_bench, cfg=config, N=networks, ppo=ppo, RS=running_stats)


def build_phase(P, models):
    """nvcc on every kernel source at once: one process per library.
    `models` maps a kernel's name to (model, dense partition?)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(models) + 1) as pool:
        futures = {name: pool.submit(P.MK.kernel, m.spec, dense) for name, (m, dense) in models.items()}
        probe = pool.submit(P.IB.library)
        kernels = {name: f.result() for name, f in futures.items()}
        probe = probe.result()
    wall = time.perf_counter() - t0
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
          "occupancy": "set by the launch: one block of 1-32 warps per SM"})
    emit({"phase": "build", "kernel": "all", "parallel_wall_seconds": round(wall, 3)})
    return kernels


def start_state(P, model, gen, hfield: bool, n_envs: int = N_ENVS):
    """Domain-randomized envs near the home keyframe (qpos 0.01, qvel 0.1
    normal). On the heightfield the base is spread uniformly over +-3 m in x
    and y and lifted as the env's spawn is (hfield_size[2] + 0.002)."""
    dev = model.device
    m = P.R.domain_randomize(model, P.R.DRDraws.sample(gen, n_envs, model.spec))
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


def kernel_phase(P, name, model, gen, replaces, timing_reps, dense=False, n_envs=N_ENVS):
    """kernel_vs_plain and kernel_timing of one megakernel build; returns
    its row of the kernel table. The first launch, with the counts at 0
    just before it, is the degenerate partition's whole path (`launches` of
    its row); the other builds' rows get their launches from the training
    paths later."""
    MK, F = P.MK, P.F
    dev = model.device
    hfield = model.spec.floor_is_hfield
    m, d0, ctrl = start_state(P, model, gen, hfield, n_envs)
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
    emit({"phase": "kernel_vs_plain", "kernel": name, "envs": n_envs, "substeps": N_SUBSTEPS,
          "gates": {"p90_max": GATES, "derived_p90": DERIVED_P90,
                    "edge_copies": EDGE_COPIES, "edge_scale": EDGE_SCALE},
          "errors": check, "edges": edges, **terrain, "finite": finite,
          "ok": not failures and finite})
    if failures or not finite:
        raise SystemExit(f"{name} disagrees with its plain version: {failures}")

    ms = cuda_ms(lambda: step(m, d0, ctrl, N_SUBSTEPS), timing_reps)
    plain_ms = cuda_ms(lambda: F.step_reference(m, d0, ctrl, N_SUBSTEPS), 2)
    active_contacts, active_limits = active_rows(m, got)
    nbytes, nops, dense_ops = megakernel_work(m, n_envs, N_SUBSTEPS, active_contacts, active_limits, dense)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / F32_FLOPS
    bound_ms = max(bytes_ms, ops_ms)
    # the same launch at 4x the envs: where the card is full, the time per
    # env stays; where latency, not work, sets the time, it falls
    m4 = P.R.domain_randomize(model, P.R.DRDraws.sample(gen, 4 * n_envs, model.spec))
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


def rollout_phase(P, gen, smi, steps: int) -> int:
    """The training rollout on the plane scene; returns the kernel launches."""
    dev = gen.device
    cfg = P.cfg.PPOConfig()
    env = P.J.Joystick("flat_terrain_backlash", device=dev)
    wrapped = P.W.TrainingEnv(env, cfg.episode_length,
                              dr_draws=P.R.DRDraws.sample(gen, cfg.num_envs, env.model.spec))
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


# The probe against its plain version: every variant and chain count, one
# warp per scheduler, PROBE_CHECK_TRIPS trips (128 rounds) from starts in
# [0.5, 0.6). The plain version accumulates in f64; the kernel rounds every
# round to f32, half an ulp of 0.5-1 (3e-8 to 6e-8), which over 128 rounds
# of `fma` or `add` adds up to 3.8e-6 to 7.6e-6 if every rounding falls the
# same way. `exp` and `sqrt_div` contract to a fixed point and forget
# earlier roundings.
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

    errs = {}
    for variant in IB.VARIANTS:
        for chains in IB.CHAINS:
            x = 0.5 + 0.1 * torch.rand((chains, sms * 128), generator=gen, device=dev)
            got = IB.run(variant, x, PROBE_CHECK_TRIPS)
            want = IB.plain(variant, x, PROBE_CHECK_TRIPS)
            errs[f"{variant}/{chains}"] = float((got - want).abs().max())
    torch.cuda.synchronize()
    max_err = max(errs.values())

    variant, chains, warps, trips = PROBE_ROW
    x = torch.full((chains, sms * 32 * warps), IB.X0, device=dev)
    ms = cuda_ms(lambda: IB.run(variant, x, trips, 32 * warps), 20)
    plain_ms = cuda_ms(lambda: IB.plain(variant, x, trips), 2)
    nops = x.numel() * trips * IB.ROUNDS * IB.OPS_PER_ROUND[variant]
    nbytes = 4 * (2 * x.numel() + 2 * chains) + 8 * sms  # x in, x out, constants, cycle counts
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / F32_FLOPS
    peak = max(rows, key=lambda r: r["ops_per_clock_per_sm"])
    emit({"phase": "issue_probe", "summary": True, "configs": len(rows), "launches": launches,
          "peak_ops_per_clock_per_sm": peak["ops_per_clock_per_sm"],
          "peak_config": [peak["variant"], peak["chains"], peak["warps_per_sm"]],
          "peak_share_of_67_tflops": peak["share_of_67_tflops"],
          "kernel_vs_plain": {"trips": PROBE_CHECK_TRIPS, "tolerance": PROBE_TOLERANCE,
                              "max_abs_err": max_err, "by_variant_and_chains": errs},
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
                                dr_draws=P.R.DRDraws.sample(gen, cfg.num_envs, env.model.spec))
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
          "frames_seen": frames, "env_steps": ts.env_steps, "ok": ok, "card": smi})
    if not ok:
        raise SystemExit(f"ppo_step failed: {launches} launches for {control_steps} control steps, "
                         f"finite {finite}, params changed {changed}, normalizer count {count} "
                         f"for {frames} frames")
    return launches_hfield


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
    build_phase(P, {"megakernel_step": (flat, False), "megakernel_step_hfield": (rough, False),
                    "megakernel_step_dense": (flat, True)})

    gen = torch.Generator(device=dev).manual_seed(0)
    row_flat = kernel_phase(P, "megakernel_step", flat, gen, P.MK.TPU_KERNEL, timing_reps=10)
    row_hfield = kernel_phase(P, "megakernel_step_hfield", rough, gen, P.MK.TPU_KERNEL_HFIELD,
                              timing_reps=10)
    row_dense = kernel_phase(P, "megakernel_step_dense", flat, gen, P.MK.TPU_KERNEL_DENSE,
                             timing_reps=10, dense=True, n_envs=N_ENVS_DENSE)
    row_flat["launches"] = rollout_phase(P, gen, smi, steps=5)
    row_probe = probe_phase(P, gen, smi)
    row_hfield["launches"] = ppo_phase(P, gen, smi)

    emit({"kernels": [row_flat, row_hfield, row_dense, row_probe], "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
