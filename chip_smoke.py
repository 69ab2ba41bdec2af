#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: the card's name and power limit;
  2. build: nvcc builds the physics megakernel from csrc/ into build/kernels/;
  3. kernel: the CUDA kernel against its plain version
     (`forward.step_reference`) at 8192 domain-randomized envs, substep by
     substep along the kernel's trajectory and over 10 substeps in one
     launch, with times and the card's least time for the same work;
  4. rollout: the training rollout (TrainingEnv + Joystick on
     flat_terrain_backlash, the 128x4 policy in the loop), 8192 envs x 20
     control steps, every physics step through the kernel.
Then the kernel table, the nvidia-smi line, and `{"ok": true, ...}` last.
Exits non-zero, printing no result, without a CUDA card or when a phase
fails. Needs no network; the kernel build counts against the run.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ENVS = 8192
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
# differs by more than max. Such an env passes only if the plain version is
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


def megakernel_work(m, n_envs: int, n_substeps: int, active_contacts: float, active_limits: float):
    """(bytes, f32 operations) the kernel's function needs for one launch.

    Bytes: each per-env input read once and each output written once.
    Operations: counted from the loops of csrc/megakernel.cuh, one per add,
    multiply, divide, sqrt, sin or cos, with the data-dependent rows (active
    contacts and joint limits) at this run's average."""
    from open_duck_playground_torch.physics import megakernel as MK
    from open_duck_playground_torch.physics import structure

    s = m.spec
    d = MK.kernel_dims(s)
    nq, nv, nu, nb, nj = s.nq, s.nv, s.nu, s.nbody, s.njnt
    # qpos qvel ctrl warmstart | qpos0 gain0 bias0-2 frictionloss armature mass ipos mu
    floats_in = nq + nv + nu + nv + nq + 4 * nu + 2 * nv + nb + 3 * nb + 1
    floats_out = nq + 3 * nv + s.nsite * 12 + nu + s.ncon_max + s.nsensordata
    nbytes = 4 * n_envs * (floats_in + floats_out)

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
    chol = sum((nv - k) + (nv - k - 1) * (nv - k) for k in range(nv)) + nv
    solve = 2 * nv * nv
    ops += chol + solve  # qacc_smooth
    ops += (len(s.collide_geom_ids) + 1) * (rot + 3 + qmul) + len(s.collide_geom_ids) * d["NVERT"] * (rot + 8)
    nlim_act, ncon_act = active_limits, active_contacts
    foot_dofs = float(np.mean([anc[s.geom_bodyid[g]].sum() for g in s.collide_geom_ids]))
    ops += d["NFRIC"] * 3 + d["NLIM"] * 30 + s.ncon_max * 40
    ops += ncon_act * (4 * foot_dofs * (9 + 3 + 5 + 2) + 24)  # contact Jacobian rows
    rows_active = d["NFRIC"] + nlim_act + 4 * ncon_act
    dense_rows = 4 * ncon_act
    jx = d["NFRIC"] + nlim_act + dense_rows * 2 * nv  # one J x over the active rows
    ops += 2 * (2 * nv * nv + 3 * nv + jx + rows_active * 8)  # two start costs
    ops += 2 * nv * nv + 2 * nv + jx + rows_active * 6  # gradient
    ops += dense_rows * (foot_dofs * (foot_dofs + 1))  # Hessian rank-1 updates
    ops += chol + solve + jx + 2 * nv * nv + 4 * nv  # Newton direction, line data
    ops += s.ls_iterations * (rows_active * 10 + 6)  # linesearch
    ops += 2 * nv + 3 * nv + 2 * 7 + 30 + 10  # integrate
    ops *= n_substeps
    ops += s.nsite * (rot + qmul + qmat) + len(s.sensors) * 30 + 12 * int(anc[s.site_bodyid[0]].sum())
    return nbytes, n_envs * ops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2

    from open_duck_playground_torch.envs.joystick import Joystick, ResetDraws, StepDraws
    from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
    from open_duck_playground_torch.envs.wrappers import TrainingEnv
    from open_duck_playground_torch.models import loader
    from open_duck_playground_torch.physics import forward as F
    from open_duck_playground_torch.physics import megakernel as MK
    from open_duck_playground_torch.train import networks as N
    from open_duck_playground_torch.train import running_stats as RS
    from open_duck_playground_torch.train.config import PPOConfig

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    F.pin_f32()

    # ---- 2. build
    model = loader.load_model(device=dev, dtype=torch.float32, timestep=0.002)
    t0 = time.perf_counter()
    kernel = MK.kernel(model.spec)
    build_s = time.perf_counter() - t0
    info = kernel.info()
    ptxas = [l.strip() for l in kernel.build_log.splitlines()
             if "registers" in l or "spill" in l or "stack frame" in l]
    resident = info["blocks_per_sm"] * info["block_size"]
    emit({"phase": "build", "nvcc_seconds": round(kernel.build_seconds, 3),
          "first_use_seconds": round(build_s, 3), **info,
          "resident_threads_per_sm": resident,
          "occupancy": resident / 2048, "ptxas": ptxas})

    # ---- 3. kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)
    m = domain_randomize(model, DRDraws.sample(gen, N_ENVS, model.spec))
    rng = np.random.default_rng(0)
    kq, kc = model.key_qpos.cpu().numpy(), model.key_ctrl.cpu().numpy()
    qpos = np.tile(kq, (N_ENVS, 1)) + 0.01 * rng.standard_normal((N_ENVS, kq.size))
    qvel = 0.1 * rng.standard_normal((N_ENVS, model.spec.nv))
    ctrl = np.tile(kc, (N_ENVS, 1))
    qpos, qvel, ctrl = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (qpos, qvel, ctrl))
    d0 = F.init(m, qpos, qvel, ctrl)
    got = MK.megakernel_step(m, d0, ctrl, N_SUBSTEPS)
    torch.cuda.synchronize()
    want = F.step_reference(m, d0, ctrl, N_SUBSTEPS)

    check = {f: {"per_substep_max": []} for f in GATES}
    edges = []
    failures = []
    edge_gen = torch.Generator(device=dev).manual_seed(1)
    d = d0
    for sub in range(N_SUBSTEPS):  # the kernel's own trajectory, substep by substep
        k1 = MK.megakernel_step(m, d, ctrl, 1)
        p1 = F.step_reference(m, d, ctrl, 1)
        over = np.zeros(N_ENVS, bool)
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
    emit({"phase": "kernel_vs_plain", "envs": N_ENVS, "substeps": N_SUBSTEPS,
          "gates": {"p90_max": GATES, "derived_p90": DERIVED_P90,
                    "edge_copies": EDGE_COPIES, "edge_scale": EDGE_SCALE},
          "errors": check, "edges": edges, "finite": finite, "ok": not failures and finite})
    if failures or not finite:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")

    ms = cuda_ms(lambda: MK.megakernel_step(m, d0, ctrl, N_SUBSTEPS), 20)
    plain_ms = cuda_ms(lambda: F.step_reference(m, d0, ctrl, N_SUBSTEPS), 3)
    # the same launch at 4x the envs: one thread per env leaves 8192 envs at
    # ~62 threads per SM, so time per env shows how far latency, not work,
    # sets the kernel's time
    m4 = domain_randomize(model, DRDraws.sample(gen, 4 * N_ENVS, model.spec))
    d4 = d0.map(lambda x: x.repeat((4,) + (1,) * (x.dim() - 1)))
    ctrl4 = ctrl.repeat(4, 1)
    ms4 = cuda_ms(lambda: MK.megakernel_step(m4, d4, ctrl4, N_SUBSTEPS), 5)
    del m4, d4, ctrl4
    active_contacts, active_limits = active_rows(m, got)
    nbytes, nops = megakernel_work(m, N_ENVS, N_SUBSTEPS, active_contacts, active_limits)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * nops / F32_FLOPS
    bound_ms = max(bytes_ms, ops_ms)
    # one substep of kernel and plain version from the same state, edges included
    max_abs_err = max(max(check[f]["per_substep_max"]) for f in GATES)
    kernel_row = {
        "name": "megakernel_step",
        "route": "cuda",
        "source": "open_duck_playground_torch/csrc/megakernel.cu",
        "replaces": MK.TPU_KERNEL,
        "launches": None,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "tolerance": {f: g[1] for f, g in GATES.items()},
        "edge_env_substeps": len(edges),
        "qpos_p90": check["qpos"]["p90"],
        "qvel_p90": check["qvel"]["p90"],
        "bytes": nbytes,
        "f32_ops": nops,
        "active_contacts_per_env": active_contacts,
        "active_limits_per_env": active_limits,
    }
    emit({"phase": "kernel_timing", "ms": ms, "plain_ms": plain_ms, "bytes_ms": bytes_ms,
          "ops_ms": ops_ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
          f"ms_at_{4 * N_ENVS}_envs": ms4, "us_per_1k_envs": 1e3 * ms / (N_ENVS / 1e3),
          f"us_per_1k_envs_at_{4 * N_ENVS}": 1e3 * ms4 / (4 * N_ENVS / 1e3)})
    del got, want, k1, p1, d, d0, m

    # ---- 4. the training rollout through the kernel
    cfg = PPOConfig()
    env = Joystick("flat_terrain_backlash", device=dev)
    wrapped = TrainingEnv(env, cfg.episode_length, dr_draws=DRDraws.sample(gen, cfg.num_envs, env.model.spec))
    state = wrapped.reset(ResetDraws.sample(gen, cfg.num_envs, env))
    obs_sizes = {k: v.shape[-1] for k, v in state.obs.items()}
    net = N.PPONetworks.init(obs_sizes, env.action_size, cfg.policy_hidden_layer_sizes,
                             gen, device=dev)
    normalizer = RS.init(obs_sizes, device=dev)

    def rollout_step(state):
        with torch.no_grad():
            logits = net.policy_logits(RS.normalize(normalizer, state.obs))
            action = N.postprocess(N.sample_raw(logits, N.normal_noise(gen, logits)))
        return wrapped.step(state, action, StepDraws.sample(gen, cfg.num_envs, env))

    for _ in range(3):  # warm-up: allocator, cuBLAS handles
        state = rollout_step(state)
    state = wrapped.reset(ResetDraws.sample(gen, cfg.num_envs, env))
    torch.cuda.synchronize()
    MK.reset_launches()
    t0 = time.perf_counter()
    rewards = []
    for _ in range(cfg.unroll_length):
        state = rollout_step(state)
        rewards.append(state.reward)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = MK.launches
    obs_ok = all(torch.isfinite(v).all().item() and v.shape[0] == cfg.num_envs
                 for v in state.obs.values())
    rew = torch.stack(rewards)
    rew_ok = bool(torch.isfinite(rew).all().item())
    sps = cfg.num_envs * cfg.unroll_length / seconds
    emit({"phase": "rollout", "envs": cfg.num_envs, "steps": cfg.unroll_length,
          "kernel_launches": launches, "seconds": seconds, "env_steps_per_s": sps,
          "ms_per_control_step": 1e3 * seconds / cfg.unroll_length,
          "obs_shapes": {k: list(v.shape) for k, v in state.obs.items()},
          "mean_reward": float(rew.mean()), "done_frac": float(state.done.mean()),
          "obs_finite": obs_ok, "reward_finite": rew_ok, "card": smi})
    if launches != cfg.unroll_length or not (obs_ok and rew_ok):
        raise SystemExit(f"rollout failed: {launches} launches, obs ok {obs_ok}, reward ok {rew_ok}")

    kernel_row["launches"] = launches
    emit({"kernels": [kernel_row], "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
