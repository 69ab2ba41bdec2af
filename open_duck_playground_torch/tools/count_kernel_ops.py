"""Census of the physics megakernel's machine code: the Hopper counterpart
of the JAX package's `tools/count_kernel_ops.py`.

    python -m open_duck_playground_torch.tools.count_kernel_ops \\
        [--task flat_terrain_backlash] [--dense] [--slots] [--by_line] \\
        [--sass LISTING] [--top 12]

On the TPU the kernel's program was its jaxpr, traced without a device; on
Hopper it is the SASS of the built library. The tool builds the megakernel
for the task's scene (rows 1, 1f, 1h, 1n of PERF.md; `--dense`: row 1d, the
degenerate partition) with nvcc, as the training path builds it, reads
`cuobjdump -sass` of the library, picks the kernel by its mangled name
(`mk_kernel`), and reports:

  - the static instructions by class: FFMA, FMUL, FADD, MUFU, LDS, STS,
    LDG, STG, LDL, STL, BAR, SHFL, branch and other (the `*32I` immediate
    forms counted with their opcode);
  - each FFMA by its sources: `three_registers` (three general registers,
    none read from the operand reuse cache: such an FFMA issues every
    other cycle, the probe's finding), `reuse` (a `.reuse` source),
    `uniform_or_constant` (a `UR` register or a `c[..]` bank operand),
    `immediate_or_rz` (an immediate or RZ);
  - `--by_line`: static instructions per source line of
    `csrc/megakernel.cuh`, from a second build of the same source with
    `-lineinfo` into its own library, disassembled by `nvdisasm -g` from
    the cubin that `cuobjdump -xelf` extracts. The tool checks that this
    build's census equals the production build's and raises where it
    differs;
  - `--slots`: an issue-bound lower bound on one launch and the
    speed-of-light env rate. The f32 operations per launch come from
    `megakernel_work` (at `--envs`, `--substeps` and this many active
    contacts and joint limits per env); the census's arithmetic mix turns
    them into thread instructions (an FFMA does two operations, FMUL, FADD
    and MUFU one), 32 lanes make a warp instruction, each scheduler issues
    one warp instruction per clock (4 per SM, 132 SMs) at `--clock_ghz`
    (the SM clock the issue probe reads), and an FFMA of the
    three-register class costs two issue cycles, every other one.

The census is static: each instruction counts once, not weighted by how
often its loop runs. Like the JAX tool's census it is a proxy, not the
objective: where it moves, the kernel's time need not.

`--sass FILE` reads a `cuobjdump -sass` listing instead of building (no
card needed). Prints a text summary, then one JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from open_duck_playground_torch.tools import benchutil
from open_duck_playground_torch.tools import issue_bench as IB

KERNEL = "mk_kernel"
CLASSES = ("FFMA", "FMUL", "FADD", "MUFU", "LDS", "STS", "LDG", "STG", "LDL", "STL", "BAR", "SHFL", "branch",
           "other")
BRANCHES = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BREAK", "WARPSYNC", "BPT"}
FFMA_CLASSES = ("three_registers", "reuse", "uniform_or_constant", "immediate_or_rz")
# an H100 SXM: 4 warp schedulers per SM, 132 SMs; the SM clock under load
# as the issue probe reads it from the kernel's own timers on that card
SCHEDULERS_PER_SM, SMS, CLOCK_GHZ = 4, 132, 1.98
NOTE = ("static census: each instruction counts once, not weighted by loop trips; "
        "a proxy for issue pressure, not the objective")
_REGISTER = re.compile(r"R\d+(\.reuse)?")
_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
_TEXT = re.compile(r"^\s*\.text\.(\S+):")


def opclass(instr: str) -> str:
    op = IB._split(instr)[0]
    op = op[:-3] if op.endswith("32I") else op
    return op if op in CLASSES else "branch" if op in BRANCHES else "other"


def ffma_class(instr: str) -> str:
    """The class of one FFMA by its three source operands."""
    sources = [s.strip("-|") for s in IB._split(instr)[1][1:4]]
    if any(s.startswith(("UR", "c[")) for s in sources):
        return "uniform_or_constant"
    if any(s.endswith(".reuse") for s in sources):
        return "reuse"
    if all(_REGISTER.fullmatch(s) for s in sources):
        return "three_registers"
    return "immediate_or_rz"


def census(instrs: List[Tuple[int, str]]) -> dict:
    """Static instructions by class and opcode, and the FFMAs by source
    class, of one function's (address, instruction) list."""
    by_class = Counter(opclass(i) for _, i in instrs)
    ffma = Counter(ffma_class(i) for _, i in instrs if opclass(i) == "FFMA")
    n_ffma = sum(ffma.values())
    return {"static_instructions": len(instrs),
            "by_class": {c: by_class.get(c, 0) for c in CLASSES},
            "by_opcode": dict(Counter(IB._split(i)[0] for _, i in instrs).most_common()),
            "ffma": {"count": n_ffma, **{c: ffma.get(c, 0) for c in FFMA_CLASSES},
                     "three_register_share": ffma.get("three_registers", 0) / n_ffma if n_ffma else None},
            "ldl_stl": by_class.get("LDL", 0) + by_class.get("STL", 0)}


def kernel_function(text: str) -> Tuple[str, List[Tuple[int, str]]]:
    """(mangled name, instructions) of the megakernel in a listing."""
    found = {name: body for name, body in IB.parse_functions(text).items() if KERNEL in name}
    if len(found) != 1:
        raise RuntimeError(f"want one {KERNEL} function in the listing, found {sorted(found)}")
    return next(iter(found.items()))


def sass_text(path) -> str:
    return subprocess.run([IB.cuobjdump(), "-sass", str(path)], capture_output=True, text=True, check=True,
                          timeout=300).stdout


def nvdisasm() -> str:
    found = shutil.which("nvdisasm")
    if found:
        return found
    default = os.path.join(os.path.dirname(IB.cuobjdump()), "nvdisasm")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvdisasm not found beside cuobjdump")


def lineinfo_library(spec, dense: bool = False):
    """The megakernel of `spec` built again with `-lineinfo` (its own
    library name: the flags enter the digest). Builds only that library,
    so it may run beside the production build."""
    from open_duck_playground_torch import cuda_build
    from open_duck_playground_torch.physics import megakernel as MK

    flags = [*MK.build_flags(MK.kernel_dims(spec, dense)), "-lineinfo"]
    return cuda_build.build(MK.SOURCE, flags, headers=MK.HEADERS)


def line_text(path) -> str:
    """`nvdisasm -g` of every cubin in the library at `path`."""
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([IB.cuobjdump(), "-xelf", "all", str(path)], cwd=tmp, capture_output=True, check=True,
                       timeout=300)
        cubins = sorted(pathlib.Path(tmp).glob("*.cubin"))
        if not cubins:
            raise RuntimeError(f"cuobjdump -xelf found no cubin in {path}")
        return "".join(subprocess.run([nvdisasm(), "-g", "-c", str(c)], capture_output=True, text=True,
                                      check=True, timeout=300).stdout for c in cubins)


def lines_census(text: str) -> Dict[Tuple[str, int], Counter]:
    """`nvdisasm -g` output -> {(file, line): Counter of instruction
    classes, FFMAs of the three-register class as "three_registers"}, for
    the megakernel's function."""
    out: Dict[Tuple[str, int], Counter] = {}
    function, where = None, None
    for line in text.splitlines():
        t = _TEXT.match(line)
        if t:
            function, where = t.group(1), None
            continue
        loc = _LINE.search(line)
        if loc:
            where = (os.path.basename(loc.group(1)), int(loc.group(2)))
            continue
        ins = IB._INSTR.search(line)
        if ins and function and KERNEL in function:
            c = out.setdefault(where or ("?", 0), Counter())
            cls = opclass(ins.group(2))
            c[cls] += 1
            c["instructions"] += 1
            if cls == "FFMA" and ffma_class(ins.group(2)) == "three_registers":
                c["three_registers"] += 1
    return out


def by_line(spec, dense: bool, production: dict, top: int) -> dict:
    """Static instructions per source line, from the `-lineinfo` build,
    whose census must equal `production`'s."""
    from open_duck_playground_torch.physics import megakernel as MK

    lib = lineinfo_library(spec, dense)
    same = census(kernel_function(sass_text(lib.path))[1])
    if same != production:
        raise RuntimeError("the -lineinfo build's census differs from the production build's: "
                           f"{same['by_class']} vs {production['by_class']}")
    lines = lines_census(line_text(lib.path))
    total = sum(c["instructions"] for c in lines.values())
    if total != production["static_instructions"]:
        raise RuntimeError(f"nvdisasm gave {total} instructions, cuobjdump {production['static_instructions']}")
    source = (MK.CSRC / "megakernel.cuh").read_text().splitlines()
    ranked = sorted(lines.items(), key=lambda kv: -kv[1]["instructions"])
    in_body = sum(c["instructions"] for (f, _), c in lines.items() if f == "megakernel.cuh")
    return {"library": lib.path.name, "instructions_on_megakernel_cuh": in_body,
            "share_on_megakernel_cuh": in_body / total,
            "top": [{"file": f, "line": n, **dict(c),
                     "text": source[n - 1].strip() if f == "megakernel.cuh" and 0 < n <= len(source) else None}
                    for (f, n), c in ranked[:top]]}


def issue_bound(cen: dict, f32_ops: float, n_envs: int, clock_ghz: float = CLOCK_GHZ) -> dict:
    """The least time one launch can take to issue its arithmetic (see the
    module's docstring), and the env rate it allows."""
    k = cen["by_class"]
    arith = k["FFMA"] + k["FMUL"] + k["FADD"] + k["MUFU"]
    ops_per_instruction = (2 * k["FFMA"] + k["FMUL"] + k["FADD"] + k["MUFU"]) / arith
    cycles_per_instruction = (arith + cen["ffma"]["three_registers"]) / arith
    warp_instructions = f32_ops / ops_per_instruction / 32
    seconds = warp_instructions * cycles_per_instruction / (SCHEDULERS_PER_SM * SMS * clock_ghz * 1e9)
    return {"f32_ops": f32_ops, "ops_per_arith_instruction": ops_per_instruction,
            "issue_cycles_per_arith_instruction": cycles_per_instruction,
            "warp_instructions": warp_instructions, "clock_ghz": clock_ghz, "issue_bound_ms": 1e3 * seconds,
            "speed_of_light_env_steps_per_s": n_envs / seconds}


def probe_agreement() -> List[dict]:
    """The FFMA classes on the issue probe's library, against
    `issue_bench.sass_report`'s reading of the same loops: in `registers`
    every loop FFMA has register sources only (`three_registers`, or
    `reuse` where the report counts reused sources), in `constant` every
    one reads a uniform register or a bank. Raises where they differ."""
    kernels = IB.parse_sass(sass_text(IB.library().path))
    rows = []
    for v, chains in (("fma", 1), ("fma", 8)):
        for operands in IB.OPERANDS:
            instrs = kernels[(v, chains, operands)]
            loop = [i for _, i in IB.hot_loop(instrs, "FFMA") if opclass(i) == "FFMA"]
            classes = Counter(ffma_class(i) for i in loop)
            report = IB.loop_report(instrs, v, chains)
            want_ffma = round(report["per_trip_by_opcode"]["FFMA"] * report["trips_per_loop"])
            if operands == "constant":
                ok = classes["uniform_or_constant"] == len(loop)
            else:
                ok = (classes["uniform_or_constant"] == 0 and report["ops_with_constant_bank_source"] == 0
                      and classes["three_registers"] + classes["reuse"] == len(loop)
                      and (classes["reuse"] == 0) == (report["register_sources_with_reuse"] == 0))
            ok = ok and len(loop) == want_ffma
            rows.append({"variant": v, "chains": chains, "operands": operands, "loop_ffma": len(loop),
                         "classes": dict(classes), "report_reused_sources": report["register_sources_with_reuse"],
                         "report_first": report["first"][:1], "ok": ok})
            if not ok:
                raise RuntimeError(f"FFMA classes disagree with issue_bench.sass_report: {rows[-1]}")
    return rows



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


def main(argv=None, device="cuda") -> dict:
    """Run the census; returns its JSON record. Building and disassembling
    need the card's machine (nvcc, cuobjdump, nvdisasm); `--sass` and
    `device="cpu"` read a given listing on any host."""
    import torch

    from open_duck_playground_torch.envs import duck_base
    from open_duck_playground_torch.models import loader
    from open_duck_playground_torch.physics import megakernel as MK

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="flat_terrain_backlash")
    ap.add_argument("--dense", action="store_true", help="the degenerate partition (row 1d)")
    ap.add_argument("--sass", default=None, help="read this cuobjdump -sass listing instead of building")
    ap.add_argument("--slots", action="store_true", help="issue-bound lower bound and speed-of-light env rate")
    ap.add_argument("--by_line", action="store_true", help="static instructions per source line")
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--contacts", type=float, default=7.41, help="active contacts per env (PERF.md, flat)")
    ap.add_argument("--limits", type=float, default=5.49, help="active joint-limit rows per env")
    ap.add_argument("--clock_ghz", type=float, default=CLOCK_GHZ)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    m = loader.load_model(duck_base.task_to_scene(args.task), device=dev, dtype=torch.float32, timestep=0.002)
    if args.sass is not None:
        library, text = args.sass, pathlib.Path(args.sass).read_text()
    else:
        if dev.type != "cuda":
            raise SystemExit("count_kernel_ops builds the kernel on the card's machine; pass --sass on a CPU")
        library = MK.kernel(m.spec, args.dense).path
        text = sass_text(library)
    name, instrs = kernel_function(text)
    record = {"tool": "count_kernel_ops", "task": args.task, "dense": args.dense,
              "library": pathlib.Path(library).name, "kernel": name, **census(instrs), "note": NOTE}
    k, f = record["by_class"], record["ffma"]
    print(f"task={args.task} dense={args.dense} kernel={name} static_instructions={record['static_instructions']}")
    for c in CLASSES:
        print(f"  {c:24s} {k[c]}")
    print(f"  FFMA sources: " + ", ".join(f"{c} {f[c]}" for c in FFMA_CLASSES)
          + f" (three-register share {f['three_register_share']})")
    print(f"  ({NOTE})")
    if args.slots:
        _, ops, _ = megakernel_work(m, args.envs, args.substeps, args.contacts, args.limits, args.dense)
        record["slots"] = {"envs": args.envs, "substeps": args.substeps, "active_contacts": args.contacts,
                           "active_limits": args.limits, **issue_bound(record, ops, args.envs, args.clock_ghz)}
        s = record["slots"]
        print(f"\nissue-bound lower bound: {s['issue_bound_ms']:.4f} ms per launch of {args.envs} envs "
              f"x {args.substeps} substeps ({s['warp_instructions']:.3e} warp instructions, "
              f"{s['issue_cycles_per_arith_instruction']:.3f} issue cycles each)")
        print(f"speed-of-light (issue-bound, {args.clock_ghz} GHz): "
              f"{s['speed_of_light_env_steps_per_s']:,.0f} env steps/s/card (10 substeps/env step)")
    if args.by_line:
        if args.sass is not None:
            raise SystemExit("--by_line builds the -lineinfo library: it takes no --sass")
        record["by_line"] = by_line(m.spec, args.dense, census(instrs), args.top)
        print("\nstatic instructions by source line (megakernel.cuh):")
        for row in record["by_line"]["top"]:
            print(f"  {row['instructions']:7d}  {row['file']}:{row['line']}  {row['text']}")
    record["device"] = benchutil.device_name(dev)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
