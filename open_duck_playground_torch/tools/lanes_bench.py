"""Time the physics megakernel at 8, 16 and 32 lanes per env.

    python -m open_duck_playground_torch.tools.lanes_bench [--envs 8192] [--scene NAME]

from the repository's root (it takes its start states and its timer from
`chip_smoke.py`). The lanes per env are a constant of `csrc/megakernel.cu`
(`MK_LANES`), not an option of the package or of the build. This tool
writes three copies of that source into `build/kernels/` with the constant
set to 8, 16 and 32, builds each, checks it against the plain version
(`forward.step_reference`, one substep, max error over all envs) and times
one launch of 10 substeps at `--envs` envs and at four times as many, in
turns (8, 16, 32, 32, 16, 8) so that a drift of the card's clock shows. One
JSON line per build and turn; the committed constant is the fastest at 8192
envs. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

LANES = (8, 16, 32)
N_SUBSTEPS = 10


def main(argv=None) -> int:
    import chip_smoke as CS
    from open_duck_playground_torch import cuda_build
    from open_duck_playground_torch.physics import megakernel as MK

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=CS.N_ENVS)
    ap.add_argument("--scene", default="scene_flat_terrain_backlash")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lanes_bench: no CUDA device", file=sys.stderr)
        return 2
    card = CS.nvidia_smi()
    P = CS.load_modules()
    P.F.pin_f32()
    model = P.loader.load_model(args.scene, device="cuda", dtype=torch.float32, timestep=0.002)
    gen = torch.Generator(device="cuda").manual_seed(0)
    hfield = model.spec.floor_is_hfield
    small = CS.start_state(P, model, gen, hfield, args.envs)
    large = CS.start_state(P, model, gen, hfield, 4 * args.envs)
    want = P.F.step_reference(*small, 1)

    committed = (cuda_build.CSRC / "megakernel.cu").read_text()
    constant = "#define MK_LANES 32\n"
    assert committed.count(constant) == 1
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    kernels = {}
    for lanes in LANES:
        copy = cuda_build.BUILD_DIR / f"megakernel_lanes{lanes}.cu"
        copy.write_text(committed.replace(constant, f"#define MK_LANES {lanes}\n"))
        kernels[lanes] = MK._Kernel(MK.kernel_dims(model.spec), source=str(copy))

    def step(k, m, d, ctrl, n):
        record, hfield = k.record(m, d.qpos.device)
        ins, outs = MK.kernel_tensors(m, d, ctrl, n, hfield)
        err = k.lib.mk_step(record.data_ptr(), MK.pointer_array(ins + outs), d.qpos.shape[0], n,
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
        return MK.data_from_outputs(d, ctrl, outs)

    for lanes in LANES + LANES[::-1]:
        k = kernels[lanes]
        got = step(k, *small, 1)
        err = {f: float(CS.per_env_err(getattr(got, f), getattr(want, f)).max()) for f in CS.GATES}
        ms = CS.cuda_ms(lambda: step(k, *small, N_SUBSTEPS), args.reps)
        step(k, *large, 1)
        ms4 = CS.cuda_ms(lambda: step(k, *large, N_SUBSTEPS), 3)
        info = k.info()
        assert info["lanes_per_env"] == lanes
        print(json.dumps({
            "lanes_per_env": lanes, "scene": args.scene, "envs": args.envs, "substeps": N_SUBSTEPS,
            "ms": ms, f"ms_at_{4 * args.envs}_envs": ms4,
            "us_per_1k_envs": 1e3 * ms / (args.envs / 1e3),
            f"us_per_1k_envs_at_{4 * args.envs}": 1e3 * ms4 / (4 * args.envs / 1e3),
            "max_abs_err_one_substep": err, "registers_per_thread": info["registers_per_thread"],
            "local_bytes_per_thread": info["local_bytes_per_thread"],
            "shared_bytes_per_block": info["shared_bytes_per_block"],
            "resident_envs_per_sm": info["resident_envs_per_sm"],
            "resident_warps_per_sm": info["resident_warps_per_sm"],
            "nvcc_seconds": round(k.build_seconds, 1), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
