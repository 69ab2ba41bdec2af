"""Bytes of one fused task step of the port (`tk_pre` and `tk_post`, its two
CUDA kernels around the physics launch) per env: a frozen copy of the
port's `chip_smoke.py:task_bytes`, with the observation widths of
`csrc/task_step.cuh` (`TK_NSTATE`, `TK_NPRIV`) written out, so that a later
change of the port's kernels does not move this count. The kernels' least
time is these bytes over the HBM peak: at the eval's batch their measured
time is launch latency, and the share reads low.

`d` is the build's `kernel_dims` (`STANDING` 1 for the standing term set,
absent or 0 for the joystick's), `nmetrics` the rows of the metrics table
the step writes."""

from __future__ import annotations

from typing import Dict, Tuple

NCMD = 7


def obs_sizes(d: Dict[str, int]) -> Tuple[int, int]:
    """The widths of the observations `state` and `privileged_state`."""
    U, F2 = d["NU"], d["NFOOT"]
    nref = d["GDIM"] if d["IMITATION"] else 0
    nstate = 3 + 3 + NCMD + 5 * U + d["OBS_MOTOR"] * U + F2 + (2 if d["OBS_PHASE"] else nref)
    npriv = nstate + 15 + 3 * U + 1 + F2 + 3 * F2 + F2 + nref + (3 if d["OBS_PHASE"] else 0)
    return nstate, npriv


def task_bytes(d: Dict[str, int], nmetrics: int) -> int:
    """Bytes the two task launches read and write per env, each counted
    once: the pre launch's inputs (the gait frame it gathers among them)
    and outputs, and the post launch's, of the physics outputs only the
    entries it reads (the feet's heights, the IMU's frame, 19 sensor
    values; the standing terms' orientation reads 2 more)."""
    U, V, Q, IH, F2 = d["NU"], d["NV"], d["NQ"], d["IHIST"], d["NFOOT"]
    nref = d["GDIM"] if d["IMITATION"] else 0
    nsens = 19 + 2 * int(bool(d.get("STANDING")))
    nstate, npriv = obs_sizes(d)
    pre = 4 * (U + V + 1 + 7 + d["AHIST"] * U + 2 + U + 2 + nref) + 8 + 4 * (
        1 + 2 * d["IMITATION"] * d["OBS_PHASE"] + nref + d["AHIST"] * U + 2 + V + U)
    post_in = 4 * (Q + V + F2 + 9 + U + F2 * d["KPTS"] + nsens + U + 7 + 3 * U + U + 1 + 2 * d["OBS_PHASE"] + nref
                   + 2 * F2 + 2 + 3 * IH + 9 + 2 * U + 7)
    post_out = 4 * (nstate + npriv + 2 + 2 * F2 + 3 * IH + 2 + 7 + nmetrics) + F2
    return pre + post_in + post_out
