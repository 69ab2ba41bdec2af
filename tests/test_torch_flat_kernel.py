"""The JAX Pallas megakernel on `scene_flat_terrain.xml` (the standing robot,
nq 21, nv 20: the kernel every step of JAX's standing runs on the TPU went
through) at the states standing training visits, held three ways in f32:

- the Pallas kernel in interpret mode (`MK.INTERPRET = True`, `MK.prepare`,
  `MK.megakernel_step_batched`, as test_megakernel_interpret.py runs it),
  at its 1-D lane tile of 128 envs;
- JAX's jnp engine (`F.step(..., use_megakernel=False)`), the physics every
  JAX-versus-port test so far held the port against;
- the port's plain step (`forward.step_reference`) on the port's snapshot
  of the same model.

**States.** The 128 envs are one tile: 16 control envs at the home pose
plus noise (qpos 0.01, qvel 0.1, servo targets 0.05, normal, as
test_megakernel_interpret.py builds them) and 112 physics inputs that the
port's `TrainingEnv(Standing("flat_terrain"))` took on the CPU over
`STEPS` control steps of `ENVS` envs, recorded at `forward.step` (state,
push and servo targets included), with injected draws: a push due every
5 control steps at magnitudes spread over `push_config.magnitude_range`
(0.1 to 1.0), random actions, a quarter of the envs leaning (the legs'
roll and pitch servos held to one side) and a quarter driving the head
servos bang-bang. From the 1,120 recorded inputs the test takes, distinct:
the 24 most tilted with a foot on the plane (a contact row active), the
12 most tilted of all, the 24 pushed hardest in that very step, the 24
with the fastest head joints and 28 others spread over the run. It
asserts that they cover: at least a quarter of the tile mid-fall (the
trunk's up axis more than 30 degrees off the vertical; 16 of them on a
foot), 16 pushes over 0.5 m/s and one near 1.0, 16 envs with a head joint
faster than 3.5 rad/s (the bang-bang servos reach about 4.7). Fallen envs
appear as the TrainingEnv sees them: the step that tips the trunk past
horizontal ends the episode and the next input is the autoreset state
(the scene's only contacts are the feet against the plane, so a trunk
does not come to rest on the ground).

**Gates**, each pair of the three, the control envs and the standing envs
apart: per env the p90/max gates of test_megakernel_interpret.py:103-121
(qpos p90 1e-5 / max 1e-4, qvel p90 1e-3 / max 1e-2) and its p90 gates on
the derived fields (sensordata 5e-2, site_xpos 1e-4, actuator_force 1e-2).
An env over a max gate passes only as an edge of the plain version
(`is_edge` of test_torch_standing_long.py, the rule of
test_torch_physics.py:assert_substep_gates over a control step): from its
input perturbed at rounding scale the port's plain step moves by at least
the max gate, and one perturbed result lies within the max gates of the
other side's (of each JAX side's, for the Pallas-engine pair). Its p90
gates then read the other envs; the edges are counted.

**Substeps.** The test runs 2 substeps, as test_megakernel_interpret.py
does (40-95 s on one CPU thread, most of it the Pallas interpreter and JAX's
compiling).
Run as a script it takes the production 10 substeps and prints each
pair's per-field maxima; `--tile 1024` steps the 2-D (sublane x lane) tile
JAX's training ran at 8192 envs, every group of inputs eight times larger:

    JAX_PLATFORMS=cpu python tests/test_torch_flat_kernel.py --substeps 10 [--tile 1024]
"""

if __name__ == "__main__":  # run as a script: the repo on the path, the tests' JAX settings
    import pathlib
    import sys

    sys.path[:0] = [str(pathlib.Path(__file__).resolve().parents[1])]
    import conftest  # noqa: F401  (CPU, x64)

import argparse
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_duck_playground_tpu.envs import duck_base as JD
from open_duck_playground_tpu.models import loader as JL
from open_duck_playground_tpu.physics import forward as JF
from open_duck_playground_tpu.physics import megakernel as JMK
from open_duck_playground_tpu.physics.types import Data as JData

from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.envs.wrappers import TrainingEnv
from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.physics import forward as TF
from open_duck_playground_torch.physics.types import Data

from test_torch_standing_long import is_edge

torch.set_num_threads(1)

SCENE = "scene_flat_terrain"
TILE = 128
N_CONTROL = 16
ENVS, STEPS = 28, 40
PUSH_EVERY_S = 0.1  # a push due every 5 control steps
PICKS = (("tilted_on_feet", 24), ("tilted", 12), ("pushed", 24), ("head", 24), ("other", 28))
HEAD_FAST = 3.5  # rad/s: the p99 of the recorded inputs' fastest head joint is about 4.0
GATES = [("qpos", 1e-5, 1e-4), ("qvel", 1e-3, 1e-2)]
DERIVED = [("sensordata", 5e-2), ("site_xpos", 1e-4), ("actuator_force", 1e-2)]
TILT_30 = float(np.cos(np.radians(30)))


# ------------------------------------------------------------ the states
def visited_inputs(env: Standing, seed: int = 0):
    """Every physics input (Data, servo targets) the port's TrainingEnv
    took over STEPS steps of ENVS envs under the module docstring's draws
    and actions, with per input its trunk tilt (the up axis' z), the push
    added in that step (m/s), its fastest head joint (rad/s) and whether a
    foot touches the plane."""
    tenv = TrainingEnv(env, env.config.episode_length)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    draws = dataclasses.replace(env.reset_draws(gen, ENVS), push_interval=torch.full((ENVS,), PUSH_EVERY_S))
    state = tenv.reset(draws)
    recorded = []
    plain_step = TF.step

    def spy(model, data, ctrl, n_substeps):
        recorded.append((data, ctrl))
        return plain_step(model, data, ctrl, n_substeps)

    nu, q = env.action_size, ENVS // 4
    magnitudes = torch.linspace(*env.config.push_config.magnitude_range, ENVS)
    pushes = []
    TF.step = spy
    try:
        for t in range(STEPS):
            action = rng.uniform(-1, 1, (ENVS, nu)).astype(np.float32)
            action[:q, [1, 2, 10, 11]] = 1.0  # lean: the legs' roll and pitch to one side
            action[2 * q : 3 * q, 5:9] = 1.0 if t % 2 else -1.0  # the head servos bang-bang
            sd = dataclasses.replace(env.step_draws(gen, ENVS), push_magnitude=magnitudes)
            state = tenv.step(state, torch.as_tensor(action), sd)
            pushes.append(torch.linalg.vector_norm(state.info["push"], dim=-1) * magnitudes)
    finally:
        TF.step = plain_step
    assert len(recorded) == STEPS
    data = Data(**{f: torch.cat([getattr(d, f) for d, _ in recorded]) for f in Data.__dataclass_fields__})
    return data, torch.cat([c for _, c in recorded]), {
        "tilt": env.get_gravity(data)[:, -1].numpy(),
        "push": torch.cat(pushes).numpy(),
        "head": env.get_actuator_joints_qvel(data.qvel)[:, 5:9].abs().amax(-1).numpy(),
        "on_feet": (data.contact_dist < 0).any(-1).numpy(),
    }


def pick(stats: dict, scale: int = 1) -> dict:
    """Indices into the recorded inputs, `scale` times PICKS per group,
    distinct: the most tilted with a foot on the plane, the most tilted,
    the hardest pushed in that step, the fastest head joints, then others
    spread over the run."""
    taken, groups = set(), {}
    n_in = len(stats["tilt"])
    keys = {"tilted_on_feet": np.where(stats["on_feet"], stats["tilt"], np.inf), "tilted": stats["tilt"],
            "pushed": -stats["push"], "head": -stats["head"]}
    for name, n in PICKS:
        n *= scale
        order = np.argsort(keys[name], kind="stable") if name in keys else np.arange(n_in) * 11 % n_in
        groups[name] = [int(i) for i in order if int(i) not in taken][:n]
        taken.update(groups[name])
        assert len(groups[name]) == n, name
    return groups


def control_inputs(kq, kc, nv: int, n: int, seed: int = 0):
    """Home pose plus noise, as test_megakernel_interpret.py builds its batch."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(kq, (n, 1)) + 0.01 * rng.standard_normal((n, kq.size))
    qvel = 0.1 * rng.standard_normal((n, nv))
    ctrl = np.tile(kc, (n, 1)) + 0.05 * rng.standard_normal((n, kc.size))
    return [torch.as_tensor(x.astype(np.float32)) for x in (qpos, qvel, ctrl)]


@pytest.fixture(scope="module")
def models():
    jm, mj = JL.load_model(str(JD.XML_DIR / f"{SCENE}.xml"), timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(SCENE, device="cpu", dtype=torch.float32, timestep=0.002)
    return jm, tm, np.asarray(mj.keyframe("home").qpos), np.asarray(mj.keyframe("home").ctrl)


def standing_tile(models, tile: int = TILE):
    """The 128 physics inputs of the module docstring (control envs first)
    and each env's group; for a larger `tile` (a multiple of 128) each
    group grows in proportion."""
    _, tm, kq, kc = models
    env = Standing("flat_terrain", device="cpu")
    data, ctrl, stats = visited_inputs(env)
    groups = pick(stats, tile // TILE)
    idx = torch.as_tensor([i for name, _ in PICKS for i in groups[name]])
    q, v, c = control_inputs(kq, kc, tm.spec.nv, N_CONTROL * tile // TILE)
    control = TF.init(tm, q, v, c)
    batch = Data(**{f: torch.cat([getattr(control, f), getattr(data, f)[idx]]) for f in Data.__dataclass_fields__})
    ctrl = torch.cat([c, ctrl[idx]])
    picked = {k: v[idx.numpy()] for k, v in stats.items()}
    labels = np.array(["control"] * len(q) + [name for name, _ in PICKS for _ in groups[name]])
    return batch, ctrl, picked, labels


def three_way(models, data: Data, ctrl: torch.Tensor, n_substeps: int, tile: int = TILE) -> dict:
    """One control step of `n_substeps` from the same inputs on each side;
    numpy fields per side."""
    jm, tm, _, _ = models
    jd = JData(**{f: jnp.asarray(getattr(data, f).numpy()) for f in Data.__dataclass_fields__})
    jc = jnp.asarray(ctrl.numpy())
    old = JMK.INTERPRET
    JMK.INTERPRET = True
    try:
        JMK.prepare(jm, n_substeps, tile)
        pallas = JMK.megakernel_step_batched(jm, jd, jc, n_substeps=n_substeps, tile=tile)
    finally:
        JMK.INTERPRET = old
    engine = jax.jit(jax.vmap(lambda dd, cc: JF.step(jm, dd, cc, n_substeps, use_megakernel=False)))(jd, jc)
    port = TF.step_reference(tm, data, ctrl, n_substeps)
    fields = [f for f, _, _ in GATES] + [f for f, _ in DERIVED]
    return {"pallas": {f: np.asarray(getattr(pallas, f)) for f in fields},
            "engine": {f: np.asarray(getattr(engine, f)) for f in fields},
            "port": {f: getattr(port, f).numpy() for f in fields}}


def per_env(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).reshape(a.shape[0], -1).max(1)


def held(models, data, ctrl, out, a: str, b: str, rows: np.ndarray, n_substeps: int) -> dict:
    """Side `a` against side `b` on the envs `rows` under the module
    docstring's gates; returns per field the max and p90 over the envs
    under the max gates, and the number of certified edges."""
    tm = models[1]
    errs = {f: per_env(out[a][f][rows], out[b][f][rows]) for f in out[a]}
    over = np.any([errs[f] >= mx for f, _, mx in GATES], 0)
    for i in np.nonzero(over)[0]:
        env = int(rows[i])
        for side in {a, b} - {"port"}:
            want = {f: out[side][f][env] for f, _, _ in GATES}
            assert is_edge(tm, data, ctrl, env, want, n_substeps), (
                a, b, "env over the max gate and not at an edge of the plain version", env)
    summary = {"edges": int(over.sum())}
    for f, p90 in [(f, p90) for f, p90, _ in GATES] + DERIVED:
        e = errs[f][~over]
        summary[f] = {"max": float(e.max()), "p90": float(np.percentile(e, 90))}
        assert summary[f]["p90"] < p90, (a, b, f, summary[f])
    return summary


def run(models, n_substeps: int, tile: int = TILE):
    data, ctrl, picked, labels = standing_tile(models, tile)
    out = three_way(models, data, ctrl, n_substeps, tile)
    result = {}
    for group, rows in [("control", np.nonzero(labels == "control")[0]),
                        ("standing", np.nonzero(labels != "control")[0])]:
        for a, b in [("pallas", "engine"), ("pallas", "port"), ("engine", "port")]:
            result[f"{group} {a}-{b}"] = held(models, data, ctrl, out, a, b, rows, n_substeps)
    return picked, labels, result


def test_pallas_kernel_engine_and_port_agree_at_standing_states(models):
    t0 = time.time()
    picked, _, result = run(models, 2)
    tilted = picked["tilt"] < TILT_30
    print("flat_terrain kernel, 2 substeps:", json.dumps(result), f"{time.time() - t0:.1f} s")
    # the tile covers what standing training visits
    assert tilted.sum() >= TILE // 4 and (tilted & picked["on_feet"]).sum() >= 16, picked["tilt"]
    assert picked["push"].max() >= 0.95 and (picked["push"] > 0.5).sum() >= 16, picked["push"]
    assert (picked["head"] > HEAD_FAST).sum() >= 16, picked["head"]
    for name, r in result.items():
        assert r["edges"] <= 2, (name, r)  # each certified above; a few at most


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--tile", type=int, default=TILE,
                    help="envs in one kernel tile: 128 (1-D lanes, the eval's) or 1024 (sublanes x lanes, training's)")
    ap.add_argument("--threads", type=int, default=1, help="torch CPU threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    jm, mj = JL.load_model(str(JD.XML_DIR / f"{SCENE}.xml"), timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(SCENE, device="cpu", dtype=torch.float32, timestep=0.002)
    t0 = time.time()
    _, _, result = run((jm, tm, np.asarray(mj.keyframe("home").qpos), np.asarray(mj.keyframe("home").ctrl)),
                       args.substeps, args.tile)
    print(json.dumps({"substeps": args.substeps, "tile": args.tile, "seconds": round(time.time() - t0, 1), **result}, indent=1))
