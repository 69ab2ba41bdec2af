"""The port's model snapshot, loader and structure tables against the JAX
package, and the port's isolation from JAX.

- Every Model array and ModelSpec field of the snapshot equals a fresh
  `loader.load_model(..., dtype=float32)` of the JAX package (exact).
- The env index tables the port reads from the snapshot equal the ones the
  JAX env gets from C-MuJoCo name lookups.
- A fresh run of the snapshot command reproduces the committed files.
- No module of the port imports JAX, orbax, tensorboardX or the JAX package.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open_duck_playground_tpu.envs import duck_base as JD
from open_duck_playground_tpu.envs.joystick import Joystick as JJoystick
from open_duck_playground_tpu.models import loader as JL
from open_duck_playground_tpu.physics import structure as JS

from open_duck_playground_torch.envs.joystick import Joystick
from open_duck_playground_torch.models import loader as TL
from open_duck_playground_torch.models import snapshot
from open_duck_playground_torch.physics import structure as TS
from open_duck_playground_torch.physics.types import Model

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "open_duck_playground_torch"


@pytest.fixture(scope="module")
def models():
    jm, _ = JL.load_model(str(JD.XML_DIR / "scene_flat_terrain_backlash.xml"),
                          timestep=0.002, dtype=jnp.float32)
    tm = TL.load_model(device="cpu", dtype=torch.float32, timestep=0.002)
    return jm, tm


def test_snapshot_equals_jax_loader(models):
    jm, tm = models
    for f in dataclasses.fields(Model):
        if f.name == "spec":
            continue
        want = np.asarray(getattr(jm, f.name))
        got = getattr(tm, f.name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    for f in dataclasses.fields(tm.spec):
        got, want = getattr(tm.spec, f.name), getattr(jm.spec, f.name)
        assert got == want, (f.name, got, want)


def test_structure_tables_equal_jax(models):
    jm, tm = models
    js, ts = jm.spec, tm.spec
    assert TS.tree_levels(ts) == JS.tree_levels(js)
    assert TS.free_joint(ts) == JS.free_joint(js)
    assert TS.dof_chain_blocks(ts) == JS.dof_chain_blocks(js)
    for name in ("dof_pred_mask", "free_trans_mask", "hinge_joints", "limited_hinges"):
        np.testing.assert_array_equal(getattr(TS, name)(ts), getattr(JS, name)(js), err_msg=name)
    np.testing.assert_array_equal(TS.one_hot_dofs(ts, ts.friction_dofs),
                                  JS.one_hot_dofs(js, js.friction_dofs))


def test_env_index_tables_equal_jax():
    jenv = JJoystick(task="flat_terrain_backlash", dtype=jnp.float32)
    tenv = Joystick(task="flat_terrain_backlash", device="cpu")
    for name in ("actuator_names", "joint_names", "backlash_joint_names",
                 "actuator_joint_ids", "backlash_joint_ids"):
        assert list(getattr(tenv, name)) == list(getattr(jenv, name)), name
    # the port keeps its index tables as long tensors on the env's device
    for name in ("_actuator_qposadr", "_actuator_dofadr", "_backlash_qposadr",
                 "_backlash_actuator_slot", "_feet_site_id"):
        assert getattr(tenv, name).dtype == torch.long, name
        assert getattr(tenv, name).tolist() == [int(x) for x in getattr(jenv, name)], name
    for name in ("_floating_base_qpos_addr", "_floating_base_qvel_addr", "_site_id"):
        assert getattr(tenv, name) == int(getattr(jenv, name)), name
    assert tenv._sensor_slices == jenv._sensor_slices
    assert tenv._foot_linvel_sensor_adr.tolist() == [int(x) for x in jenv._foot_linvel_sensor_adr.ravel()]
    np.testing.assert_array_equal(tenv._init_q.numpy(), np.asarray(jenv._init_q))
    np.testing.assert_array_equal(tenv._default_actuator.numpy(), np.asarray(jenv._default_actuator))
    np.testing.assert_array_equal(tenv._qpos_noise_scale.numpy(), np.asarray(jenv._qpos_noise_scale))


def test_snapshot_command_reproduces_committed_files(tmp_path):
    snapshot.main(["--out", str(tmp_path)])
    data = PORT / "models" / "data"
    for name in sorted(p.name for p in data.iterdir()):
        if name.endswith(".json"):
            assert json.loads((tmp_path / name).read_text()) == json.loads((data / name).read_text()), name
        else:
            with np.load(tmp_path / name) as a, np.load(data / name) as b:
                assert a.files == b.files, name
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: neither JAX,
    the JAX package, orbax nor tensorboardX (optional, imported by the CLI
    only when it runs) may load."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_collections', 'mujoco', 'tensorboardX', "
        "'open_duck_playground_tpu'))\n"
        "assert not bad, bad\n"
        "print('ISOLATED', len(sys.argv))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "ISOLATED" in r.stdout, r.stderr[-2000:]
