"""Write the compiled robot model into the package as plain numpy files.

The machine that runs the port has no `mujoco`, so MJCF is compiled here,
once, and frozen into `models/data/`:

- `<scene>.npz`: every array the model needs (the fields of
  `physics.types.Model`), as C-MuJoCo gives them, in float64;
- `<scene>.json`: the `ModelSpec` tuples and the name -> id tables the
  envs read (actuators, joints, bodies, sites, geoms, sensors);
- `gait_coefficients.npz` / `.json`: the polynomial gait library of
  `polynomial_coefficients.pkl` as one dense coefficient table.

Run from the repository root, where `mujoco` is installed:

    python -m open_duck_playground_torch.models.snapshot

`mujoco` is imported only by this command and by `compile_mjcf`, which the
C-MuJoCo eval tools (`eval_tools/`) call; never by the training path.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import pickle
from typing import Dict, Optional

import numpy as np

DATA_DIR = pathlib.Path(__file__).resolve().parent / "data"
ROBOT_DIR = (
    pathlib.Path(__file__).resolve().parents[2]
    / "open_duck_playground_tpu"
    / "models"
    / "open_duck_mini_v2"
)
XML_DIR = ROBOT_DIR / "xmls"
GAIT_PKL = ROBOT_DIR / "data" / "polynomial_coefficients.pkl"

SCENES = (
    "scene_flat_terrain_backlash",
    "scene_flat_terrain",
    "scene_rough_terrain_backlash",
    "scene_rough_terrain",
    "scene_flat_terrain_no_head",
)

FREE, HINGE = 0, 3


def _sensor_kinds(mujoco):
    S = mujoco.mjtSensor
    return {
        S.mjSENS_GYRO: "gyro",
        S.mjSENS_VELOCIMETER: "velocimeter",
        S.mjSENS_ACCELEROMETER: "accelerometer",
        S.mjSENS_FRAMEZAXIS: "framezaxis",
        S.mjSENS_FRAMEXAXIS: "framexaxis",
        S.mjSENS_FRAMELINVEL: "framelinvel",
        S.mjSENS_FRAMEANGVEL: "frameangvel",
        S.mjSENS_FRAMEPOS: "framepos",
        S.mjSENS_FRAMEQUAT: "framequat",
    }


def compile_mjcf(xml_path, timestep: Optional[float] = None):
    """The C-MuJoCo `MjModel` of the scene at `xml_path`, with the XML files
    beside it and its `assets/` as the compiler's assets; `timestep`
    overrides the scene's."""
    import mujoco

    xml_path = pathlib.Path(xml_path)
    assets: Dict[str, bytes] = {}
    for p in sorted(xml_path.parent.glob("*.xml")):
        assets[p.name] = p.read_bytes()
    adir = xml_path.parent / "assets"
    for p in sorted(adir.iterdir()):
        if p.is_file():
            assets[p.name] = p.read_bytes()
    mj = mujoco.MjModel.from_xml_string(xml_path.read_text(), assets)
    if timestep is not None:
        mj.opt.timestep = timestep
    return mj


def _hull_vertices(mj, geom_id: int) -> np.ndarray:
    """Convex-hull vertices of a mesh geom, in the geom frame."""
    mesh_id = mj.geom_dataid[geom_id]
    vadr = mj.mesh_vertadr[mesh_id]
    vnum = mj.mesh_vertnum[mesh_id]
    verts = mj.mesh_vert[vadr : vadr + vnum].copy()
    gadr = mj.mesh_graphadr[mesh_id]
    if gadr >= 0:
        # mesh_graph: numvert, numface, vert_edgeadr(nv), vert_globalid(nv), ...
        graph = mj.mesh_graph[gadr:]
        numvert = int(graph[0])
        globalid = graph[2 + numvert : 2 + 2 * numvert]
        verts = verts[np.asarray(globalid)]
    return verts


def model_arrays(mj, points_per_foot: int = 4):
    """(arrays, spec dict) of a compiled MjModel, the same fields and rules
    as the JAX package's `models/loader.py:put_model`."""
    import mujoco

    for jt in mj.jnt_type:
        if jt not in (FREE, HINGE):
            raise NotImplementedError(f"joint type {jt} unsupported")
    if mj.neq or mj.ntendon:
        raise NotImplementedError("equality/tendon constraints unsupported")
    for i in range(mj.nu):
        if mj.actuator_trntype[i] != mujoco.mjtTrn.mjTRN_JOINT:
            raise NotImplementedError("only joint-transmission actuators")
        if mj.actuator_dyntype[i] != mujoco.mjtDyn.mjDYN_NONE:
            raise NotImplementedError("only stateless actuators")

    feet, floor, floor_is_hfield = [], -1, False
    for g in range(mj.ngeom):
        if not (mj.geom_contype[g] or mj.geom_conaffinity[g]):
            continue
        t = mj.geom_type[g]
        if t == mujoco.mjtGeom.mjGEOM_MESH:
            feet.append(g)
        elif t == mujoco.mjtGeom.mjGEOM_PLANE:
            floor = g
        elif t == mujoco.mjtGeom.mjGEOM_HFIELD:
            floor, floor_is_hfield = g, True
        else:
            raise NotImplementedError(f"colliding geom type {t} unsupported")
    if floor < 0 or not feet:
        raise NotImplementedError("expected foot meshes + one floor geom")

    hulls = [_hull_vertices(mj, g) for g in feet]
    nvert = max(h.shape[0] for h in hulls)
    foot_hull = np.stack(
        [np.pad(h, ((0, nvert - h.shape[0]), (0, 0)), mode="edge") for h in hulls]
    )

    if floor_is_hfield:
        hid = mj.geom_dataid[floor]
        nrow, ncol = int(mj.hfield_nrow[hid]), int(mj.hfield_ncol[hid])
        hfield_data = mj.hfield_data[
            mj.hfield_adr[hid] : mj.hfield_adr[hid] + nrow * ncol
        ].reshape(nrow, ncol)
        hfield_size = mj.hfield_size[hid].copy()
    else:
        nrow = ncol = 1
        hfield_data = np.zeros((1, 1))
        hfield_size = np.zeros(4)

    mask = np.zeros((mj.nbody, mj.nv), dtype=bool)
    for b in range(mj.nbody):
        chain, anc = [], b
        while anc != 0:
            chain.append(anc)
            anc = mj.body_parentid[anc]
        for d in range(mj.nv):
            if mj.dof_bodyid[d] in chain:
                mask[b, d] = True

    kinds = _sensor_kinds(mujoco)
    sensors = [
        [
            kinds[mujoco.mjtSensor(mj.sensor_type[i])],
            int(mj.sensor_objid[i]),
            int(mj.sensor_adr[i]),
            int(mj.sensor_dim[i]),
        ]
        for i in range(mj.nsensor)
    ]

    ints = lambda xs: [int(x) for x in xs]
    spec = dict(
        nq=int(mj.nq),
        nv=int(mj.nv),
        nu=int(mj.nu),
        nbody=int(mj.nbody),
        njnt=int(mj.njnt),
        ngeom=int(mj.ngeom),
        nsite=int(mj.nsite),
        nsensordata=int(mj.nsensordata),
        jnt_type=ints(mj.jnt_type),
        jnt_bodyid=ints(mj.jnt_bodyid),
        jnt_qposadr=ints(mj.jnt_qposadr),
        jnt_dofadr=ints(mj.jnt_dofadr),
        jnt_limited=[bool(x) for x in mj.jnt_limited],
        body_parentid=ints(mj.body_parentid),
        body_jntadr=ints(mj.body_jntadr),
        body_jntnum=ints(mj.body_jntnum),
        dof_bodyid=ints(mj.dof_bodyid),
        dof_jntid=ints(mj.dof_jntid),
        friction_dofs=[i for i in range(mj.nv) if mj.dof_frictionloss[i] > 0],
        actuator_trnid=ints(mj.actuator_trnid[:, 0]),
        site_bodyid=ints(mj.site_bodyid),
        geom_bodyid=ints(mj.geom_bodyid),
        sensors=sensors,
        collide_geom_ids=[int(g) for g in feet],
        floor_geom_id=int(floor),
        floor_is_hfield=bool(floor_is_hfield),
        points_per_foot=int(points_per_foot),
        hull_nvert=int(nvert),
        hfield_nrow=nrow,
        hfield_ncol=ncol,
        timestep=float(mj.opt.timestep),
        iterations=int(mj.opt.iterations),
        ls_iterations=int(mj.opt.ls_iterations),
        impratio=float(mj.opt.impratio),
        tolerance=float(mj.opt.tolerance),
        ls_tolerance=float(mj.opt.ls_tolerance),
    )

    key_qpos = mj.key_qpos[0] if mj.nkey else mj.qpos0
    key_ctrl = mj.key_ctrl[0] if mj.nkey else np.zeros(mj.nu)
    f64 = lambda x: np.array(x, dtype=np.float64)
    arrays = dict(
        body_pos=f64(mj.body_pos),
        body_quat=f64(mj.body_quat),
        body_ipos=f64(mj.body_ipos),
        body_iquat=f64(mj.body_iquat),
        body_mass=f64(mj.body_mass),
        body_inertia=f64(mj.body_inertia),
        body_invweight0=f64(mj.body_invweight0),
        jnt_pos=f64(mj.jnt_pos),
        jnt_axis=f64(mj.jnt_axis),
        jnt_range=f64(mj.jnt_range),
        jnt_solref=f64(mj.jnt_solref),
        jnt_solimp=f64(mj.jnt_solimp),
        jnt_margin=f64(mj.jnt_margin),
        dof_armature=f64(mj.dof_armature),
        dof_damping=f64(mj.dof_damping),
        dof_frictionloss=f64(mj.dof_frictionloss),
        dof_invweight0=f64(mj.dof_invweight0),
        dof_solref=f64(mj.dof_solref),
        dof_solimp=f64(mj.dof_solimp),
        qpos0=f64(mj.qpos0),
        actuator_gainprm=f64(mj.actuator_gainprm),
        actuator_biasprm=f64(mj.actuator_biasprm),
        actuator_ctrlrange=f64(mj.actuator_ctrlrange),
        actuator_forcerange=f64(mj.actuator_forcerange),
        geom_pos=f64(mj.geom_pos),
        geom_quat=f64(mj.geom_quat),
        geom_friction=f64(mj.geom_friction),
        geom_solref=f64(mj.geom_solref),
        geom_solimp=f64(mj.geom_solimp),
        geom_priority=np.array(mj.geom_priority, dtype=np.int32),
        geom_margin=f64(mj.geom_margin),
        site_pos=f64(mj.site_pos),
        site_quat=f64(mj.site_quat),
        foot_hull=f64(foot_hull),
        hfield_data=f64(hfield_data),
        hfield_size=f64(hfield_size),
        ancestor_mask=mask,
        gravity=f64(mj.opt.gravity),
        key_qpos=f64(key_qpos),
        key_ctrl=f64(key_ctrl),
    )
    return arrays, spec


def name_tables(mj) -> dict:
    """Name -> id tables of every object kind the envs look up."""
    import mujoco

    def names(obj, n):
        return [mujoco.mj_id2name(mj, obj, i) for i in range(n)]

    O = mujoco.mjtObj
    return dict(
        actuator=names(O.mjOBJ_ACTUATOR, mj.nu),
        joint=names(O.mjOBJ_JOINT, mj.njnt),
        body=names(O.mjOBJ_BODY, mj.nbody),
        site=names(O.mjOBJ_SITE, mj.nsite),
        geom=names(O.mjOBJ_GEOM, mj.ngeom),
        sensor=names(O.mjOBJ_SENSOR, mj.nsensor),
        sensor_adr=[int(x) for x in mj.sensor_adr],
        sensor_dim=[int(x) for x in mj.sensor_dim],
    )


def write_scene(scene: str, out_dir: pathlib.Path = DATA_DIR) -> None:
    mj = compile_mjcf(XML_DIR / f"{scene}.xml")
    arrays, spec = model_arrays(mj)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / f"{scene}.npz", **arrays)
    meta = dict(scene=scene, spec=spec, names=name_tables(mj))
    (out_dir / f"{scene}.json").write_text(json.dumps(meta, indent=1) + "\n")


def gait_arrays(pkl_path: pathlib.Path = GAIT_PKL):
    """(arrays, meta) of the gait library: coefficient table indexed
    (dx, dy, dtheta, dim, power), lowest power first, and its grid."""
    with open(pkl_path, "rb") as f:
        raw = pickle.load(f)
    meta = next(iter(raw.values()))
    dxs, dys, dthetas = set(), set(), set()
    for key in raw:
        a, b, c = key.split("_")
        dxs.add(float(a))
        dys.add(float(b))
        dthetas.add(float(c))
    dxs, dys, dthetas = (np.array(sorted(v)) for v in (dxs, dys, dthetas))
    ndim = len(meta["coefficients"])
    ncoef = len(meta["coefficients"]["dim_0"])
    table = np.zeros((len(dxs), len(dys), len(dthetas), ndim, ncoef))
    for key, entry in raw.items():
        a, b, c = (float(v) for v in key.split("_"))
        ix = int(np.argmin(np.abs(dxs - a)))
        iy = int(np.argmin(np.abs(dys - b)))
        it = int(np.argmin(np.abs(dthetas - c)))
        for d in range(ndim):
            table[ix, iy, it, d] = np.asarray(entry["coefficients"][f"dim_{d}"])
    return (
        dict(table=table, dxs=dxs, dys=dys, dthetas=dthetas),
        dict(period=float(meta["period"]), fps=float(meta["fps"])),
    )


def write_gait(out_dir: pathlib.Path = DATA_DIR) -> None:
    arrays, meta = gait_arrays()
    np.savez(out_dir / "gait_coefficients.npz", **arrays)
    (out_dir / "gait_coefficients.json").write_text(json.dumps(meta) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=DATA_DIR)
    args = ap.parse_args(argv)
    for scene in SCENES:
        write_scene(scene, args.out)
    write_gait(args.out)
    print(f"wrote {', '.join(SCENES)} and the gait library to {args.out}")


if __name__ == "__main__":
    main()
