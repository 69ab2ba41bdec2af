"""Open Duck Mini V2 env base: the model, name -> index tables, qpos/qvel
slicing and sensor accessors, every env at once. Counterpart of
`open_duck_playground_tpu/envs/duck_base.py`; the ids come from the model
snapshot (`models/data/`), not from C-MuJoCo name lookups.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from open_duck_playground_torch.models import loader, snapshot
from open_duck_playground_torch.physics import forward as F
from open_duck_playground_torch.physics.types import Data, Model

TASKS = {
    "flat_terrain": "scene_flat_terrain",
    "flat_terrain_backlash": "scene_flat_terrain_backlash",
    "rough_terrain_backlash": "scene_rough_terrain_backlash",
    "rough_terrain": "scene_rough_terrain",
    # the robot without its head (10 actuators, legs only)
    "flat_terrain_no_head": "scene_flat_terrain_no_head",
}

# the scene XMLs and the gait library, by path: read by the C-MuJoCo eval
# tools (`eval_tools/`) and by `models/snapshot.py`, never by training
XML_DIR = snapshot.XML_DIR
GAIT_PKL = snapshot.GAIT_PKL

FEET_SITES = ["left_foot", "right_foot"]
FEET_GEOMS = ["left_foot_bottom_tpu", "right_foot_bottom_tpu"]
JOINTS_ORDER_NO_HEAD = [
    "left_hip_yaw", "left_hip_roll", "left_hip_pitch", "left_knee", "left_ankle",
    "right_hip_yaw", "right_hip_roll", "right_hip_pitch", "right_knee", "right_ankle",
]

GRAVITY_SENSOR = "upvector"
GLOBAL_ANGVEL_SENSOR = "global_angvel"
LOCAL_LINVEL_SENSOR = "local_linvel"
ACCELEROMETER_SENSOR = "accelerometer"
GYRO_SENSOR = "gyro"


def task_to_scene(task: str) -> str:
    if task not in TASKS:
        raise NotImplementedError(f"task {task!r} is not ported yet (have {sorted(TASKS)})")
    return TASKS[task]


def override_config(config, overrides: Optional[Mapping[str, Any]]):
    """A copy of the frozen config dataclass `config` with the dotted keys of
    `overrides` replaced (`reward_config.scales.tracking_lin_vel=4.0`,
    `push_config.magnitude_range=[0.1, 0.5]`), by the rules of
    `ConfigDict.update_from_flattened_dict` on a locked config: an unknown
    key raises KeyError, a value that cannot take the field's type raises
    TypeError (an int may stand for a float)."""
    for key, value in (overrides or {}).items():
        config = _replace_path(config, key.split("."), value, key)
    return config


def _replace_path(node, path, value, key):
    name, rest = path[0], path[1:]
    if isinstance(node, Mapping):
        names = set(node)
    elif dataclasses.is_dataclass(node):
        names = {f.name for f in dataclasses.fields(node)}
    else:
        names = set()
    if name not in names:
        raise KeyError(f"config key {key!r} does not exist (have {sorted(names)} at {name!r})")
    old = node[name] if isinstance(node, Mapping) else getattr(node, name)
    new = _replace_path(old, rest, value, key) if rest else _cast(old, value, key)
    if isinstance(node, Mapping):
        return {**node, name: new}
    return dataclasses.replace(node, **{name: new})


def _cast(old, value, key):
    def bad():
        return TypeError(f"config key {key!r}: {value!r} cannot take the type of {old!r}")

    if isinstance(old, bool):
        if not isinstance(value, bool):
            raise bad()
        return value
    if isinstance(old, (int, float)):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise bad()
        if isinstance(old, int) and not isinstance(value, int):
            raise bad()
        return type(old)(value)
    if isinstance(old, tuple):
        if not isinstance(value, (list, tuple)):
            raise bad()
        if len(value) == len(old):
            return tuple(_cast(o, v, key) for o, v in zip(old, value))
        return tuple(value)
    if isinstance(old, str) and isinstance(value, str):
        return value
    raise bad()


class DuckEnv:
    """Holds the model and index tables; reset/step live in subclasses."""

    def __init__(self, scene: str, config, config_overrides: Optional[Mapping[str, Any]] = None,
                 device="cuda", dtype=torch.float32):
        self._config = override_config(config, config_overrides)
        config = self._config
        self.device = torch.device(device)
        if self.device.type == "cuda":
            F.pin_f32()
        self._model = loader.load_model(scene, device=self.device, dtype=dtype, timestep=config.sim_dt)
        names = loader.load_names(scene)
        s = self._model.spec

        def jid(name):
            return names["joint"].index(name)

        self.actuator_names = list(names["actuator"])
        self.joint_names = list(names["joint"])
        self.floating_base_name = [
            n for j, n in enumerate(self.joint_names) if s.jnt_type[j] == 0
        ][0]
        self.backlash_joint_names = [
            n for n in self.joint_names
            if n not in self.actuator_names and n != self.floating_base_name
        ]
        self.actuator_joint_ids = [jid(n) for n in self.actuator_names]
        self.backlash_joint_ids = [jid(n) for n in self.backlash_joint_names]
        fb = jid(self.floating_base_name)
        self._floating_base_qpos_addr = s.jnt_qposadr[fb]
        self._floating_base_qvel_addr = s.jnt_dofadr[fb]
        self._site_id = names["site"].index("imu")
        self._sensor_slices = {
            n: (a, a + d)
            for n, a, d in zip(names["sensor"], names["sensor_adr"], names["sensor_dim"])
        }

        # index tables as long tensors on the env's device, made once: a
        # tensor indexed by a Python list copies the list to the card from
        # pageable host memory at every call, a host synchronization that
        # also keeps the step out of a CUDA graph
        def index(values):
            return torch.tensor(list(values), dtype=torch.long, device=self.device)

        self._actuator_qposadr = index(s.jnt_qposadr[j] for j in self.actuator_joint_ids)
        self._actuator_dofadr = index(s.jnt_dofadr[j] for j in self.actuator_joint_ids)
        self._backlash_qposadr = index(s.jnt_qposadr[j] for j in self.backlash_joint_ids)
        # actuator slot of each backlash joint, in backlash-joint order (empty
        # on the robots without backlash joints)
        self._backlash_actuator_slot = index(
            self.actuator_names.index(n.removesuffix("_backlash"))
            for n in self.backlash_joint_names
        )
        self._feet_site_id = index(names["site"].index(n) for n in FEET_SITES)
        self._foot_linvel_sensor_adr = index(
            i
            for site in FEET_SITES
            for i in range(*self._sensor_slices[f"{site}_global_linvel"])
        )

    @property
    def dt(self) -> float:
        return self._config.ctrl_dt

    @property
    def n_substeps(self) -> int:
        return int(round(self._config.ctrl_dt / self._config.sim_dt))

    @property
    def model(self) -> Model:
        return self._model

    @property
    def action_size(self) -> int:
        return self._model.spec.nu

    # --- qpos/qvel slicing, (B, ...) in and out
    def get_floating_base_qpos(self, qpos):
        a = self._floating_base_qpos_addr
        return qpos[:, a : a + 7]

    def get_floating_base_qvel(self, qvel):
        a = self._floating_base_qvel_addr
        return qvel[:, a : a + 6]

    def get_actuator_joints_qpos(self, qpos):
        return qpos[:, self._actuator_qposadr]

    def get_actuator_joints_qvel(self, qvel):
        return qvel[:, self._actuator_dofadr]

    def get_actuator_angles_with_backlash(self, qpos):
        """Actuated joint angles with the paired backlash deflection added;
        actuators without a backlash joint (the head) add zero."""
        angles = self.get_actuator_joints_qpos(qpos)
        angles[:, self._backlash_actuator_slot] += qpos[:, self._backlash_qposadr]
        return angles

    # --- sensor readings
    def _sensor(self, data: Data, name: str):
        a, b = self._sensor_slices[name]
        return data.sensordata[..., a:b]

    def get_gravity(self, data):
        return self._sensor(data, GRAVITY_SENSOR)

    def get_global_angvel(self, data):
        return self._sensor(data, GLOBAL_ANGVEL_SENSOR)

    def get_local_linvel(self, data):
        return self._sensor(data, LOCAL_LINVEL_SENSOR)

    def get_accelerometer(self, data):
        return self._sensor(data, ACCELEROMETER_SENSOR)

    def get_gyro(self, data):
        return self._sensor(data, GYRO_SENSOR)
