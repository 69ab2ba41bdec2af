"""The joystick task's step on the card as two hand-written CUDA kernels
around the physics launch (`csrc/task_step.cu`, body in `task_step.cuh`),
for the joystick task and for the standing task that inherits its step.

`Joystick.step` on CUDA tensors, for a task class with `task_kernel = True`
(`Joystick` and `Standing`), calls `step` here: one launch (`tk_pre`)
computes what the physics launch needs (the gait's frame index, phase and
reference frame, the action history and the delayed action, the push, the
motor targets), `forward.step` launches the megakernel, and one launch
(`tk_post`) computes the rest in the eager body's order and formulas
(contacts, air times, swing peaks, both observations, termination, the
reward terms and their clamped sum, the info's counters and command
resample, the metrics). The reward terms are the task class's
`reward_terms`: the joystick's ten (`JOYSTICK_TERMS`) or the standing
task's six (`STANDING_TERMS`, in a build of its own). The eager body in
`Joystick.step` is the plain version: the CPU's path and the reference of
the tests. Tensors the eager body only re-binds (`last_last_act =
last_act`) stay aliases here too.

Shapes are build constants (`kernel_dims`: the robot's sizes, the history
lengths, the observation layout, and `STANDING=1` for the standing term
set; a joystick build has no such key, so its -D flags are those of the
builds before the standing one), one library per set, built with nvcc at
first use into `build/kernels/` and bound with ctypes. Everything else is
the env's record (`record`): a `TkRecord` in a uint8 tensor, one per env
object and device, made at the env's first eager step there (a CUDA graph's
warm-up runs it before the capture; inside a capture it is refused) and
dropped with the env; it points at the gait oracle's frame table. A launch
runs on the tensors' current stream, does not synchronize and allocates
nothing: the outputs are allocated here with torch.empty.

Counters: `launches`, fused task steps (one per `tk_post` launch, and one per
replay of a CUDA graph that captured one); `build_launches`, the same
steps by build: keyed by `build_key` (the build's `kernel_dims` as sorted
items, the rows of the metrics table the step writes), so that a reader
recovers the dims (`dict(key[0])`) and the term set (`terms(dims)`); `eager_steps`,
task step bodies on CUDA tensors that ran eagerly (`count_eager_step`),
counted the same way. `reset_counts` zeroes all three.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from open_duck_playground_torch import cuda_build
from open_duck_playground_torch.envs import duck_base
from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.physics import forward as F
from open_duck_playground_torch.physics import megakernel as MK

SOURCE, HEADERS = "task_step.cu", ("task_step.cuh",)
TPU_KERNEL = "none: the JAX package's envs/joystick.py step, fused by XLA"

# the reward terms of each term set in the order of its task's `_get_reward`
# (task_step.cuh's TK_*)
JOYSTICK_TERMS = ("tracking_lin_vel", "tracking_ang_vel", "torques", "action_rate", "alive", "imitation",
                  "stand_still", "progress", "yaw_rate_l1", "lin_vel_l1")
STANDING_TERMS = ("orientation", "torques", "action_rate", "alive", "stand_still", "head_pos")
_SENSORS = {"s_gyro": duck_base.GYRO_SENSOR, "s_accel": duck_base.ACCELEROMETER_SENSOR,
            "s_up": duck_base.GRAVITY_SENSOR, "s_linvel": duck_base.LOCAL_LINVEL_SENSOR,
            "s_angvel": duck_base.GLOBAL_ANGVEL_SENSOR}

launches = 0
eager_steps = 0
build_launches: Dict[tuple, int] = {}


def reset_counts() -> None:
    global launches, eager_steps
    launches = 0
    eager_steps = 0
    build_launches.clear()


def _count_fused(build: tuple) -> None:
    global launches
    launches += 1
    build_launches[build] = build_launches.get(build, 0) + 1


def _count_eager() -> None:
    global eager_steps
    eager_steps += 1


def count_eager_step() -> None:
    """Count an eager task step body on CUDA tensors (inside a CUDA graph's
    capture: once per replay)."""
    MK.launched(_count_eager)


# ------------------------------------------------------------ shapes and record
def terms(dims: Dict[str, int]) -> Tuple[str, ...]:
    """The reward terms a build for `dims` computes, in its order."""
    return STANDING_TERMS if dims.get("STANDING") else JOYSTICK_TERMS


def term_set(env) -> Tuple[str, ...]:
    """`env`'s reward terms (its class's `reward_terms`), checked against
    the reward scales of its config."""
    names = env.reward_terms
    if names not in (JOYSTICK_TERMS, STANDING_TERMS):
        raise NotImplementedError(f"the task kernels compute the terms {JOYSTICK_TERMS} or {STANDING_TERMS}, "
                                  f"the task {names}")
    scales = set(env.config.reward_config.scales)
    if scales != set(names):
        raise NotImplementedError(f"the task's terms {names}, the config's scales {sorted(scales)}")
    return names


def kernel_dims(env) -> Dict[str, int]:
    """The -D constants of the task kernels for `env`."""
    s = env.model.spec
    cfg = env.config
    nfoot = len(s.collide_geom_ids)
    if env.action_size not in (10, 14) or nfoot != len(duck_base.FEET_SITES):
        raise NotImplementedError("the task kernels take the duck: 14 or 10 actuators, two feet")
    if s.ncon_max != nfoot * s.points_per_foot:
        raise NotImplementedError("the task kernels take one contact slot per foot point")
    for name in _SENSORS.values():
        a, b = env._sensor_slices[name]
        if b - a != 3:
            raise NotImplementedError(f"sensor {name} has {b - a} entries, the task kernels read 3")
    gait = tuple(env.gait.frames.shape) if env.use_imitation else (1, 1, 1, 1, 1)
    standing = {"STANDING": 1} if term_set(env) == STANDING_TERMS else {}
    return dict(
        NQ=s.nq, NV=s.nv, NU=env.action_size, NSITE=s.nsite, NSENS=s.nsensordata, NFOOT=nfoot,
        KPTS=s.points_per_foot, AHIST=cfg.noise_config.action_max_delay,
        IHIST=cfg.noise_config.imu_max_delay, IMITATION=int(env.use_imitation),
        OBS_MOTOR=int(env.obs_has_motor_targets), OBS_PHASE=int(env.obs_has_imitation_phase),
        GDX=gait[0], GDY=gait[1], GDT=gait[2], GPH=gait[3], GDIM=gait[4], **standing,
    )


def build_key(env, dims: Optional[Dict[str, int]] = None) -> tuple:
    """The key of `env`'s fused steps in `build_launches`: its build's dims
    (`dims`, or `kernel_dims(env)`) as sorted items, and the rows of its
    metrics table."""
    dims = kernel_dims(env) if dims is None else dims
    return tuple(sorted(dims.items())), len(env._metric_keys)


def record_fields(d: Dict[str, int]) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """(name, 'p'|'i'|'f', shape) of TkRecord, in the order of task_step.cuh."""
    U, T = d["NU"], len(terms(d))
    return [
        ("gait", "p", ()),
        ("gait_x", "f", (d["GDX"],)), ("gait_y", "f", (d["GDY"],)), ("gait_t", "f", (d["GDT"],)),
        ("default_act", "f", (U,)), ("qpos_noise", "f", (U,)), ("ref_offset", "f", (10,)),
        ("reward_scale", "f", (T,)), ("down", "f", (3,)),
        ("dt", "f", ()), ("action_scale", "f", ()), ("motor_lim", "f", ()), ("dof_vel_scale", "f", ()),
        ("level", "f", ()), ("sc_gyro", "f", ()), ("sc_accel", "f", ()), ("sc_gravity", "f", ()),
        ("sc_jvel", "f", ()), ("sigma", "f", ()),
        ("act_qadr", "i", (U,)), ("act_dadr", "i", (U,)), ("backlash_qadr", "i", (U,)),
        ("metric_row", "i", (T,)), ("foot_vel", "i", (3 * d["NFOOT"],)), ("feet_site", "i", (d["NFOOT"],)),
        ("imu_site", "i", ()), ("fb_qadr", "i", ()), ("fb_dadr", "i", ()),
        *[(name, "i", ()) for name in _SENSORS],
        ("row_swing", "i", ()), ("row_lin", "i", ()), ("row_ang", "i", ()), ("row_head", "i", ()),
        ("speed_limit", "i", ()), ("head_direct", "i", ()), ("push_enable", "i", ()),
        *([("head_ungated", "i", ())] if d.get("STANDING") else []),
    ]


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int32, "f": ctypes.c_float}


def record_type(d: Dict[str, int]):
    fields = []
    for name, kind, shape in record_fields(d):
        t = _CTYPES[kind]
        for n in reversed(shape):
            t = t * n
        fields.append((name, t))
    return type("TkRecord", (ctypes.Structure,), {"_fields_": fields})


def record_tables(env) -> Dict[str, object]:
    """The TkRecord fields of `env` but the gait pointer: its index tables,
    the scales and constants of its config (as float32, as PyTorch takes a
    Python number against a float32 tensor) and its flags."""
    cfg = env.config
    nc = cfg.noise_config
    scales = cfg.reward_config.scales
    names = term_set(env)
    keys = env._metric_keys
    cpu = lambda t: t.detach().cpu().numpy()
    backlash = [-1] * env.action_size
    for slot, adr in zip(env._backlash_actuator_slot.tolist(), env._backlash_qposadr.tolist()):
        backlash[slot] = adr
    offset = env._imitation_ref_offset
    if env.use_imitation:
        grids = [cpu(g) for g in (env.gait._dxs, env.gait._dys, env.gait._dthetas)]
    else:
        grids = [np.zeros(1, np.float32)] * 3
    return dict(
        gait_x=grids[0], gait_y=grids[1], gait_t=grids[2],
        default_act=cpu(env._default_actuator), qpos_noise=cpu(env._qpos_noise_scale),
        ref_offset=np.zeros(10, np.float32) if offset is None else cpu(offset),
        reward_scale=np.array([scales[t] for t in names], np.float32), down=cpu(env._down),
        dt=env.dt, action_scale=cfg.action_scale,
        motor_lim=cfg.max_motor_velocity * env.dt if env.use_motor_speed_limits else 0.0,
        dof_vel_scale=cfg.dof_vel_scale, level=nc.level, sc_gyro=nc.scales.gyro,
        sc_accel=nc.scales.accelerometer, sc_gravity=nc.scales.gravity, sc_jvel=nc.scales.joint_vel,
        sigma=cfg.reward_config.tracking_sigma,
        act_qadr=env._actuator_qposadr.tolist(), act_dadr=env._actuator_dofadr.tolist(),
        backlash_qadr=backlash,
        metric_row=[keys.index(("reward/" if scales[t] > 0 else "cost/") + t) if scales[t] != 0 else -1
                    for t in names],
        foot_vel=env._foot_linvel_sensor_adr.tolist(), feet_site=env._feet_site_id.tolist(),
        imu_site=env._site_id, fb_qadr=env._floating_base_qpos_addr, fb_dadr=env._floating_base_qvel_addr,
        **{name: env._sensor_slices[sensor][0] for name, sensor in _SENSORS.items()},
        row_swing=keys.index("swing_peak"), row_lin=keys.index("tracking_err/lin_vel"),
        row_ang=keys.index("tracking_err/ang_vel"),
        row_head=keys.index("tracking_err/head") if "tracking_err/head" in keys else -1,
        speed_limit=int(env.use_motor_speed_limits),
        head_direct=int(env.has_head and cfg.head_direct_targets),
        push_enable=int(cfg.push_config.enable),
        **({"head_ungated": int(cfg.head_pos_ungated)} if names == STANDING_TERMS else {}),
    )


def record_struct(env, d: Dict[str, int], gait_ptr: int):
    """A filled ctypes TkRecord of `env` whose gait pointer is `gait_ptr`."""
    st = record_type(d)()
    st.gait = gait_ptr
    tables = record_tables(env)
    for name, kind, shape in record_fields(d)[1:]:
        v = np.array(tables[name], dtype=np.int32 if kind == "i" else np.float32)
        if v.shape != shape:
            raise ValueError(f"{name}: shape {v.shape}, the record expects {shape}")
        if shape:
            ctypes.memmove(ctypes.addressof(getattr(st, name)), v.ctypes.data, v.nbytes)
        else:
            setattr(st, name, v.item())
    return st


# env -> {device index (-1: the CPU): (record, gait table, dims)}
_RECORDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def record(env, dev: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, int]]:
    """The record of `env` on `dev` (a uint8 tensor of the TkRecord bytes,
    whose address a launch passes), the gait frame table it points at (None
    without imitation) and the env's dims: made at the first call for the
    env and device, kept until the env goes. The env's config is read then:
    the record holds it as it was."""
    per_env = _RECORDS.setdefault(env, {})
    key = dev.index if dev.type == "cuda" else -1
    rec = per_env.get(key)
    if rec is not None:
        return rec
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("an env's task record is made at its first eager step on a device, not inside a "
                           "CUDA graph capture: run the step once eagerly before capturing it")
    dims = kernel_dims(env)
    gait = env.gait.frames.to(dev).contiguous() if env.use_imitation else None
    st = record_struct(env, dims, 0 if gait is None else gait.data_ptr())
    # a blocking copy: the record is on the card for any stream's launch
    rec = per_env[key] = (torch.tensor(np.frombuffer(st, dtype=np.uint8), device=dev), gait, dims)
    return rec


# ------------------------------------------------------------ build and bind
def build_flags(dims: Dict[str, int]) -> List[str]:
    """The -D flags of a build for `dims`, and the include path."""
    return [*(f"-DTK_{k}={v}" for k, v in sorted(dims.items())), f"-I{cuda_build.CSRC}"]


class TaskLibrary:
    """One built library of the two kernels: `library` builds the card's
    with nvcc; the CPU tests build the host harness
    (`csrc/task_step_host.cpp`), which has the same interface."""

    def __init__(self, built: cuda_build.Library, dims: Dict[str, int]):
        self.dims = dims
        lib = built.lib
        for fn in (lib.tk_pre, lib.tk_post):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tk_record_size.restype = ctypes.c_int
        if lib.tk_record_size() != ctypes.sizeof(record_type(dims)):
            raise RuntimeError("TkRecord layout differs between task_step.cuh and the wrapper")
        lib.tk_obs_sizes.argtypes = [ctypes.c_void_p]
        lib.tk_obs_sizes.restype = None
        sizes = (ctypes.c_int * 2)()
        lib.tk_obs_sizes(sizes)
        self.obs_sizes = tuple(sizes)  # the widths of `state` and `privileged_state`
        self.lib = lib

    def launch(self, fn: str, rec: torch.Tensor, tensors, batch: int, dev: torch.device) -> None:
        """`fn` (tk_pre or tk_post) on the current stream of `dev`; None
        in `tensors` passes a null pointer."""
        ptrs = (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])
        stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
        err = getattr(self.lib, fn)(rec.data_ptr(), ptrs, batch, stream)
        if err:
            raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


_LIBRARIES: Dict[tuple, TaskLibrary] = {}


def library(dims: Dict[str, int]) -> TaskLibrary:
    """The card's library for `dims`, built at first use."""
    key = tuple(sorted(dims.items()))
    if key not in _LIBRARIES:
        built = cuda_build.build(SOURCE, [*build_flags(dims), "-fmad=false"], headers=HEADERS)
        _LIBRARIES[key] = TaskLibrary(built, dims)
    return _LIBRARIES[key]


# -------------------------------------------------------------------- step
def _inputs(dev: torch.device, args) -> List[Optional[torch.Tensor]]:
    """The tensors of `args` ((name, tensor or None, shape, dtype)),
    checked and contiguous."""
    out = []
    for name, t, shape, dtype in args:
        if t is not None:
            if t.dtype != dtype or t.device != dev or tuple(t.shape) != shape:
                raise TypeError(f"{name}: the task kernels take {dtype} {shape} on {dev}, "
                                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
            t = t.contiguous()
        out.append(t)
    return out


def step(env, state: State, action: torch.Tensor, draws, model=None,
         lib: Optional[TaskLibrary] = None) -> State:
    """`env.step(state, action, draws, model)` (a Joystick or a Standing)
    through the two kernels around `forward.step`; `lib` is the card's
    library unless given (the CPU tests give the host harness's)."""
    model = model if model is not None else env.model
    dev = state.data.qvel.device
    rec, gait, d = record(env, dev)
    lib = library(d) if lib is None else lib
    f32, i32 = torch.float32, torch.int32
    action = action.to(f32)
    B, nu, nv = action.shape[0], d["NU"], d["NV"]
    info = dict(state.info)
    e = lambda *shape, dtype=f32: torch.empty((B,) + shape, dtype=dtype, device=dev)

    pre_in = _inputs(dev, [
        ("action", action, (B, nu), f32), ("qvel", state.data.qvel, (B, nv), f32),
        ("imitation_i", info["imitation_i"], (B,), i32), ("command", info["command"], (B, 7), f32),
        ("action_history", info["action_history"], (B, d["AHIST"] * nu), f32),
        ("push_step", info["push_step"], (B,), i32),
        ("push_interval_steps", info["push_interval_steps"], (B,), i32),
        ("motor_targets", info["motor_targets"], (B, nu), f32),
        ("action_delay", draws.action_delay.long(), (B,), torch.int64),
        ("push_theta", draws.push_theta, (B,), f32), ("push_magnitude", draws.push_magnitude, (B,), f32),
    ])
    imitation_i = e(dtype=i32)
    phase = e(2) if d["IMITATION"] and d["OBS_PHASE"] else None
    ref = e(d["GDIM"]) if d["IMITATION"] else None
    hist, push, qvel, targets = e(d["AHIST"] * nu), e(2), e(nv), e(nu)
    lib.launch("tk_pre", rec, pre_in + [imitation_i, phase, ref, hist, push, qvel, targets], B, dev)
    info["imitation_i"] = imitation_i
    if phase is not None:
        info["imitation_phase"] = phase
    if ref is not None:
        info["current_reference_motion"] = ref
    info["action_history"] = hist

    data = F.step(model, state.data.replace(qvel=qvel), targets, env.n_substeps)
    info["motor_targets"] = targets

    s = model.spec
    nstate, npriv = lib.obs_sizes
    nref = d["GDIM"] if d["IMITATION"] else 0
    noise = draws.obs
    post_in = _inputs(dev, [
        ("qpos", data.qpos, (B, s.nq), f32), ("qvel", data.qvel, (B, nv), f32),
        ("site_xpos", data.site_xpos, (B, s.nsite, 3), f32),
        ("site_xmat", data.site_xmat, (B, s.nsite, 3, 3), f32),
        ("actuator_force", data.actuator_force, (B, nu), f32),
        ("contact_dist", data.contact_dist, (B, s.ncon_max), f32),
        ("sensordata", data.sensordata, (B, s.nsensordata), f32),
        ("action", action, (B, nu), f32), ("command", info["command"], (B, 7), f32),
        ("last_act", info["last_act"], (B, nu), f32), ("last_last_act", info["last_last_act"], (B, nu), f32),
        ("last_last_last_act", info["last_last_last_act"], (B, nu), f32),
        ("motor_targets", targets, (B, nu), f32), ("imitation_i", imitation_i, (B,), i32),
        ("imitation_phase", info["imitation_phase"] if d["OBS_PHASE"] else None, (B, 2), f32),
        ("current_reference_motion", info["current_reference_motion"], (B, nref), f32),
        ("feet_air_time", info["feet_air_time"], (B, d["NFOOT"]), f32),
        ("swing_peak", info["swing_peak"], (B, d["NFOOT"]), f32),
        ("step", info["step"], (B,), i32), ("push_step", info["push_step"], (B,), i32),
        ("imu_history", info["imu_history"], (B, 3 * d["IHIST"]), f32),
        ("noise.gyro", noise.gyro, (B, 3), f32), ("noise.accelerometer", noise.accelerometer, (B, 3), f32),
        ("noise.gravity", noise.gravity, (B, 3), f32), ("noise.joint_pos", noise.joint_pos, (B, nu), f32),
        ("noise.joint_vel", noise.joint_vel, (B, nu), f32), ("draws.command", draws.command, (B, 7), f32),
    ])
    obs = {"state": e(nstate), "privileged_state": e(npriv)}
    reward, done = e(), e()
    air_time, swing_peak, contact = e(d["NFOOT"]), e(d["NFOOT"]), e(d["NFOOT"], dtype=torch.bool)
    imu, step_count, push_step, command = e(3 * d["IHIST"]), e(dtype=i32), e(dtype=i32), e(7)
    metrics_rows = torch.empty((len(env._metric_keys), B), dtype=f32, device=dev)
    post_out = [obs["state"], obs["privileged_state"], reward, done, air_time, swing_peak, contact, imu,
                step_count, push_step, command, metrics_rows]
    lib.launch("tk_post", rec, post_in + post_out, B, dev)
    held = [t for t in [rec, gait, *pre_in, imitation_i, phase, ref, hist, push, qvel, targets, *post_in, *post_out]
            if t is not None]
    MK.launched(functools.partial(_count_fused, build_key(env, d)), held)

    info["feet_air_time"] = air_time
    info["swing_peak"] = swing_peak
    info["imu_history"] = imu
    info["push"] = push
    info["step"] = step_count
    info["push_step"] = push_step
    info["last_last_last_act"] = info["last_last_act"]
    info["last_last_act"] = info["last_act"]
    info["last_act"] = action
    info["command"] = command
    info["last_contact"] = contact
    metrics = dict(state.metrics)
    metrics.update(zip(env._metric_keys, metrics_rows))
    return state.replace(data=data, obs=obs, reward=reward, done=done, metrics=metrics, info=info)
