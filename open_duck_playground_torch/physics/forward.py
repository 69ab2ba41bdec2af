"""The forward-dynamics pipeline and the init / step entry points, batched
over a leading env axis.

Semantics of MuJoCo's mj_step: each substep is `forward` then semi-implicit
Euler, so the derived fields of the returned Data (sensordata, contacts,
site poses) describe the start of the last substep. Counterpart of
`open_duck_playground_tpu/physics/forward.py`.

`step` sends CUDA tensors through the hand-written CUDA kernel
(`physics/megakernel.py`) and CPU tensors through `step_reference`, the loop
of plain substeps that is the kernel's plain version. `init` runs the plain
`forward` once on either device.
"""

from __future__ import annotations

import torch

from open_duck_playground_torch.physics import collision as C
from open_duck_playground_torch.physics import constraint as CN
from open_duck_playground_torch.physics import kinematics as K
from open_duck_playground_torch.physics import linalg as LA
from open_duck_playground_torch.physics import maths
from open_duck_playground_torch.physics import sensors as SN
from open_duck_playground_torch.physics import smooth as S
from open_duck_playground_torch.physics import solver as SV
from open_duck_playground_torch.physics import structure
from open_duck_playground_torch.physics.types import Data, Model
from open_duck_playground_torch.utils import tracing


def pin_f32() -> None:
    """Keep float32 products in true f32 on the card: the Newton system and
    the gait table need it (the JAX package pins Precision.HIGHEST)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def make_data(m: Model, batch: int, dtype=None) -> Data:
    s = m.spec
    dtype = dtype or m.dtype
    z = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype, device=m.device)
    qpos0 = m.qpos0.to(dtype)
    return Data(
        qpos=qpos0.expand(batch, s.nq).clone(),
        qvel=z(s.nv),
        ctrl=z(s.nu),
        qacc=z(s.nv),
        qacc_warmstart=z(s.nv),
        site_xpos=z(s.nsite, 3),
        site_xmat=z(s.nsite, 3, 3),
        actuator_force=z(s.nu),
        contact_dist=z(s.ncon_max),
        sensordata=z(s.nsensordata),
    )


def forward(m: Model, d: Data) -> Data:
    """One full forward pass: position, velocity and actuation stages, the
    constraint solve and the sensors."""
    qpos, qvel, ctrl = d.qpos, d.qvel, d.ctrl
    m = m.expand_batch(qpos.shape[0])

    xpos, xquat, xanchor, xaxis, xipos, ximat, site_xpos, site_xmat = K.kinematics(m, qpos)
    com, cdof = K.com_cdof(m, xquat, xanchor, xaxis, xipos)
    qm = S.mass_matrix(m, cdof, xipos, ximat, com)
    contact = C.collide(m, xpos, xquat)

    cvel, cdof_dot = K.com_vel(m, cdof, qvel)
    qfrc_bias = S.rne_bias(m, cdof, cdof_dot, cvel, qvel, xipos, ximat, com)
    qfrc_passive = S.passive_force(m, qvel)
    actuator_force, qfrc_actuator = S.actuation(m, qpos, qvel, ctrl)

    qfrc_smooth = qfrc_passive - qfrc_bias + qfrc_actuator
    qacc_smooth = LA.cholesky_solve(qm, qfrc_smooth)

    efc = CN.make_constraints(m, qpos, qvel, cdof, com, contact)
    qacc = SV.solve(m, qm, qacc_smooth, d.qacc_warmstart, efc)

    cacc = SN.body_cacc(m, cdof, cdof_dot, qvel, qacc)
    sensordata = SN.sensor_data(m, xquat, site_xpos, site_xmat, com, cvel, cacc)
    return d.replace(
        qacc=qacc,
        site_xpos=site_xpos,
        site_xmat=site_xmat,
        actuator_force=actuator_force,
        contact_dist=contact.dist,
        sensordata=sensordata,
    )


def _integrate(m: Model, d: Data) -> Data:
    """Semi-implicit Euler: qvel from qacc, then qpos from the new qvel."""
    s = m.spec
    dt = s.timestep
    qvel = d.qvel + dt * d.qacc
    qpos = d.qpos.clone()
    hj = structure.hinge_joints(s)
    hq = [s.jnt_qposadr[j] for j in hj]
    hd = [s.jnt_dofadr[j] for j in hj]
    qpos[:, hq] = qpos[:, hq] + dt * qvel[:, hd]
    fj = structure.free_joint(s)
    if fj >= 0:
        qa, da = s.jnt_qposadr[fj], s.jnt_dofadr[fj]
        qpos[:, qa : qa + 3] = qpos[:, qa : qa + 3] + dt * qvel[:, da : da + 3]
        qpos[:, qa + 3 : qa + 7] = maths.quat_integrate(
            qpos[:, qa + 3 : qa + 7], qvel[:, da + 3 : da + 6], dt
        )
    return d.replace(qpos=qpos, qvel=qvel, qacc_warmstart=d.qacc)


def substep(m: Model, d: Data) -> Data:
    return _integrate(m, forward(m, d))


def step_reference(m: Model, d: Data, ctrl: torch.Tensor, n_substeps: int) -> Data:
    """n_substeps plain substeps under a fixed ctrl: the plain version of
    the CUDA kernel, on any device."""
    d = d.replace(ctrl=ctrl)
    for _ in range(n_substeps):
        d = substep(m, d)
    return d


def step(m: Model, d: Data, ctrl: torch.Tensor, n_substeps: int) -> Data:
    """n_substeps physics substeps under a fixed ctrl (control-rate to
    sim-rate decimation, 0.02 / 0.002 = 10 on the duck).

    CUDA tensors go through the CUDA kernel, CPU tensors through
    `step_reference`."""
    with tracing.span("env.physics"):
        if d.qpos.is_cuda:
            from open_duck_playground_torch.physics import megakernel as MK

            pin_f32()
            return MK.megakernel_step(m, d, ctrl, n_substeps)
        return step_reference(m, d, ctrl, n_substeps)


def init(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor) -> Data:
    """Fresh Data plus one plain forward pass (mjx_env.init role)."""
    if qpos.is_cuda:
        pin_f32()
    d = make_data(m, qpos.shape[0], dtype=qpos.dtype)
    d = d.replace(qpos=qpos, qvel=qvel, ctrl=ctrl)
    return forward(m, d)
