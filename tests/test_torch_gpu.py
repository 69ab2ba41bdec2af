"""Tests of the port that need an NVIDIA card (the CUDA kernel has no CPU
mode); each skips without one. This file imports no JAX package module, so
it also runs on the card's machine, which has no `mujoco`:

    python -m pytest tests/test_torch_gpu.py -q

Gates: the kernel against its plain version (`forward.step_reference`),
per env, at the interpret-mode test's tolerances: the max for every env of
every substep along the kernel's own trajectory, p90 after 10 free-running
substeps (the 1-iteration Newton solve lets a few envs part later). The
issue-rate probe against its plain version within 1e-5 after 128 rounds
(half an ulp per f32 round, all falling the same way, is 7.6e-6).
"""

import numpy as np
import pytest
import torch

from open_duck_playground_torch.envs.joystick import Joystick, ResetDraws, StepDraws
from open_duck_playground_torch.envs.randomize import DRDraws, domain_randomize
from open_duck_playground_torch.envs.wrappers import TrainingEnv
from open_duck_playground_torch.models import loader
from open_duck_playground_torch.physics import forward as F
from open_duck_playground_torch.physics import megakernel as MK
from open_duck_playground_torch.tools import issue_bench as IB
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _per_env(a, b):
    return (a - b).abs().reshape(a.shape[0], -1).amax(1).double().cpu().numpy()


def test_cuda_kernel_matches_step_reference(cuda):
    """One substep per launch along the kernel's own trajectory, every env
    within the max gates at every substep; the one 10-substep launch gives
    exactly that trajectory, within the p90 gates of 10 plain substeps."""
    model = loader.load_model(device=cuda, timestep=0.002)
    batch = 1000  # not a multiple of the block: the ragged edge is masked
    gen = torch.Generator(device=cuda).manual_seed(3)
    m = domain_randomize(model, DRDraws.sample(gen, batch, model.spec))
    rng = np.random.default_rng(3)
    kq = model.key_qpos.cpu().numpy()
    qpos = np.tile(kq, (batch, 1)) + 0.01 * rng.standard_normal((batch, kq.size))
    qvel = 0.1 * rng.standard_normal((batch, model.spec.nv))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    ctrl = model.key_ctrl.expand(batch, -1).contiguous()
    d0 = F.init(m, f32(qpos), f32(qvel), ctrl)
    gates = [("qpos", 1e-5, 1e-4), ("qvel", 1e-3, 1e-2)]
    d = d0
    for _ in range(10):
        k1 = MK.megakernel_step(m, d, ctrl, 1)
        p1 = F.step_reference(m, d, ctrl, 1)
        for f, _, mx in gates:
            e = _per_env(getattr(k1, f), getattr(p1, f))
            assert e.max() < mx, (f, e.max())
        d = k1
    got = MK.megakernel_step(m, d0, ctrl, 10)
    assert torch.equal(got.qpos, d.qpos) and torch.equal(got.qvel, d.qvel)
    want = F.step_reference(m, d0, ctrl, 10)
    for f, p90, _ in gates:
        e = _per_env(getattr(got, f), getattr(want, f))
        assert np.percentile(e, 90) < p90, (f, np.percentile(e, 90))
    assert torch.equal(got.qacc_warmstart, got.qacc)


def test_cuda_dense_partition_matches_step_reference(cuda):
    """The same source on the degenerate partition (no root, one chain of
    all dofs), which a model without block-arrow shape takes: max gates one
    substep from a shared state, and the launch counts say which build ran."""
    model = loader.load_model(device=cuda, timestep=0.002)
    batch = 300
    gen = torch.Generator(device=cuda).manual_seed(7)
    m = domain_randomize(model, DRDraws.sample(gen, batch, model.spec))
    qpos = model.key_qpos + 0.01 * torch.randn(batch, model.spec.nq, generator=gen, device=cuda)
    qvel = 0.1 * torch.randn(batch, model.spec.nv, generator=gen, device=cuda)
    ctrl = model.key_ctrl.expand(batch, -1).contiguous()
    d0 = F.init(m, qpos, qvel, ctrl)
    before = MK.launches_dense
    k1, p1 = MK.megakernel_step(m, d0, ctrl, 1, dense=True), F.step_reference(m, d0, ctrl, 1)
    assert MK.launches_dense == before + 1
    for f, mx in (("qpos", 1e-4), ("qvel", 1e-2), ("contact_dist", 1e-6)):
        assert _per_env(getattr(k1, f), getattr(p1, f)).max() < mx, f
    info = MK.kernel(model.spec).info()
    assert info["lanes_per_env"] > 1 and info["local_bytes_per_thread"] <= 256
    assert info["resident_warps_per_sm"] >= 8


@pytest.mark.parametrize("scene", ["scene_flat_terrain_backlash", "scene_rough_terrain_backlash"])
def test_cuda_kernel_survives_nan_state(cuda, scene):
    """Blown-up envs (NaN base position) stay NaN for the quarantine and
    leave every other env bit for bit as it is without them, at the
    committed lanes per env: the warp arg-min over hull vertices and the
    lanes' sums see the NaN only here (the host build runs them on one lane
    or on threads, without shuffles and lane masks). The bad envs sit at
    both ends of a block and in the ragged last one."""
    model = loader.load_model(scene, device=cuda, timestep=0.002)
    batch = 67
    gen = torch.Generator(device=cuda).manual_seed(8)
    m = domain_randomize(model, DRDraws.sample(gen, batch, model.spec))
    qpos = model.key_qpos + 0.01 * torch.randn(batch, model.spec.nq, generator=gen, device=cuda)
    qvel = 0.1 * torch.randn(batch, model.spec.nv, generator=gen, device=cuda)
    ctrl = model.key_ctrl.expand(batch, -1).contiguous()
    d0 = F.init(m, qpos, qvel, ctrl)
    bad_envs = [0, 7, 13, 66]
    bad = d0.replace(qpos=d0.qpos.clone())
    bad.qpos[bad_envs, :3] = float("nan")
    assert MK.kernel(model.spec).info()["lanes_per_env"] == 32
    got, ref = MK.megakernel_step(m, bad, ctrl, 2), MK.megakernel_step(m, d0, ctrl, 2)
    plain = F.step_reference(m, bad, ctrl, 2)
    keep = [e for e in range(batch) if e not in bad_envs]
    for e in bad_envs:
        assert torch.isnan(got.qpos[e]).any() and torch.isnan(plain.qpos[e]).any()
    for f in ("qpos", "qvel", "qacc", "sensordata", "contact_dist"):
        assert torch.equal(getattr(got, f)[keep], getattr(ref, f)[keep]), f
    assert torch.isfinite(got.qpos[keep]).all()


def test_cuda_kernel_rejects_what_it_cannot_take(cuda):
    model = loader.load_model(device=cuda, timestep=0.002)
    ctrl = model.key_ctrl.expand(4, -1).contiguous()
    d0 = F.init(model, model.key_qpos.expand(4, -1).contiguous(),
                torch.zeros(4, model.spec.nv, device=cuda), ctrl)
    with pytest.raises(TypeError):
        MK.megakernel_step(model, d0, ctrl.double(), 10)
    with pytest.raises(ValueError):
        MK.megakernel_step(model, d0.replace(qpos=d0.qpos.t().contiguous().t()), ctrl, 10)


def test_training_rollout_runs_through_the_kernel(cuda):
    env = Joystick("flat_terrain_backlash", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    batch = 256
    wrapped = TrainingEnv(env, 1000, dr_draws=DRDraws.sample(gen, batch, env.model.spec))
    state = wrapped.reset(ResetDraws.sample(gen, batch, env))
    before = MK.launches
    for _ in range(3):
        action = 2 * torch.rand(batch, env.action_size, generator=gen, device=cuda) - 1
        state = wrapped.step(state, action, StepDraws.sample(gen, batch, env))
    torch.cuda.synchronize()
    assert MK.launches - before == 3
    assert all(torch.isfinite(v).all() for v in state.obs.values())
    assert torch.isfinite(state.reward).all()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_cuda_hfield_kernel_matches_step_reference(cuda):
    """The heightfield build on rough terrain, envs spread over +-3 m: every
    env within the max gates one substep from a shared state, contacts
    active, p90 after 10 free-running substeps, and the one 10-substep
    launch equal to 10 chained launches."""
    model = loader.load_model("scene_rough_terrain_backlash", device=cuda, timestep=0.002)
    batch = 1000
    gen = torch.Generator(device=cuda).manual_seed(4)
    m = domain_randomize(model, DRDraws.sample(gen, batch, model.spec))
    rng = np.random.default_rng(4)
    kq = model.key_qpos.cpu().numpy()
    qpos = np.tile(kq, (batch, 1)) + 0.01 * rng.standard_normal((batch, kq.size))
    qpos[:, :2] += rng.uniform(-3.0, 3.0, (batch, 2))
    qvel = 0.1 * rng.standard_normal((batch, model.spec.nv))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    ctrl = model.key_ctrl.expand(batch, -1).contiguous()
    d0 = F.init(m, f32(qpos), f32(qvel), ctrl)
    before = MK.launches_hfield
    k1, p1 = MK.megakernel_step(m, d0, ctrl, 1), F.step_reference(m, d0, ctrl, 1)
    assert MK.launches_hfield == before + 1
    for f, mx in (("qpos", 1e-4), ("qvel", 1e-2), ("contact_dist", 1e-6)):
        assert _per_env(getattr(k1, f), getattr(p1, f)).max() < mx, f
    assert (k1.contact_dist < 0).any(1).sum() > batch // 2
    d = d0
    for _ in range(10):
        d = MK.megakernel_step(m, d, ctrl, 1)
    got, want = MK.megakernel_step(m, d0, ctrl, 10), F.step_reference(m, d0, ctrl, 10)
    assert torch.equal(got.qpos, d.qpos) and torch.equal(got.qvel, d.qvel)
    for f, p90 in (("qpos", 1e-5), ("qvel", 1e-3)):
        assert np.percentile(_per_env(getattr(got, f), getattr(want, f)), 90) < p90, f


@pytest.mark.parametrize("variant", IB.VARIANTS)
def test_issue_probe_matches_its_plain_version(cuda, variant):
    gen = torch.Generator(device=cuda).manual_seed(5)
    for chains in IB.CHAINS:
        x = 0.5 + 0.1 * torch.rand((chains, 4 * 96), generator=gen, device=cuda)
        before = IB.launches
        cycles = torch.zeros(4, dtype=torch.int64, device=cuda)
        got = IB.run(variant, x, 4, threads=96, cycles=cycles)
        assert IB.launches == before + 1 and (cycles > 0).all()
        assert (got - IB.plain(variant, x, 4)).abs().max() < 1e-5, chains
    assert torch.equal(IB.run(variant, x, 0), x)  # no trips: the loads and stores alone
    with pytest.raises(ValueError):
        IB.run(variant, x[:3], 4)  # 3 chains were not built
    with pytest.raises(TypeError):
        IB.run(variant, x.double(), 4)


def test_training_step_runs_on_rough_terrain_through_the_kernel(cuda):
    cfg = PPOConfig(num_envs=256, batch_size=64, num_minibatches=4, unroll_length=5,
                    num_updates_per_batch=2, num_evals=1)
    env = Joystick("rough_terrain_backlash", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    train_env = TrainingEnv(env, cfg.episode_length,
                            dr_draws=DRDraws.sample(gen, cfg.num_envs, env.model.spec))
    state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=cuda)
    before = [p.detach().clone() for p in ts.net.parameters()]
    launches = MK.launches_hfield
    ts, state, metrics = ppo.training_step(ts, train_env, env, state, cfg, gen)
    assert MK.launches_hfield - launches == cfg.unroll_length
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, ts.net.parameters()))
    assert float(ts.normalizer.count) == cfg.steps_per_training_step == ts.env_steps
