"""Tests of the port that need an NVIDIA card (the CUDA kernel has no CPU
mode); each skips without one. This file imports no JAX package module, so
it also runs on the card's machine, which has no `mujoco`:

    python -m pytest tests/test_torch_gpu.py -q

Gates: the kernel against its plain version (`forward.step_reference`),
per env, at the interpret-mode test's tolerances: the max for every env of
every substep along the kernel's own trajectory, p90 after 10 free-running
substeps (the 1-iteration Newton solve lets a few envs part later). The
issue-rate probe against its plain version within 1e-5 after 128 rounds
(half an ulp per f32 round, all falling the same way, is 7.6e-6), its
blocks each on its own SM, and its wrapper free of synchronisations. A
one-rank NCCL mesh against no mesh within 1e-6 (its all-reduces are
identities); `tools.bench_physics` on every scene gives a finite rate.
The profilers: the CUDA-graph epochs within a relative 1e-5 of the
production epoch and of the same epoch with the capturable Adam; the SASS
census of the plane build adds up and its FFMA classes agree with the
probe's reading; `benchutil.device_trace` sees each section's kernels and
`host_syncs` counts one copy to the host.
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
    wrapped = TrainingEnv(env, 1000, dr_draws=DRDraws.sample(gen, batch, env.model.spec),
                          randomization_fn=domain_randomize)
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
        x = 0.5 + 0.1 * torch.rand((chains, 4 * IB.per_block(variant, 96)), generator=gen, device=cuda)
        for operands in IB.OPERANDS:
            before = IB.launches
            timers = torch.zeros((4, len(IB.TIMERS)), dtype=torch.int64, device=cuda)
            got = IB.run(variant, x, 4, threads=96, timers=timers, operands=operands)
            assert IB.launches == before + 1
            assert (timers[:, 2] > timers[:, 1]).all() and (timers[:, 4] >= timers[:, 3]).all()
            assert (got - IB.plain(variant, x, 4)).abs().max() < 1e-5, (chains, operands)
    assert torch.equal(IB.run(variant, x, 0), x)  # no trips: the loads and stores alone
    with pytest.raises(ValueError):
        IB.run(variant, x[:3], 4)  # 3 chains were not built
    with pytest.raises(TypeError):
        IB.run(variant, x.double(), 4)


@pytest.mark.parametrize("variant", ["fma", "narrow"])
def test_issue_probe_puts_one_block_on_each_sm(cuda, variant):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    x = torch.full((1, sms * IB.per_block(variant, 32)), IB.X0, device=cuda)
    timers = torch.zeros((sms, len(IB.TIMERS)), dtype=torch.int64, device=cuda)
    IB.run(variant, x, 8, threads=32, timers=timers)
    assert len(torch.unique(timers[:, 0])) == sms  # even one warp a block: each alone on its SM
    assert timers[:, 0].min() >= 0 and timers[:, 0].max() < sms


def test_issue_probe_run_does_not_synchronize(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    x = torch.full((8, sms * 512), IB.X0, device=cuda)
    IB.run("fma", x, 64, threads=512)  # the first use puts the constants on the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [IB.run("fma", x, 64, threads=512) for _ in range(20)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(outs[0], outs[-1])


def test_training_step_runs_on_rough_terrain_through_the_kernel(cuda):
    cfg = PPOConfig(num_envs=256, batch_size=64, num_minibatches=4, unroll_length=5,
                    num_updates_per_batch=2, num_evals=1)
    env = Joystick("rough_terrain_backlash", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    train_env = TrainingEnv(env, cfg.episode_length,
                            dr_draws=DRDraws.sample(gen, cfg.num_envs, env.model.spec),
                            randomization_fn=domain_randomize)
    state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=cuda)
    before = [p.detach().clone() for p in ts.net.parameters()]
    launches = MK.launches_hfield
    ts, state, metrics = ppo.training_step(ts, train_env, env, state, cfg, gen)
    assert MK.launches_hfield - launches == cfg.unroll_length
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, ts.net.parameters()))
    assert float(ts.normalizer.count) == cfg.steps_per_training_step == ts.env_steps


def test_eval_runs_through_the_kernel(cuda):
    """`ppo.run_eval` (EvalEnv on the nominal model, 128 envs) on the card:
    one plane-kernel launch per control step, finite metrics."""
    from open_duck_playground_torch.envs.wrappers import EvalEnv
    from open_duck_playground_torch.train import networks as N, running_stats as RS

    env = Joystick("flat_terrain_backlash", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    ev = EvalEnv(env, 1000)
    sizes = {k: v.shape[-1] for k, v in ev.reset(env.reset_draws(gen, 2)).obs.items()}
    net = N.PPONetworks.init(sizes, env.action_size, (32, 32), gen, device=cuda, value_hidden=(32,))
    before = MK.kernel(env.model.spec).launches
    metrics = ppo.run_eval(ev, (RS.init(sizes, device=cuda), net), 128, 30, False, gen)
    assert MK.kernel(env.model.spec).launches - before == 30
    assert all(np.isfinite(v) for v in metrics.values()) and 0 < metrics["eval/avg_episode_length"] <= 30


def test_standing_step_runs_on_flat_terrain_through_the_kernel(cuda):
    from open_duck_playground_torch.envs.standing import Standing

    env = Standing("flat_terrain", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    batch = 256
    wrapped = TrainingEnv(env, 1000, dr_draws=DRDraws.sample(gen, batch, env.model.spec),
                          randomization_fn=domain_randomize)
    state = wrapped.reset(env.reset_draws(gen, batch))
    before = MK.kernel(env.model.spec).launches
    for _ in range(3):
        action = 2 * torch.rand(batch, env.action_size, generator=gen, device=cuda) - 1
        state = wrapped.step(state, action, env.step_draws(gen, batch))
    torch.cuda.synchronize()
    assert MK.kernel(env.model.spec).launches - before == 3 and MK.kernel_dims(env.model.spec)["NV"] == 20
    assert all(torch.isfinite(v).all() for v in state.obs.values()) and torch.isfinite(state.reward).all()


def test_cuda_no_head_kernel_matches_step_reference(cuda):
    """The plane build for the no-head robot (nv 16, chains of 5 and 5):
    its block-arrow partition, every env within the max gates one substep
    per launch along the kernel's trajectory, and the one 10-substep launch
    equal to those launches."""
    model = loader.load_model("scene_flat_terrain_no_head", device=cuda, timestep=0.002)
    dims = MK.kernel_dims(model.spec)
    assert (dims["NV"], dims["NU"], dims["NCHAIN"], dims["MAXCHAIN"], dims["NROOT"]) == (16, 10, 2, 5, 6)
    batch = 1000
    gen = torch.Generator(device=cuda).manual_seed(10)
    m = domain_randomize(model, DRDraws.sample(gen, batch, model.spec))
    qpos = model.key_qpos + 0.01 * torch.randn(batch, model.spec.nq, generator=gen, device=cuda)
    qvel = 0.1 * torch.randn(batch, model.spec.nv, generator=gen, device=cuda)
    ctrl = model.key_ctrl.expand(batch, -1).contiguous()
    d0 = F.init(m, qpos, qvel, ctrl)
    before = MK.kernel(model.spec).launches
    d = d0
    for _ in range(10):
        k1, p1 = MK.megakernel_step(m, d, ctrl, 1), F.step_reference(m, d, ctrl, 1)
        for f, mx in (("qpos", 1e-4), ("qvel", 1e-2)):
            assert _per_env(getattr(k1, f), getattr(p1, f)).max() < mx, f
        d = k1
    got = MK.megakernel_step(m, d0, ctrl, 10)
    assert MK.kernel(model.spec).launches - before == 11
    assert torch.equal(got.qpos, d.qpos) and torch.equal(got.qvel, d.qvel)


def test_no_head_recipe_step_runs_through_the_kernel(cuda):
    """A training step of the no-head recipe (rsi_prob 0.5, bf16 products)
    on the card: one no-head launch per control step, finite metrics."""
    cfg = PPOConfig(num_envs=256, batch_size=64, num_minibatches=4, unroll_length=5,
                    num_updates_per_batch=2, num_evals=1, bf16_matmuls=True)
    env = Joystick("flat_terrain_no_head", config_overrides={"rsi_prob": 0.5}, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    train_env = TrainingEnv(env, cfg.episode_length,
                            dr_draws=DRDraws.sample(gen, cfg.num_envs, env.model.spec),
                            randomization_fn=domain_randomize)
    state = train_env.reset(env.reset_draws(gen, cfg.num_envs))
    assert 0.3 < float((state.info["imitation_i"] > 0).float().mean()) < 0.7
    ts = ppo.init_training_state(state.obs, env.action_size, cfg, gen, device=cuda)
    assert ts.net.policy.matmul_dtype == torch.bfloat16
    before = MK.kernel(env.model.spec).launches
    ts, state, metrics = ppo.training_step(ts, train_env, env, state, cfg, gen)
    assert MK.kernel(env.model.spec).launches - before == cfg.unroll_length
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in ts.net.parameters())


def test_world_one_nccl_mesh_equals_no_mesh(cuda):
    """One training step of `ppo.train` without a mesh and on a one-rank
    NCCL mesh from the same seed: the mesh's code path (global counts,
    all-reduces that are identities) gives the same parameters and
    normalizer within 1e-6, one plane-kernel launch per control step each."""
    import torch.distributed as dist

    from open_duck_playground_torch.envs.randomize import domain_randomize
    from open_duck_playground_torch.parallel import dryrun, mesh as M

    cfg = PPOConfig(num_envs=256, batch_size=64, num_minibatches=4, unroll_length=5,
                    num_updates_per_batch=2, num_evals=1)
    env = Joystick("flat_terrain_backlash", device=cuda)

    def train(mesh):
        return ppo.train(env, cfg.steps_per_training_step, config=cfg, device=cuda,
                         randomization_fn=domain_randomize, mesh=mesh)[1]

    before = MK.kernel(env.model.spec).launches
    normalizer, net = train(None)
    dist.init_process_group(M.backend_for(cuda), init_method=f"tcp://127.0.0.1:{dryrun.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = M.make_mesh("cuda")
        assert dist.get_backend() == "nccl" and mesh.world_size == 1
        mnormalizer, mnet = train(mesh)
    finally:
        dist.destroy_process_group()
    assert MK.kernel(env.model.spec).launches - before == 2 * cfg.unroll_length
    for a, b in zip(net.parameters(), mnet.parameters()):
        assert float((a - b).detach().abs().max()) <= 1e-6
    for field in ("mean", "std"):
        for k, v in getattr(normalizer, field).items():
            assert float((v - getattr(mnormalizer, field)[k]).abs().max()) <= 1e-6, (field, k)


@pytest.mark.parametrize("task", ["flat_terrain_backlash", "flat_terrain", "rough_terrain_backlash",
                                  "rough_terrain", "flat_terrain_no_head"])
def test_bench_physics_runs_on_each_scene(cuda, task):
    from open_duck_playground_torch.tools import bench_physics

    record = bench_physics.main(["--task", task, "--envs", "1024", "--steps", "5"])
    assert record["finite"] and np.isfinite(record["value"]) and record["value"] > 0
    assert record["kernel_launches"] == 5 * bench_physics.REPS and record["device"] == torch.cuda.get_device_name(0)


def test_native_runtime_builds_on_the_host_and_matches_the_policy(cuda, tmp_path):
    """The deployment runtime of the card's machine: `onnx_mlp.cc` built with
    the host's C++ compiler into build/host/, on an export of a policy on the
    card, against the numpy runtime and the torch deterministic action
    within 1e-5, and accepted by the port's validator."""
    from open_duck_playground_torch import cuda_build
    from open_duck_playground_torch.export import native_runtime, onnx_export, onnx_runtime, onnx_validate

    gen = torch.Generator(device=cuda).manual_seed(5)
    obs = {"state": torch.randn(32, 101, generator=gen, device=cuda),
           "privileged_state": torch.randn(32, 212, generator=gen, device=cuda)}
    ts = ppo.init_training_state(obs, 14, PPOConfig(), gen, device=cuda)
    path = tmp_path / "policy.onnx"
    onnx_export.export_policy((ts.normalizer, ts.net), 14, None, 101, str(path))
    lib = cuda_build.build(native_runtime.SOURCE, host=True)
    assert lib.path.parent == cuda_build.HOST_BUILD_DIR
    want = ppo.make_policy((ts.normalizer, ts.net), deterministic=True)(obs)[0].cpu().numpy()
    state = obs["state"].cpu().numpy()
    native = np.stack([native_runtime.NativeOnnxPolicy(str(path)).infer(o) for o in state])
    assert np.abs(native - onnx_runtime.OnnxPolicy(str(path)).infer(state)).max() < 1e-5
    assert np.abs(native - want).max() < 1e-5
    assert onnx_validate.validate_file(str(path))["outputs"] == {"continuous_actions": (1, 14)}


def test_reward_terms_on_the_card_match_their_numpy_mirrors(cuda):
    """Every torch reward term and the imitation reward (14 and 10 joints)
    on CUDA tensors against `eval_tools.rewards_numpy` row by row, at the
    mirror test's tolerances (rtol 2e-5, atol 2e-6)."""
    from open_duck_playground_torch.envs import imitation, rewards as RT
    from open_duck_playground_torch.eval_tools import rewards_numpy as RN

    n = 256
    gen = torch.Generator(device=cuda).manual_seed(6)
    f = lambda *shape: torch.randn((n, *shape), generator=gen, device=cuda)
    cmd, vel3, pose14, vel14, contact = f(7), f(3), f(14), f(14), f(2) > 0
    cases = [
        (RT.tracking_lin_vel, RN.tracking_lin_vel, (cmd, vel3, 0.2)),
        (RT.tracking_ang_vel, RN.tracking_ang_vel, (cmd, vel3, 0.2)),
        (RT.yaw_rate_l1, RN.yaw_rate_l1, (cmd, vel3)),
        (RT.lin_vel_l1, RN.lin_vel_l1, (cmd, vel3)),
        (RT.forward_progress, RN.forward_progress, (cmd, vel3)),
        (RT.torques, RN.torques, (f(14),)),
        (RT.action_rate, RN.action_rate, (f(14), f(14))),
        (RT.orientation, RN.orientation, (f(3),)),
        (RT.stand_still, RN.stand_still, (cmd * 0.001, pose14, vel14, f(14), True)),
        (RT.stand_still, RN.stand_still, (cmd * 0.001, f(10), f(10), f(10), True)),
        (RT.head_pos, RN.head_pos, (pose14, vel14, cmd, True)),
        (RT.lin_vel_z, RN.lin_vel_z, (vel3,)),
        (RT.ang_vel_xy, RN.ang_vel_xy, (vel3,)),
        (RT.base_height, RN.base_height, (f().abs(), 0.15)),
        (RT.base_y_swing, RN.base_y_swing, (0.1 * f(), 1.5, 0.05, f().abs(), 0.2)),
        (RT.energy, RN.energy, (f(20), f(20))),
        (RT.joint_pos_limits, RN.joint_pos_limits, (pose14, f(14) - 3, f(14) + 3)),
        (RT.termination, RN.termination, (contact[:, 0].float(),)),
        (RT.joint_deviation, RN.joint_deviation, (pose14, [0, 1, 2, 3, 4], f(14), 1.0)),
        (RT.pose, RN.pose, (pose14, f(14), f(14).abs())),
        (RT.feet_slip, RN.feet_slip, (contact, f(3))),
        (RT.feet_clearance, RN.feet_clearance, (f(2, 3), f(2, 3), 0.08)),
        (RT.feet_height, RN.feet_height, (f(2).abs(), contact, 0.1)),
        (RT.feet_air_time, RN.feet_air_time, (f(2).abs(), contact, cmd)),
        (RT.feet_phase, RN.feet_phase, (f(2, 3), f(2))),
        (imitation.imitation_reward, RN.imitation_reward,
         (f(6), pose14, vel14, contact.float(), f(40), cmd)),
        (imitation.imitation_reward, RN.imitation_reward,
         (f(6), f(10), f(10), contact.float(), f(40), cmd, True, 0.05 * f(10))),
    ]
    for torch_fn, np_fn, args in cases:
        got = torch_fn(*args)
        assert got.device.type == "cuda" and got.shape == (n,), torch_fn.__name__
        rows = [a.cpu().numpy() if torch.is_tensor(a) else a for a in args]
        want = [np_fn(*[r[i] if torch.is_tensor(a) else r for a, r in zip(args, rows)]) for i in range(n)]
        np.testing.assert_allclose(got.double().cpu().numpy(), np.asarray(want, np.float64),
                                   rtol=2e-5, atol=2e-6, err_msg=torch_fn.__name__)
    assert float(RT.alive(n, cuda).sum()) == n * float(RN.alive())


def test_profile_epoch_graph_variants_replay_the_eager_epoch(cuda):
    """The CUDA-graph epochs (k = 1 and 4 minibatch steps per replay)
    within a relative 1e-5 of the production epoch's parameters (the
    capturable Adam rounds otherwise), and of the same epoch run eagerly
    with the capturable Adam."""
    from open_duck_playground_torch.tools import profile_epoch

    cfg = PPOConfig(num_envs=2048, batch_size=256, num_minibatches=8)
    gen = torch.Generator(device=cuda).manual_seed(0)
    data, final_obs = profile_epoch.payload(cfg, gen)
    ts = ppo.init_training_state(final_obs, profile_epoch.ACTION_SIZE, cfg, gen, device=cuda)
    draws = ppo.sgd_draws(cfg, profile_epoch.ACTION_SIZE, gen)
    out = profile_epoch.profile(ts, cfg, data, final_obs, draws, ["graph_1", "graph_4"], 0, 1, cuda)
    for name, v in out.items():
        assert v["finite"] and v["rel_diff"] <= 1e-5, (name, v)
        assert v["rel_diff_from_eager_capturable_adam"] <= 1e-5, (name, v)


def test_count_kernel_ops_census_of_the_plane_build(cuda):
    """The census of the built plane kernel adds up, its FFMA classes agree
    with the probe's SASS reading, and its issue bound is finite."""
    from open_duck_playground_torch.tools import count_kernel_ops as CK

    r = CK.main(["--slots"])
    assert r["static_instructions"] > 1000 and sum(r["by_class"].values()) == r["static_instructions"]
    assert r["ffma"]["count"] == r["by_class"]["FFMA"] == sum(r["ffma"][c] for c in CK.FFMA_CLASSES)
    assert 0 < r["slots"]["issue_bound_ms"] < 10
    assert all(row["ok"] for row in CK.probe_agreement())


def test_device_trace_sees_kernels_in_each_section(cuda):
    from open_duck_playground_torch.tools import benchutil

    x = torch.ones(1 << 20, device=cuda)

    def fn(mark):
        with mark("add"):
            y = x + 1
        with mark("mul"):
            (y * 2).sum()
        with mark("item"):
            y.sum().item()  # a copy to the host: one synchronization

    fn(benchutil.no_marks)
    t = benchutil.device_trace(fn, cuda)
    assert t["whole"]["kernel_launches"] >= 4 and 0 <= t["whole"]["idle_share"] < 1
    assert t["whole"]["launch_calls"] >= 4 and t["whole"]["untraced_launches"] == 0
    assert t["sections"]["add"]["kernel_launches"] == 1 and t["sections"]["mul"]["kernel_launches"] >= 2
    assert benchutil.host_syncs(fn, cuda) == {"whole": 1, "sections": {"add": 0, "mul": 0, "item": 1}}
