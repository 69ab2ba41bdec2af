"""The port's samplers against the JAX package's distributions.

Every parity test elsewhere hands the port the very numbers JAX drew, so the
port's own samplers (torch's Philox/mt19937 streams) are never compared
there. Here each sampler draws 2^16 rows from a torch generator and the JAX
package draws 2^16 rows of the same quantity through its env's own methods
(`sample_command`, `domain_randomize`, `networks.sample_raw` / `entropy` /
`init_mlp`) or through the `jax.random` calls at the lines the port mirrors
(the split order of `Joystick.reset` / `step`, replayed by
`test_torch_envs`). For every column of every field:

- support: the lower bound is attained inclusively, both ends are reached to
  within 1e-3 of the range; float draws lie in [lo, hi] (the f32 rounding of
  lo + u (hi - lo) may land on hi, on both sides), integer draws in
  [lo, hi) and take every value there;
- mean and std of the port within 5 standard errors of JAX's (the std's
  standard error by the delta method from the fourth moment), and of the
  uniform law where the field has one;
- integer draws: each value's frequency within 5 standard errors of JAX's
  and of 1/k;
- commands: the share of all-zero commands within 5 standard errors of
  p = 0.1 and of JAX's share.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.envs import randomize as JR
from open_duck_playground_tpu.envs.joystick import Joystick as JJoystick
from open_duck_playground_tpu.envs.standing import Standing as JStanding
from open_duck_playground_tpu.train import networks as JN

from open_duck_playground_torch.envs import randomize as TR
from open_duck_playground_torch.envs.joystick import Joystick, ResetDraws, StepDraws, head_ranges
from open_duck_playground_torch.envs.standing import Standing
from open_duck_playground_torch.train import networks as TN
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig

from test_torch_envs import jax_reset_draws, jax_step_draws

torch.set_num_threads(1)

N = 1 << 16
Z = 5.0  # standard errors
TASK = "flat_terrain_backlash"
RANGE_REACH = 1e-3  # fraction of the range within which both ends are reached


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), N)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(x):
    return np.asarray(x, dtype=np.float64).reshape(len(x), -1)


# ------------------------------------------------------------------ checks
def _mean_std_se(x):
    """Per column: mean, std and their standard errors."""
    n = len(x)
    m = x.mean(0)
    v = x.var(0)
    m4 = ((x - m) ** 4).mean(0)
    se_m = np.sqrt(v / n)
    se_s = np.sqrt(np.maximum(m4 - v * v, 0.0) / (4.0 * np.maximum(v, 1e-300) * n))
    return m, np.sqrt(v), se_m, se_s


def assert_moments_agree(name, port, ref, law=None):
    """Mean and std of `port` within Z standard errors of `ref`'s and, for
    `law=(mean, std)` per column, of the law's."""
    a, b = _np(port), _np(ref)
    ma, sa, sema, sesa = _mean_std_se(a)
    mb, sb, semb, sesb = _mean_std_se(b)
    tiny = 1e-12
    assert np.all(np.abs(ma - mb) <= Z * np.hypot(sema, semb) + tiny), (
        f"{name}: mean {ma} vs JAX {mb}")
    assert np.all(np.abs(sa - sb) <= Z * np.hypot(sesa, sesb) + tiny), (
        f"{name}: std {sa} vs JAX {sb}")
    if law is not None:
        lm, ls = (np.broadcast_to(np.asarray(v, np.float64), ma.shape) for v in law)
        for side, m, s, sem, ses in (("port", ma, sa, sema, sesa), ("JAX", mb, sb, semb, sesb)):
            assert np.all(np.abs(m - lm) <= Z * sem + tiny), f"{name}: {side} mean {m} vs {lm}"
            assert np.all(np.abs(s - ls) <= Z * ses + tiny), f"{name}: {side} std {s} vs {ls}"


def assert_uniform_field(name, port, ref, lo, hi, law=True):
    """Float draws of U(lo, hi) per column (lo, hi scalars or per column)."""
    a, b = _np(port), _np(ref)
    lo = np.broadcast_to(np.asarray(lo, np.float64), a.shape[1:])
    hi = np.broadcast_to(np.asarray(hi, np.float64), a.shape[1:])
    # f32 bounds: the draws are f32 arithmetic on the f32-rounded bounds
    lo32, hi32 = lo.astype(np.float32).astype(np.float64), hi.astype(np.float32).astype(np.float64)
    reach = RANGE_REACH * (hi - lo)
    for side, x in (("port", a), ("JAX", b)):
        assert np.all(x.min(0) >= lo32), f"{name}: {side} below {lo}: {x.min(0)}"
        assert np.all(x.max(0) <= hi32), f"{name}: {side} above {hi}: {x.max(0)}"
        assert np.all(x.min(0) - lo <= reach), f"{name}: {side} never near {lo}: {x.min(0)}"
        assert np.all(hi - x.max(0) <= reach), f"{name}: {side} never near {hi}: {x.max(0)}"
    assert_moments_agree(name, a, b, ((lo + hi) / 2, (hi - lo) / math.sqrt(12.0)) if law else None)


def assert_integer_field(name, port, ref, lo, hi):
    """Integer draws in [lo, hi): the support and every value's frequency."""
    assert_categorical(name, port, ref, np.arange(lo, hi))


def assert_categorical(name, port, ref, values):
    """Draws equally likely over `values`: the support and every value's
    frequency."""
    a = np.asarray(port).reshape(-1)
    b = np.asarray(ref).reshape(-1)
    for side, x in (("port", a), ("JAX", b)):
        assert np.array_equal(np.unique(x), values), f"{name}: {side} support {np.unique(x)}"
    p = 1.0 / len(values)
    fa = (a[:, None] == values).mean(0)
    fb = (b[:, None] == values).mean(0)
    se = lambda f, n: np.sqrt(f * (1 - f) / n)
    assert np.all(np.abs(fa - fb) <= Z * np.hypot(se(fa, len(a)), se(fb, len(b)))), (
        f"{name}: frequencies {fa} vs JAX {fb}")
    for side, f, n in (("port", fa, len(a)), ("JAX", fb, len(b))):
        assert np.all(np.abs(f - p) <= Z * np.sqrt(p * (1 - p) / n)), f"{name}: {side} {f} vs {p}"


def assert_zero_share(name, port, ref, p=0.1):
    a = (_np(port) == 0).all(1)
    b = (_np(ref) == 0).all(1)
    fa, fb = a.mean(), b.mean()
    assert abs(fa - fb) <= Z * math.hypot(math.sqrt(fa * (1 - fa) / len(a)),
                                          math.sqrt(fb * (1 - fb) / len(b))), (
        f"{name}: zero share {fa} vs JAX {fb}")
    for side, f, n in (("port", fa, len(a)), ("JAX", fb, len(b))):
        assert abs(f - p) <= Z * math.sqrt(p * (1 - p) / n), f"{name}: {side} zero share {f}"


def assert_commands(name, port, ref, ranges):
    """(N, 7) commands: zero with probability 0.1, else U(range) per dim
    (the locomotion dims of `ranges` None: always zero)."""
    a, b = _np(port), _np(ref)
    assert a.shape == b.shape == (N, 7), name
    assert_zero_share(name, a, b)
    for i, r in enumerate(ranges):
        if r is None:
            assert not a[:, i].any() and not b[:, i].any(), f"{name}[{i}] not zero"
            continue
        # the mixture: 0.9 U(lo, hi) + 0.1 delta(0)
        assert_uniform_field(f"{name}[{i}]", a[:, i], b[:, i], r[0], r[1], law=False)
        nz = ~(a == 0).all(1), ~(b == 0).all(1)
        lo, hi = r
        assert_moments_agree(f"{name}[{i}] | nonzero", a[nz[0], i], b[nz[1], i],
                             ((lo + hi) / 2, (hi - lo) / math.sqrt(12.0)))


def assert_obs_noise(name, port, ref):
    for f in dataclasses.fields(port):
        assert_uniform_field(f"{name}.{f.name}", getattr(port, f.name), getattr(ref, f.name),
                             -1.0, 1.0)


# ------------------------------------------------------------------- envs
@pytest.fixture(scope="module")
def envs():
    return {
        "joystick": (JJoystick(task=TASK, dtype=jnp.float32), Joystick(task=TASK, device="cpu")),
        "rsi": (JJoystick(task=TASK, config_overrides={"rsi_prob": 0.5}, dtype=jnp.float32),
                Joystick(task=TASK, config_overrides={"rsi_prob": 0.5}, device="cpu")),
        "standing": (JStanding(task="flat_terrain", dtype=jnp.float32),
                     Standing(task="flat_terrain", device="cpu")),
    }


def _joystick_ranges(cfg):
    return [cfg.lin_vel_x, cfg.lin_vel_y, cfg.ang_vel_yaw] + head_ranges(cfg)


def case_joystick_reset(envs):
    jenv, tenv = envs["joystick"]
    port = ResetDraws.sample(_gen(1), N, tenv)
    ref = jax_reset_draws(jenv, _keys(1))
    assert port.rsi_gate is None and port.rsi_phase is None  # rsi_prob = 0: not drawn
    cfg = tenv.config
    assert_uniform_field("base_dxy", port.base_dxy, ref.base_dxy, -0.05, 0.05)
    assert_uniform_field("yaw", port.yaw, ref.yaw, -3.14, 3.14)
    assert_uniform_field("joint_scale", port.joint_scale, ref.joint_scale,
                         *cfg.reset_joint_scale_range)
    assert_uniform_field("base_vel", port.base_vel, ref.base_vel, -0.05, 0.05)
    assert_commands("command", port.command, ref.command, _joystick_ranges(cfg))
    assert_uniform_field("push_interval", port.push_interval, ref.push_interval,
                         *cfg.push_config.interval_range)
    assert_obs_noise("obs", port.obs, ref.obs)


def case_joystick_reset_rsi(envs):
    """Reference-state init: the gate U[0, 1) and the phase, an integer in
    [0, nb_steps_in_period) (joystick.py:227-231 of the JAX package)."""
    jenv, tenv = envs["rsi"]
    port = ResetDraws.sample(_gen(2), N, tenv)
    nb = jenv.gait.nb_steps_in_period
    assert nb == tenv.gait.nb_steps_in_period

    def one(rng):
        for _ in range(5):  # dxy, yaw, joint scale, base velocity, command
            rng, _k = jax.random.split(rng)
        rng, gate_key, phase_key = jax.random.split(rng, 3)
        return (jax.random.uniform(gate_key),
                jax.random.randint(phase_key, (), 0, nb, jnp.int32))

    gate, phase = jax.vmap(one)(_keys(2))
    assert_uniform_field("rsi_gate", port.rsi_gate, gate, 0.0, 1.0)
    assert_integer_field("rsi_phase", port.rsi_phase, phase, 0, nb)
    share = lambda g: float((np.asarray(g) < 0.5).mean())
    assert abs(share(port.rsi_gate) - 0.5) <= Z * math.sqrt(0.25 / N)
    assert abs(share(port.rsi_gate) - share(gate)) <= Z * math.sqrt(0.5 / N)


def case_joystick_step(envs):
    jenv, tenv = envs["joystick"]
    port = StepDraws.sample(_gen(3), N, tenv)
    ref = jax_step_draws(jenv, _keys(3))
    nc = tenv.config.noise_config
    assert_integer_field("action_delay", port.action_delay, ref.action_delay,
                         nc.action_min_delay, nc.action_max_delay)
    assert_uniform_field("push_theta", port.push_theta, ref.push_theta, 0.0, 2 * math.pi)
    assert_uniform_field("push_magnitude", port.push_magnitude, ref.push_magnitude,
                         *tenv.config.push_config.magnitude_range)
    assert_obs_noise("obs", port.obs, ref.obs)
    assert_commands("command", port.command, ref.command, _joystick_ranges(tenv.config))


def case_joystick_command(envs):
    jenv, tenv = envs["joystick"]
    port = tenv.sample_command(_gen(4), N)
    ref = jax.vmap(jenv.sample_command)(_keys(4))
    assert_commands("command", port, ref, _joystick_ranges(tenv.config))


def case_standing_command(envs):
    jenv, tenv = envs["standing"]
    port = tenv.sample_command(_gen(5), N)
    ref = jax.vmap(jenv.sample_command)(_keys(5))
    assert_commands("standing command", port, ref, [None] * 3 + head_ranges(tenv.config))


DR_BOUNDS = {
    "floor_friction": (0.5, 1.0), "frictionloss_scale": (0.9, 1.1),
    "armature_scale": (1.0, 1.05), "torso_ipos_offset": (-0.05, 0.05),
    "mass_scale": (0.9, 1.1), "torso_mass_offset": (-0.1, 0.1),
    "qpos0_offset": (-0.03, 0.03), "kp_scale": (0.9, 1.1),
}


def case_domain_randomize(envs):
    """`DRDraws.sample` on its bounds, then the randomized model of the
    port's `domain_randomize` against the JAX package's, field by field
    over every column that either side varies."""
    jenv, tenv = envs["joystick"]
    draws = TR.DRDraws.sample(_gen(6), N, tenv.model.spec)
    for name, (lo, hi) in DR_BOUNDS.items():
        x = _np(getattr(draws, name))
        assert x.min() >= np.float32(lo) and x.max() <= np.float32(hi), name
        assert_moments_agree(name, x, x, ((lo + hi) / 2, (hi - lo) / math.sqrt(12.0)))
    tm = TR.domain_randomize(tenv.model, draws)
    jm, _ = JR.domain_randomize(jenv.model, _keys(6))
    fields = ("geom_friction", "body_ipos", "dof_frictionloss", "dof_armature", "body_mass",
              "qpos0", "actuator_gainprm", "actuator_biasprm")
    varied = 0
    for name in fields:
        a, b = _np(getattr(tm, name)), _np(getattr(jm, name))
        assert a.shape == b.shape, name
        cols = (a.std(0) > 0) | (b.std(0) > 0)
        np.testing.assert_array_equal(a[0, ~cols], b[0, ~cols], err_msg=name)
        a, b = a[:, cols], b[:, cols]
        varied += int(cols.sum())
        span = b.max(0) - b.min(0)
        assert np.all(np.abs(a.min(0) - b.min(0)) <= 2 * RANGE_REACH * span), name
        assert np.all(np.abs(a.max(0) - b.max(0)) <= 2 * RANGE_REACH * span), name
        assert_moments_agree(name, a, b)
    spec = tenv.model.spec
    nf = len(spec.friction_dofs)
    # floor friction, frictionloss, armature, torso CoM, masses of the bodies
    # with mass, qpos0 of the friction dofs, kp and -kp
    nmass = int((tenv.model.body_mass > 0).sum())
    assert varied == 1 + nf + nf + 3 + nmass + nf + 2 * spec.nu


def case_ppo_action(envs):
    """The rollout's action noise (`ppo.unroll_draws`) through `sample_raw`
    against JAX `networks.sample_raw` (networks.py:121-124), one logits row
    per action dim."""
    _, tenv = envs["joystick"]
    act = tenv.action_size
    logits = torch.linspace(-1.0, 1.0, 2 * act)
    noise = ppo.unroll_draws(tenv, N, 1, _gen(7)).action_noise[0]
    port = TN.sample_raw(logits.expand(N, -1), noise)
    ref = jax.vmap(lambda k: JN.sample_raw(k, jnp.asarray(logits.numpy())))(_keys(7))
    loc, scale = (x.numpy() for x in TN.dist_params(logits))
    assert_moments_agree("raw action", port, ref, (loc, scale))
    for side, x in (("port", _np(port)), ("JAX", _np(ref))):
        z = (x - loc) / scale
        tail = (np.abs(z) > 2).mean(0)
        p = math.erfc(2 / math.sqrt(2))
        assert np.all(np.abs(tail - p) <= Z * math.sqrt(p * (1 - p) / N)), f"{side} tail {tail}"


def _sgd_config(updates):
    return dataclasses.replace(PPOConfig(), num_envs=8, batch_size=8, num_minibatches=1,
                               unroll_length=1, num_updates_per_batch=updates)


def case_ppo_entropy(envs):
    """The loss's entropy noise (`ppo.sgd_draws`) through `entropy` against
    JAX `networks.entropy` (networks.py:137-143)."""
    _, tenv = envs["joystick"]
    act = tenv.action_size
    logits = torch.linspace(-1.0, 1.0, 2 * act)
    cfg = _sgd_config(N // 8)
    noise = ppo.sgd_draws(cfg, act, _gen(8)).entropy_noise.reshape(N, act)
    assert_moments_agree("entropy noise", noise, noise, (0.0, 1.0))
    port = TN.entropy(logits.expand(N, -1), noise)
    ref = jax.vmap(lambda k: JN.entropy(k, jnp.asarray(logits.numpy())))(_keys(8))
    assert_moments_agree("entropy", port, ref)


def case_ppo_permutation(envs):
    """The minibatch shuffle (`ppo.sgd_draws` perms) against
    `jax.random.permutation` (ppo.py:357 of the JAX package): 2^16
    permutations of 8 trajectories, each value's frequency at each place
    and each ordered pair's at each two neighbouring places."""
    del envs
    n = 8
    port = ppo.sgd_draws(_sgd_config(N), 1, _gen(9)).perms.numpy()
    ref = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(_keys(9)))
    for side, x in (("port", port), ("JAX", ref)):
        assert x.shape == (N, n) and (np.sort(x, 1) == np.arange(n)).all(), side
    for place in range(n):
        assert_integer_field(f"perm[{place}]", port[:, place], ref[:, place], 0, n)
    # jointly: the ordered pair at each two neighbouring places, 56 pairs
    pairs = np.array([a * n + b for a in range(n) for b in range(n) if a != b])
    for place in range(n - 1):
        assert_categorical(f"perm[{place}:{place + 2}]", port[:, place] * n + port[:, place + 1],
                           ref[:, place] * n + ref[:, place + 1], pairs)


def case_network_init(envs):
    """Lecun-uniform kernels, zero biases (networks.py:21-34 of the JAX
    package), every layer of both production networks, pooled over seeds
    up to 2^16 weights per layer."""
    _, tenv = envs["joystick"]
    cfg = PPOConfig()
    obs = {"state": 101, "privileged_state": 212}
    act = tenv.action_size
    sizes = {"policy": (obs["state"], *cfg.policy_hidden_layer_sizes, 2 * act),
             "value": (obs["privileged_state"], *cfg.value_hidden_layer_sizes, 1)}
    fewest = min(d * e for s in sizes.values() for d, e in zip(s[:-1], s[1:]))
    seeds = -(-N // fewest)
    nets = [TN.PPONetworks.init(obs, act, cfg.policy_hidden_layer_sizes, _gen(100 + s),
                                device="cpu", value_hidden=cfg.value_hidden_layer_sizes)
            for s in range(seeds)]
    mlps = {"policy": [n.policy for n in nets], "value": [n.value_mlp for n in nets]}
    for which, sz in sizes.items():
        ref = jax.vmap(lambda k: JN.init_mlp(k, sz))(jax.random.split(jax.random.PRNGKey(10), seeds))
        for i, (din, dout) in enumerate(zip(sz[:-1], sz[1:])):
            bound = math.sqrt(3.0 / din)
            w = torch.stack([m.layers[i].weight.detach().T for m in mlps[which]])
            assert w.shape == (seeds, din, dout)
            jw = np.asarray(ref[f"hidden_{i}"]["kernel"])
            assert_uniform_field(f"{which}[{i}]", w.reshape(-1)[:, None] / bound,
                                 jw.reshape(-1)[:, None] / bound, -1.0, 1.0)
            for m in mlps[which]:
                assert not m.layers[i].bias.any()
            assert not np.asarray(ref[f"hidden_{i}"]["bias"]).any()


SAMPLERS = {f.__name__[len("case_"):]: f for f in (
    case_joystick_reset, case_joystick_reset_rsi, case_joystick_step, case_joystick_command,
    case_standing_command, case_domain_randomize, case_ppo_action, case_ppo_entropy,
    case_ppo_permutation, case_network_init)}


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sampler_matches_jax_distribution(envs, sampler):
    SAMPLERS[sampler](envs)
