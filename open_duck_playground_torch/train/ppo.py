"""PPO trainer: rollout with the normalizer's moments accumulated in the
loop, truncation-aware GAE, clipped surrogate loss, minibatched SGD, running
obs normalization, asymmetric actor-critic, periodic evaluation, checkpoint
restore and the per-eval hooks. Counterpart of
`open_duck_playground_tpu/train/ppo.py` in eager PyTorch with autograd: the
update is small matrix products and elementwise code, which the JAX package
also computes outside any hand-written kernel. The physics of every env
step (rollout and evaluation) goes through `forward.step`, on the card the
CUDA megakernel.

Random numbers are drawn up front from an explicit `torch.Generator`
(`unroll_draws`, `sgd_draws`), or injected in the same form so a test can
replay them. The evaluator has a generator of its own.

`train` keeps the JAX trainer's schedule: the same number of training steps
per eval period, an initial eval when `num_evals > 1`, and the hooks called
once per period with the period's mean metrics. It runs the hooks after the
period instead of overlapping them with the next one. `bf16_matmuls` puts
the networks' products in bf16 with f32 results (`networks.MLP`) for the
rollout's policy and the SGD steps.

Under a mesh (`parallel.mesh`) each rank steps its shard of the envs and
the update is the one-process update, up to the order of float sums: every
rank draws the global random numbers and keeps its slice, the normalizer's
moments are all-reduced, each minibatch is the global one (each rank holds
the members in its shard), and the gradients are all-reduced once per SGD
step, so parameters and Adam state stay replicated. Without a mesh no
collective runs.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from open_duck_playground_torch.envs.env_types import State
from open_duck_playground_torch.envs.randomize import DRDraws
from open_duck_playground_torch.envs.wrappers import EvalEnv, TrainingEnv
from open_duck_playground_torch.parallel.mesh import Mesh, make_mesh
from open_duck_playground_torch.train import checkpoint as CKPT
from open_duck_playground_torch.train import gae, networks as N, running_stats as RS
from open_duck_playground_torch.train.config import PPOConfig

# optax.adam defaults (eps_root = 0)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass
class TrainingState:
    """What a training step carries over. `net` and `optimizer` are updated
    in place; `normalizer` and `env_steps` are replaced."""

    net: N.PPONetworks
    optimizer: torch.optim.Adam
    normalizer: RS.RunningStats
    env_steps: int = 0


@dataclass(frozen=True)
class UnrollDraws:
    """The random numbers of one rollout of L = k * unroll_length steps."""

    action_noise: torch.Tensor  # (L, num_envs, action_size) standard normal
    env: Sequence  # L step draws of the env


@dataclass(frozen=True)
class SGDDraws:
    """The random numbers of one training step's update."""

    perms: torch.Tensor  # (num_updates_per_batch, k * num_envs) int64, one permutation per epoch
    entropy_noise: torch.Tensor  # (num_updates_per_batch, num_minibatches, T, batch_size, action_size)


def obs_sizes(obs: Dict[str, torch.Tensor]) -> Dict[str, int]:
    return {k: int(v.shape[-1]) for k, v in obs.items()}


def make_optimizer(net: N.PPONetworks, learning_rate: float) -> torch.optim.Adam:
    """Adam as `optax.adam(learning_rate)`: the same update up to rounding
    (torch divides sqrt(nu) by sqrt(1 - b2^t) where optax takes
    sqrt(nu / (1 - b2^t))), one fused pass over all tensors on the card."""
    return torch.optim.Adam(net.parameters(), lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
                            foreach=True)


def init_training_state(obs: Dict[str, torch.Tensor], action_size: int, cfg: PPOConfig,
                        generator: torch.Generator, device="cuda") -> TrainingState:
    sizes = obs_sizes(obs)
    net = N.PPONetworks.init(sizes, action_size, cfg.policy_hidden_layer_sizes, generator,
                             device=device, policy_obs_key=cfg.policy_obs_key,
                             value_hidden=cfg.value_hidden_layer_sizes,
                             value_obs_key=cfg.value_obs_key,
                             matmul_dtype=torch.bfloat16 if cfg.bf16_matmuls else None)
    return TrainingState(net=net, optimizer=make_optimizer(net, cfg.learning_rate),
                         normalizer=RS.init(sizes, device=device))


def host_copy(ts: TrainingState) -> TrainingState:
    """A copy of `ts` on the CPU that later training steps cannot change
    (the live network and Adam state are updated in place)."""
    net = copy.deepcopy(ts.net).to("cpu")
    optimizer = make_optimizer(net, ts.optimizer.param_groups[0]["lr"])
    optimizer.load_state_dict(CKPT.to_host(ts.optimizer.state_dict()))
    normalizer = RS.RunningStats(**{f: CKPT.to_host(getattr(ts.normalizer, f))
                                    for f in ("count", "mean", "summed_var", "std")})
    return TrainingState(net=net, optimizer=optimizer, normalizer=normalizer,
                         env_steps=ts.env_steps)


def make_policy(variables, deterministic: bool = False):
    """The policy of `variables` = (normalizer, net): `policy(obs, noise)`
    returns (action, extras). Deterministic: tanh of the mean, no extras.
    Else a sample from standard-normal `noise` (batch, action_size), with
    its `raw_action` and `log_prob`. Counterpart of what JAX's
    `make_policy_factory(net)` returns; here the variables hold the
    network itself."""
    normalizer, net = variables

    def policy(obs: Dict[str, torch.Tensor], noise: Optional[torch.Tensor] = None):
        with torch.no_grad():
            logits = net.policy_logits(RS.normalize(normalizer, obs))
            if deterministic:
                return N.deterministic_action(logits), {}
            raw = N.sample_raw(logits, noise)
            return N.postprocess(raw), {"raw_action": raw, "log_prob": N.log_prob(logits, raw)}

    return policy


# ---------------------------------------------------------------- rollout
def unroll_draws(env, num_envs: int, length: int, generator: torch.Generator) -> UnrollDraws:
    """`env` is the TrainingEnv (or a bare env when actions are not
    repeated): its `step_draws` gives what one of its steps takes."""
    noise = torch.randn((length, num_envs, env.action_size), generator=generator,
                        device=generator.device)
    return UnrollDraws(action_noise=noise,
                       env=[env.step_draws(generator, num_envs) for _ in range(length)])


def generate_unroll(train_env: TrainingEnv, net: N.PPONetworks, normalizer: RS.RunningStats,
                    env_state: State, draws: UnrollDraws, accumulate: bool = True):
    """One policy-in-the-loop env step per draw. Returns (env_state, data,
    final_obs, moments): data leaves are time-major (length, num_envs, ...),
    final_obs is the obs after the last step (the GAE bootstrap needs no
    other next-obs), moments are the normalizer's sums about its old mean,
    accumulated here while each obs is at hand."""
    moments = RS.zero_moments(normalizer)
    steps: List[dict] = []
    with torch.no_grad():
        for noise, env_draws in zip(draws.action_noise, draws.env):
            obs = env_state.obs
            logits = net.policy_logits(RS.normalize(normalizer, obs))
            raw = N.sample_raw(logits, noise)
            env_state = train_env.step(env_state, N.postprocess(raw), env_draws)
            if accumulate:
                moments = RS.accumulate_moments(normalizer, moments, obs)
            steps.append({
                "obs": obs,
                "raw_action": raw,
                "log_prob": N.log_prob(logits, raw),
                "reward": env_state.reward,
                "done": env_state.done,
                "truncation": env_state.info["truncation"],
            })
    data = {k: torch.stack([s[k] for s in steps]) for k in steps[0] if k != "obs"}
    data["obs"] = {k: torch.stack([s["obs"][k] for s in steps]) for k in steps[0]["obs"]}
    return env_state, data, env_state.obs, moments


# ------------------------------------------------------------------- loss
def _absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x|, 0 for a rank that holds no member of the minibatch."""
    return x.abs().amax() if x.numel() else x.new_zeros(())


def loss_fn(net: N.PPONetworks, normalizer: RS.RunningStats, data: dict,
            final_obs: Dict[str, torch.Tensor], entropy_noise: torch.Tensor, cfg: PPOConfig,
            mesh: Optional[Mesh] = None, debug_loss_metrics: bool = False):
    """Clipped-surrogate PPO loss of one minibatch. `data` leaves are
    time-major (T, MB, ...) as the rollout left them, `final_obs` leaves
    (MB, ...) give the bootstrap value. Returns (total, metrics, maxima):
    `metrics` the loss terms (and `debug_loss_metrics`' mean entropy
    `ent`), `maxima` the other 11 diagnostics of `debug_loss_metrics`, all
    abs-max values (empty without it). The JAX trainer's names.

    Under a mesh, `data` holds this rank's members of a minibatch of
    `cfg.batch_size` trajectories (maybe none): advantages are normalized
    with the whole minibatch's all-reduced mean, then variance about it (the
    no-mesh path's two passes, so that one rank rounds as no mesh does), and
    each term is the local sum over the minibatch's count, so the SUM over
    ranks of `metrics` and of the gradients is the minibatch's, and the MAX
    over ranks of `maxima`."""
    norm_obs = RS.normalize(normalizer, data["obs"])
    logits = net.policy_logits(norm_obs)
    baseline = net.value(norm_obs)
    bootstrap = net.value(RS.normalize(normalizer, final_obs))

    rewards = data["reward"] * cfg.reward_scaling
    truncation = data["truncation"]
    termination = data["done"] * (1 - truncation)

    target_lp = N.log_prob(logits, data["raw_action"])
    behaviour_lp = data["log_prob"]

    vs, advantages = gae.compute_gae(
        truncation=truncation, termination=termination, rewards=rewards, values=baseline,
        bootstrap_value=bootstrap, lambda_=cfg.gae_lambda, discount=cfg.discounting)
    if mesh is None:
        mean = torch.mean
    else:
        count = float(cfg.unroll_length * cfg.batch_size)
        mean = lambda x: x.sum() / count
    if cfg.normalize_advantage:
        if mesh is None:
            # population std, as jnp.std
            advantages = (advantages - advantages.mean()) / (advantages.std(unbiased=False) + 1e-8)
        else:
            (mu,) = mesh.all_reduce([mean(advantages)])
            (var,) = mesh.all_reduce([mean((advantages - mu) ** 2)])
            advantages = (advantages - mu) / (torch.sqrt(var) + 1e-8)
    rho = torch.exp(target_lp - behaviour_lp)
    surrogate = rho * advantages
    clipped = torch.clamp(rho, 1 - cfg.clipping_epsilon, 1 + cfg.clipping_epsilon) * advantages
    policy_loss = -mean(torch.minimum(surrogate, clipped))

    v_error = vs - baseline
    v_loss = mean(v_error * v_error) * 0.5 * 0.5

    ent = mean(N.entropy(logits, entropy_noise))
    entropy_loss = -cfg.entropy_cost * ent

    total = policy_loss + v_loss + entropy_loss
    metrics = {"total_loss": total, "policy_loss": policy_loss, "v_loss": v_loss,
               "entropy_loss": entropy_loss}
    maxima = {}
    if debug_loss_metrics:
        metrics["ent"] = ent
        maxima = dict(
            obs_absmax=_absmax(data["obs"]["state"]),
            pobs_absmax=_absmax(data["obs"]["privileged_state"]),
            normobs_absmax=_absmax(norm_obs["state"]),
            pnormobs_absmax=_absmax(norm_obs["privileged_state"]),
            baseline_absmax=_absmax(baseline),
            bootstrap_absmax=_absmax(bootstrap),
            vs_absmax=_absmax(vs),
            adv_absmax=_absmax(advantages),
            rho_max=_absmax(rho),  # rho > 0
            lp_absmax=_absmax(target_lp),
            blp_absmax=_absmax(behaviour_lp),
        )
    return total, metrics, maxima


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm), in
    one fused pass on the card."""
    return torch.nn.utils.get_total_norm(tensors, norm_type=2.0)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, norm: torch.Tensor) -> None:
    """In place, as optax.clip_by_global_norm: untouched below max_norm,
    else scaled by max_norm / norm. No epsilon, unlike clip_grad_norm_."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)


def apply_gradients(ts: TrainingState, max_grad_norm: Optional[float]) -> Dict[str, torch.Tensor]:
    """One optimizer step from the gradients in `.grad`: global-norm clip,
    then Adam. Returns the norms before the step."""
    params = [p for p in ts.net.parameters() if p.grad is not None]
    with torch.no_grad():
        grads = [p.grad for p in params]
        grad_norm = global_norm(grads)
        params_norm = global_norm(params)
        if max_grad_norm is not None:
            clip_by_global_norm(grads, max_grad_norm, grad_norm)
    ts.optimizer.step()
    return {"grad_norm": grad_norm, "params_norm": params_norm}


def all_reduce_grads(net: N.PPONetworks, mesh: Mesh) -> None:
    """Every parameter's `.grad` summed over the ranks, in one collective."""
    params = list(net.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    for p, g in zip(params, mesh.all_reduce(grads)):
        p.grad = g


def minibatch(data: dict, final_obs: Dict[str, torch.Tensor], envs: torch.Tensor):
    """The trajectories `envs` of the time-major rollout: a gather on the
    env axis, so the payload is never transposed or stored permuted."""
    take = lambda x: x.index_select(1, envs)
    mb = {k: take(v) for k, v in data.items() if k != "obs"}
    mb["obs"] = {k: take(v) for k, v in data["obs"].items()}
    return mb, {k: v.index_select(0, envs) for k, v in final_obs.items()}


def to_segments(data: dict, final_obs: Dict[str, torch.Tensor], k: int, T: int):
    """k > 1: split the (k*T, E, ...) rollout into k unroll segments per env
    and treat them as k*E trajectories of length T. Segment j's bootstrap
    obs is the obs at the first step of segment j+1; the last segment uses
    the obs after the rollout."""

    def seg(x):  # (k*T, E, ...) -> (T, k*E, ...)
        E = x.shape[1]
        x = x.reshape((k, T) + x.shape[1:]).transpose(0, 1)
        return x.reshape((T, k * E) + x.shape[3:])

    fin = {
        key: torch.cat([data["obs"][key][T::T][: k - 1], f[None]], 0).reshape((-1,) + f.shape[1:])
        for key, f in final_obs.items()
    }
    out = {key: seg(v) for key, v in data.items() if key != "obs"}
    out["obs"] = {key: seg(v) for key, v in data["obs"].items()}
    return out, fin


def sgd_draws(cfg: PPOConfig, action_size: int, generator: torch.Generator) -> SGDDraws:
    dev = generator.device
    ntraj = cfg.k_unrolls * cfg.num_envs
    perms = torch.stack([torch.randperm(ntraj, generator=generator, device=dev)
                         for _ in range(cfg.num_updates_per_batch)])
    noise = torch.randn((cfg.num_updates_per_batch, cfg.num_minibatches, cfg.unroll_length,
                         cfg.batch_size, action_size), generator=generator, device=dev)
    return SGDDraws(perms=perms, entropy_noise=noise)


def shard_minibatches(perms: torch.Tensor, cfg: PPOConfig, mesh: Mesh):
    """Per epoch and minibatch, the members of global minibatch i
    (perm[i*B:(i+1)*B]) whose env lies in this rank's shard, as (their
    positions in the minibatch, their local trajectory indices): trajectory
    j*E + e, segment j of env e, is local trajectory j*E_local + e - the
    shard's first env. A rank may hold no member of a minibatch. One copy
    to the host and one back per training step."""
    E, B, nmb = cfg.num_envs, cfg.batch_size, cfg.num_minibatches
    sl = mesh.env_slice(E)
    p = perms.cpu().reshape(perms.shape[0], nmb, B)
    seg, env = p // E, p % E
    mine = (env >= sl.start) & (env < sl.stop)
    local = seg * (sl.stop - sl.start) + env - sl.start
    both = torch.stack([mine.nonzero()[:, 2], local[mine]]).to(perms.device)
    chunks = both.split(mine.sum(-1).flatten().tolist(), dim=1)
    return [[(c[0], c[1]) for c in chunks[u * nmb : (u + 1) * nmb]] for u in range(perms.shape[0])]


def training_step(ts: TrainingState, train_env: TrainingEnv, env, env_state: State,
                  cfg: PPOConfig, generator: Optional[torch.Generator],
                  unroll: Optional[UnrollDraws] = None, sgd: Optional[SGDDraws] = None,
                  phase_hook: Optional[Callable[[str], None]] = None, mesh: Optional[Mesh] = None,
                  debug_loss_metrics: bool = False):
    """One PPO training step: rollout of k * unroll_length steps, normalizer
    update, then num_updates_per_batch epochs of num_minibatches SGD steps.
    The random numbers come from `generator` unless `unroll` and `sgd` give
    them; under a `mesh` they are the global draws, of which each rank keeps
    its slice, and `env_state` is this rank's shard. Returns (ts, env_state,
    metrics); the metrics are 0-d tensors (means over the SGD steps, and the
    rollout's mean reward), the same on every rank. `phase_hook` is called
    with "rollout" and "update" as each phase ends (a caller that times them
    synchronizes there)."""
    k, T = cfg.k_unrolls, cfg.unroll_length
    if unroll is None:
        unroll = unroll_draws(train_env, cfg.num_envs, k * T, generator)
    if mesh is not None:
        sl = mesh.env_slice(cfg.num_envs)
        unroll = UnrollDraws(action_noise=unroll.action_noise[:, sl],
                             env=mesh.shard(unroll.env, cfg.num_envs))
    env_state, data, final_obs, moments = generate_unroll(
        train_env, ts.net, ts.normalizer, env_state, unroll, accumulate=cfg.normalize_observations)
    frames = float(k * cfg.num_envs * T)
    if mesh is None:
        reward_mean = data["reward"].mean()
    else:
        t1, t2 = moments
        keys = list(t1)
        reduced = mesh.all_reduce([t1[key] for key in keys] + [t2[key] for key in keys]
                                  + [data["reward"].sum(dtype=torch.float64) / frames])
        moments = dict(zip(keys, reduced)), dict(zip(keys, reduced[len(keys):]))
        reward_mean = reduced[-1].float()
    if cfg.normalize_observations:
        ts.normalizer = RS.merge_moments(ts.normalizer, frames, *moments)
    if k > 1:
        data, final_obs = to_segments(data, final_obs, k, T)
    if phase_hook is not None:
        phase_hook("rollout")

    if sgd is None:
        sgd = sgd_draws(cfg, env.action_size, generator)
    members = None if mesh is None else shard_minibatches(sgd.perms, cfg, mesh)
    # per SGD step: the loss terms (under a mesh, local parts that SUM over
    # the ranks), the diagnostics' maxima (MAX over the ranks), and the norms
    # (after the gradient all-reduce, the same on every rank)
    collected: List[Dict[str, List[torch.Tensor]]] = [{}, {}, {}]
    for u, (perm, epoch_noise) in enumerate(zip(sgd.perms, sgd.entropy_noise)):
        for i in range(cfg.num_minibatches):
            if members is None:
                envs, noise = perm[i * cfg.batch_size : (i + 1) * cfg.batch_size], epoch_noise[i]
            else:
                pos, envs = members[u][i]
                noise = epoch_noise[i].index_select(1, pos)
            mb, mb_final = minibatch(data, final_obs, envs)
            ts.optimizer.zero_grad(set_to_none=True)
            total, metrics, maxima = loss_fn(ts.net, ts.normalizer, mb, mb_final, noise, cfg, mesh,
                                             debug_loss_metrics)
            total.backward()
            if mesh is not None:
                all_reduce_grads(ts.net, mesh)
            norms = apply_gradients(ts, cfg.max_grad_norm)
            for part, values in zip(collected, (metrics, maxima, norms)):
                for name, v in values.items():
                    part.setdefault(name, []).append(v.detach())
    stacked = [{name: torch.stack(v) for name, v in part.items()} for part in collected]
    if mesh is not None:
        for part, op in zip(stacked[:2], ("sum", "max")):
            if part:
                names = list(part)
                part.update(zip(names, mesh.all_reduce([part[n] for n in names], op)))
    out = {name: v.mean() for part in stacked for name, v in part.items()}
    out["reward_mean"] = reward_mean
    ts.env_steps += cfg.steps_per_training_step
    if phase_hook is not None:
        phase_hook("update")
    return ts, env_state, out


# ------------------------------------------------------------------- eval
@dataclass(frozen=True)
class EvalDraws:
    """The random numbers of one evaluation of `length` control steps."""

    reset: Any  # the env's reset draws
    action_noise: Optional[torch.Tensor]  # (length, num_envs, action_size); None when deterministic
    env: Sequence  # length step draws of the eval env


def run_eval(eval_env: EvalEnv, variables, num_envs: int, length: int, deterministic: bool,
             generator: Optional[torch.Generator], draws: Optional[EvalDraws] = None
             ) -> Dict[str, float]:
    """`num_envs` fresh episodes of `length` control steps under the policy
    of `variables`, with `generator`'s random numbers unless `draws` gives
    them. Returns the mean and std episode reward, the mean length, the
    tracking errors as per-step means and every other env metric as an
    episode sum (ppo.py:423-455 of the JAX package)."""
    policy = make_policy(variables, deterministic)
    act = eval_env.action_size
    with torch.no_grad():
        state = eval_env.reset(eval_env.env.reset_draws(generator, num_envs) if draws is None
                               else draws.reset)
        for t in range(length):
            if draws is None:
                noise = None if deterministic else torch.randn(
                    (num_envs, act), generator=generator, device=generator.device)
                step_draws = eval_env.step_draws(generator, num_envs)
            else:
                noise = None if deterministic else draws.action_noise[t]
                step_draws = draws.env[t]
            action, _ = policy(state.obs, noise)
            state = eval_env.step(state, action, step_draws)
        em = state.info["eval_metrics"]
        out = {
            "eval/episode_reward": em["episode_reward"].mean(),
            "eval/episode_reward_std": em["episode_reward"].std(unbiased=False),
            "eval/avg_episode_length": em["episode_length"].mean(),
        }
        ep_len = torch.clamp(em["episode_length"], min=1.0)
        for k, v in em["episode_metrics"].items():
            if k.startswith("tracking_err/"):
                out["eval/" + k] = (v / ep_len).mean()
            else:
                out["eval/episode_" + k] = v.mean()
    return {k: float(v) for k, v in out.items()}


# --------------------------------------------------------------- schedule
def schedule(num_timesteps: int, num_evals: int, steps_per_training_step: int,
             max_env_steps_per_jit: Optional[int]):
    """(n_chunks, chunk_steps): training steps per eval period in the JAX
    trainer's arithmetic (ppo.py:460-474), which splits a period into equal
    jitted chunks of at most `max_env_steps_per_jit` env steps. Here a chunk
    is only a count; a period is n_chunks * chunk_steps training steps."""
    num_evals_after_init = max(num_evals - 1, 1)
    steps_per_epoch = int(math.ceil(num_timesteps / (num_evals_after_init * steps_per_training_step)))
    if max_env_steps_per_jit is None:
        n_chunks = 1
    else:
        max_ts = max(1, int(max_env_steps_per_jit) // steps_per_training_step)
        n_chunks = max(1, int(math.ceil(steps_per_epoch / max_ts)))
    return n_chunks, int(math.ceil(steps_per_epoch / n_chunks))


# ------------------------------------------------------------------ train
def train(environment, num_timesteps: Optional[int] = None, config: Optional[PPOConfig] = None,
          device="cuda", randomization_fn: Optional[Callable] = None,
          progress_fn: Callable[[int, dict], None] = lambda *a: None,
          eval_env=None, policy_params_fn: Callable = lambda *a, **k: None,
          restore_checkpoint_path: Optional[str] = None, mesh: Optional[Mesh] = None,
          max_env_steps_per_jit: Optional[int] = 8_192_000, debug_loss_metrics: bool = False,
          **overrides):
    """Train `environment` for `num_timesteps` env steps. `overrides`
    replace fields of `config`. Per eval period (and once before training
    when `num_evals > 1`): `progress_fn(env_steps, metrics)` with the
    period's mean `training/...` metrics, `training/sps` and, when there is
    an evaluator, the `eval/...` metrics; then
    `policy_params_fn(env_steps, make_policy, variables,
    full_state=(training_state, generator_state))`, both on host copies
    taken before the next period starts. Returns (make_policy,
    (normalizer, net), metrics).

    `randomization_fn(model, DRDraws) -> model` (the port's
    `envs.randomize.domain_randomize`) trains on per-env randomized models;
    None, the default, on the nominal model, as the JAX trainer.
    `debug_loss_metrics` adds the JAX trainer's 12 diagnostics to the loss
    metrics. `mesh=None` is one process unless `torch.distributed` is
    initialized, and then the world group on `device` (`make_mesh`): every
    rank trains its shard of `num_envs`, runs the evaluator and calls the
    hooks, and all ranks hold the same parameters throughout."""
    cfg = dataclasses.replace(config or PPOConfig(), **overrides)
    num_timesteps = cfg.num_timesteps if num_timesteps is None else num_timesteps
    cfg.k_unrolls  # raises on a broken rollout contract
    if mesh is None and dist.is_available() and dist.is_initialized():
        mesh = make_mesh(device)
    local = (lambda tree: tree) if mesh is None else (lambda tree: mesh.shard(tree, cfg.num_envs))

    dev = torch.device(device) if mesh is None else mesh.device
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    dr = None
    if randomization_fn is not None and environment.model is not None:
        dr = local(DRDraws.sample(gen, cfg.num_envs, environment.model.spec))
    train_env = TrainingEnv(environment, cfg.episode_length, dr_draws=dr, action_repeat=cfg.action_repeat,
                            randomization_fn=randomization_fn if dr is not None else None)
    env_state = train_env.reset(local(environment.reset_draws(gen, cfg.num_envs)))
    ts = init_training_state(env_state.obs, environment.action_size, cfg, gen, device=dev)
    if restore_checkpoint_path is not None:
        ts, gen_state = CKPT.restore_training_state(restore_checkpoint_path, ts)
        if gen_state is not None:
            gen.set_state(gen_state)

    evaluator = None
    if cfg.num_evals > 1 or eval_env is not None:
        # the nominal model: no domain randomization, as in the reference
        ev_env = EvalEnv(eval_env or environment, cfg.episode_length,
                         action_repeat=cfg.action_repeat)
        eval_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1000)
        evaluator = lambda variables: run_eval(
            ev_env, variables, cfg.num_eval_envs, cfg.episode_length // cfg.action_repeat,
            cfg.deterministic_eval, eval_gen)

    def hooks(step: int, metrics: dict) -> None:
        host = host_copy(ts)
        variables = (host.normalizer, host.net)
        if evaluator is not None:
            metrics = {**metrics, **evaluator((ts.normalizer, ts.net))}
        progress_fn(step, metrics)
        policy_params_fn(step, make_policy, variables, full_state=(host, gen.get_state()))

    n_chunks, chunk_steps = schedule(num_timesteps, cfg.num_evals, cfg.steps_per_training_step,
                                     max_env_steps_per_jit)
    all_metrics: Dict[str, float] = {}
    if cfg.num_evals > 1:
        hooks(ts.env_steps, {})
    while ts.env_steps < num_timesteps:
        t0 = time.monotonic()
        collected: Dict[str, List[torch.Tensor]] = {}
        for _ in range(n_chunks * chunk_steps):
            ts, env_state, metrics = training_step(ts, train_env, environment, env_state, cfg, gen,
                                                   mesh=mesh, debug_loss_metrics=debug_loss_metrics)
            for k, v in metrics.items():
                collected.setdefault(k, []).append(v)
        all_metrics = {f"training/{k}": float(torch.stack(v).mean()) for k, v in collected.items()}
        all_metrics["training/sps"] = (n_chunks * chunk_steps * cfg.steps_per_training_step
                                       / (time.monotonic() - t0))
        hooks(ts.env_steps, all_metrics)
    return make_policy, (ts.normalizer, ts.net), all_metrics
