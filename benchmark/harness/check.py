"""What decides `correct`: the reference (`benchmark/reference`) follows
the port from the port's own states and judges what the timed path
produced.

The 1-iteration Newton solve is discontinuous, so two f32 implementations
part on a few envs in a thousand over one control step's 10 substeps, and
no trajectory of either can be followed for long by the other. So every
control step is taken from the port's state before it: the reference steps
that state with the port's action and the same draws, and its state after
the step is compared with the port's. The checked steps go through the
reference together, in blocks of rows (a row is an env at a step), since
the plain engine is bound by its launches, not its rows. The physics, the
task and the wrappers are held by the per-env gaps of a row (qpos, qvel,
the observations, reward and done), pooled over every checked row and read
at the mix's `gap_quantile` (0.99: the rows of the few envs at an edge of
the solve stay under its 1%, and a fault on 1% of the rows or more, such as
one control step in twenty gone wrong, or one block of 8 envs of the
eval's 128, decides it). The policy is held by its action from the port's
observation with the port's noise, in every env. The start, which this
skips, is held by itself: the reference resets from the same draws and the
port's first state is compared with it, its per-env gaps read as the
steps' are.

In training the reference follows the whole of each checked training step
from the benchmark's weights, its own parameters and Adam state after the
steps before: the normalizer merged from every env's observations, then
every SGD step of every epoch on the port's permutations and entropy
noise, over every env's rollout data: the port's observations, rewards,
dones and truncations (each judged as above on the sample, step by step)
with the raw actions and log-probabilities the reference works out itself
from the port's observations and noise, with the parameters and normalizer
that the port's step before returned (the benchmark's at the first).
So an edge of the solve, which moves a reward or a done of one env, does
not reach the update's numbers, and these read the update's arithmetic
alone: per training step the mean loss and the mean gradient norm over
its SGD steps (what `training_step` returns), against the reference's, and
each leaf's change from the start after each step, by the worst leaf
against that leaf's change or the median leaf's, whichever is larger. A
minibatch or an epoch left out, or half of each minibatch, moves the
change. Leaves whose first reference gradient is under a thousandth of the
median leaf's are left out of the change: Adam moves them by round-off
alone.

A candidate is the port (what the recorders kept) or, for the calibration
of the limits, the reference itself in another precision (the control) or
with a fault planted (`benchmark/calibrate.py`)."""

from __future__ import annotations

import contextlib
import types
from typing import Dict, List, Optional

import torch

from benchmark.harness import inputs, trees
from benchmark.reference.envs import wrappers as RW
from benchmark.reference.train import ppo as RP, running_stats as RS

ENV_FIELDS = ("qpos", "qvel", "obs", "reward")


@contextlib.contextmanager
def precision(name: str):
    """float32 products in true f32 (`f32`) or in TF32 (`tf32`, the
    control) while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def env_out(state) -> types.SimpleNamespace:
    """What is compared of a state after a control step."""
    em = state.info.get("eval_metrics")
    return types.SimpleNamespace(qpos=state.data.qpos, qvel=state.data.qvel, obs=dict(state.obs),
                                 reward=state.reward, done=state.done,
                                 episode_reward=None if em is None else em["episode_reward"])


def _maxabs(a: torch.Tensor, b: torch.Tensor, dev) -> torch.Tensor:
    """(B,) max |a - b| over all but the env axis, in f64."""
    d = (a.detach().to(dev, torch.float64) - b.detach().to(dev, torch.float64)).abs()
    return d.reshape(d.shape[0], -1).amax(1) if d.dim() > 1 else d


def env_gaps(cand, ref, dev) -> Dict[str, torch.Tensor]:
    """Per-env gaps of one control step's outputs."""
    obs = torch.stack([_maxabs(cand.obs[k], ref.obs[k], dev) for k in ref.obs]).amax(0)
    reward = _maxabs(cand.reward, ref.reward, dev) + _maxabs(cand.done, ref.done, dev)
    if ref.episode_reward is not None:
        reward = reward + _maxabs(cand.episode_reward, ref.episode_reward, dev)
    return {"qpos": _maxabs(cand.qpos, ref.qpos, dev), "qvel": _maxabs(cand.qvel, ref.qvel, dev),
            "obs": obs, "reward": reward}


def pooled_gaps(cand_outs, ref_outs, dev) -> Dict[str, torch.Tensor]:
    """Each field's per-env gaps of every row (env at a control step)."""
    gaps = [env_gaps(c, r, dev) for c, r in zip(cand_outs, ref_outs)]
    return {f: torch.cat([g[f] for g in gaps]) for f in ENV_FIELDS}


def quantile(x: torch.Tensor, q: float) -> float:
    return float(torch.quantile(x.double().cpu(), q))


def _env_numbers(cand_outs, ref_outs, q: float, dev) -> Dict[str, float]:
    return {f: quantile(g, q) for f, g in pooled_gaps(cand_outs, ref_outs, dev).items()}


def _reset_gaps(cand_obs, ref_obs, dev) -> torch.Tensor:
    """Per-env gaps of the reset's observations."""
    return torch.stack([_maxabs(cand_obs[k], ref_obs[k], dev) for k in ref_obs]).amax(0)


def _worst_leaf(cand: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor = None) -> float:
    if keep is not None:
        cand, ref = cand[keep], ref[keep]
    scale = torch.maximum(ref, ref.median())
    return float(((cand - ref).abs() / scale).max())


def _leaf_norms(leaves) -> torch.Tensor:
    return torch.stack([x.detach().double().cpu().norm() for x in leaves])


def draws_gap(given, replayed) -> float:
    """max |a - b| over the leaves of two draws (0: the same numbers)."""
    a, b = list(trees.tensors(given)), list(trees.tensors(replayed))
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        return float("inf")
    return max([float((x.double() - y.double().to(x.device)).abs().max()) for x, y in zip(a, b) if x.numel()]
               + [0.0])


# ------------------------------------------------------------------ train
def train_reference(rec, config: dict, traffic: dict, device, prec: str = "f32", fault: Optional[str] = None):
    """The reference's outputs for the recorded training steps (see the
    module's docstring). `fault` plants one in the reference, for the
    calibration: `half_batch` (each SGD step's loss a mean over half of its
    minibatch) or `skip_minibatches` (every other minibatch of each epoch
    left out)."""
    dev = torch.device(device)
    cfg = inputs.ppo_config(config)
    pkey, vkey = cfg.policy_obs_key, cfg.value_obs_key
    block = traffic["reference_block_steps"]
    envs = rec.envs.to(dev)
    with precision(prec):
        env = inputs.reference_env(config, dev)
        classes = inputs.reference_classes()
        dr = None if rec.dr is None else trees.to(rec.dr, dev)
        reset = inputs.reference_training_env(env, config, dr).reset(trees.to(rec.reset, dev, classes))
        out = types.SimpleNamespace(reset_obs=dict(reset.obs), steps=[], moved=None)
        leaves = [p.to(dev) for p in rec.params0]
        adam = RP.Adam(leaves, cfg.learning_rate, cfg.max_grad_norm)
        norm = RS.init(rec.obs_sizes, device=dev)
        prev, acting, acting_norm = rec.state0, rec.params0, norm
        for st in rec.steps:
            T = len(st.states)
            states_in, prev = [prev] + st.states[:-1], st.states[-1]
            outs = []
            with torch.no_grad():
                # the env step of the sampled envs, `block` control steps of
                # rows at once, each row from the port's state of its env and
                # step on that env's randomized model
                for a in range(0, T, block):
                    ts = range(a, min(a + block, T))
                    tenv = inputs.reference_training_env(env, config, None if dr is None else trees.cat([dr] * len(ts)))
                    s_in = trees.to(trees.cat([states_in[t] for t in ts]), dev, classes)
                    act = torch.cat([st.actions[t].to(dev).index_select(0, envs) for t in ts])
                    d = trees.to(trees.cat([trees.rows(st.draws[t], envs.cpu()) for t in ts]), dev, classes)
                    outs += [env_out(x) for x in trees.split(tenv.step(s_in, act, d), len(ts))]
                # the policy at every env's observation with the port's noise,
                # from the parameters and normalizer the port's step before
                # returned, then the normalizer merged from them
                obs = {k: torch.stack([o[k] for o in st.obs[:T]]).to(dev) for k in rec.obs_sizes}
                params = RP.Params([p.to(dev) for p in acting], rec.n_policy)
                action, raw, lp = RP.policy_step(params, trees.to(acting_norm, dev, classes), obs, st.noise.to(dev),
                                                 pkey)
                acting, acting_norm = st.params, st.normalizer
                moments = RS.zero_moments(norm)
                for t in range(T):
                    moments = RS.accumulate_moments(norm, moments, {k: v[t] for k, v in obs.items()})
                norm = RS.merge_moments(norm, float(T * action.shape[1]), *moments)
            data = {"obs": obs, "raw_action": raw, "log_prob": lp,
                    "reward": torch.stack(st.reward).to(dev), "done": torch.stack(st.done).to(dev),
                    "truncation": torch.stack(st.truncation).to(dev)}
            final = {k: st.obs[T][k].to(dev) for k in rec.obs_sizes}
            B = cfg.batch_size
            losses, gnorms = [], []
            for e, perm in enumerate(st.perms.to(dev)):
                for i in range(cfg.num_minibatches):
                    if fault == "skip_minibatches" and i % 2:
                        continue
                    idx = perm[i * B : (i + 1) * B]
                    if fault == "half_batch":
                        idx = idx[: B // 2]
                    take = lambda x: x.index_select(1, idx)
                    mb = {k: ({kk: take(vv) for kk, vv in v.items()} if isinstance(v, dict) else take(v))
                          for k, v in data.items()}
                    mb_final = {k: v.index_select(0, idx) for k, v in final.items()}
                    noise = st.entropy_noise[e, i].to(dev)[:, : idx.shape[0]]
                    req = [x.detach().requires_grad_(True) for x in leaves]
                    loss = RP.loss(RP.Params(req, rec.n_policy), norm, mb, mb_final, noise, cfg, pkey, vkey)
                    grads = torch.autograd.grad(loss, req)
                    if out.moved is None:
                        g = _leaf_norms(grads)
                        out.moved = g >= 1e-3 * g.median()
                    gnorms.append(RP.global_norm(grads).detach())
                    leaves = adam.step([x.detach() for x in leaves], adam.clip(grads))
                    losses.append(loss.detach())
            losses = torch.stack(losses).double()
            out.steps.append(types.SimpleNamespace(
                env=outs, actions=action, loss=float(losses.mean()), loss_scale=float(losses.abs().mean()),
                grad_norm=float(torch.stack(gnorms).double().mean()), params=[x.detach() for x in leaves]))
    return out


def program_outputs(rec) -> types.SimpleNamespace:
    """What the port's timed path produced in the recorded training steps."""
    steps = [types.SimpleNamespace(env=[env_out(s) for s in st.states], actions=torch.stack(st.actions),
                                   loss=st.metrics["total_loss"], grad_norm=st.metrics["grad_norm"],
                                   params=st.params)
             for st in rec.steps]
    return types.SimpleNamespace(reset_obs=rec.state0.obs, steps=steps)


def train_numbers(cand, ref, rec, traffic: dict) -> Dict[str, float]:
    dev = ref.steps[0].actions.device
    out = {"reset_obs": quantile(_reset_gaps(cand.reset_obs, ref.reset_obs, dev), traffic["gap_quantile"]),
           **_env_numbers([o for s in cand.steps for o in s.env], [o for s in ref.steps for o in s.env],
                          traffic["gap_quantile"], dev)}
    out["action"] = max(float(_maxabs(c.actions, r.actions, dev).max()) for c, r in zip(cand.steps, ref.steps))
    out["loss"] = max(abs(c.loss - r.loss) / r.loss_scale for c, r in zip(cand.steps, ref.steps))
    out["grad_norm"] = max(abs(c.grad_norm - r.grad_norm) / r.grad_norm for c, r in zip(cand.steps, ref.steps))
    p0 = [p.double().cpu() for p in rec.params0]
    change = lambda after: torch.stack([(a.detach().double().cpu() - b).norm() for a, b in zip(after, p0)])
    out["param_change"] = max(_worst_leaf(change(c.params), change(r.params), ref.moved)
                              for c, r in zip(cand.steps, ref.steps))
    out["draws"] = max(draws_gap(d, e) for st in rec.steps for d, e in zip(st.draws, st.replayed))
    return out


# ------------------------------------------------------------------- eval
def eval_reference(records: List, config: dict, params0: RP.Params, normalizer0, deterministic: bool,
                   device, prec: str = "f32", per_step: bool = False):
    """Per eval record: the reference's reset, and at each kept step its
    action from the port's observation with the port's noise and its state
    after the port's state and action. The kept steps of an eval go
    through as one batch of rows; `per_step` runs each at the eval's own
    shape (`num_eval_envs` rows), as the control does: cuBLAS takes its TF32
    paths for the engine's small products at that shape, and not at the
    batched one."""
    dev = torch.device(device)
    cfg = inputs.ppo_config(config)
    with precision(prec), torch.no_grad():
        env = inputs.reference_env(config, dev)
        classes = inputs.reference_classes()
        eenv = RW.EvalEnv(env, cfg.episode_length, action_repeat=cfg.action_repeat)
        params = RP.Params([p.to(dev) for p in params0.leaves], params0.n_policy)
        outs = []
        for rec in records:
            kept = sorted(rec.steps)
            steps = []
            for group in ([[t] for t in kept] if per_step else [kept]):
                # each row from the port's state of its env and step
                s_in = trees.to(trees.cat([rec.steps[t].state for t in group]), dev, classes)
                if deterministic:
                    logits = RP.mlp(RS.normalize(normalizer0, s_in.obs)[cfg.policy_obs_key], params.policy)
                    a = torch.tanh(RP.dist_params(logits)[0])
                else:
                    noise = torch.cat([rec.steps[t].noise for t in group]).to(dev)
                    a = RP.policy_step(params, normalizer0, s_in.obs, noise, cfg.policy_obs_key)[0]
                s_out = eenv.step(s_in, torch.cat([rec.steps[t].action for t in group]).to(dev),
                                  trees.to(trees.cat([rec.steps[t].draws for t in group]), dev, classes))
                steps += [types.SimpleNamespace(env=env_out(s), action=x) for s, x in
                          zip(trees.split(s_out, len(group)), a.chunk(len(group)))]
            reset = eenv.reset(trees.to(rec.reset_draws, dev, classes))
            outs.append(types.SimpleNamespace(reset_obs=dict(reset.obs), steps=steps))
    return outs


def eval_program_outputs(records: List) -> List:
    return [types.SimpleNamespace(reset_obs=rec.reset_state.obs,
                                  steps=[types.SimpleNamespace(env=env_out(rec.steps[t].out), action=rec.steps[t].action)
                                         for t in sorted(rec.steps)])
            for rec in records]


def eval_numbers(cands: List, refs: List, records: List, traffic: dict) -> Dict[str, float]:
    dev = refs[0].steps[0].action.device
    out = {"reset_obs": quantile(torch.cat([_reset_gaps(c.reset_obs, r.reset_obs, dev) for c, r in zip(cands, refs)]),
                                 traffic["gap_quantile"])}
    out.update(_env_numbers([s.env for c in cands for s in c.steps], [s.env for r in refs for s in r.steps],
                            traffic["gap_quantile"], dev))
    out["action"] = max(float(_maxabs(a.action, b.action, dev).max()) for c, r in zip(cands, refs)
                        for a, b in zip(c.steps, r.steps))
    out["draws"] = max(rec.draws_gap for rec in records)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """Each number that has a limit, beside it; a number that is not
    finite fails."""
    return {name: {"value": numbers[name], "limit": lim["limit"],
                   "ok": numbers[name] == numbers[name] and numbers[name] <= lim["limit"]}
            for name, lim in limits.items()}
