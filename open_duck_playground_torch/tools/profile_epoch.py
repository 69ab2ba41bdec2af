"""Timing of one PPO SGD epoch at the production shapes, with ablation
variants.

    python -m open_duck_playground_torch.tools.profile_epoch \\
        [--num-envs 8192] [--warmup 1] [--reps 8] [--variants NAME ...] \\
        [--config_override KEY=VALUE ...]

One module for the JAX package's three epoch profilers, which time the same
epoch with overlapping ablations (`tools/profile_epoch.py`,
`tools/profile_epoch_timemajor.py`, `tools/profile_sgd_variants.py`). Every
variant runs the trainer's own functions (`ppo.minibatch`, `ppo.loss_fn`,
`ppo.apply_gradients`, `gae.compute_gae`) on the synthetic payload of the
JAX tools: time-major (T, B, ...) rollout data of standard-normal
observations (101 / 212 features), raw actions, log-probs and rewards, no
done or truncation. Variants, with the JAX labels they answer:

  production        the trainer's epoch: per minibatch an index gather on
                    the env axis of the time-major payload (`ppo.minibatch`).
                    JAX: "production epoch (gather, unroll=1)"
                    (profile_sgd_variants), and "C: deferred per-mb axis1
                    gather" (profile_epoch_timemajor), which is this path.
  no_shuffle        contiguous minibatches. JAX: "epoch: NO shuffle".
  transpose_gather  the payload transposed to (B, T, ...), gathered by the
                    permutation, cut into minibatches and each transposed
                    back. JAX: "epoch: shuffle + 32 minibatches
                    (production)" of profile_epoch.py:147-159.
  permute_slice     the whole payload gathered once along the env axis,
                    then each minibatch a contiguous slice. JAX: "B:
                    transpose-free (axis1 perm + slice)".
  gae_once          GAE's 20-step loop taken out of the SGD steps:
                    advantages and value targets computed once before the
                    epoch from its starting parameters, each minibatch
                    gathering its share. A different function: it reads
                    what the loop's launches cost inside each SGD step,
                    the question of JAX's "epoch: shuffle + unrolled GAE".
  tf32              the production epoch with TF32 products (the trainer
                    keeps TF32 off). JAX: "matmul precision=tensorfloat32".
  bf16              the production epoch with `bf16_matmuls`' products.
                    JAX: "matmul precision=bfloat16".
  graph_1/4/32      k = 1, 4 or 32 minibatch steps captured in one
                    `torch.cuda.CUDAGraph` and replayed: the torch meaning
                    of JAX's minibatch-scan unroll (`mb_unroll` 1/2/4/8,
                    "A: production epoch, mb_unroll=u"): more work per
                    dispatch. Its own `torch.optim.Adam(capturable=True)`,
                    static permutation, noise and gradients
                    (`zero_grad(set_to_none=False)`), warmed up on a side
                    stream, then put back to the epoch's starting state
                    before capture. The card only: on the CPU it raises.

`SAME_FUNCTION` says which variants compute the production epoch's
function (the same draws give the same parameters, up to the order of
float sums and, for the graph variants, the capturable Adam's arithmetic)
and which a different one. Each variant runs one epoch from the same state
and draws, and its parameters' relative distance from production's is in
the record (`rel_diff`: max |a - b| over every parameter over max |b|;
`rel_diff_worst_tensor`: the same ratio tensor by tensor, its largest).
The capturable Adam rounds otherwise than the trainer's, and Adam turns a
rounding-sized gradient into a step of the learning rate's size, so a
graph variant's own check is against the same epoch run eagerly with its
optimizer (`rel_diff_from_eager_capturable_adam`); then
`--warmup` untimed and `--reps` timed epochs (CUDA events on the card).
On the CPU the default variants leave out the graph ones.

Prints a text line per variant, then one JSON record.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json

import torch

from open_duck_playground_torch.tools import benchutil
from open_duck_playground_torch.train import gae, ppo
from open_duck_playground_torch.train import running_stats as RS

OBS_SIZES = {"state": 101, "privileged_state": 212}  # the JAX tools' payload
ACTION_SIZE = 14
GRAPH_KS = (1, 4, 32)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def payload(cfg, gen: torch.Generator, obs_sizes=OBS_SIZES, action_size: int = ACTION_SIZE):
    """(data, final_obs) of the JAX tools' synthetic rollout: data leaves
    time-major (T, B, ...) with B = k * num_envs trajectories."""
    T, B, dev = cfg.unroll_length, cfg.k_unrolls * cfg.num_envs, gen.device
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    data = {"obs": {k: normal(T, B, n) for k, n in obs_sizes.items()},
            "raw_action": 0.1 * normal(T, B, action_size), "log_prob": normal(T, B),
            "reward": normal(T, B), "done": torch.zeros((T, B), device=dev),
            "truncation": torch.zeros((T, B), device=dev)}
    return data, {k: normal(B, n) for k, n in obs_sizes.items()}


def clone_state(ts: ppo.TrainingState) -> ppo.TrainingState:
    """A copy of the network and Adam's state that later steps of either
    leave alone (the normalizer is replaced, never changed in place)."""
    net = copy.deepcopy(ts.net)
    opt = ppo.make_optimizer(net, ts.optimizer.param_groups[0]["lr"])
    opt.load_state_dict(copy.deepcopy(ts.optimizer.state_dict()))
    return ppo.TrainingState(net=net, optimizer=opt, normalizer=ts.normalizer, env_steps=ts.env_steps)


def sgd_step(ts: ppo.TrainingState, cfg, gather, noise: torch.Tensor, mark=benchutil.no_marks,
             set_to_none: bool = True):
    """One SGD step of `ppo.training_step`'s loop (no mesh): `gather()`
    gives the minibatch (time-major data, final obs), then the trainer's
    loss, backward, global-norm clip and Adam. Sections for a trace:
    shuffle, forward_gae, backward, clip_adam. Returns (loss metrics,
    norms)."""
    with mark("shuffle"):
        mb, mb_final = gather()
    with mark("forward_gae"):
        ts.optimizer.zero_grad(set_to_none=set_to_none)
        total, metrics, _ = ppo.loss_fn(ts.net, ts.normalizer, mb, mb_final, noise, cfg)
    with mark("backward"):
        total.backward()
    with mark("clip_adam"):
        norms = ppo.apply_gradients(ts, cfg.max_grad_norm)
    return metrics, norms


def members(perm: torch.Tensor, cfg, i: int) -> torch.Tensor:
    return perm[i * cfg.batch_size : (i + 1) * cfg.batch_size]


# Each maker takes (ts, cfg, data, final_obs) and returns epoch(perm, noise),
# which runs one epoch on ts in place; noise is (num_minibatches, T,
# batch_size, action_size).

def production(ts, cfg, data, final_obs):
    def epoch(perm, noise):
        for i in range(cfg.num_minibatches):
            envs = members(perm, cfg, i)
            sgd_step(ts, cfg, lambda: ppo.minibatch(data, final_obs, envs), noise[i])

    return epoch


def no_shuffle(ts, cfg, data, final_obs):
    ordered = production(ts, cfg, data, final_obs)
    return lambda perm, noise: ordered(torch.arange(perm.numel(), device=perm.device), noise)


def transpose_gather(ts, cfg, data, final_obs):
    nmb, B = cfg.num_minibatches, cfg.batch_size

    def epoch(perm, noise):
        cut = lambda x: x.index_select(0, perm).reshape((nmb, B) + x.shape[1:])
        shuffled = tree_map(lambda x: cut(x.transpose(0, 1)), data)
        shuffled_final = tree_map(cut, final_obs)
        for i in range(nmb):
            sgd_step(ts, cfg, lambda: (tree_map(lambda x: x[i].transpose(0, 1), shuffled),
                                       tree_map(lambda x: x[i], shuffled_final)), noise[i])

    return epoch


def permute_slice(ts, cfg, data, final_obs):
    B = cfg.batch_size

    def epoch(perm, noise):
        pdata = tree_map(lambda x: x.index_select(1, perm), data)
        pfinal = tree_map(lambda x: x.index_select(0, perm), final_obs)
        for i in range(cfg.num_minibatches):
            sgd_step(ts, cfg, lambda: (tree_map(lambda x: x[:, i * B : (i + 1) * B], pdata),
                                       tree_map(lambda x: x[i * B : (i + 1) * B], pfinal)), noise[i])

    return epoch


@contextlib.contextmanager
def _replaced(module, name, value):
    original = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, original)


def gae_once(ts, cfg, data, final_obs):
    def epoch(perm, noise):
        with torch.no_grad():
            values = ts.net.value(RS.normalize(ts.normalizer, data["obs"]))
            bootstrap = ts.net.value(RS.normalize(ts.normalizer, final_obs))
            truncation = data["truncation"]
            vs, adv = gae.compute_gae(truncation=truncation, termination=data["done"] * (1 - truncation),
                                      rewards=data["reward"] * cfg.reward_scaling, values=values,
                                      bootstrap_value=bootstrap, lambda_=cfg.gae_lambda,
                                      discount=cfg.discounting)
        for i in range(cfg.num_minibatches):
            envs = members(perm, cfg, i)
            precomputed = lambda **_: (vs.index_select(1, envs), adv.index_select(1, envs))
            with _replaced(gae, "compute_gae", precomputed):
                sgd_step(ts, cfg, lambda: ppo.minibatch(data, final_obs, envs), noise[i])

    return epoch


def tf32(ts, cfg, data, final_obs):
    inner = production(ts, cfg, data, final_obs)

    def epoch(perm, noise):
        with _replaced(torch.backends.cuda.matmul, "allow_tf32", True):
            inner(perm, noise)

    return epoch


def bf16(ts, cfg, data, final_obs):
    for mlp in (ts.net.policy, ts.net.value_mlp):
        mlp.matmul_dtype = torch.bfloat16
    return production(ts, cfg, data, final_obs)


def with_capturable_adam(ts: ppo.TrainingState) -> ppo.TrainingState:
    """`ts`'s network with a fresh `torch.optim.Adam(capturable=True)` of
    the trainer's hyperparameters: its step count is a tensor on the card
    and its update reads no host value, so a CUDA graph can hold it. Its
    arithmetic differs from the trainer's Adam in rounding only."""
    opt = torch.optim.Adam(list(ts.net.parameters()), lr=ts.optimizer.param_groups[0]["lr"],
                           betas=ppo.ADAM_BETAS, eps=ppo.ADAM_EPS, foreach=True, capturable=True)
    return ppo.TrainingState(net=ts.net, optimizer=opt, normalizer=ts.normalizer, env_steps=ts.env_steps)


def graph(k: int):
    """The maker of the variant that replays k minibatch steps per CUDA
    graph launch."""

    def make(ts, cfg, data, final_obs):
        params = list(ts.net.parameters())
        dev = params[0].device
        if dev.type != "cuda":
            raise RuntimeError("a CUDA graph runs on the card only")
        if cfg.num_minibatches % k:
            raise ValueError(f"{cfg.num_minibatches} minibatches are not whole groups of {k}")
        start = ts.optimizer.state_dict()["state"]
        gts = with_capturable_adam(ts)
        opt = gts.optimizer
        B = cfg.batch_size
        envs = torch.arange(k * B, device=dev).reshape(k, B) % data["reward"].shape[1]
        noise = torch.zeros((k, cfg.unroll_length, B, ts.net.policy.sizes[-1] // 2), device=dev)

        def steps():
            for j in range(k):
                sgd_step(gts, cfg, lambda j=j: ppo.minibatch(data, final_obs, envs[j]), noise[j],
                         set_to_none=False)

        saved = [p.detach().clone() for p in params]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):  # Adam's state and the gradients exist before capture
                steps()
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():  # back to the epoch's starting state, in place
            for i, (p, v) in enumerate(zip(params, saved)):
                p.copy_(v)
                for name, t in opt.state[p].items():
                    t.copy_(start[i][name]) if i in start else t.zero_()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            steps()

        def epoch(perm, eps_noise):
            for c in range(cfg.num_minibatches // k):
                envs.copy_(perm[c * k * B : (c + 1) * k * B].reshape(k, B))
                noise.copy_(eps_noise[c * k : (c + 1) * k])
                g.replay()

        return epoch

    return make


VARIANTS = {"production": production, "no_shuffle": no_shuffle, "transpose_gather": transpose_gather,
            "permute_slice": permute_slice, "gae_once": gae_once, "tf32": tf32, "bf16": bf16,
            **{f"graph_{k}": graph(k) for k in GRAPH_KS}}
SAME_FUNCTION = {"production": True, "no_shuffle": False, "transpose_gather": True, "permute_slice": True,
                 "gae_once": False, "tf32": False, "bf16": False, **{f"graph_{k}": True for k in GRAPH_KS}}


def rel_diff(a: ppo.TrainingState, b: ppo.TrainingState) -> dict:
    """How far `a`'s parameters lie from `b`'s: `all`, max |a - b| over
    every parameter over max |b| (the parameter vector's max norm), and
    `worst_tensor`, the largest of the same ratio taken tensor by tensor
    (a bias that is still near 0 makes it large)."""
    with torch.no_grad():
        pairs = list(zip(a.net.parameters(), b.net.parameters()))
        return {"all": max(float((x - y).abs().max()) for x, y in pairs) / max(float(y.abs().max()) for _, y in pairs),
                "worst_tensor": max(float((x - y).abs().max() / y.abs().max()) for x, y in pairs)}


def profile(ts: ppo.TrainingState, cfg, data, final_obs, draws: ppo.SGDDraws, variants, warmup: int,
            reps: int, dev) -> dict:
    """Per variant: one epoch from `ts` with the first epoch's draws, its
    distance from production's, then seconds per epoch. `ts` is left as
    it was."""
    perm, noise = draws.perms[0], draws.entropy_noise[0]
    reference = clone_state(ts)
    production(reference, cfg, data, final_obs)(perm, noise)
    capturable = None
    out = {}
    for name in variants:
        state = clone_state(ts)
        epoch = VARIANTS[name](state, cfg, data, final_obs)
        epoch(perm, noise)
        diff = rel_diff(state, reference)
        row = {"same_function": SAME_FUNCTION[name], "rel_diff": diff["all"],
               "rel_diff_worst_tensor": diff["worst_tensor"]}
        if name.startswith("graph"):
            # the same epoch run eagerly with the graph's optimizer: what the
            # graph must replay exactly
            if capturable is None:
                capturable = with_capturable_adam(clone_state(ts))
                production(capturable, cfg, data, final_obs)(perm, noise)
            row["rel_diff_from_eager_capturable_adam"] = rel_diff(state, capturable)["all"]
        seconds = benchutil.seconds_per_call(lambda: epoch(perm, noise), dev, reps=reps, warmup=warmup)
        print(f"epoch: {name:18s} {1e3 * seconds:9.3f} ms/epoch   (rel diff from production "
              f"{diff['all']:.2e}, {'same' if row['same_function'] else 'a different'} function)", flush=True)
        out[name] = {"ms_per_epoch": 1e3 * seconds, **row,
                     "finite": all(bool(torch.isfinite(p).all()) for p in state.net.parameters())}
    return out


def main(argv=None, device="cuda") -> dict:
    """Run the profile; returns its JSON record. `device` is for callers on
    the CPU (tests)."""
    from open_duck_playground_torch.cli import runner
    from open_duck_playground_torch.physics import forward as F

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS), default=None)
    ap.add_argument("--config_override", action="append", default=None, metavar="KEY=VALUE",
                    help="a PPO config key of the CLI, repeatable")
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    if dev.type == "cuda":
        F.pin_f32()
    overrides = runner.parse_overrides(args.config_override) or {}
    cfg = runner.ppo_config(**{"num_envs": args.num_envs, **overrides})
    variants = args.variants or [v for v in VARIANTS if dev.type == "cuda" or not v.startswith("graph")]
    gen = torch.Generator(device=dev).manual_seed(0)
    data, final_obs = payload(cfg, gen)
    ts = ppo.init_training_state(final_obs, ACTION_SIZE, cfg, gen, device=dev)
    draws = ppo.sgd_draws(cfg, ACTION_SIZE, gen)
    record = {"tool": "profile_epoch", "envs": cfg.num_envs, "unroll_length": cfg.unroll_length,
              "num_minibatches": cfg.num_minibatches, "batch_size": cfg.batch_size, "warmup": args.warmup,
              "reps": args.reps,
              "variants": profile(ts, cfg, data, final_obs, draws, variants, args.warmup, args.reps, dev),
              "device": benchutil.device_name(dev), "card": benchutil.card(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
