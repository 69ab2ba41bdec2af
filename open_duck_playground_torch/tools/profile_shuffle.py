"""Microbenchmark of PPO epoch-shuffle strategies at the production shapes.

    python -m open_duck_playground_torch.tools.profile_shuffle \\
        [--num-envs 8192] [--unroll-length 20] [--num-minibatches 32] [--reps 20]

Counterpart of the JAX package's `tools/profile_shuffle.py`, on the port's
payload: the time-major (T, B, ...) rollout of `ppo.generate_unroll` with
the rollout's features (observations of 101 and 212 features, 14 raw
actions, log-prob, reward, done, truncation) and the final observations
(B, ...), standard-normal from a seeded generator. Strategies, each
timed as one untimed call then `--reps` (CUDA events on the card):

  permutation       `torch.randperm` of B, the indices alone;
  transpose         (T, B, ...) -> (B, T, ...), materialized;
  gather_axis0      a gather on axis 0 of the (B, T, ...) payload;
  gather_axis1      a gather on axis 1 of the (T, B, ...) payload;
  jax_production    JAX's production shuffle: transpose, gather, reshape
                    to (minibatches, batch, T, ...) (profile_epoch.py:147-159);
  deferred          the trainer's path: per minibatch `ppo.minibatch`, an
                    index gather on the env axis, each consumed by a sum;
  reduce_floor      a sum over the whole payload, the floor: it reads
                    every byte once and moves nothing;
  onehot_bf16       the permutation as a product with a one-hot bf16 matrix
                    on the tensor cores. JAX took one bf16 product, which
                    rounds the payload; here each f32 value is split into
                    three bf16 parts (8 + 8 + 8 mantissa bits, each exact),
                    each permuted by one product (a single nonzero term per
                    output, so exact), and summed back in f32: exact, at
                    three products.

Every strategy that permutes yields the minibatches of `ppo.minibatch` for
the same permutation, bit for bit (`minibatches`, checked in `main`: the
record's `equal_to_production`); the permutation, the transpose and the
floor yield no minibatch.

Prints a text line per strategy, then one JSON record.
"""

from __future__ import annotations

import argparse
import json

import torch

from open_duck_playground_torch.tools import benchutil
from open_duck_playground_torch.tools.profile_epoch import tree_map

OBS_SIZES = {"state": 101, "privileged_state": 212}
ACTION_SIZE = 14


def payload(gen: torch.Generator, T: int, B: int):
    """(data, final_obs) as the rollout leaves them, standard normal."""
    dev = gen.device
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    data = {"obs": {k: normal(T, B, n) for k, n in OBS_SIZES.items()}, "raw_action": normal(T, B, ACTION_SIZE),
            **{k: normal(T, B) for k in ("log_prob", "reward", "done", "truncation")}}
    return data, {k: normal(B, n) for k, n in OBS_SIZES.items()}


def flat(tree, prefix: str = "") -> dict:
    """{"obs/state": tensor, ...}: the leaves by path."""
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def same_minibatches(got, want) -> bool:
    """Bit for bit, leaf by leaf: the (data, final obs) of each minibatch."""
    pairs = [(flat(g[j]), flat(w[j])) for g, w in zip(got, want) for j in (0, 1)]
    return len(got) == len(want) and all(
        a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a) for a, b in pairs)


def _cut(tree, nmb: int, time_axis: int):
    """Per minibatch i, the time-major (T, MB, ...) tree of batch-major
    (nmb * MB, T, ...) leaves (time_axis 1) or the (MB, ...) final obs."""
    def part(x, i):
        y = x.reshape((nmb, -1) + x.shape[1:])[i]
        return y.transpose(0, 1) if time_axis else y

    return [tree_map(lambda x: part(x, i), tree) for i in range(nmb)]


# Each strategy takes (data, datab, final_obs, perm, nmb): the time-major
# payload, the same transposed to batch-major (B, T, ...) beforehand (the
# JAX tool's `datab`), the final obs, the permutation, the minibatches.

def production(data, datab, final_obs, perm, nmb: int):
    """The trainer's minibatches: `ppo.minibatch` on each slice of `perm`."""
    from open_duck_playground_torch.train import ppo

    return [ppo.minibatch(data, final_obs, envs) for envs in perm.reshape(nmb, -1)]


def gather_axis0(data, datab, final_obs, perm, nmb: int):
    shuffled = tree_map(lambda x: x.index_select(0, perm), datab)
    return list(zip(_cut(shuffled, nmb, 1), _cut(tree_map(lambda x: x.index_select(0, perm), final_obs), nmb, 0)))


def gather_axis1(data, datab, final_obs, perm, nmb: int):
    B = perm.numel() // nmb
    shuffled = tree_map(lambda x: x.index_select(1, perm), data)
    final = tree_map(lambda x: x.index_select(0, perm), final_obs)
    return [(tree_map(lambda x: x[:, i * B : (i + 1) * B], shuffled), tree_map(lambda x: x[i * B : (i + 1) * B], final))
            for i in range(nmb)]


def jax_production(data, datab, final_obs, perm, nmb: int):
    """jnp.take(jnp.swapaxes(x, 0, 1), perm, 0).reshape((nmb, MB) + ...)."""
    shuf = lambda x: x.transpose(0, 1).index_select(0, perm).reshape((nmb, -1) + x.shape[:1] + x.shape[2:])
    shuffled = tree_map(shuf, data)
    final = tree_map(lambda x: x.index_select(0, perm).reshape((nmb, -1) + x.shape[1:]), final_obs)
    return [(tree_map(lambda x: x[i].transpose(0, 1), shuffled), tree_map(lambda x: x[i], final))
            for i in range(nmb)]


def onehot_bf16(data, datab, final_obs, perm, nmb: int):
    B = perm.numel()
    onehot = (perm[:, None] == torch.arange(B, device=perm.device)[None]).to(torch.bfloat16)

    def permute(x):  # rows of axis 0
        flat = x.reshape(B, -1)
        out = torch.zeros_like(flat)
        rest = flat
        for _ in range(3):
            part = rest.to(torch.bfloat16)
            out += (onehot @ part).float()
            rest = rest - part.float()
        return out.reshape(x.shape)

    return list(zip(_cut(tree_map(permute, datab), nmb, 1), _cut(tree_map(permute, final_obs), nmb, 0)))


PERMUTING = {"gather_axis0": gather_axis0, "gather_axis1": gather_axis1, "jax_production": jax_production,
             "deferred": production, "onehot_bf16": onehot_bf16}


def main(argv=None, device="cuda") -> dict:
    """Run the benchmark; returns its JSON record. `device` is for callers
    on the CPU (tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--unroll-length", type=int, default=20)
    ap.add_argument("--num-minibatches", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = benchutil.measured_device(device)
    B, T, nmb = args.num_envs, args.unroll_length, args.num_minibatches
    gen = torch.Generator(device=dev).manual_seed(0)
    data, final_obs = payload(gen, T, B)
    leaves = lambda *trees: [x for t in trees for x in flat(t).values()]
    nbytes = sum(4 * x.numel() for x in leaves(data, final_obs))
    print(f"payload: {nbytes / 1e6:.0f} MB", flush=True)
    perm = torch.randperm(B, generator=gen, device=dev)
    datab = tree_map(lambda x: x.transpose(0, 1).contiguous(), data)
    inputs = (data, datab, final_obs, perm, nmb)
    want = production(*inputs)
    total = lambda mbs: sum(x.sum() for mb in mbs for x in leaves(*mb))
    timed = {
        "permutation": lambda: torch.randperm(B, generator=gen, device=dev),
        "transpose": lambda: tree_map(lambda x: x.transpose(0, 1).contiguous(), data),
        "gather_axis0": lambda: gather_axis0(*inputs),
        "gather_axis1": lambda: gather_axis1(*inputs),
        "jax_production": lambda: jax_production(*inputs),
        "deferred": lambda: total(production(*inputs)),
        "reduce_floor": lambda: sum(x.sum() for x in leaves(datab, final_obs)),
        "onehot_bf16": lambda: onehot_bf16(*inputs),
    }
    strategies = {}
    for name, fn in timed.items():
        ms = 1e3 * benchutil.seconds_per_call(fn, dev, reps=args.reps)
        row = {"ms": ms}
        if name in PERMUTING:
            got = PERMUTING[name](*inputs)
            row["equal_to_production"] = same_minibatches(got, want)
        print(f"{name:56s} {ms:8.3f} ms", flush=True)
        strategies[name] = row
    record = {"tool": "profile_shuffle", "envs": B, "unroll_length": T, "num_minibatches": nmb,
              "payload_bytes": nbytes, "reps": args.reps, "strategies": strategies,
              "device": benchutil.device_name(dev), "card": benchutil.card(dev)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
