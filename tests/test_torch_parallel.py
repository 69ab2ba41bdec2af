"""Data parallelism of the port (`parallel/mesh.py`, `ppo.train(mesh=...)`)
on the CPU with gloo.

- `dryrun_multigpu(2)`: two processes, each training its half of the envs
  for two full PPO steps (Joystick on flat_terrain_backlash, plain engine,
  per-env domain randomization), against one process on the same seed, for
  k_unrolls 1 and 2: parameters, normalizer and loss within rtol 2e-4,
  atol 2e-5 (tests/test_multihost.py's tolerance), every rank holding the
  same values bit for bit. Measured on the CPU, the worst entry uses
  0.25% (k 1) and 3.4% (k 2) of that tolerance.
- A one-rank gloo mesh gives the no-mesh run: the same update through the
  mesh's code path (sums over the global count, all-reduces that are
  identities), within 1e-6.
- Each rank takes exactly its members of every global minibatch, a rank
  may hold none, and the env axis does not shard unevenly.
- A `cuda` mesh without NCCL raises; it does not fall back to gloo.
- The CLI under torchrun's environment (WORLD_SIZE 2) trains data parallel
  and only rank 0 writes.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from open_duck_playground_torch.parallel import dryrun as D
from open_duck_playground_torch.parallel import mesh as M
from open_duck_playground_torch.train import ppo
from open_duck_playground_torch.train.config import PPOConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("k_unrolls", [1, 2])
def test_dryrun_two_processes_match_one(k_unrolls):
    report = D.dryrun_multigpu(2, k_unrolls=(k_unrolls,), device="cpu")
    assert report[k_unrolls]["worst_margin"] < 1, report


def test_world_one_gloo_mesh_equals_no_mesh():
    want = D.run(2, device="cpu")
    dist.init_process_group(M.backend_for("cpu"), init_method=f"tcp://127.0.0.1:{D.free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = M.make_mesh("cpu")
        assert (mesh.world_size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
        got = D.run(2, mesh)
        implicit = D.run(2, device="cpu")  # mesh=None with the group initialized: the world group
    finally:
        dist.destroy_process_group()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(implicit[key], got[key], err_msg=key)


@pytest.mark.parametrize("world", [2, 3])
def test_each_rank_takes_its_members_of_every_minibatch(world):
    """k = 2 over 12 envs: trajectory j*12 + e is segment j of env e; each
    member of a global minibatch goes to the rank of its env, at its local
    index j*E_local + e - first env, and keeps its position (the row of its
    entropy noise)."""
    cfg = PPOConfig(num_envs=12, batch_size=4, num_minibatches=6, num_updates_per_batch=2)
    assert cfg.k_unrolls == 2
    perms = torch.stack([torch.randperm(24, generator=torch.Generator().manual_seed(s)) for s in (0, 1)])
    local_envs = 12 // world
    seen = {}
    counts = []
    for rank in range(world):
        members = ppo.shard_minibatches(perms, cfg, M.Mesh(world, rank, torch.device("cpu")))
        assert len(members) == 2 and all(len(m) == 6 for m in members)
        for u, row in enumerate(members):
            for i, (pos, local) in enumerate(row):
                counts.append(len(pos))
                assert bool((local >= 0).all() and (local < 2 * local_envs).all())  # only its own shard
                for p, l in zip(pos.tolist(), local.tolist()):
                    g = int(perms[u, i * 4 + p])
                    seg, env = divmod(g, 12)
                    assert env // local_envs == rank and l == seg * local_envs + env - rank * local_envs
                    seen[(u, i, p)] = rank
    assert len(seen) == 2 * 24  # every member of every minibatch, on exactly one rank
    assert 0 in counts  # some rank holds no member of some minibatch
    with pytest.raises(ValueError):
        M.Mesh(5, 0, torch.device("cpu")).env_slice(12)


def test_uneven_shard_raises():
    """num_envs % world must be 0, as the JAX trainer asserts."""
    with pytest.raises(ValueError, match="do not shard"):
        D.run(1, M.Mesh(3, 0, torch.device("cpu")))


def test_cuda_mesh_without_nccl_raises(monkeypatch):
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        M.make_mesh("cuda")
    with pytest.raises(RuntimeError, match="NCCL"):
        M.initialize_multihost("127.0.0.1:1", 2, 0, "cuda")
    M.initialize_multihost(num_processes=1)  # one process: nothing to do
    assert not dist.is_initialized()


_CLI = """
import sys, torch
torch.set_num_threads(1)
from open_duck_playground_torch.cli import runner
argv = ["--task", "flat_terrain_backlash", "-o", sys.argv[1], "--num_timesteps", "64"]
for pair in ["num_envs=8", "batch_size=4", "num_minibatches=2", "unroll_length=4", "num_updates_per_batch=1",
             "episode_length=6", "num_eval_envs=4", "num_evals=2",
             "network_factory={'policy_hidden_layer_sizes': (8,), 'value_hidden_layer_sizes': (8,)}"]:
    argv += ["--config_override", pair]
_, (normalizer, net), _ = runner.main(argv, device="cpu")
torch.save([p.detach() for p in net.parameters()], sys.argv[2])
import os
assert not torch.distributed.is_initialized()  # main destroys the group it started
print("RANK_DONE", os.environ["RANK"], os.environ["WORLD_SIZE"])
"""


def test_cli_trains_under_torchrun_env(tmp_path):
    """Two processes with torchrun's variables (WORLD_SIZE 2, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) run `cli.runner.main` on the CPU:
    a gloo group, the same parameters on both ranks, checkpoints and .onnx
    files written by rank 0 alone, and the group destroyed on return."""
    port = str(D.free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CLI, str(tmp_path / f"out{rank}"), str(tmp_path / f"params{rank}.pt")],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_DONE {rank} 2" in out, out
    assert "STEP: 64 reward:" in outs[0] and "STEP:" not in outs[1]
    written = sorted(x.name for x in (tmp_path / "out0").iterdir())
    assert len([n for n in written if n.endswith(".onnx")]) == 2 and not (tmp_path / "out1").exists()
    a, b = (torch.load(tmp_path / f"params{r}.pt") for r in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
