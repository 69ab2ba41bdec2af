"""Data parallelism over processes, one device each: the env batch is
sharded over the ranks, parameters and normalizer are replicated, and the
trainer's few reductions are all-reduces over the process group.
Counterpart of `open_duck_playground_tpu/parallel/mesh.py`, with
`torch.distributed` in place of a JAX device mesh.

The backend follows the device: NCCL for `cuda`, gloo for `cpu`. A `cuda`
mesh without NCCL raises; it never falls back to gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device) -> str:
    """The process group backend of `device`: nccl on the card, gloo on
    the CPU. Raises where this build of torch lacks it."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda mesh needs NCCL, which this build of torch lacks")
        return "nccl"
    if kind == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("a cpu mesh needs gloo, which this build of torch lacks")
        return "gloo"
    raise ValueError(f"no process group backend for device {device!r}")


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Bring-up of a run over several processes, once per process before
    `make_mesh`: `torch.distributed.init_process_group` at
    `tcp://<coordinator_address>` (host:port of rank 0) with the backend of
    `device`; on the card the rank's device becomes the current one first,
    as NCCL requires. No-op for one process, as in the JAX package (a
    one-rank group is `torch.distributed.init_process_group` with
    `backend_for(device)` and world size 1)."""
    if num_processes is None or num_processes <= 1:
        return
    backend = backend_for(device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=timeout)


@dataclass(frozen=True)
class Mesh:
    """World size, rank, the rank's device and the process group. The env
    axis is cut into `world_size` equal shards, rank r holding shard r."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def env_slice(self, num_envs: int) -> slice:
        if num_envs % self.world_size:
            raise ValueError(f"{num_envs} envs do not shard over {self.world_size} ranks")
        n = num_envs // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def shard(self, tree, num_envs: int):
        """This rank's slice of the env axis (the leading one) of every
        tensor in `tree` (a tensor, dataclass, dict, list, tuple or None)."""
        sl = self.env_slice(num_envs)

        def take(x):
            if isinstance(x, torch.Tensor):
                return x[sl]
            if dataclasses.is_dataclass(x):
                return dataclasses.replace(x, **{f.name: take(getattr(x, f.name))
                                                 for f in dataclasses.fields(x)})
            if isinstance(x, dict):
                return {k: take(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(take(v) for v in x)
            return x

        return take(tree)

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        """The elementwise SUM or MAX of `tensors` over the ranks, in one
        collective over a flat buffer; returns new tensors of the same
        shapes."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.group)
        return [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the initialized world group on `device` (`cuda` alone
    means the current card). The group's backend must be the device's."""
    want = backend_for(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call initialize_multihost")
    group = dist.group.WORLD
    got = dist.get_backend(group)
    if got != want:
        raise RuntimeError(f"a {torch.device(device).type} mesh needs a {want} group, got {got}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world_size=dist.get_world_size(group), rank=dist.get_rank(group), device=dev, group=group)


def distributed_from_env(device) -> Tuple[object, Optional[Mesh]]:
    """(device, mesh) of a process that `torchrun` started with
    WORLD_SIZE > 1: the group over its ranks (initialized here unless it
    already is; NCCL on the card, gloo on the CPU), each rank on
    `cuda:LOCAL_RANK`. (device, None) otherwise."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device, None
    if torch.device(device).type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        initialize_multihost(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
                             int(os.environ["RANK"]), device)
    return device, make_mesh(device)
