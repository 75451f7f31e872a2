"""Multi-process glue (counterpart of kbo_tpu/parallel/distributed.py).

A mesh (kbo_tpu_torch.parallel.mesh) is driven by one process. Several
processes join with :func:`initialize_from_env`: the global mesh is every
process's local devices, in rank order, each process runs its own shards,
and :func:`gather_to_host` fills in the other processes' shards with one
gloo ``all_gather`` of host results. What crosses processes is what the
mesh paths fetch to the host anyway.

Typical multi-process entry (torchrun sets the environment):

    from kbo_tpu_torch.parallel import distributed, mesh
    distributed.initialize_from_env()          # no-op single-process
    m = mesh.make_mesh()                       # every process's cards
    out = mesh.matches_batch_sharded(index, queries, threshold, mesh=m)
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize_from_env() -> bool:
    """Join a gloo process group when the environment asks for one.

    Reads torchrun's contract: ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT``. Without ``WORLD_SIZE`` this does nothing: nothing
    is detected otherwise. Safe to call twice. Returns True when the run
    has more than one process.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    addr = os.environ["MASTER_ADDR"]
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}:{port}", world_size=world,
        rank=int(os.environ["RANK"]),
    )
    return world > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` (same shape and dtype in each), stacked in
    process order: [process_count, *arr.shape]. One gloo ``all_gather``;
    a single process gets ``arr[None]``."""
    arr = np.ascontiguousarray(arr)
    if process_count() == 1:
        return arr[None]
    t = torch.from_numpy(arr)
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return np.stack([p.numpy() for p in parts])


def gather_to_host(mesh, parts) -> np.ndarray:
    """A sharded value on the host of every process: the per-shard tensors
    ``parts`` (one per shard of ``mesh``, None for another process's
    shards) fetched and concatenated along axis 0 in shard order.

    Fetches follow the launches: call this after every shard's work is
    queued, so that the cards run side by side. Across processes the
    local blocks meet in one :func:`process_allgather`."""
    local = np.concatenate([parts[i].cpu().numpy() for i in mesh.local_shards])
    if mesh.process_count == 1:
        return local
    return np.concatenate(list(process_allgather(local)))
