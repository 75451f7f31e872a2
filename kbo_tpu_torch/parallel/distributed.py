"""Multi-process glue (counterpart of kbo_tpu/parallel/distributed.py).

Several processes join with :func:`initialize_from_env`: the global mesh
(kbo_tpu_torch.parallel.mesh) is every process's local devices, in rank
order, and each process runs its own shards. Two kinds of value cross
processes, both over the gloo group:

- host results: :func:`gather_to_host` fills in the other processes'
  shards of a sharded value with one :func:`process_allgather`;
- device tensors: the mesh's collectives (``all_gather``, ``psum``,
  ``pmax``) combine this process's shards on its first device, then meet
  the other processes through :func:`all_gather` and :func:`all_reduce`.
  gloo moves host memory, so a CUDA tensor is copied to the host, reduced
  or gathered there, and copied back to its device: the transport of a
  gloo group, while the compute stays on the card.

Every call counts the bytes it receives from the other processes and the
wall time it takes in the run's stats (``dist_bytes``; ``dist_calls`` and
``dist_s`` from the ``dist`` stage). Every process must make the same calls
in the same order, with the same shapes.

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

from kbo_tpu_torch.utils.stats import get_stats, stage


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


def require_group(n_processes: int | None = None) -> None:
    """Raise unless a process group (of ``n_processes``, when given) is
    initialized: a mesh that spans processes never computes a one-process
    answer."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a collective across processes needs their process group: call "
            "kbo_tpu_torch.parallel.distributed.initialize_from_env() in "
            "every process first"
        )
    if n_processes is not None and dist.get_world_size() != n_processes:
        raise RuntimeError(
            f"a mesh over {n_processes} processes in a process group of "
            f"{dist.get_world_size()}"
        )


def _host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy gloo can carry (bool as uint8)."""
    x = x.detach().contiguous().cpu()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's block ``x`` (the same shape and dtype in each),
    concatenated along ``dim`` in rank order, on ``x``'s device."""
    require_group()
    n = process_count()
    with stage("dist"):
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h)
        get_stats().add("dist_bytes", (n - 1) * h.numel() * h.element_size())
        out = torch.cat(parts, dim=dim).to(x.dtype).to(x.device)
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """The elementwise ``op`` (``"sum"`` or ``"max"``) of every process's
    ``x`` (the same shape and dtype in each), on ``x``'s device. A bool
    tensor reduces as uint8: its max is the OR."""
    require_group()
    n = process_count()
    with stage("dist"):
        h = _host(x)
        if h.data_ptr() == x.data_ptr():
            h = h.clone()  # never reduce into the caller's tensor
        dist.all_reduce(h, op=_OPS[op])
        get_stats().add("dist_bytes", (n - 1) * h.numel() * h.element_size())
        out = h.to(x.dtype).to(x.device)
    return out


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` (same shape and dtype in each), stacked in
    process order: [process_count, *arr.shape]. One gloo ``all_gather``;
    a single process gets ``arr[None]``."""
    arr = np.ascontiguousarray(arr)
    if process_count() == 1:
        return arr[None]
    return all_gather(torch.from_numpy(arr)[None]).numpy()


def gather_to_host(mesh, parts, local=None) -> np.ndarray:
    """A sharded value on the host of every process: the per-shard tensors
    ``parts`` (one per shard of ``mesh``, None for another process's
    shards) fetched and concatenated along axis 0 in shard order. ``local``
    names the indices of ``parts`` this process holds when they are not
    its shards (a 2-D mesh's data rows: a contiguous run in rank order).

    Fetches follow the launches: call this after every shard's work is
    queued, so that the cards run side by side. Across processes the
    local blocks meet in one :func:`process_allgather`."""
    local = np.concatenate([parts[i].cpu().numpy()
                            for i in (mesh.local_shards if local is None
                                      else local)])
    if mesh.process_count == 1:
        return local
    require_group(mesh.process_count)
    return np.concatenate(list(process_allgather(local)))
