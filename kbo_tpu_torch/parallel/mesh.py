"""Multi-device execution over a mesh of torch devices (counterpart of
kbo_tpu/parallel/mesh.py).

kbo_tpu's mesh is single-controller: one process drives every device
through ``jax.shard_map``. So is this one within a process: a
:class:`Mesh` is a list of torch devices whose local ones one process
drives, and a device may repeat (four shards on one card run every sharded
path at real per-shard shapes).

- Index tables are REPLICATED, one copy per distinct device
  (:func:`index_replicas`); query batches and sequences are SHARDED over the
  ``data`` axis: a sharded value is a list of per-shard tensors, shard i on
  ``mesh.devices[i]``.
- Collectives are explicit copies onto the first local device followed by
  a torch reduction (:func:`all_gather`, :func:`psum`, :func:`pmax`); on
  one card they are device-local copies, on several peer copies.
- A stage that kbo_tpu runs replicated on every device runs once (per
  process), on the first local device, and its outputs are copied to the
  shards that read them.
- Each shard's work runs under its device (:func:`map_shards`), and every
  shard is launched before the first fetch to the host, so that cards run
  side by side.
- Per-query outputs come back in input order: fixed-shape per-shard blocks
  concatenate in shard order.

Several processes (kbo_tpu_torch.parallel.distributed) form one global mesh
of every process's local devices, stacked along the first axis in rank
order; each process runs its own shards, and every process passes the same
inputs and gets the whole result back. The collectives combine this
process's shards on its first local device, then meet the other processes
over the gloo group (``distributed.all_gather`` / ``all_reduce``); their
result lands on every process's first local device, the counterpart of a
replicated ``shard_map`` output. A stage that runs once runs once per
process there, over the gathered inputs, so every later step reads the
same values in every process and every process makes the same collectives
in the same order. A mesh over several processes without their process
group raises ``RuntimeError``.

A ``model`` axis splits the KEY TABLE instead (prefix-sharded placement,
for an index larger than one card's memory): model shard j holds a
contiguous colex range of the sorted join keys (:class:`Sharded3Index`, the
2-bit keys in :func:`matches_batch_index_sharded`), the queries are
replicated, and the per-shard partial joins meet in one :func:`pmax`; the
map's refinement reads the table through kernels.refine.ShardedKeys3
(:func:`map_batch_index_sharded`). The 2-D ``("data", "model")`` mesh does
both at once (:func:`map_batch_2d_sharded`): each row of its device grid
is a model group mapping its own block of contigs. No API entry point
takes a mesh with a ``model`` axis (in kbo_tpu neither): these functions
are called directly.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from kbo_tpu_torch import engine
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels.mapsweep import (
    _ms3_rows_chunk,
    map_sweep_compact_core,
    ms3_rows_sweep,
)
from kbo_tpu_torch.kernels.ms import (
    INVALID,
    DeviceIndex,
    device_scope,
    ms2_core,
    ms3_rows_from_packed,
    ms3_rows_partial_core,
)
from kbo_tpu_torch.kernels.postprocess import (
    derandomize_translate,
    rle_segments_global_core,
)
from kbo_tpu_torch.kernels.refine import (
    ShardedKeys3,
    get_ext_table,
    max_tag,
    resolve_variants_core,
    score_gaps_core,
    seq_keys3_tagged_core,
)
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.opts import MapOpts
from kbo_tpu_torch.parallel import distributed
from kbo_tpu_torch.parallel.distributed import gather_to_host
from kbo_tpu_torch.pipeline import (
    _bucket,
    _rle_structs_global,
    decode_packed_codes_device,
    matches_pipeline_core,
    pack_codes_host,
    pad_batch,
)
from kbo_tpu_torch.refine.device_map import (
    KeyTable,
    devref_core,
    devref_sharded_finish,
    map_devref_finish,
)
from kbo_tpu_torch.utils.stats import stage

_BIG32 = 2**31 - 1
_AXES = (("data",), ("model",), ("data", "model"))


class Mesh:
    """Devices along named axes: the one-axis ``("data",)`` or
    ``("model",)`` mesh, or the 2-D ``("data", "model")`` mesh.

    ``devices`` is a numpy object array of ``torch.device`` with one
    dimension per axis (a device may repeat), ``axis_names`` the axis
    names, ``shape`` {axis: size}, as on a ``jax.sharding.Mesh``. In a
    multi-process run the devices are every process's, in rank order, and
    ``local_shards`` are this process's (flat indices, row-major): on a 2-D
    mesh whole rows, so a model group never spans processes (ValueError
    otherwise).
    """

    def __init__(self, devices, axis_names=("data",), process_count: int = 1,
                 process_index: int = 0):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if axis_names not in _AXES:
            raise ValueError(
                f"a mesh over axes {axis_names}: the axes are one of {_AXES}"
            )
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"a mesh over axes {axis_names} takes a {len(axis_names)}-D "
                f"device array, not a {devices.ndim}-D one"
            )
        if devices.size == 0 or devices.size % process_count:
            raise ValueError(
                f"{devices.size} devices do not split over {process_count} "
                f"processes"
            )
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, map(int, devices.shape)))
        self.process_count = process_count
        per = devices.size // process_count
        if devices.ndim == 2 and per % devices.shape[1]:
            raise ValueError(
                f"a {devices.shape[0]} x {devices.shape[1]} mesh over "
                f"{process_count} processes would split a model group "
                f"across processes: each process holds whole rows"
            )
        self.local_shards = range(process_index * per,
                                  (process_index + 1) * per)

    @property
    def first_local(self) -> torch.device:
        """This process's first device: where the combined results of the
        collectives and the stages that run once land."""
        return self.devices.flat[self.local_shards[0]]


def make_mesh(n_devices=None, axis="data", device=None) -> Mesh:
    """A mesh over ``axis``: ``"data"`` (the batch splits), ``"model"`` (the
    key table splits), or ``("data", "model")`` with ``n_devices`` a pair of
    sizes (both at once: ``make_mesh((2, 4), axis=("data", "model"),
    device="cuda:0")``).

    ``device`` None or ``"cuda"``: this process's own block of the visible
    cards (:func:`local_cards`), as many as the mesh has shards (for one
    axis by default all the cards of the block); raises when that block is
    not visible, or there is no card. A single named device (``"cuda:0"``,
    ``"cpu"``): every shard on that one device (``n_devices`` required),
    in every process that names it. In a multi-process run these are this
    process's devices, and the mesh holds every process's, in rank order
    along the first axis.
    """
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if axes not in _AXES:
        raise ValueError(f"a mesh over axes {axes}: the axes are one of "
                         f"{_AXES}")
    if len(axes) == 2 and not (isinstance(n_devices, (tuple, list))
                               and len(n_devices) == 2):
        raise ValueError(f"make_mesh over {axes} needs n_devices=(data, "
                         f"model) sizes, not {n_devices}")
    grid = None if len(axes) == 1 else tuple(int(x) for x in n_devices)
    n_devices = n_devices if grid is None else grid[0] * grid[1]
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        local = local_cards(n_devices)
    else:
        if n_devices is None or n_devices < 1:
            raise ValueError(
                f"make_mesh: shards on the one device {dev} need n_devices"
            )
        local = [dev] * n_devices
    n_proc = distributed.process_count()
    if n_proc > 1:
        names = [None] * n_proc
        dist.all_gather_object(names, [str(d) for d in local])
        if len({len(part) for part in names}) != 1:
            raise ValueError(
                "make_mesh: every process must bring as many devices")
        local = [torch.device(s) for part in names for s in part]
    devices = np.empty(len(local), dtype=object)
    devices[:] = local
    if grid is not None:
        devices = devices.reshape(n_proc * grid[0], grid[1])
    return Mesh(devices, axes, n_proc, distributed.process_index())


def local_cards(n_devices=None) -> list[torch.device]:
    """This process's own cards: block ``LOCAL_RANK`` (torchrun's; 0 when
    unset) of n visible cards, ``cuda:LOCAL_RANK*n`` to
    ``cuda:(LOCAL_RANK+1)*n - 1``. n is ``n_devices``, by default the
    visible cards over ``LOCAL_WORLD_SIZE`` (1 when unset). Raises when the
    block is not visible, so that no process takes another's card unless
    it names it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device; make_mesh(n, device='cpu') puts "
            "n shards on the CPU"
        )
    count = torch.cuda.device_count()
    rank = int(os.environ.get("LOCAL_RANK", 0))
    n = (count // int(os.environ.get("LOCAL_WORLD_SIZE", 1))
         if n_devices is None else n_devices)
    if n < 1 or (rank + 1) * n > count:
        raise ValueError(
            f"make_mesh: local rank {rank} takes cards {rank * n} to "
            f"{(rank + 1) * n - 1}, {count} visible; name a device "
            f"(device='cuda:0') to share one"
        )
    return [torch.device("cuda", rank * n + i) for i in range(n)]


# ------------------------------------------------------------- placement


def map_shards(mesh: Mesh, fn, *per_shard):
    """``fn(a[i], b[i], ...)`` for every local shard i, under its device:
    a list per shard (None for another process's shards). Launches only:
    fetch after every shard is queued."""
    out = [None] * mesh.devices.size
    for i in mesh.local_shards:
        with device_scope(mesh.devices[i]):
            out[i] = fn(*(a[i] for a in per_shard))
    return out


def shard_rows(mesh: Mesh, arr: np.ndarray):
    """A host array split along axis 0 into one block per shard, shard i's
    block on ``mesh.devices[i]`` (every process passes the same array)."""
    n = mesh.devices.size
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not split over {n} shards")
    per = arr.shape[0] // n
    return map_shards(
        mesh,
        lambda i: torch.from_numpy(
            np.ascontiguousarray(arr[i * per : (i + 1) * per])
        ).to(mesh.devices[i]),
        range(n),
    )


def replicate(mesh: Mesh, x: torch.Tensor):
    """``x`` on every local shard's device, one copy per distinct device
    (shards on one device share it)."""
    copies: dict[str, torch.Tensor] = {}

    def copy_on(d):
        if str(d) not in copies:
            copies[str(d)] = x.to(d)
        return copies[str(d)]

    return map_shards(mesh, copy_on, mesh.devices)


def _replica(dev: DeviceIndex, device: torch.device) -> DeviceIndex:
    """A device index's tables on another device: a shallow copy whose
    tensors (tuples of tensors too) are moved there."""
    if dev.device == device:
        return dev
    rep = object.__new__(type(dev))
    for name, v in vars(dev).items():
        if name == "_mesh_replicas":
            continue
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, tuple) and all(isinstance(t, torch.Tensor)
                                          for t in v):
            v = tuple(t.to(device) for t in v)
        setattr(rep, name, v)
    rep.device = device
    return rep


def index_replicas(index, mesh: Mesh):
    """The index's join tables on every local shard's device, as a list
    per shard: one :class:`DeviceIndex` per distinct device, kept on the
    index for the mesh's devices.

    The first local device takes the engine's own tables for it
    (``engine.device_index``), which the stages run there read too; the
    other devices' copies are this layer's, so a mesh of many cards does
    not cycle the engine's five-entry cache."""
    key = tuple(str(mesh.devices[i]) for i in mesh.local_shards)
    cache = vars(index).setdefault("_mesh_replicas", {})
    if key not in cache:
        base = engine.device_index(index, mesh.devices[mesh.local_shards[0]])
        by_dev: dict[str, DeviceIndex] = {}

        def replica_on(d):
            if str(d) not in by_dev:
                by_dev[str(d)] = _replica(base, d)
            return by_dev[str(d)]

        cache[key] = map_shards(mesh, replica_on, mesh.devices)
    return cache[key]


# ----------------------------------------------------------- collectives


def pick(parts, j: int):
    """Item j of each shard's tuple of outputs (None for another process's
    shards)."""
    return [None if p is None else p[j] for p in parts]


def _fold(fn, parts, dst):
    out = parts[0].to(dst)
    for p in parts[1:]:
        out = fn(out, p.to(dst))
    return out


def _local(mesh: Mesh, parts):
    return [parts[i] for i in mesh.local_shards]


def across(mesh: Mesh, x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` (this process's part, on its first local device) reduced by
    ``op`` (``"sum"`` / ``"max"``) over the mesh's processes: the identity
    in one process."""
    if mesh.process_count == 1:
        return x
    distributed.require_group(mesh.process_count)
    return distributed.all_reduce(x, op)


class ProcessReduce:
    """The reducer that kernels.refine hands a sharded value's per-process
    part to (a ShardedKeys3's unpack, membership ORs and extension, the
    sequence-sharded variant join's max): ``sum`` / ``max`` over the mesh's
    processes, the identity in one process."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return across(self.mesh, x, "sum")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return across(self.mesh, x, "max")


def all_gather(mesh: Mesh, parts, dim: int = 0) -> torch.Tensor:
    """The shards' tensors (one per shard, None for another process's)
    concatenated along ``dim`` in shard order, on the first local device
    of every process: this process's shards first, then the processes'
    blocks in rank order (global shard i is process i // per's local
    shard i % per)."""
    out = torch.cat([p.to(mesh.first_local) for p in _local(mesh, parts)],
                    dim=dim)
    if mesh.process_count == 1:
        return out
    distributed.require_group(mesh.process_count)
    return distributed.all_gather(out, dim)


def psum(mesh: Mesh, parts) -> torch.Tensor:
    """The elementwise sum of the shards' tensors (integers: exact in any
    order), on the first local device of every process."""
    return across(mesh, _fold(torch.add, _local(mesh, parts),
                              mesh.first_local), "sum")


def pmax(mesh: Mesh, parts, dst=None) -> torch.Tensor:
    """The elementwise maximum of the shards' tensors (one per shard, None
    for another process's), on the first local device of every process.
    With ``dst`` (a model group's first device) ``parts`` are that group's,
    all in this process, and no process collective runs."""
    if dst is not None:
        return _fold(torch.maximum, parts, dst)
    return across(mesh, _fold(torch.maximum, _local(mesh, parts),
                              mesh.first_local), "max")


def require_data_axis(mesh: Mesh, what: str) -> None:
    """Raise unless ``mesh`` is a one-axis ``data`` mesh: the entry points
    split batches, never the key table."""
    if mesh.axis_names != ("data",):
        raise ValueError(
            f"{what} shards its batch over a one-axis 'data' mesh, not axes "
            f"{mesh.axis_names}: a mesh with a 'model' axis splits the key "
            f"table, which matches_batch_index_sharded, "
            f"ms3_rows_sweep_index_sharded, map_batch_index_sharded and "
            f"map_batch_2d_sharded (kbo_tpu_torch.parallel.mesh) take"
        )


# -------------------------------------------------- data-parallel batches


def pad_rows(codes: np.ndarray, lengths: np.ndarray, n: int):
    """Pad a [Q, L] batch with empty INVALID rows to a multiple of n."""
    Qp = -(-codes.shape[0] // n) * n
    if Qp != codes.shape[0]:
        pad = Qp - codes.shape[0]
        codes = np.pad(codes, ((0, pad), (0, 0)), constant_values=INVALID)
        lengths = np.pad(lengths, (0, pad))
    return codes, lengths


def ref_matrix(ref_seqs, Q: int, L: int) -> np.ndarray:
    """The raw reference bytes as a padded [Q, L] host matrix."""
    ref_mat = np.zeros((Q, L), dtype=np.uint8)
    for q, r in enumerate(ref_seqs):
        ref_mat[q, : len(r)] = np.frombuffer(bytes(r), dtype=np.uint8)
    return ref_mat


def _matches_parts(mesh, index, codes_p, lengths_p, threshold: int):
    """The find pipeline launched on every shard: (chars, ms) per shard."""
    return map_shards(
        mesh,
        lambda dv, c, le: matches_pipeline_core(
            dv.keys2, dv.cap2, c, le, dv.k, int(threshold)
        ),
        index_replicas(index, mesh), codes_p, lengths_p,
    )


def matches_batch_sharded(index, code_list: list[np.ndarray], threshold: int,
                          mesh: Mesh | None = None) -> list[np.ndarray]:
    """Data-parallel batched matches over the shards of a mesh: Q is padded
    to a multiple of the shard count; chars (uint8 arrays) come back in
    input order."""
    mesh = mesh or make_mesh()
    codes, lengths = pad_rows(*pad_batch(code_list), mesh.devices.size)
    parts = _matches_parts(mesh, index, shard_rows(mesh, codes),
                           shard_rows(mesh, lengths), threshold)
    chars = gather_to_host(mesh, [p and p[0] for p in parts])
    return [chars[i, : c.size] for i, c in enumerate(code_list)]


def find_rle_batch_sharded(index, code_list: list[np.ndarray], threshold: int,
                           mesh: Mesh | None = None):
    """Data-parallel batched find with the segments extracted on the
    shards (``max_gap_len == 0``): a clean ACGT batch uploads 2-bit packed
    and decodes on its shards, the chars stay there, and each shard's
    global segment table (kernels.postprocess.rle_segments_global_core) is
    all that is fetched, again with a larger table when one overflows.
    Returns the RLE lists in input order."""
    mesh = mesh or make_mesh()
    n = mesh.devices.size
    codes, lengths = pad_rows(*pad_batch(code_list, bucket=True), n)
    Q, L = codes.shape
    lengths_p = shard_rows(mesh, lengths)
    packed = pack_codes_host(codes, lengths)
    if packed is not None:
        codes_p = map_shards(mesh, decode_packed_codes_device,
                             shard_rows(mesh, packed), lengths_p)
    else:
        codes_p = shard_rows(mesh, codes)
    chars_p = [p and p[0] for p in
               _matches_parts(mesh, index, codes_p, lengths_p, threshold)]
    q_per = Q // n
    cap = _bucket(max(128, 2 * q_per), lo=128)
    while True:
        blocks = gather_to_host(mesh, map_shards(
            mesh, lambda c, le: rle_segments_global_core(c, le, cap)[None],
            chars_p, lengths_p,
        ))
        rows: list = []
        for block in blocks:
            part = _rle_structs_global(block, q_per, cap)
            if part is None:
                break
            rows.extend(part)
        else:
            return rows[: len(code_list)]
        cap = min(cap * 4, q_per * ((L + 1) // 2 + 1))


def matches_long_sharded(index, codes: np.ndarray, threshold: int,
                         mesh: Mesh | None = None):
    """Sequence-parallel find pipeline over ONE long query.

    Every MS value depends only on its k-window, and derandomize/translate
    carry information at most k + threshold + 2 positions from a reset, so
    chunks with a halo of that size are exact. Shard 0 starts at the
    sequence start (no left pad: translate's position-0/1 rule applies to
    the true start); ceil-division chunking can put trailing shards past
    the end, and they contribute nothing. Returns (chars uint8 [L], ms
    int64 [L])."""
    mesh = mesh or make_mesh()
    n = mesh.devices.size
    codes = np.asarray(codes, dtype=np.uint8)
    L = codes.size
    halo = index.k + int(threshold) + 2
    chunk = -(-L // n)
    if chunk <= halo:
        raise ValueError(
            f"a sequence of {L} is too short to shard {n} ways with halo "
            f"{halo}"
        )
    width = chunk + 2 * halo
    rows = np.full((n, width), INVALID, dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    offs = np.zeros(n, dtype=np.int64)  # row index of position i * chunk
    for i in range(n):
        s = i * chunk
        lo = max(0, s - halo)
        hi = max(min(L, s + chunk + halo), lo)
        rows[i, : hi - lo] = codes[lo:hi]
        lengths[i] = hi - lo
        offs[i] = s - lo
    parts = _matches_parts(mesh, index, shard_rows(mesh, rows),
                           shard_rows(mesh, lengths), threshold)
    chars = gather_to_host(mesh, [p and p[0] for p in parts])
    ms = gather_to_host(mesh, [p and p[1] for p in parts]).astype(np.int64)
    out_chars = np.empty(L, dtype=np.uint8)
    out_ms = np.empty(L, dtype=np.int64)
    for i in range(n):
        s, e = i * chunk, min(L, (i + 1) * chunk)
        if e > s:
            off = int(offs[i])
            out_chars[s:e] = chars[i, off : off + e - s]
            out_ms[s:e] = ms[i, off : off + e - s]
    return out_chars, out_ms


def ms_values_many_sharded(index, code_list: list[np.ndarray],
                           mesh: Mesh) -> list[np.ndarray]:
    """Data-parallel MS of many short queries (the variant caller's k-mer
    re-runs over the ``data`` axis): int64 arrays in input order."""
    k = index.k
    codes, _ = pad_rows(*pad_batch(code_list), mesh.devices.size)
    buf = np.concatenate(
        [np.full((codes.shape[0], k - 1), INVALID, np.uint8), codes], axis=1
    )
    parts = map_shards(
        mesh,
        lambda dv, b: ms2_core(dv.keys2, dv.cap2, b.reshape(-1), k).reshape(
            b.shape),
        index_replicas(index, mesh), shard_rows(mesh, buf),
    )
    ms = gather_to_host(mesh, parts)[:, k - 1 :].astype(np.int64)
    return [ms[i, : c.size] for i, c in enumerate(code_list)]


def map_sweep_compact_sharded(index, codes: np.ndarray, lengths: np.ndarray,
                              threshold: int, mesh: Mesh):
    """Data-parallel 2-bit map sweep with the candidates compacted on the
    shards (kernels.mapsweep.map_sweep_compact_core); the compaction is
    row-local, so the per-shard outputs in shard order are the
    single-device sweep's. The caller pads the batch to a multiple of the
    shard count. Returns, per shard, (codes, chars, ms, counts, drop_pos,
    gap_start, gap_end_at) on the shard's device."""
    return map_shards(
        mesh,
        lambda dv, c, le: (c,) + map_sweep_compact_core(
            dv.keys2, dv.cap2, c, le, dv.k, int(threshold)
        ),
        index_replicas(index, mesh), shard_rows(mesh, codes),
        shard_rows(mesh, lengths),
    )


# --------------------------------------------- sequence-sharded map path
#
# The flagship `map` workload is ONE multi-megabase pair (reference:
# src/lib.rs:720-761); contig-granular sharding cannot split it. This path
# places POSITION CHUNKS of the sequence on the shards:
#
#   stage 1  the 3-bit rows join per chunk with k-1 real left context
#            (exact, as kernels.mapsweep.ms3_rows_sweep_chunked), the dense
#            (ms, uniq, rows) all-gathered onto the first local device;
#   stage 2  derandomize/translate and the candidate compaction run once
#            there (the derandomize scan and gap runs cross chunk edges);
#   stage 3  gap scoring splits the CANDIDATE SLOTS over the shards (each
#            gap's math is slot-local), the variant resolver's
#            rk-vs-sequence join the SEQUENCE chunks (per-shard tagged
#            window keys, the per-probe best maxed over the shards);
#   stage 4  priority assembly and the single delta fetch run once.


class _SeqShardedDev:
    """The sequence-sharded map's view of the key table, which
    refine.device_map.devref_core reads through its two operations: the
    index replicas per shard (kept on the index by :func:`index_replicas`),
    the mesh and each shard's context chunk."""

    def __init__(self, replicas, k: int, mesh: Mesh, ctx_chunks):
        self.replicas = replicas
        self.k = k
        self.mesh = mesh
        self.ctx_chunks = ctx_chunks

    def score_gaps(self, ref_mat, lengths, gap_start, gap_end_at, grid,
                   threshold: int, k: int, cap_g: int, cap_ext: int,
                   bound: float):
        """kernels.refine.score_gaps_core with the CANDIDATE SLOTS split
        over the shards: each scores cap_g / n of the compacted gap runs
        against its replica of the key table and extension table (the
        reference matrix and lengths copied to it). The patch grids gather
        (their order does not matter to the scatter-max assembly),
        ``needs_host`` is laid back into the [Q * cap_g] slot order, the
        counters sum; across processes too, so that every process holds all
        of them."""
        mesh = self.mesh
        nd = mesh.shape["data"]
        Q = gap_start.shape[0]
        capp = -(-cap_g // nd) * nd
        gs, ge, gr = (gap_start[:, :cap_g], gap_end_at[:, :cap_g],
                      grid[:, :cap_g])
        if capp != cap_g:
            pad = capp - cap_g
            gs = torch.cat([gs, gs.new_full((Q, pad), _BIG32)], dim=1)
            ge = torch.cat([ge, ge.new_full((Q, pad), _BIG32)], dim=1)
            gr = torch.cat([gr, gr.new_full((Q, pad, gr.shape[2]), -1)],
                           dim=1)
        cap_gl = capp // nd

        def shard(s, dv, rm, le):
            sl = slice(s * cap_gl, (s + 1) * cap_gl)
            d = dv.device
            return score_gaps_core(
                dv.keys3, rm, le, gs[:, sl].to(d), ge[:, sl].to(d),
                gr[:, sl].to(d), threshold, k, cap_gl, cap_ext,
                get_ext_table(dv), bound,
            )

        parts = map_shards(mesh, shard, range(nd), self.replicas,
                           replicate(mesh, ref_mat), replicate(mesh, lengths))
        needs_host = all_gather(
            mesh,
            [None if p is None else p[2].reshape(Q, cap_gl) for p in parts],
            dim=1,
        )[:, :cap_g].reshape(-1)
        return (all_gather(mesh, pick(parts, 0)),
                all_gather(mesh, pick(parts, 1)), needs_host,
                psum(mesh, pick(parts, 3)))

    def resolve_variants(self, codes, ref_mat, ms, lengths, drop_pos, apos,
                         arow, d: int, k: int, cap_d: int, d_lo: int,
                         seq_tables=None, revcomp: bool = False):
        """kernels.refine.resolve_variants_core with the rk-vs-sequence join
        table SEQUENCE-SHARDED: each shard sorts only its chunk's tagged
        window keys (chunk + k-1 real context) on its own device, the
        probes join each and the best is maxed over the shards (exact:
        every true window lies in one chunk; a context-region duplicate can
        only score lower), this process's chunks first, then over the
        processes. The rest runs once (per process), on the first local
        device. The chunks are the forward strand's own tables
        (:func:`map_seq_sharded` refuses ``revcomp``; ``seq_tables`` are
        the single card's)."""
        mesh = self.mesh
        tables = map_shards(mesh, lambda cc: seq_keys3_tagged_core(cc, k),
                            self.ctx_chunks)
        return resolve_variants_core(
            self.replicas[mesh.local_shards[0]].keys3, _local(mesh, tables),
            codes, ref_mat, ms, lengths, drop_pos, apos, arow, d, k, cap_d,
            d_lo=d_lo, reduce=ProcessReduce(mesh),
        )


def _seqsh_stage1(holder: _SeqShardedDev, L: int):
    """Stage 1: each shard's chunk joined with its k-1 context codes; the
    dense (ms, uniq, rows) [Q, L] gathered along dim 1 onto the first local
    device of every process."""
    k = holder.k
    parts = map_shards(
        holder.mesh,
        lambda dv, cc: _ms3_rows_chunk(dv.keys3, dv.rows_packed, cc, k),
        holder.replicas, holder.ctx_chunks,
    )
    return tuple(all_gather(holder.mesh, pick(parts, j), dim=1)[:, :L]
                 for j in range(3))


def map_seq_sharded(ref_seqs: list[bytes], query_sbwt, map_opts=None,
                    mesh: Mesh | None = None,
                    code_list=None) -> list[bytes]:
    """Batched ``map_`` with the SEQUENCE position-sharded over the
    ``data`` axis: one genome uses every shard, where the contig-sharded
    map (:func:`map_devref_data_sharded`) cannot split the single-pair
    workload. The same single-fetch refinement as the single-device map
    (refine.device_map.map_devref_finish), and byte for byte its output."""
    opts = map_opts or MapOpts()
    if not ref_seqs:
        return []
    mesh = mesh or make_mesh()
    nd = mesh.shape["data"]
    k = query_sbwt.k
    if opts.call_variants and (k != opts.sbwt_build_opts.k
                               or opts.sbwt_build_opts.add_revcomp):
        raise ValueError(
            "the sequence-sharded map calls variants with the index's k and "
            "the forward strand only"
        )
    threshold = random_match_threshold(k, query_sbwt.n_kmers, 4,
                                       opts.max_error_prob)
    if code_list is None:
        code_list = [encode_ascii(bytes(r)) for r in ref_seqs]
    codes, lengths = pad_batch(code_list, bucket=True)
    Q, L = codes.shape
    chunk = -(-L // nd)
    if Q * L >= 2**31 or chunk < k:
        raise ValueError(
            f"a [{Q}, {L}] batch does not position-shard {nd} ways at k={k}"
        )
    # per-shard chunk + k-1 real left context (INVALID for shard 0: the
    # unchunked buffer head), INVALID tail pad
    cc = np.full((nd, Q, k - 1 + chunk), INVALID, dtype=np.uint8)
    for s in range(nd):
        lo = s * chunk
        if lo < L:
            c0 = max(0, lo - (k - 1))
            seg = codes[:, c0 : min(L, lo + chunk)]
            off = (k - 1) - (lo - c0)
            cc[s, :, off : off + seg.shape[1]] = seg
    ref_mat = ref_matrix(ref_seqs, Q, L)

    holder = _SeqShardedDev(index_replicas(query_sbwt, mesh), k, mesh,
                            pick(shard_rows(mesh, cc), 0))
    d0 = mesh.first_local
    codes_dev = torch.from_numpy(codes).to(d0)
    lengths_dev = torch.from_numpy(lengths).to(d0)
    ref_mat_dev = torch.from_numpy(ref_mat).to(d0)
    with stage("map_sweep", bases=sum(c.size for c in code_list)):
        sweep = _seqsh_stage1(holder, L)
        with device_scope(d0):
            return map_devref_finish(
                holder, codes_dev, lengths_dev, sweep, ref_seqs, query_sbwt,
                opts, threshold, ref_mat, ref_mat_dev,
            )


# ------------------------------------------- prefix-sharded index placement
#
# A mesh with a ``model`` axis: model shard j holds columns [j*m, (j+1)*m)
# of the sorted key table (all-ones pad columns past its end, cap 0 for the
# 2-bit keys), every shard joins the whole replicated query buffer against
# its rows, and one pmax combines them. Exact: the global best row lives in
# one shard and clamping commutes with max. On one card the shards run in
# turn; the bytes a shard holds are the placement's point.
#
# The map's refinement reads the table at three places: the k-mer unpack,
# the membership probes and gap filling's left extension. Those run per
# shard (kernels.refine.ShardedKeys3, the search loop: the per-index chain
# table needs the whole table); everything else runs once, on the first
# device of the model group. On the 2-D ``("data", "model")`` mesh each row
# of the device grid is a model group with its own block of contigs.


def _model_shards(mesh: Mesh) -> int:
    if mesh.axis_names != ("model",):
        raise ValueError(
            f"prefix-sharded placement needs a one-axis 'model' mesh, not "
            f"axes {mesh.axis_names}"
        )
    return mesh.devices.size


def _column_blocks(table: np.ndarray, n_blocks: int, fill):
    """``table`` [..., n] split along its last axis into n_blocks host blocks
    of m = ceil(n / n_blocks) columns, padded with ``fill`` past n."""
    n = table.shape[-1]
    m = -(-n // n_blocks)
    blocks = []
    for j in range(n_blocks):
        part = np.full(table.shape[:-1] + (m,), fill, dtype=table.dtype)
        lo, hi = min(j * m, n), min((j + 1) * m, n)
        part[..., : hi - lo] = table[..., lo:hi]
        blocks.append(part)
    return blocks, m


def _split_columns(mesh: Mesh, table: np.ndarray, fill):
    """``table`` split into one column block per shard of a one-axis
    ``model`` mesh (:func:`_column_blocks`), shard i's block on
    ``mesh.devices[i]`` (local shards only)."""
    blocks, m = _column_blocks(table, _model_shards(mesh), fill)
    return map_shards(
        mesh, lambda i: torch.from_numpy(blocks[i]).to(mesh.devices[i]),
        range(len(blocks)),
    ), m


def _replicated_buffer(mesh: Mesh, codes, k: int):
    """The flat query buffer of a [Q, L] code batch (k-1 INVALID before
    each row) on every local shard's device."""
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8))
    Q = codes.shape[0]
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8,
                     device=codes.device)
    buf = torch.cat([pad, codes], dim=1).reshape(-1)
    return replicate(mesh, buf)


class Sharded3Index:
    """The rows join's tables of a host index, prefix-sharded over the
    ``model`` axis of a one-axis ``model`` mesh or a 2-D ``("data",
    "model")`` mesh: model shard j holds ``keys3`` columns [j*m, (j+1)*m)
    (all-ones int32 -1 columns past the table, so ``m * shards`` covers it)
    and the GLOBAL adjacent-row LCS values of those rows, ``down[j] =
    lcs[j]`` and ``up[j] = lcs[j + 1]`` (0 past the table). No device holds
    the whole table: four shards on one card are four tensors of m columns.

    Along ``data`` the model shards repeat with one copy per distinct
    device (the rule of :func:`index_replicas`): data row i of the device
    grid reads model shard j on ``devices[i, j]``, so a 2 x 4 mesh on one
    card holds four shards, not eight.

    Across processes each process places only its own shards (None for
    another process's): the model shards of a one-axis ``model`` mesh, or
    the rows of a 2-D mesh that it holds.

    ``keys3`` / ``down`` / ``up`` are lists per model shard (the first local
    data row's, ``first_row``); :meth:`tables` gives data row i's (keys3,
    down, up) per shard and :meth:`group` its keys as a
    kernels.refine.ShardedKeys3, the refinement's view. ``shard_cols`` is m,
    ``shard_bytes`` the bytes one shard's tensors hold.
    """

    def __init__(self, index, mesh: Mesh):
        if "model" not in mesh.axis_names:
            raise ValueError(
                f"prefix-sharded placement needs a one-axis 'model' mesh or "
                f"a ('data', 'model') mesh, not axes {mesh.axis_names}"
            )
        if index.keys3 is None:
            raise ValueError("index built without join keys")
        keys3 = np.ascontiguousarray(index.keys3, dtype=np.uint32).view(
            np.int32)
        n = keys3.shape[1]
        lcs = np.asarray(index.lcs, dtype=np.uint8)[:n]
        up = np.zeros(n, dtype=np.uint8)
        up[: n - 1] = lcs[1:]
        n_model = mesh.shape["model"]
        blocks = [_column_blocks(t, n_model, fill)[0]
                  for t, fill in ((keys3, -1), (lcs, 0), (up, 0))]
        grid = mesh.devices.reshape(-1, n_model)
        placed: dict = {}

        def place(i, j):
            if i * n_model + j not in mesh.local_shards:
                return None
            key = (j, str(grid[i, j]))
            if key not in placed:
                placed[key] = tuple(torch.from_numpy(b[j]).to(grid[i, j])
                                    for b in blocks)
            return placed[key]

        self._rows = [[place(i, j) for j in range(n_model)]
                      for i in range(grid.shape[0])]
        self.first_row = mesh.local_shards[0] // n_model
        self.keys3, self.down, self.up = (
            pick(self._rows[self.first_row], t) for t in range(3))
        self.shard_cols = m = -(-n // n_model)
        self.shard_bytes = m * (keys3.shape[0] * 4 + 2)
        self.n_rows = int(index.n_rows)
        self.k = int(index.k)
        self.model_mesh = mesh
        self._groups: dict = {}

    def tables(self, i: int | None = None):
        """Data row i's (keys3, down, up) per model shard (by default the
        first local row's)."""
        return self._rows[self.first_row if i is None else i]

    def group(self, i: int | None = None) -> ShardedKeys3:
        """Data row i's key shards as a ShardedKeys3 (by default the first
        local row's); data rows on the same devices share one (and its
        bucket tables). The model group of a one-axis ``model`` mesh may
        span processes: its ShardedKeys3 then reduces over them."""
        shards = pick(self.tables(i), 0)
        key = tuple(id(s) for s in shards)
        if key not in self._groups:
            self._groups[key] = ShardedKeys3(
                shards, self.shard_cols, ProcessReduce(self.model_mesh)
                if self.model_mesh.axis_names == ("model",) else None)
        return self._groups[key]


def _group_rows_join(sidx: Sharded3Index, i: int, codes):
    """(ms, uniq, rows) [Q, L] of a code batch (host array or tensor)
    against model group i of the sharded table: every local shard's partial
    join (kernels.ms.ms3_rows_partial_core, row offset j * m) over the query
    buffer copied to its device, one pmax for each pack (over the processes
    too when the group is a one-axis ``model`` mesh that spans them) and
    the finish on the group's first local device."""
    shards = sidx.tables(i)
    local = [(j, t) for j, t in enumerate(shards) if t is not None]
    first = local[0][1][0].device
    k = sidx.k
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8))
    codes = codes.to(first)
    Q, L = codes.shape
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8, device=first)
    buf = torch.cat([pad, codes], dim=1).reshape(-1)
    copies = {str(first): buf}
    m = sidx.shard_cols
    packs = [None] * len(shards)
    for j, (k3, dn, up) in local:
        b = copies.setdefault(str(k3.device), buf.to(k3.device))
        with device_scope(k3.device):
            packs[j] = ms3_rows_partial_core(k3, dn, up, j * m, b, k)
    mesh = sidx.model_mesh
    if mesh.axis_names == ("model",):
        fp, bp = (pmax(mesh, pick(packs, t)) for t in range(2))
    else:
        fp, bp = (pmax(mesh, pick(packs, t), first) for t in range(2))
    with device_scope(first):
        ms, uniq, rows = ms3_rows_from_packed(fp, bp, sidx.n_rows, k)
    stride = L + k - 1
    return tuple(x.reshape(Q, stride)[:, k - 1 :] for x in (ms, uniq, rows))


def ms3_rows_sweep_index_sharded(sidx: Sharded3Index, codes, mesh: Mesh):
    """(ms, uniq, rows) [Q, L] of a code batch (host array or tensor)
    against the SHARDED key table of a one-axis ``model`` mesh: every
    shard's partial join over the replicated query buffer, one pmax for
    each pack, the finish on the first local device. Equal to
    kernels.mapsweep.ms3_rows_sweep's outputs; rows where uniq holds."""
    _model_shards(mesh)
    return _group_rows_join(sidx, 0, codes)


def _sharded_map_setup(ref_seqs, query_sbwt, opts, what: str):
    """(threshold, code list, padded codes, lengths) of a map over a
    sharded table; refuses what kbo_tpu's refuses."""
    k = query_sbwt.k
    if opts.call_variants and (k != opts.sbwt_build_opts.k
                               or opts.sbwt_build_opts.add_revcomp):
        raise ValueError(
            f"{what} calls variants with the index's k and the forward "
            f"strand only (the sharded path carries the forward text)"
        )
    threshold = random_match_threshold(k, query_sbwt.n_kmers, 4,
                                       opts.max_error_prob)
    code_list = [encode_ascii(bytes(r)) for r in ref_seqs]
    codes, lengths = pad_batch(code_list, bucket=True)
    return threshold, code_list, codes, lengths


def map_batch_index_sharded(ref_seqs: list[bytes], query_sbwt, map_opts=None,
                            mesh: Mesh | None = None) -> list[bytes]:
    """Batched ``map_`` with the 3-bit index tables PREFIX-SHARDED over a
    one-axis ``model`` mesh (the larger-than-one-card placement of the map
    path; ``find`` has :func:`matches_batch_index_sharded`): the rows join
    by shard with one pmax per pack, then the single-device map's
    single-fetch refinement (refine.device_map.map_devref_finish) over the
    model group's ShardedKeys3 (its unpacks and searches per shard, the
    rest once on the first local device). Gaps the device flags go to the
    exact host evaluator. Byte for byte the single-device map's output. No
    API entry point takes a ``model`` mesh: call this directly."""
    opts = map_opts or MapOpts()
    if not ref_seqs:
        return []
    mesh = mesh or make_mesh(axis="model")
    _model_shards(mesh)
    k = query_sbwt.k
    threshold, code_list, codes, lengths = _sharded_map_setup(
        ref_seqs, query_sbwt, opts, "the index-sharded map")
    Q, L = codes.shape
    if Q > max_tag(k) or Q * L >= 2**31:
        raise ValueError(f"a [{Q}, {L}] batch exceeds the tagged join's "
                         f"limits at k={k}")
    sidx = Sharded3Index(query_sbwt, mesh)
    ref_mat = ref_matrix(ref_seqs, Q, L)
    d0 = mesh.first_local
    codes_dev = torch.from_numpy(codes).to(d0)
    lengths_dev = torch.from_numpy(lengths).to(d0)
    ref_mat_dev = torch.from_numpy(ref_mat).to(d0)
    with stage("map_sweep", bases=sum(c.size for c in code_list)):
        sweep = _group_rows_join(sidx, 0, codes_dev)
        with device_scope(d0):
            return map_devref_finish(
                KeyTable(sidx.group()), codes_dev, lengths_dev, sweep,
                ref_seqs, query_sbwt, opts, threshold, ref_mat, ref_mat_dev,
            )


def matches_batch_index_sharded(index, code_list: list[np.ndarray],
                                threshold: int,
                                mesh: Mesh | None = None) -> list[np.ndarray]:
    """Batched matches against a PREFIX-SHARDED 2-bit key table: ``keys2`` /
    ``cap2`` split over the ``model`` shards (all-ones keys and cap 0 past
    the table: such rows add nothing to the clamped-LCP scan), each shard's
    ms2_core over the replicated buffer, one pmax, then derandomize and
    translate once (per process) on the first local device
    (kernels.postprocess.derandomize_translate). Returns uint8 chars per
    query, equal to pipeline.matches_batch's."""
    mesh = mesh or make_mesh(axis="model")
    _model_shards(mesh)
    if index.keys2 is None:
        raise ValueError("index built without join keys")
    k = int(index.k)
    codes, lengths = pad_batch(code_list)
    Q, L = codes.shape
    keys2, _ = _split_columns(
        mesh, np.ascontiguousarray(index.keys2, dtype=np.uint32).view(
            np.int32), -1)
    cap2, _ = _split_columns(mesh, np.asarray(index.cap2, dtype=np.int32), 0)
    parts = map_shards(
        mesh,
        lambda k2, c2, b: ms2_core(k2, c2, b, k).reshape(Q, L + k - 1)[
            :, k - 1 :],
        keys2, cap2, _replicated_buffer(mesh, codes, k),
    )
    ms = pmax(mesh, parts)
    d0 = mesh.first_local
    with device_scope(d0):
        chars = derandomize_translate(
            ms, k, int(threshold), torch.from_numpy(lengths).to(d0))
    chars = chars.cpu().numpy()
    return [chars[i, : c.size] for i, c in enumerate(code_list)]


# ----------------------------- 2-D placement: data x model at once


def _local_rows(mesh: Mesh) -> range:
    """The data rows of a 2-D mesh that this process holds."""
    n_model = mesh.shape["model"]
    return range(mesh.local_shards[0] // n_model,
                 mesh.local_shards[-1] // n_model + 1)


def _stage1_2d(sidx: Sharded3Index, codes_p):
    """The dense (ms, uniq, rows) of each local data row's contig block
    against its model group (:func:`_group_rows_join`: a partial join per
    (data, model) shard, pmax over ``model`` only), on the group's first
    device (None for another process's rows)."""
    return [None if c is None else _group_rows_join(sidx, i, c)
            for i, c in enumerate(codes_p)]


def _stage2_2d(sidx: Sharded3Index, codes_p, ref_p, len_p, sweep_p,
               threshold: int, opts, caps) -> np.ndarray:
    """refine.device_map.devref_core per local data row with its model
    group's sharded table (the search loop's left extension, no chain
    table: it syncs once a round); the delta blocks [n_data, 4, caps.r]
    are fetched together after the last row, the processes' rows meeting
    in distributed.gather_to_host."""
    mesh = sidx.model_mesh
    blocks = [None] * len(codes_p)
    for i in _local_rows(mesh):
        co, rm, le, sw = codes_p[i], ref_p[i], len_p[i], sweep_p[i]
        with device_scope(co.device):
            blocks[i] = devref_core(
                KeyTable(sidx.group(i)), sidx.k, co, rm, le, sw, threshold,
                caps, opts).delta(caps.r)[None]
    return gather_to_host(mesh, blocks, _local_rows(mesh))


def map_batch_2d_sharded(ref_seqs: list[bytes], query_sbwt, map_opts=None,
                         mesh: Mesh | None = None) -> list[bytes] | None:
    """Batched ``map_`` over a 2-D ``("data", "model")`` mesh: the contig
    batch shards over ``data`` (Q padded to a multiple of its size) while
    the 3-bit key table prefix-shards over ``model``, the placement where
    neither the batch nor the index fits one card. Each data row runs the
    contig-sharded map's whole refinement (refine.device_map.devref_core)
    against its model group; the host pays one fetch of the per-row delta
    blocks. Byte for byte the single-device map's output, or None when a
    gap needs the exact host evaluator (as kbo_tpu's: callers take a 1-D
    path then). No API entry point takes this mesh: call this directly."""
    opts = map_opts or MapOpts()
    if not ref_seqs:
        return []
    if mesh is None or mesh.axis_names != ("data", "model"):
        raise ValueError("map_batch_2d_sharded needs a ('data', 'model') "
                         "mesh (make_mesh((d, m), axis=('data', 'model')))")
    k = query_sbwt.k
    threshold, code_list, codes, lengths = _sharded_map_setup(
        ref_seqs, query_sbwt, opts, "the 2-D map")
    nd = mesh.shape["data"]
    codes, lengths = pad_rows(codes, lengths, nd)
    Q, L = codes.shape
    q_per = Q // nd
    if q_per > max_tag(k) or q_per * L >= 2**31:
        raise ValueError(f"[{q_per}, {L}] contig blocks exceed the tagged "
                         f"join's limits at k={k}")
    sidx = Sharded3Index(query_sbwt, mesh)
    ref_mat = ref_matrix(ref_seqs, Q, L)

    local = _local_rows(mesh)

    def blocks_of(arr):
        """This process's rows' blocks of ``arr`` (None for another's)."""
        return [torch.from_numpy(np.ascontiguousarray(
            arr[i * q_per : (i + 1) * q_per])).to(mesh.devices[i, 0])
            if i in local else None for i in range(nd)]

    codes_p, ref_p, len_p = (blocks_of(a) for a in (codes, ref_mat, lengths))
    with stage("map_sweep", bases=sum(c.size for c in code_list)):
        sweep_p = _stage1_2d(sidx, codes_p)
        return devref_sharded_finish(
            ref_seqs, ref_mat, nd, opts,
            lambda caps: _stage2_2d(sidx, codes_p, ref_p, len_p, sweep_p,
                                    threshold, opts, caps),
        )


# ------------------------------------- contig-sharded map over ``data``


def map_devref_data_sharded(ref_seqs, query_sbwt, code_list, opts,
                            threshold: int, mesh: Mesh):
    """Contig-sharded single-fetch map over a ``data`` mesh: the 3-bit
    sweep AND the refinement (refine.device_map.devref_core) run per shard
    on its replica of the index; the host pays one gather of the per-shard
    [4, caps.r] delta blocks (refine.device_map.devref_sharded_finish),
    again at larger capacities when candidates or runs overflowed. Returns
    None when a gap needs the exact host evaluator: the caller takes the
    classic mesh sweep (kbo_tpu_torch.api._map_classic), so correctness
    never rests on this path."""
    k = query_sbwt.k
    nd = mesh.devices.size
    codes, lengths = pad_rows(*pad_batch(code_list, bucket=True), nd)
    Q, L = codes.shape
    ref_mat = ref_matrix(ref_seqs, Q, L)
    reps = index_replicas(query_sbwt, mesh)
    codes_p = shard_rows(mesh, codes)
    ref_p = shard_rows(mesh, ref_mat)
    len_p = shard_rows(mesh, lengths)
    sweep_p = map_shards(
        mesh, lambda dv, co: ms3_rows_sweep(dv.keys3, dv.rows_packed, co, k),
        reps, codes_p,
    )

    def run(caps):
        def shard(dv, co, rm, le, sw):
            return devref_core(KeyTable.of(dv), k, co, rm, le, sw, threshold,
                               caps, opts).delta(caps.r)[None]

        return gather_to_host(mesh, map_shards(
            mesh, shard, reps, codes_p, ref_p, len_p, sweep_p))

    return devref_sharded_finish(ref_seqs, ref_mat, nd, opts, run)
