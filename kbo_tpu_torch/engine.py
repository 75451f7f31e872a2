"""MS backend (PyTorch; counterpart of kbo_tpu/engine.py).

Every query takes the sort-join on the chosen device, however small: the
port has no host-oracle cutoff (kbo_tpu's ``_HOST_CUTOFF`` branches need
the scalar SBWT walk, which belongs to a later slice, and on the card they
would keep small queries off the GPU). ``device=None`` means the CUDA card.

Besides the MS values, the sparse colex intervals that the refinement
layers read (:func:`compute_ms_intervals_at`, :class:`SparseIntervals`)
and the index-free joins of short queries against a raw sequence
(:func:`compute_ms_values_vs_seq`).
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels.ms import (
    INVALID,
    DeviceIndex,
    _intervals3_pos,
    _intervals3_windows_msrow,
    intervals3_windows_core,
    ms2_core,
    ms3_batch_vs_seq_core,
    query_ms_device,
    query_ms_values_device,
    resolve_device,
)
from kbo_tpu_torch.pipeline import _flat_ms_to_batch, _make_buf, pad_batch

_device_cache: dict[tuple[int, str], tuple[SbwtIndex, DeviceIndex]] = {}


def device_index(index, device=None) -> DeviceIndex:
    """Memoized device-resident sort-join tables of an index on a device
    (a :class:`DeviceIndex`, such as a device-built
    :class:`kbo_tpu_torch.kernels.ms.DeviceFullIndex`, passes through)."""
    if isinstance(index, DeviceIndex):
        return index
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # "cuda" and a tensor's "cuda:0" name one card: one cache entry
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (id(index), str(dev))
    cached = _device_cache.get(key)
    if cached is None or cached[0] is not index:
        if len(_device_cache) > 4:
            _device_cache.clear()
        cached = (index, DeviceIndex(index, dev))
        _device_cache[key] = cached
    return cached[1]


def compute_ms(index: SbwtIndex, codes: np.ndarray, device=None):
    """(ms int64 [L], intervals int64 [L, 2]) of one encoded query: the
    3-bit join and the interval probe on the device, whatever the query's
    length (kbo_tpu's host cutoff is left out; ``ops.ms.query_ms_codes``
    stays the test oracle)."""
    return query_ms_device(device_index(index, device), np.asarray(codes))


def compute_ms_values(index: SbwtIndex, codes: np.ndarray, device=None):
    """MS values (int64 [L]) of one encoded query -- the 2-bit join."""
    return query_ms_values_device(
        device_index(index, device), np.asarray(codes)
    )


def compute_ms_values_many_device(index: SbwtIndex, code_list, device=None):
    """Dispatches one padded batch and returns the device-resident [Q, Lb]
    int32 MS (not fetched), or None for an empty list."""
    if not code_list:
        return None
    dev = device_index(index, device)
    codes, _ = pad_batch([np.asarray(c) for c in code_list], bucket=True)
    Q, L = codes.shape
    buf = _make_buf(torch.from_numpy(codes).to(dev.device), dev.k)
    return _flat_ms_to_batch(
        ms2_core(dev.keys2, dev.cap2, buf, dev.k), Q, L, dev.k
    )


def compute_ms_values_many_async(index: SbwtIndex, code_list, device=None):
    """Dispatches the batch and returns a zero-arg finalizer that fetches
    the per-query int64 MS lists ([] for an empty list)."""
    if not code_list:
        return []
    ms = compute_ms_values_many_device(index, code_list, device)

    def finalize():
        ms_np = ms.cpu().numpy().astype(np.int64)
        return [ms_np[i, : c.size] for i, c in enumerate(code_list)]

    return finalize


def compute_ms_values_many(index: SbwtIndex, code_list, device=None):
    """Batched MS values for many short queries: one padded device batch.
    Returns a list of int64 ms arrays, one per query."""
    out = compute_ms_values_many_async(index, code_list, device)
    return out() if callable(out) else out


def compute_ms_intervals_at(index: SbwtIndex, codes: np.ndarray,
                            positions: np.ndarray, ms=None, dev_codes=None,
                            device=None):
    """MS values + colex intervals at a sparse set of query positions.

    The refinement layers (variant calling, gap filling) only read
    intervals at data-dependent candidate positions; this avoids the
    full-length interval pass. ``ms`` is the full-length MS from the main
    sweep: a host array (or None: computed here), or a device-resident
    int32 row (a tensor, never fetched whole; its device is the one used).
    With a device row, ``dev_codes`` (the resident uint8 code row) moves the
    window assembly to the device as well. Returns (ms int64 [P],
    intervals int64 [P, 2]) in ``positions`` order.
    """
    codes = np.asarray(codes)
    positions = np.asarray(positions, dtype=np.int64)
    dev_ms = isinstance(ms, torch.Tensor)
    dev = device_index(index, ms.device if dev_ms else device)
    k = dev.k
    if ms is None:
        ms = query_ms_values_device(dev, codes)
    P = positions.size
    Pb = 64
    while Pb < P:
        Pb <<= 1
    pos32 = np.zeros(Pb, dtype=np.int32)
    pos32[:P] = positions
    if dev_ms and dev_codes is not None:
        # windows gathered from the resident code row, ms from the resident
        # row: positions up, one stacked int32 [3, Pb] down
        out = _intervals3_pos(
            dev.keys3, dev_codes, ms, torch.from_numpy(pos32).to(dev.device), k
        ).cpu().numpy().astype(np.int64)
        return out[2, :P], np.stack([out[0, :P], out[1, :P]], axis=1)
    # window matrix on the host; row p = codes[pos-k+1 ..= pos]
    padded = np.full(codes.size + k - 1, INVALID, dtype=np.uint8)
    padded[k - 1 :] = codes
    windows = np.full((Pb, k), INVALID, dtype=np.uint8)
    windows[:P] = padded[positions[:, None] + np.arange(k)[None, :]]
    windows = torch.from_numpy(windows).to(dev.device)
    if dev_ms:
        # the MS row stays on the device: gathered inside the probe and
        # fetched with (l, r) as one stacked array
        out = _intervals3_windows_msrow(
            dev.keys3, windows, ms, torch.from_numpy(pos32).to(dev.device), k
        ).cpu().numpy().astype(np.int64)
        return out[2, :P], np.stack([out[0, :P], out[1, :P]], axis=1)
    ms_at = np.asarray(ms, dtype=np.int64)[positions]
    ms_pad = np.zeros(Pb, dtype=np.int32)
    ms_pad[:P] = ms_at
    l, r = intervals3_windows_core(
        dev.keys3, windows, torch.from_numpy(ms_pad).to(dev.device), k
    )
    iv = torch.stack([l[:P], r[:P]], dim=1).cpu().numpy().astype(np.int64)
    return ms_at, iv


class SparseIntervals:
    """Lazy, batched colex-interval provider indexed like an [n, 2] array.

    Supports ``iv[pos, 0]`` / ``iv[pos, 1]`` and ``len(iv)``, so the
    refinement code reads a fully materialized interval array and this
    provider alike. Ranges must be prefetched (one device batch per
    prefetch call); reading a position never prefetched raises KeyError.
    """

    def __init__(self, index: SbwtIndex, codes: np.ndarray, ms=None,
                 dev_codes=None, device=None):
        self._index = index
        self._codes = np.asarray(codes)
        # ms may be a host array OR a device-resident int32 row (query
        # coordinates) that is never fetched whole; dev_codes a resident
        # code row for window assembly on the device
        self._ms = ms
        self._dev_codes = dev_codes
        self._device = device
        # sorted-array cache: _pos sorted positions, _val [n, 3] = (l, r,
        # ms). Miss batches collect as extra sorted blocks and merge into
        # the main arrays only when the block list grows (an insert per
        # prefetch would copy the cache every anchor round)
        self._pos = np.zeros(0, dtype=np.int64)
        self._val = np.zeros((0, 3), dtype=np.int64)
        self._blocks: list[tuple[np.ndarray, np.ndarray]] = []

    def __len__(self) -> int:
        return self._codes.size

    def _have(self, positions) -> np.ndarray:
        """Boolean mask of positions already cached (main array or blocks)."""
        have = np.zeros(positions.size, dtype=bool)
        for pos_arr in [self._pos] + [p for p, _ in self._blocks]:
            if not pos_arr.size:
                continue
            loc = np.minimum(
                np.searchsorted(pos_arr, positions), pos_arr.size - 1
            )
            have |= pos_arr[loc] == positions
        return have

    def _consolidate(self) -> None:
        if not self._blocks:
            return
        pos = np.concatenate([self._pos] + [p for p, _ in self._blocks])
        val = np.concatenate([self._val] + [v for _, v in self._blocks])
        order = np.argsort(pos, kind="stable")
        self._pos = pos[order]
        self._val = val[order]
        self._blocks = []

    def prefetch(self, positions) -> None:
        positions = np.unique(np.atleast_1d(
            np.asarray(positions, dtype=np.int64)
        ))
        if positions.size:
            positions = positions[~self._have(positions)]
        if positions.size == 0:
            return
        ms_at, iv = compute_ms_intervals_at(
            self._index, self._codes, positions, ms=self._ms,
            dev_codes=self._dev_codes, device=self._device,
        )
        new_val = np.concatenate(
            [iv, np.asarray(ms_at, dtype=np.int64)[:, None]], axis=1
        )
        if self._pos.size:
            self._blocks.append((positions, new_val))
            if len(self._blocks) > 8:
                self._consolidate()
        else:
            self._pos = positions
            self._val = new_val

    def _gather(self, positions) -> np.ndarray:
        """[P, 3] cached (l, r, ms) rows across the main array + blocks."""
        out = np.empty((positions.size, 3), dtype=np.int64)
        found = np.zeros(positions.size, dtype=bool)
        for pos_arr, val_arr in [(self._pos, self._val)] + self._blocks:
            if not pos_arr.size:
                continue
            loc = np.minimum(
                np.searchsorted(pos_arr, positions), pos_arr.size - 1
            )
            hit = (pos_arr[loc] == positions) & ~found
            if hit.any():
                out[hit] = val_arr[loc[hit]]
                found |= hit
        if positions.size and not found.all():
            raise KeyError("interval positions were not prefetched")
        return out

    def __getitem__(self, key):
        pos, col = key
        row = self._gather(np.asarray([pos], dtype=np.int64))
        return int(row[0, int(col)])

    def get_batch(self, positions) -> np.ndarray:
        """[P, 2] interval array for ``positions`` (prefetching the misses)."""
        positions = np.atleast_1d(np.asarray(positions, dtype=np.int64))
        self.prefetch(positions)
        return self._gather(positions)[:, :2]

    def get_ms_batch(self, positions) -> np.ndarray:
        """MS values at ``positions`` (prefetching the misses): sparse MS
        reads without a full-vector download."""
        positions = np.atleast_1d(np.asarray(positions, dtype=np.int64))
        self.prefetch(positions)
        return self._gather(positions)[:, 2]


def compute_ms_values_vs_seq_device(ref_codes: np.ndarray, code_list, k: int,
                                    device=None):
    """Dispatches one padded batch of short queries against a RAW sequence
    (no index: the reference's build-an-index-inside-call(),
    src/lib.rs:553) and returns the device-resident [Q, Lb] int32 MS (not
    fetched), or None for an empty list."""
    if not code_list:
        return None
    dev = resolve_device(device)
    ref_codes = np.asarray(ref_codes, dtype=np.uint8)
    buf = np.full(ref_codes.size + k - 1, INVALID, dtype=np.uint8)
    buf[k - 1 :] = ref_codes
    codes, _ = pad_batch([np.asarray(c) for c in code_list], bucket=True)
    return ms3_batch_vs_seq_core(
        torch.from_numpy(buf).to(dev), torch.from_numpy(codes).to(dev), k
    )


def compute_ms_values_vs_seq_async(ref_codes: np.ndarray, code_list, k: int,
                                   device=None):
    """Dispatches the batch and returns a zero-arg finalizer that fetches
    the per-query int64 MS lists ([] for an empty list)."""
    if not code_list:
        return []
    ms = compute_ms_values_vs_seq_device(ref_codes, code_list, k, device)

    def finalize():
        ms_np = ms.cpu().numpy().astype(np.int64)
        return [ms_np[i, : c.size] for i, c in enumerate(code_list)]

    return finalize


def compute_ms_values_vs_seq(ref_codes: np.ndarray, code_list, k: int,
                             device=None):
    """Batched MS values of short queries against a RAW sequence: a list
    of int64 ms arrays, one per query."""
    out = compute_ms_values_vs_seq_async(ref_codes, code_list, k, device)
    return out() if callable(out) else out
