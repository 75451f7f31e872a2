"""MS backend (PyTorch; counterpart of kbo_tpu/engine.py).

Every query takes the sort-join on the chosen device, however small: the
port has no host-oracle cutoff (kbo_tpu's ``_HOST_CUTOFF`` branch needs the
scalar SBWT walk, which belongs to a later slice, and on the card it would
keep small queries off the GPU). ``device=None`` means the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels.ms import (
    DeviceIndex,
    ms2_core,
    query_ms_values_device,
    resolve_device,
)
from kbo_tpu_torch.pipeline import _flat_ms_to_batch, _make_buf, pad_batch

_device_cache: dict[tuple[int, str], tuple[SbwtIndex, DeviceIndex]] = {}


def device_index(index, device=None) -> DeviceIndex:
    """Memoized device-resident sort-join tables of an index on a device
    (a :class:`DeviceIndex` passes through)."""
    if isinstance(index, DeviceIndex):
        return index
    dev = resolve_device(device)
    key = (id(index), str(dev))
    cached = _device_cache.get(key)
    if cached is None or cached[0] is not index:
        if len(_device_cache) > 4:
            _device_cache.clear()
        cached = (index, DeviceIndex(index, dev))
        _device_cache[key] = cached
    return cached[1]


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
