"""Batched device pipelines: MS -> derandomize -> translate -> RLE
(PyTorch; counterpart of kbo_tpu/pipeline.py).

The throughput (``find``/``matches``) hot path: a [Q, L] batch of padded
queries goes in; alignment characters and MS values come out with no host
round trips between stages. MS comes from the sort-join engine
(kbo_tpu_torch.kernels.ms); derandomize/translate/RLE from
kbo_tpu_torch.kernels.postprocess.
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels.ms import INVALID, _bucket as _kernel_bucket, ms2_core
from kbo_tpu_torch.kernels.postprocess import (
    derandomize_core,
    rle_segments_global_core,
    translate_core,
)
from kbo_tpu_torch.ops.format import RLE


def _flat_ms_to_batch(ms_flat, Q: int, L: int, k: int):
    stride = L + k - 1
    return ms_flat.reshape(Q, stride)[:, k - 1 :]


def _make_buf(codes: torch.Tensor, k: int) -> torch.Tensor:
    Q = codes.shape[0]
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8, device=codes.device)
    return torch.cat([pad, codes], dim=1).reshape(-1)


def matches_pipeline_core(keys2, cap2, codes, lengths, k: int, threshold: int):
    """codes: uint8 [Q, L] (tail-padded with INVALID); lengths: int32 [Q].

    Returns (chars uint8 [Q, L], ms int32 [Q, L]). Positions past each
    query's length are garbage; mask with lengths.
    """
    Q, L = codes.shape
    buf = _make_buf(codes, k)
    ms = _flat_ms_to_batch(ms2_core(keys2, cap2, buf, k), Q, L, k)
    derand = derandomize_core(ms, k, threshold, lengths)
    chars = translate_core(derand, k, threshold, lengths)
    return chars, ms


def _bucket(n: int, lo: int = 64) -> int:
    return _kernel_bucket(n, lo=lo)


def pad_batch(code_list: list[np.ndarray], L: int | None = None, bucket=False):
    """Stack encoded queries into a [Q, L] padded batch + lengths."""
    L = L or max(c.size for c in code_list)
    if bucket:
        L = _bucket(L)
    Q = len(code_list)
    codes = np.full((Q, L), INVALID, dtype=np.uint8)
    lengths = np.zeros(Q, dtype=np.int32)
    for i, c in enumerate(code_list):
        codes[i, : c.size] = c
        lengths[i] = c.size
    return codes, lengths


def _run_pipeline(index, code_list, threshold: int, device):
    from kbo_tpu_torch.engine import device_index

    dev = device_index(index, device)
    codes, lengths = pad_batch(code_list, bucket=True)
    lengths_dev = torch.from_numpy(lengths).to(dev.device)
    chars, ms = matches_pipeline_core(
        dev.keys2, dev.cap2, torch.from_numpy(codes).to(dev.device),
        lengths_dev, dev.k, threshold,
    )
    return chars, ms, lengths_dev


def matches_ms_batch(index: SbwtIndex, code_list: list[np.ndarray],
                     threshold: int, device=None):
    """(translation chars, noisy ms) per query, one device batch."""
    chars, ms, _ = _run_pipeline(index, code_list, threshold, device)
    chars = chars.cpu().numpy()
    ms = ms.cpu().numpy().astype(np.int64)
    return (
        [chars[i, : c.size] for i, c in enumerate(code_list)],
        [ms[i, : c.size] for i, c in enumerate(code_list)],
    )


def matches_batch(index: SbwtIndex, code_list: list[np.ndarray],
                  threshold: int, device=None) -> list[np.ndarray]:
    """Translated alignment chars (uint8 arrays) for a batch of queries;
    the ms output stays on the device."""
    chars, _ms, _ = _run_pipeline(index, code_list, threshold, device)
    chars = chars.cpu().numpy()
    return [chars[i, : c.size] for i, c in enumerate(code_list)]


def _rle_structs_global(vec: np.ndarray, q_rows: int, cap_total: int):
    """Flat [1 + q_rows + 5*cap_total] int32 (rle_segments_global_core) ->
    per-row RLE lists, or None when the shared table overflowed."""
    total = int(vec[0])
    if total > cap_total:
        return None
    counts = vec[1 : 1 + q_rows]
    cols = vec[1 + q_rows :].reshape(5, cap_total)
    out = []
    off = 0
    for q in range(q_rows):
        cnt = int(counts[q])
        out.append(
            [
                RLE(
                    start=int(cols[0, off + s]),
                    end=int(cols[1, off + s]),
                    matches=int(cols[2, off + s]),
                    mismatches=int(cols[3, off + s]),
                    jumps=int(cols[4, off + s]),
                )
                for s in range(cnt)
            ]
        )
        off += cnt
    return out


def _rle_from_device_chars(chars_dev, lengths_dev):
    """Device chars [Q, L] -> RLE lists via the global segment table: one
    flat counts+table fetch sized by the true total segment count
    (capacity-quadrupling retry)."""
    Q, L = chars_dev.shape
    cap = _bucket(max(128, 2 * Q), lo=128)
    while True:
        vec = rle_segments_global_core(chars_dev, lengths_dev, cap)
        out = _rle_structs_global(vec.cpu().numpy(), Q, cap)
        if out is not None:
            return out
        cap = min(cap * 4, Q * ((L + 1) // 2 + 1))


def find_rle_batch(index: SbwtIndex, code_list: list[np.ndarray],
                   threshold: int, device=None):
    """Batched find segments with device RLE extraction (max_gap_len == 0
    semantics): the full chars array never leaves the device."""
    chars, _ms, lengths_dev = _run_pipeline(index, code_list, threshold, device)
    return _rle_from_device_chars(chars, lengths_dev)
