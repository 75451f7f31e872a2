"""Batched device pipelines: MS -> derandomize -> translate -> RLE
(PyTorch; counterpart of kbo_tpu/pipeline.py).

The throughput (``find``/``matches``) hot path: a [Q, L] batch of padded
queries goes in; alignment characters and MS values come out with no host
round trips between stages. MS comes from the sort-join engine
(kbo_tpu_torch.kernels.ms): the 2-bit join against an index, or the 3-bit
join against a device-built sequence index (``*_seq``);
derandomize/translate/RLE from kbo_tpu_torch.kernels.postprocess.

The host clock of each step goes to the run's stats: ``find_pack`` (pad
and upload), ``find_join`` (the join and derandomize_translate launches),
``find_fetch`` (each device-to-host fetch) and ``find_rle`` (the segment
lists built on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels.ms import (
    INVALID,
    _bucket as _kernel_bucket,
    ms2_core,
    ms3_values_vs_sorted_seq_core,
)
from kbo_tpu_torch.kernels.postprocess import (
    derandomize_translate,
    rle_segments_global_core,
)
from kbo_tpu_torch.ops.format import RLE
from kbo_tpu_torch.utils.stats import get_stats, stage


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
    query's length are not results (garbage on the CPU, 0 from the CUDA
    kernel); mask with lengths.
    """
    Q, L = codes.shape
    buf = _make_buf(codes, k)
    ms = _flat_ms_to_batch(ms2_core(keys2, cap2, buf, k), Q, L, k)
    return derandomize_translate(ms, k, threshold, lengths), ms


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


def pack_codes_host(codes: np.ndarray, lengths) -> np.ndarray | None:
    """2-bit pack a clean [Q, L] code batch, 4 bases a byte, base j of a
    byte in bits 2j..2j+1 (the order of kernels.mapsweep.pack_ascii_host):
    the mesh find path's query upload is a quarter of the raw bytes.
    Returns None when any in-length code is outside 1..4 (N runs, '$') or
    L % 4 != 0: the caller uploads the raw batch. Tail padding needs no
    exception list: :func:`decode_packed_codes_device` writes INVALID past
    each row's length."""
    Q, L = codes.shape
    if L % 4:
        return None
    lens = np.asarray(lengths)[:Q]
    in_len = np.arange(L, dtype=np.int64)[None, :] < lens[:, None]
    if (in_len & ((codes < 1) | (codes > 4))).any():
        return None
    v = (
        np.where(in_len, codes, 1).astype(np.uint8) - np.uint8(1)
    ).reshape(Q, L // 4, 4).view(np.uint32)[..., 0] & np.uint32(0x03030303)
    return ((v | (v >> 6) | (v >> 12) | (v >> 18)) & 0xFF).astype(np.uint8)


def decode_packed_codes_device(packed4: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`pack_codes_host`: the exact [Q, L] codes (1..4
    within each row's length, INVALID past it)."""
    Q, Lp = packed4.shape
    parts = [(packed4 >> (2 * j)) & 3 for j in range(4)]
    u2 = torch.stack(parts, dim=-1).reshape(Q, Lp * 4) + 1
    idx = torch.arange(Lp * 4, dtype=torch.int32, device=packed4.device)
    in_len = idx[None, :] < lengths.to(torch.int32)[:, None]
    return torch.where(in_len, u2, INVALID).to(torch.uint8)


def _run_pipeline(index, code_list, threshold: int, device):
    from kbo_tpu_torch.engine import device_index

    dev = device_index(index, device)
    with stage("find_pack"):
        codes, lengths = pad_batch(code_list, bucket=True)
        lengths_dev = torch.from_numpy(lengths).to(dev.device)
        codes_dev = torch.from_numpy(codes).to(dev.device)
    with stage("find_join"):
        chars, ms = matches_pipeline_core(
            dev.keys2, dev.cap2, codes_dev, lengths_dev, dev.k, threshold,
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
    with stage("find_fetch"):
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
    (capacity-quadrupling retry, counted as ``find_rle_retries``)."""
    Q, L = chars_dev.shape
    cap = _bucket(max(128, 2 * Q), lo=128)
    while True:
        with stage("find_fetch"):
            vec = rle_segments_global_core(chars_dev, lengths_dev, cap)
            vec = vec.cpu().numpy()
        with stage("find_rle"):
            out = _rle_structs_global(vec, Q, cap)
        if out is not None:
            return out
        get_stats().add("find_rle_retries")
        cap = min(cap * 4, Q * ((L + 1) // 2 + 1))


def find_rle_batch(index: SbwtIndex, code_list: list[np.ndarray],
                   threshold: int, device=None):
    """Batched find segments with device RLE extraction (max_gap_len == 0
    semantics): the full chars array never leaves the device."""
    chars, _ms, lengths_dev = _run_pipeline(index, code_list, threshold, device)
    return _rle_from_device_chars(chars, lengths_dev)


def _run_pipeline_seq(dev_index, code_list, threshold: int):
    """chars [Q, L] and lengths on the device against a
    :class:`kbo_tpu_torch.kernels.ms.DeviceSeqIndex`."""
    with stage("find_pack"):
        codes, lengths = pad_batch(code_list, bucket=True)
        lengths_dev = torch.from_numpy(lengths).to(dev_index.device)
        codes_dev = torch.from_numpy(codes).to(dev_index.device)
    with stage("find_join"):
        ms = ms3_values_vs_sorted_seq_core(
            dev_index.ref_words, codes_dev, dev_index.k
        )
        chars = derandomize_translate(ms, dev_index.k, threshold,
                                      lengths_dev)
    return chars, lengths_dev


def matches_batch_seq(dev_index, code_list: list[np.ndarray],
                      threshold: int) -> list[np.ndarray]:
    """Translated alignment chars (uint8 arrays) for a batch of queries
    against a device-built sequence index (the index-free find path)."""
    chars, _ = _run_pipeline_seq(dev_index, code_list, threshold)
    with stage("find_fetch"):
        chars = chars.cpu().numpy()
    return [chars[i, : c.size] for i, c in enumerate(code_list)]


def find_rle_batch_seq(dev_index, code_list: list[np.ndarray], threshold: int):
    """Device-RLE find (max_gap_len == 0) against a device-built sequence
    index."""
    return _rle_from_device_chars(
        *_run_pipeline_seq(dev_index, code_list, threshold)
    )
