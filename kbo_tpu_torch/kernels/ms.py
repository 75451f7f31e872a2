"""Batched matching statistics on the device via the sorted k-mer join
(PyTorch; counterpart of kbo_tpu/kernels/ms.py, value path only).

MS[i] = best over index rows s of min(lcp(window_i, s), cap_s), where lcp is
the common colex prefix of packed 2-bit window keys (last char most
significant) and cap_s is k for real k-mer rows and the real-suffix length
for '$'-padded dummy rows. The join packs the query windows, radix-sorts
them, merges them with the presorted index table (:func:`merge_path`), runs
one clamped-LCP scan per direction (:func:`clamp_scan`) and sorts back to
position order. On CUDA tensors the merge and the scans are hand-written
kernels; on CPU tensors they are their plain versions.

Key words are uint32 bit patterns in int32 tensors of shape ``[W, n]``
(see kernels/sort.py).

Golden vector to verify: query vs 18-base ref gives MS
[1,2,2,3,2,2,3,2,1,2,3,1,1,1,2,3,1,2] (reference: src/index.rs:238-240).
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels.join import clamp_scan
from kbo_tpu_torch.kernels.sort import _radix_sort, merge_path, to_i32, u32

INVALID = 255
_BIG = 2**31 - 1

# slots addressable by the 24-bit id in the single-payload packed join;
# beyond this _neighbor_best switches to the two-operand fallback
# (tests force it lower to exercise the fallback at small sizes)
_PACKED_SLOT_LIMIT = (1 << 24) - 1


def w2_for_k(k: int) -> int:
    return (k + 15) // 16


def resolve_device(device=None) -> torch.device:
    """The device to run on: the CUDA card unless the caller names one.
    Without a card, ``device=None`` raises rather than falling back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


# --------------------------------------------------------------- packing


def _shift_up_const(x: torch.Tensor, t: int, fill) -> torch.Tensor:
    """y[p] = x[p - t] with the first t entries filled (static t)."""
    if t == 0:
        return x
    out = torch.full_like(x, fill)
    if t < x.shape[0]:
        out[t:] = x[: x.shape[0] - t]
    return out


def _doubling_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive left-to-right cummax along the last axis, by log-depth
    doubling passes as in kbo_tpu. Not ``torch.cummax``: on CUDA it scans a
    long row in one thread block (12 ms for one 4.7 M row on an H100)."""
    L = x.shape[-1]
    lowest = torch.iinfo(x.dtype).min
    s = 1
    while s < L:
        pad = torch.full(x.shape[:-1] + (s,), lowest, dtype=x.dtype,
                         device=x.device)
        x = torch.maximum(x, torch.cat([pad, x[..., :-s]], dim=-1))
        s <<= 1
    return x


def pack_windows_2bit(buf: torch.Tensor, k: int):
    """2-bit window keys for every position of a flat code buffer.

    buf: uint8 [T] codes (1..4 real; anything else is a barrier). Returns
    (words int32 [W2, T], limit int32 [T]) where limit[p] = min(k, length of
    the valid run ending at p).
    """
    T = buf.shape[0]
    c = (buf.to(torch.int64) - 1) & 3
    valid = (buf >= 1) & (buf <= 4)
    idx = torch.arange(T, dtype=torch.int32, device=buf.device)
    last_bad = _doubling_cummax(torch.where(valid, -1, idx))
    limit = torch.clamp(idx - last_bad, max=k)
    # word w is word 0 shifted 16w positions; the last word masks chunks at
    # distances >= k (bit-identical with the per-chunk formulation)
    w0 = torch.zeros(T, dtype=torch.int64, device=buf.device)
    for j in range(min(16, k)):
        w0 = w0 | (_shift_up_const(c, j, 0) << (30 - 2 * j))
    words = [w0]
    for w in range(1, w2_for_k(k)):
        words.append(_shift_up_const(w0, 16 * w, 0))
    jmax = (k - 1) % 16
    if k % 16:
        words[-1] = words[-1] & ((0xFFFFFFFF << (30 - 2 * jmax)) & 0xFFFFFFFF)
    return to_i32(torch.stack(words)), limit


# ------------------------------------------------------------ sort-join


def _clamp_both(sw, cap, bits: int):
    """max of forward/backward clamped-LCP scans (>= 0)."""
    f = clamp_scan(sw, cap, bits, reverse=False)
    b = clamp_scan(sw, cap, bits, reverse=True)
    return torch.clamp(torch.maximum(f, b), min=0)


def _neighbor_best(ref_words, ref_cap, q_words, q_meta, bits: int):
    """Best min(lcp, cap) of each query key against the reference keys.

    ref_words: int32 [W, n] sorted key words; ref_cap: int32 [n] per-row caps
    in chunk units (1..254); q_words/q_meta: int32 [W, L] query keys and
    [L] identifiers (< 2**23). Returns int32 [L] >= 0 in q_meta order.

    Source identity and the back-sort ride ONE uint32 payload:
    (slot24 << 8) | capbyte, with capbyte 0xFF marking query slots and
    slot24 0xFFFFFF marking reference slots (they sort after every query in
    the back-sort). The scan result overwrites the low byte before the
    back-sort.
    """
    n = ref_words.shape[1]
    L = q_words.shape[1]
    device = q_words.device
    if n + L >= _PACKED_SLOT_LIMIT:
        # very large inputs: no room for a 24-bit slot id, so cap and meta
        # ride as separate operands of one concat + radix sort
        sw, (cap_s, meta_s) = _radix_sort(
            torch.cat([ref_words, q_words], dim=1),
            [
                torch.cat([
                    ref_cap.to(torch.int32),
                    torch.full((L,), -1, dtype=torch.int32, device=device),
                ]),
                torch.cat([
                    torch.full((n,), _BIG, dtype=torch.int32, device=device),
                    q_meta.to(torch.int32),
                ]),
            ],
        )
        c = _clamp_both(sw, cap_s, bits)
        return c[torch.argsort(meta_s)][:L]
    sw, spacked, f, b = _merge_scan(ref_words, ref_cap, q_words, q_meta, bits)
    c = torch.clamp(torch.maximum(f, b), min=0)
    out_packed = (u32(spacked) & 0xFFFFFF00) | torch.clamp(c, max=255)
    back = torch.sort(out_packed).values[:L]
    return (back & 255).to(torch.int32)


def _merge_scan(ref_words, ref_cap, q_words, q_meta, bits: int):
    """Packed merge + directional clamped-LCP scans.

    Packs reference and query slots into the single payload (see
    :func:`_neighbor_best`), radix-sorts the query side, merges it with the
    sorted reference table (:func:`merge_path`) and runs both scan
    directions (:func:`clamp_scan`). Returns (sw, spacked, f, b) in merged
    order. On CPU tensors the merge's plain version is the concat + radix
    sort of kbo_tpu's non-TPU branch, with the same merged order.
    """
    ref_packed = to_i32(0xFFFFFF00 | u32(ref_cap))
    q_packed = to_i32((q_meta.to(torch.int64) << 8) | 0xFF)
    qs, (qp,) = _radix_sort(q_words, [q_packed])
    sw, spacked = merge_path(ref_words.contiguous(), ref_packed, qs, qp)
    capbyte = spacked & 0xFF
    cap = torch.where(capbyte == 0xFF, -1, capbyte)
    f = clamp_scan(sw, cap, bits, reverse=False)
    b = clamp_scan(sw, cap, bits, reverse=True)
    return sw, spacked, f, b


def ms2_core(keys2, cap2, buf, k: int):
    """Value-only MS for every position of a flat code buffer (2-bit join).

    keys2: int32 [W2, n_rows] 2-bit keys of ALL rows (real + dummy), sorted
    by 2-bit key; cap2: int32 [n_rows] per-row caps; buf: uint8 [T] with k-1
    leading pad entries per query segment. Returns ms int32 [T] (entries at
    pad positions are garbage).
    """
    q_words, limit = pack_windows_2bit(buf, k)
    meta = torch.arange(buf.shape[0], dtype=torch.int32, device=buf.device)
    c = _neighbor_best(keys2, cap2, q_words, meta, bits=2)
    return torch.minimum(c, limit)


class DeviceIndex:
    """An SbwtIndex's 2-bit sort-join tables resident on a device.

    The host-built ``keys2`` / ``cap2`` are uploaded as they are (kbo_tpu's
    ``KBO_TPU_UPLOAD_INDEX=1`` branch); the on-device table rebuild and the
    3-bit tables come with later slices of the port.
    """

    def __init__(self, index: SbwtIndex, device=None):
        if index.keys2 is None:
            raise ValueError("index built without join keys")
        self.device = resolve_device(device)
        keys2 = np.ascontiguousarray(index.keys2, dtype=np.uint32)
        self.keys2 = torch.from_numpy(keys2.view(np.int32)).to(self.device)
        self.cap2 = torch.from_numpy(
            np.ascontiguousarray(index.cap2, dtype=np.int32)
        ).to(self.device)
        self.n_rows = int(index.n_rows)
        self.n_kmers = int(index.n_kmers)
        self.k = int(index.k)


def _bucket(n: int, lo: int = 1024) -> int:
    """Round up to 1/8-octave steps (kbo_tpu's shape bucketing, kept so
    buffers and outputs have the same shapes as there)."""
    if n <= lo:
        return lo
    p = 1 << (int(n).bit_length() - 1)
    step = max(1, p >> 3)
    return ((n + step - 1) // step) * step


def make_flat_buffer(codes: np.ndarray, k: int):
    """Sentinel-pad one query into a bucketed flat buffer.

    Returns (buf uint8 [k-1+Lp], L). Window position i of the query is
    buffer position k-1+i.
    """
    L = int(codes.size)
    Lp = _bucket(L)
    buf = np.full(k - 1 + Lp, INVALID, dtype=np.uint8)
    buf[k - 1 : k - 1 + L] = np.asarray(codes, dtype=np.uint8)
    return buf, L


def query_ms_values_device(index, codes: np.ndarray, device=None):
    """MS values (int64 [L] on the host) for one encoded query (2-bit join).
    ``index`` is a :class:`DeviceIndex` or an :class:`SbwtIndex` to upload
    to ``device``."""
    dev = index if isinstance(index, DeviceIndex) else DeviceIndex(index, device)
    buf, L = make_flat_buffer(np.asarray(codes), dev.k)
    ms = ms2_core(dev.keys2, dev.cap2, torch.from_numpy(buf).to(dev.device), dev.k)
    return ms[dev.k - 1 : dev.k - 1 + L].cpu().numpy().astype(np.int64)
