"""Batched matching statistics on the device via the sorted k-mer join
(PyTorch; counterpart of kbo_tpu/kernels/ms.py: the 2-bit value join and
the 3-bit rows join).

MS[i] = best over index rows s of min(lcp(window_i, s), cap_s), where lcp is
the common colex prefix of packed 2-bit window keys (last char most
significant) and cap_s is k for real k-mer rows and the real-suffix length
for '$'-padded dummy rows. The join packs the query windows, radix-sorts
them, merges them with the presorted index table (:func:`merge_path`), runs
one clamped-LCP scan per direction (:func:`clamp_scan`) and sorts back to
position order. On CUDA tensors the merge and the scans are hand-written
kernels; on CPU tensors they are their plain versions.

The rows join (:func:`ms3_rows_core`) runs the same merge and scans over
3-bit keys of ALL index rows ('$' has its own chunk value, so every cap is
k) and also yields, per position, whether the matched suffix's colex
interval has width 1 and which row it is -- what the map path needs.

Key words are uint32 bit patterns in int32 tensors of shape ``[W, n]``
(see kernels/sort.py).

Golden vector to verify: query vs 18-base ref gives MS
[1,2,2,3,2,2,3,2,1,2,3,1,1,1,2,3,1,2] (reference: src/index.rs:238-240).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from kbo_tpu_torch import native
from kbo_tpu_torch.index.encode import (
    decode_codes,
    encode_ascii,
    revcomp_ascii,
    split_segments,
)
from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels.join import _common_chunks, clamp_scan
from kbo_tpu_torch.kernels.sort import (
    _radix_sort,
    bitonic_merge,
    merge_path,
    to_i32,
    u32,
)
from kbo_tpu_torch.utils.stats import get_stats, stage

INVALID = 255
_BIG = 2**31 - 1

# slots addressable by the 24-bit id in the single-payload packed join;
# beyond this _neighbor_best switches to the two-operand fallback
# (tests force it lower to exercise the fallback at small sizes)
_PACKED_SLOT_LIMIT = (1 << 24) - 1


def w2_for_k(k: int) -> int:
    return (k + 15) // 16


def w3_for_k(k: int) -> int:
    return (k + 9) // 10


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


def device_scope(device: torch.device):
    """The context that makes ``device`` current for the work inside it:
    ``torch.cuda.device`` for a card, nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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
    limit = window_limits(buf, k)
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


def pack_windows_3bit(buf: torch.Tensor, k: int, pad_chunk: int = 7):
    """3-bit window keys ('$'/invalid/pre-start -> ``pad_chunk``) for every
    position of a flat code buffer: int32 [W3, T], 10 chunks per word under
    2 zero lead bits. Query sides pad with 7."""
    T = buf.shape[0]
    valid = (buf >= 1) & (buf <= 4)
    c = torch.where(valid, buf.to(torch.int64), pad_chunk)
    # word w = word 0 shifted 10w positions (see pack_windows_2bit);
    # before-start positions read an all-pad word, and the last word masks
    # distances >= k
    w0 = torch.zeros(T, dtype=torch.int64, device=buf.device)
    for j in range(min(10, k)):
        w0 = w0 | (_shift_up_const(c, j, pad_chunk) << (27 - 3 * j))
    padw = pad_chunk * 0o1111111111
    words = [w0]
    for w in range(1, w3_for_k(k)):
        words.append(_shift_up_const(w0, 10 * w, padw))
    jmax = (k - 1) % 10
    if k % 10:
        words[-1] = words[-1] & ((0xFFFFFFFF << (27 - 3 * jmax)) & 0x3FFFFFFF)
    return to_i32(torch.stack(words))


def window_limits(buf: torch.Tensor, k: int) -> torch.Tensor:
    """int32 [T]: min(k, length of the valid-char run ending at p)."""
    valid = (buf >= 1) & (buf <= 4)
    idx = torch.arange(buf.shape[0], dtype=torch.int32, device=buf.device)
    last_bad = _doubling_cummax(torch.where(valid, -1, idx))
    return torch.clamp(idx - last_bad, max=k)


_SCAN_BLOCK = 1024


def _carry_nearest(v: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Propagate the nearest source value (entries >= 0) to every slot,
    inclusive. -1 marks non-source slots; slots with no source on the scan
    side keep -1. Two-level (within-block doubling, a block-total scan, one
    combine): take-first-set is associative."""
    L = v.shape[0]

    def shifted(x, s):
        pad = torch.full(x.shape[:-1] + (s,), -1, dtype=x.dtype, device=x.device)
        if reverse:
            return torch.cat([x[..., s:], pad], dim=-1)
        return torch.cat([pad, x[..., :-s]], dim=-1)

    def flat(x):
        s = 1
        while s < x.shape[-1]:
            x = torch.where(x >= 0, x, shifted(x, s))
            s <<= 1
        return x

    if L <= 4 * _SCAN_BLOCK:
        return flat(v)
    S = _SCAN_BLOCK
    B = -(-L // S)
    pad = torch.full((B * S - L,), -1, dtype=v.dtype, device=v.device)
    vb = flat(torch.cat([v, pad]).reshape(B, S))
    tot = vb[:, 0] if reverse else vb[:, -1]  # nearest source per block
    tot_x = flat(shifted(tot, 1))
    return torch.where(vb >= 0, vb, tot_x[:, None]).reshape(B * S)[:L]


# ------------------------------------------------------------ sort-join


def _clamp_both(sw, cap, bits: int):
    """max of forward/backward clamped-LCP scans (>= 0)."""
    f = clamp_scan(sw, cap, bits, reverse=False)
    b = clamp_scan(sw, cap, bits, reverse=True)
    return torch.clamp(torch.maximum(f, b), min=0)


def _neighbor_best(ref_words, ref_cap, q_words, q_meta, bits: int,
                   merge: str = "path", ref_sorted: bool = True):
    """Best min(lcp, cap) of each query key against the reference keys.

    ref_words: int32 [W, n] key words (sorted when ``ref_sorted``);
    ref_cap: int32 [n] per-row caps in chunk units (1..254);
    q_words/q_meta: int32 [W, L] query keys and [L] identifiers (< 2**23).
    Returns int32 [L] >= 0 in q_meta order.

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
    sw, spacked, f, b = _merge_scan(
        ref_words, ref_cap, q_words, q_meta, bits, merge=merge,
        ref_sorted=ref_sorted,
    )
    c = torch.clamp(torch.maximum(f, b), min=0)
    out_packed = (u32(spacked) & 0xFFFFFF00) | torch.clamp(c, max=255)
    back = torch.sort(out_packed).values[:L]
    return (back & 255).to(torch.int32)


def _merge_scan(ref_words, ref_cap, q_words, q_meta, bits: int,
                q_aux=None, ref_packed=None, merge: str = "path",
                ref_sorted: bool = True):
    """Packed merge + directional clamped-LCP scans.

    Packs reference and query slots into the single payload (see
    :func:`_neighbor_best`), radix-sorts the query side, merges it with the
    sorted reference table (:func:`merge_path`) and runs both scan
    directions (:func:`clamp_scan`). Returns (sw, spacked, f, b) in merged
    order. On CPU tensors the merge's plain version is the concat + radix
    sort of kbo_tpu's non-TPU branch, with the same merged order.

    ``ref_packed`` (int32 [n]) is a reference payload packed ahead of time,
    read in place of ``ref_cap``: its low byte is the cap, and its high 24
    bits, the constant 0xFFFFFF otherwise, are room for per-row data to
    ride the merge (kbo_tpu's ``ref_hi24``; see :func:`rows_ref_packed`).
    ``q_aux`` (int32 [L]) rides the query sort, and the return grows
    to (sw, spacked, f, b, (q_sorted_words, q_aux_sorted)): the query-side
    sorted table, free here because the merge needs the query side sorted.

    ``merge="bitonic"`` merges with :func:`bitonic_merge` instead (kbo_tpu's
    ``KBO_TPU_MERGE_PATH=0`` choice, ``slice_output=False``): the merged
    arrays stay padded to a power of two, and the pads (all-ones keys,
    payload 0xFFFFFFFF) run through the scans as non-source query slots with
    slot id 0xFFFFFF, which every back-to-order step drops.

    ``ref_sorted=False`` takes reference keys in no order (a sequence's own
    window keys): the reference and query slots are concatenated and go
    through one stable radix sort, with no merge (kbo_tpu's concat branch;
    ``merge`` and ``q_aux`` do not apply).
    """
    if ref_packed is None:
        ref_packed = to_i32(0xFFFFFF00 | u32(ref_cap))
    q_packed = to_i32((q_meta.to(torch.int64) << 8) | 0xFF)
    if not ref_sorted:
        sw, (spacked,) = _radix_sort(
            torch.cat([ref_words, q_words], dim=1),
            [torch.cat([ref_packed, q_packed])],
        )
        return (sw, spacked) + _scans(sw, spacked, bits)
    pays = [q_packed] if q_aux is None else [q_packed, q_aux]
    qs, qpays = _radix_sort(q_words, pays)
    if merge == "path":
        sw, spacked = merge_path(ref_words.contiguous(), ref_packed, qs, qpays[0])
    elif merge == "bitonic":
        W = ref_words.shape[0]
        merged = bitonic_merge(
            torch.cat([ref_words, ref_packed[None]]),
            torch.cat([qs, qpays[0][None]]),
            W,
        )
        sw, spacked = merged[:W], merged[W]
    else:
        raise ValueError(f"merge must be 'path' or 'bitonic', not {merge!r}")
    f, b = _scans(sw, spacked, bits)
    if q_aux is not None:
        return sw, spacked, f, b, (qs, qpays[1])
    return sw, spacked, f, b


def _scans(sw, spacked, bits: int):
    """The forward and backward clamped-LCP scans over merged slots whose
    payload's low byte is the cap (0xFF: a query slot, no source)."""
    capbyte = spacked & 0xFF
    cap = torch.where(capbyte == 0xFF, -1, capbyte)
    return (clamp_scan(sw, cap, bits, reverse=False),
            clamp_scan(sw, cap, bits, reverse=True))


def ms2_core(keys2, cap2, buf, k: int, merge: str = "path"):
    """Value-only MS for every position of a flat code buffer (2-bit join).

    keys2: int32 [W2, n_rows] 2-bit keys of ALL rows (real + dummy), sorted
    by 2-bit key; cap2: int32 [n_rows] per-row caps; buf: uint8 [T] with k-1
    leading pad entries per query segment. Returns ms int32 [T] (entries at
    pad positions are garbage).
    """
    q_words, limit = pack_windows_2bit(buf, k)
    meta = torch.arange(buf.shape[0], dtype=torch.int32, device=buf.device)
    c = _neighbor_best(keys2, cap2, q_words, meta, bits=2, merge=merge)
    return torch.minimum(c, limit)


def ms3_core(keys3, buf, k: int):
    """MS values for every buffer position via the 3-bit (all-rows) join."""
    q_words = pack_windows_3bit(buf, k)
    meta = torch.arange(buf.shape[0], dtype=torch.int32, device=buf.device)
    cap = torch.full((keys3.shape[1],), k, dtype=torch.int32, device=buf.device)
    c = _neighbor_best(keys3, cap, q_words, meta, bits=3)
    return torch.clamp(c, max=k)


def lcs3_from_keys3(keys3, k: int):
    """int32 [n] longest common suffix (in chars, capped at k) between
    colex-adjacent rows; entry 0 is 0. One elementwise pass over the keys
    (the reference's LcsArray semantics, derived from the key table)."""
    prev = torch.cat([~keys3[:, :1], keys3[:, :-1]], dim=1)
    # row 0's synthetic predecessor differs in the top bits, where the clz
    # chunk arithmetic yields -1; clamp to the true "no common suffix" 0
    return torch.clamp(_common_chunks(keys3, prev, 3), 0, k)


def rows_ref_packed(lcs3, k: int):
    """The rows join's reference payload, static per index:
    ``(lcs3 | lcs3_up << 7) << 8 | min(k, 254)`` with ``lcs3_up[i] =
    lcs3[i + 1]`` (0 past the table). kbo_tpu caches padded DMA streams of
    the same data (``get_rows_merge_streams``); the CUDA merge reads the
    key table in place and needs only this payload."""
    lcs = lcs3.to(torch.int64)
    lcs_up = torch.cat([lcs[1:], torch.zeros_like(lcs[:1])])
    return to_i32(((lcs | (lcs_up << 7)) << 8) | min(k, 254))


def _rows_scan_pieces(keys3, ref_packed, buf, k: int,
                      want_qtable: bool = False, merge: str = "path"):
    """Shared merge + scans of the rows join: per merged slot, the
    directional clamped LCPs, the nearest-left row index, and the
    adjacent-row LCS values at the prospective block edges.

    The adjacent-row LCS pair rides the merge in the reference slots'
    otherwise-constant high payload bits (k < 128 so each value fits 7
    bits): down = lcs3[row] (common suffix with the row below), up =
    lcs3[row + 1] (with the row above; 0 past the table). The
    nearest-source carry scans resolve a missing side to 0 = "no row beyond
    the table edge"; left/right-best themselves imply a source row exists.
    ``ref_packed`` is that payload, :func:`rows_ref_packed` of the index's
    ``lcs3`` (``DeviceIndex.rows_packed``).
    """
    n = keys3.shape[1]
    T = buf.shape[0]
    assert n + T < (1 << 24) - 1, "packed path requires < 16.7M slots"
    assert k < 128, "ms rides 7 bits of the back-sort payload"
    q_words = pack_windows_3bit(buf, k)
    meta = torch.arange(T, dtype=torch.int32, device=buf.device)
    out = _merge_scan(
        keys3, None, q_words, meta, 3, ref_packed=ref_packed,
        q_aux=window_limits(buf, k) if want_qtable else None, merge=merge,
    )
    sw, spacked, f, b = out[:4]
    qtable = out[4] if want_qtable else None
    is_ref = (spacked & 0xFF) != 0xFF
    # nearest reference row on each side (colex index = rank among rows);
    # with uniform caps the nearest row attains the best lcp, so the side
    # with the strictly larger lcp holds the matched block's edge row
    xl = torch.cumsum(is_ref, dim=0, dtype=torch.int32) - 1
    down_slot = torch.where(is_ref, (spacked >> 8) & 0x7F, -1)
    up_slot = torch.where(is_ref, (spacked >> 15) & 0x7F, -1)
    near_down = torch.clamp(_carry_nearest(down_slot, reverse=False), min=0)
    near_up = torch.clamp(_carry_nearest(up_slot, reverse=True), min=0)
    return sw, spacked, is_ref, f, b, xl, near_down, near_up, qtable


def ms3_rows_core(keys3, ref_packed, buf, k: int, want_qtable: bool = False,
                  merge: str = "path"):
    """(ms, uniq, row) for EVERY buffer position via ONE 3-bit join.

    The colex interval of position i's matched suffix (length ms[i]) has
    width 1 iff, around the query key's insertion point, exactly one
    adjacent row shares a length-ms[i] prefix and the block does not extend
    past it -- an LCS-array identity (the block of rows sharing a depth-m
    prefix is delimited by lcs < m).

    Returns (ms int32 [T] in [0, k], uniq bool [T], row int32 [T] = the
    colex row of the unique match, valid where uniq). ``want_qtable``
    appends the sorted query-side window keys + per-window caps ((words,
    limits), see :func:`_merge_scan`). ``ref_packed`` is the index's cached
    :func:`rows_ref_packed` (kbo_tpu passes ``lcs3`` here and packs it per
    call). ``merge`` picks the merge of :func:`_merge_scan`.
    """
    sw, spacked, is_ref, f, b, xl, near_down, near_up, qtable = (
        _rows_scan_pieces(keys3, ref_packed, buf, k, want_qtable, merge)
    )
    n = keys3.shape[1]
    T = buf.shape[0]
    f = torch.clamp(f, max=k)
    b = torch.clamp(b, max=k)
    ms_slot = torch.clamp(torch.maximum(f, b), min=0)
    left_best = f > b
    right_best = b > f
    x = torch.where(left_best, xl, xl + 1)
    lcsv = torch.where(left_best, near_down, near_up)
    uniq_slot = (
        (ms_slot > 0) & (left_best | right_best) & (lcsv < ms_slot)
        & (x >= 0) & (x < n)
    )
    # back to query order: every buffer position owns exactly one query
    # slot, so a scatter by slot id (reference slots go to a spare entry)
    # stands for kbo_tpu's single-key back-sort; the payload packs
    # (row 24b | ms 7b | uniq 1b). The bitonic merge's pads carry slot id
    # 0xFFFFFF and go to the spare entry with the reference slots.
    dest = torch.where(is_ref, T, (spacked >> 8) & 0xFFFFFF)
    dest = torch.clamp(dest, max=T).to(torch.int64)
    payload = to_i32(
        (torch.clamp(x, 0, n - 1).to(torch.int64) << 8)
        | (ms_slot << 1) | uniq_slot
    )
    out = torch.zeros(T + 1, dtype=torch.int32, device=buf.device)
    out.scatter_(0, dest, payload)
    out = out[:T]
    ms = (out >> 1) & 0x7F
    uniq = (out & 1).to(torch.bool)
    row = (out >> 8) & 0xFFFFFF
    if want_qtable:
        return ms, uniq, row, qtable
    return ms, uniq, row


_X24 = (1 << 24) - 1


def ms3_rows_partial_core(keys3, lcs_down, lcs_up_next, row_offset: int, buf,
                          k: int):
    """One shard's half of the rows join over a prefix-sharded key table.

    ``keys3`` [W, m] is a contiguous colex range of the table starting at
    global row ``row_offset`` (all-ones pad columns past the table);
    ``lcs_down`` / ``lcs_up_next`` [m] are the GLOBAL LCS values of its rows
    (lcs[row_offset + i] and lcs[row_offset + i + 1], 0 past the table).
    They ride the merge in the reference payload
    ``((down | up << 7) << 8) | min(k, 254)``, as :func:`rows_ref_packed`
    lays it out for the whole table. Returns two int64 [T] packs in buffer
    order:

        fpack = (f+1) << 32 | global_x << 8 | down     (0 = no row left)
        bpack = (b+1) << 32 | (2^24-1 - global_x) << 8 | up

    An elementwise max over the shards (``parallel.mesh.pmax``) gives the
    global nearest-row data: the lcp first, then the row nearest the
    query's insertion point (the largest x on the left, the smallest on the
    right; a block over a shard edge makes two shards report one lcp).
    :func:`ms3_rows_from_packed` finishes it. Rows ride 24 bits, so the
    table holds fewer than 2^24 rows.
    """
    lcs_down = lcs_down.to(torch.int64)
    lcs_up_next = lcs_up_next.to(torch.int64)
    ref_packed = to_i32(((lcs_down | (lcs_up_next << 7)) << 8) | min(k, 254))
    sw, spacked, is_ref, f, b, xl, near_down, near_up, _ = _rows_scan_pieces(
        keys3, ref_packed, buf, k
    )
    T = buf.shape[0]
    xl = xl.to(torch.int64)
    gx_l = torch.clamp(xl + row_offset, 0, _X24)
    gx_r = torch.clamp(xl + 1 + row_offset, 0, _X24)
    fpack = torch.where(
        f >= 0,
        ((f.to(torch.int64) + 1) << 32) | (gx_l << 8) | near_down,
        0,
    )
    bpack = torch.where(
        b >= 0,
        ((b.to(torch.int64) + 1) << 32) | ((_X24 - gx_r) << 8) | near_up,
        0,
    )
    # back to buffer order by a scatter on slot id: reference slots go to a
    # spare entry, as in ms3_rows_core
    dest = torch.where(is_ref, T, (spacked >> 8) & 0xFFFFFF)
    dest = torch.clamp(dest, max=T).to(torch.int64)
    out = torch.zeros((2, T + 1), dtype=torch.int64, device=buf.device)
    out[0].scatter_(0, dest, fpack)
    out[1].scatter_(0, dest, bpack)
    return out[0, :T], out[1, :T]


def ms3_rows_from_packed(fpack, bpack, n_rows: int, k: int):
    """Finish the sharded rows join: the max-reduced packs of
    :func:`ms3_rows_partial_core` -> (ms int32, uniq bool, row int32), as
    :func:`ms3_rows_core` gives them (rows where uniq holds)."""
    gf = (fpack >> 32).to(torch.int32) - 1
    xf = ((fpack >> 8) & _X24).to(torch.int32)
    downf = (fpack & 0xFF).to(torch.int32)
    gb = (bpack >> 32).to(torch.int32) - 1
    xr = _X24 - ((bpack >> 8) & _X24).to(torch.int32)
    upr = (bpack & 0xFF).to(torch.int32)
    f = torch.clamp(gf, max=k)
    b = torch.clamp(gb, max=k)
    ms = torch.clamp(torch.maximum(f, b), min=0)
    left_best = f > b
    right_best = b > f
    x = torch.where(left_best, xf, xr)
    lcsv = torch.where(left_best, downf, torch.where(right_best, upr, 0))
    uniq = ((ms > 0) & (left_best | right_best) & (lcsv < ms) & (x >= 0)
            & (x < n_rows))
    return ms, uniq, x


def _intervals_from_keys(keys3, q_words, ms, merge: str = "path"):
    """Colex intervals [l, r) of the length-ms prefixes of the given 3-bit
    query keys, counted over ALL rows (dummies included -- the 3-bit key
    space is the true colex order, so no dummy rank adjustment exists).
    ms == 0 yields the empty-pattern interval [0, n_rows).

    keys3: int32 [W, n] sorted table; q_words: int32 [W, P]; ms: [P].
    Returns (l, r) int32 [P]. Each pattern becomes a floor probe (its
    unmatched chunks cleared) and a ceil probe (set); one merge of the
    probes into the table and a count of the rows before each probe give
    the interval. The merge compares W + 1 key rows: the words, then a rank
    row (floor 0, table 1, ceil 2) that puts a floor before equal table
    keys (they belong to its interval) and, at ms == k, a ceil after the
    row equal to the full pattern; the probe's slot rides as the payload.
    ``merge="bitonic"`` merges with :func:`bitonic_merge` (kbo_tpu's
    ``KBO_TPU_MERGE_PATH=0`` choice: W + 2 operand rows).
    """
    W, P = q_words.shape
    n = keys3.shape[1]
    if 2 * P + n >= 2**31 - 1:
        # the probe slot rides the merge as an int32 payload
        raise ValueError(
            f"the interval probe merges {2 * P} probes with {n} rows: past "
            f"the int32 slot payload's 2**31 - 1 slots"
        )
    device = q_words.device
    w_off = 10 * torch.arange(W, dtype=torch.int64, device=device)[:, None]
    keep = torch.clamp(ms.to(torch.int64)[None] - w_off, 0, 10)
    ones = (1 << (30 - 3 * keep)) - 1
    floors = u32(q_words) & ~ones
    probe_keys = torch.cat([
        to_i32(torch.cat([floors, floors | ones], dim=1)),
        torch.cat([
            torch.zeros((1, P), dtype=torch.int32, device=device),
            torch.full((1, P), 2, dtype=torch.int32, device=device),
        ], dim=1),
    ])
    # stable LSD keeps equal keys in slot order, so the probe side is
    # sorted by (words, rank) as the merge requires
    probe_keys, (probe_slot,) = _radix_sort(
        probe_keys, [torch.arange(2 * P, dtype=torch.int32, device=device)]
    )
    ref_keys = torch.cat([
        keys3, torch.ones((1, n), dtype=torch.int32, device=device)
    ])
    ref_slot = torch.full((n,), _BIG, dtype=torch.int32, device=device)
    if merge == "path":
        sk, sslot = merge_path(ref_keys, ref_slot, probe_keys, probe_slot)
    elif merge == "bitonic":
        merged = bitonic_merge(
            torch.cat([ref_keys, ref_slot[None]]),
            torch.cat([probe_keys, probe_slot[None]]),
            W + 1,
        )
        sk, sslot = merged[: W + 1], merged[W + 1]
    else:
        raise ValueError(f"merge must be 'path' or 'bitonic', not {merge!r}")
    is_ref = (sk[W] == 1).to(torch.int32)
    before = torch.cumsum(is_ref, dim=0, dtype=torch.int32) - is_ref
    # back to probe order: table slots (_BIG) and the bitonic merge's
    # all-ones pads land in the spare entry 2P
    dest = torch.clamp(u32(sslot), max=2 * P)
    out = torch.zeros(2 * P + 1, dtype=torch.int32, device=device)
    out.scatter_(0, dest, before)
    return out[:P], out[P : 2 * P]


def intervals3_core(keys3, buf, ms, k: int):
    """Colex intervals [l, r) of each buffer position's matched suffix."""
    return _intervals_from_keys(keys3, pack_windows_3bit(buf, k), ms)


def intervals3_windows_core(keys3, windows, ms, k: int, merge: str = "path"):
    """Full-row colex intervals for a [P, k] window matrix given its MS
    values (from the value sweep -- never recomputed here).

    The sparse interval path: the refinement layers (variant calling, gap
    filling) only read intervals at data-dependent candidate positions.
    """
    P = windows.shape[0]
    words_all = pack_windows_3bit(windows.reshape(-1), k, pad_chunk=7)
    q_words = words_all.reshape(-1, P, k)[:, :, k - 1]
    return _intervals_from_keys(keys3, q_words, ms, merge)


def _intervals3_windows_msrow(keys3, windows, ms_row, pos, k: int):
    """Sparse interval probe reading MS values from a device-resident row.

    ms_row: int32 [L] query-coordinate MS values (never fetched whole);
    pos: int32 [Pb] positions (pad entries clipped; their rows are INVALID
    windows whose outputs the caller drops). Returns one stacked int32
    [3, Pb] (l, r, ms_at), so the host pays a single fetch.
    """
    ms_at = ms_row[torch.clamp(pos, max=ms_row.shape[0] - 1).to(torch.int64)]
    l, r = intervals3_windows_core(keys3, windows, ms_at, k)
    return torch.stack([l, r, ms_at.to(torch.int32)])


def intervals_at_positions_core(keys3, codes_row, ms_row, pos, k: int):
    """(l, r, ms_at) colex-interval probe at device-resident positions.

    codes_row: uint8 [L] resident code row; ms_row: int32 [L] resident MS
    row; pos: int32 [P]. The [P, k] window matrix is gathered on the
    device.
    """
    pos = pos.to(torch.int64)
    ms_at = ms_row[torch.clamp(pos, max=ms_row.shape[0] - 1)]
    idx = pos[:, None] + torch.arange(
        -(k - 1), 1, dtype=torch.int64, device=pos.device
    )[None, :]
    windows = torch.where(
        idx >= 0, codes_row[torch.clamp(idx, min=0)], INVALID
    ).to(torch.uint8)
    l, r = intervals3_windows_core(keys3, windows, ms_at, k)
    return l, r, ms_at.to(torch.int32)


def _intervals3_pos(keys3, codes_row, ms_row, pos, k: int):
    """Sparse interval probe with device-side window assembly; one stacked
    int32 [3, Pb] (l, r, ms_at) for a single fetch."""
    return torch.stack(
        intervals_at_positions_core(keys3, codes_row, ms_row, pos, k)
    )


def ms3_batch_vs_seq_core(ref_buf, q_codes, k: int):
    """Per-position MS of a [Q, L] probe batch against a raw sequence.

    The "index" side is the sequence's OWN window keys -- every position of
    ref_buf, 3-bit packed with pad chunk 5, no sorting, dedup or host
    construction (duplicates and $-padded partial windows do not change
    best-match values, and chunk 5 reproduces '$' boundary semantics
    exactly: it never matches a probe's real chars 1..4 nor the probe-side
    pad 7). This is the reference's build-an-index-inside-call() pattern
    (src/lib.rs:553) on the device: the variant caller's per-candidate
    k-mer MS re-runs join directly against the reference sequence.
    Returns ms int32 [Q, L].
    """
    ref_words = pack_windows_3bit(ref_buf, k, pad_chunk=5)
    Q, L = q_codes.shape
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8,
                     device=q_codes.device)
    qbuf = torch.cat([pad, q_codes], dim=1).reshape(-1)
    q_words = pack_windows_3bit(qbuf, k, pad_chunk=7)
    meta = torch.arange(qbuf.shape[0], dtype=torch.int32, device=qbuf.device)
    cap = torch.full((ref_buf.shape[0],), k, dtype=torch.int32,
                     device=qbuf.device)
    # the sequence-side keys are NOT presorted: one sort of the
    # concatenation, no merge shortcut
    c = _neighbor_best(ref_words, cap, q_words, meta, bits=3,
                       ref_sorted=False)
    return torch.clamp(c, max=k).reshape(Q, L + k - 1)[:, k - 1 :]


class DeviceIndex:
    """An SbwtIndex's sort-join tables resident on a device.

    The host-built ``keys2`` / ``cap2`` / ``keys3`` are uploaded as they are
    (kbo_tpu's ``KBO_TPU_UPLOAD_INDEX=1`` branch; an index built on the
    device is a :class:`DeviceFullIndex`). ``keys2`` / ``cap2`` go
    up at construction; ``keys3``, ``lcs3`` and the rows join's static
    reference payload ``rows_packed`` are made once, at the first read (the
    map path's), so an index that only serves find never holds them.
    """

    def __init__(self, index: SbwtIndex, device=None):
        if index.keys2 is None:
            raise ValueError("index built without join keys")
        self.device = resolve_device(device)
        self.n_rows = int(index.n_rows)
        self.n_kmers = int(index.n_kmers)
        self.k = int(index.k)

        self._index = index
        self.keys2 = self._put(index.keys2, np.uint32)
        self.cap2 = self._put(index.cap2, np.int32)

    def _put(self, table, dtype):
        table = np.ascontiguousarray(table, dtype=dtype)
        if dtype is np.uint32:
            table = table.view(np.int32)
        return torch.from_numpy(table).to(self.device)

    @functools.cached_property
    def keys3(self):
        return self._put(self._index.keys3, np.uint32)

    @functools.cached_property
    def lcs3(self):
        return lcs3_from_keys3(self.keys3, self.k)

    @functools.cached_property
    def rows_packed(self):
        # k >= 128 has no rows join (the payload carries 7-bit LCS values)
        return rows_ref_packed(self.lcs3, self.k) if self.k < 128 else None


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


def query_ms_device(index, codes: np.ndarray, device=None):
    """MS values and colex intervals of one encoded query from the 3-bit
    join (:func:`ms3_core`, then :func:`intervals3_core` over the same
    flat buffer): (ms int64 [L], intervals int64 [L, 2]) on the host, the
    device counterpart of ``kbo_tpu_torch.ops.ms.query_ms_codes``.
    ``index`` is a :class:`DeviceIndex` (a :class:`DeviceFullIndex` too),
    taken as it is, or an :class:`SbwtIndex` to upload to ``device``."""
    dev = index if isinstance(index, DeviceIndex) else DeviceIndex(index, device)
    buf, L = make_flat_buffer(np.asarray(codes), dev.k)
    buf = torch.from_numpy(buf).to(dev.device)
    ms = ms3_core(dev.keys3, buf, dev.k)
    l, r = intervals3_core(dev.keys3, buf, ms, dev.k)
    s = slice(dev.k - 1, dev.k - 1 + L)
    out = torch.stack([ms[s], l[s], r[s]]).cpu().numpy().astype(np.int64)
    return out[0], np.ascontiguousarray(out[1:].T)


def query_ms_row_device(index, codes: np.ndarray, device=None):
    """Device-resident int32 MS row [L] of one encoded query (2-bit join),
    never fetched: callers that only need sparse reads (drop detection,
    interval probes) fetch compacted results instead of the full vector.
    ``index`` is a :class:`DeviceIndex` or an :class:`SbwtIndex` to upload
    to ``device``."""
    return query_ms_row_and_buffer_device(index, codes, device)[0]


def query_ms_row_and_buffer_device(index, codes: np.ndarray, device=None):
    """(MS row, code buffer): the row of :func:`query_ms_row_device` and
    the uint8 flat buffer it was computed from (:func:`make_flat_buffer`:
    k-1 INVALID, the codes, INVALID up to the bucket), both resident.
    Query position j is buffer position k-1+j, so the buffer's 3-bit
    window keys (:func:`pack_windows_3bit`) at k-1+j are those of the
    query's window ending at j."""
    dev = index if isinstance(index, DeviceIndex) else DeviceIndex(index, device)
    buf, L = make_flat_buffer(np.asarray(codes), dev.k)
    buf = torch.from_numpy(buf).to(dev.device)
    ms = ms2_core(dev.keys2, dev.cap2, buf, dev.k)
    return ms[dev.k - 1 : dev.k - 1 + L], buf


def ms_drops_device(ms_row, d: int) -> np.ndarray:
    """Drop positions (int64, ascending, on the host) of a device MS row:
    i >= 1 with ms[i] < ms[i-1], ms[i-1] >= d and ms[i] < d, the
    reference's variant-start signal (src/variant_calling.rs:269). One mask
    and one ``torch.nonzero`` on the device; only the positions cross."""
    prev, cur = ms_row[:-1], ms_row[1:]
    mask = (cur < prev) & (prev >= d) & (cur < d)
    return torch.nonzero(mask).flatten().cpu().numpy().astype(np.int64) + 1


# ------------------------------------------------- device-built seq index


def _seq_keys3(buf, k: int):
    """Sorted 3-bit window keys of a sequence buffer + the count of its
    distinct full k-mers (int32 scalar tensor). The 'index' is the
    sequence's own window keys (pad chunk 5, see
    :func:`ms3_batch_vs_seq_core`), sorted so that queries take the merge;
    duplicates stay (they do not change best-match values)."""
    words = pack_windows_3bit(buf, k, pad_chunk=5)
    # a window is full iff its valid run reaches k (window_limits uses the
    # doubling cummax, not torch.cummax)
    full = (window_limits(buf, k) == k).to(torch.int32)
    sw, (sfull,) = _radix_sort(words, [full])
    prev = torch.cat([sw[:, :1] ^ 1, sw[:, :-1]], dim=1)
    neq = (sw != prev).any(dim=0)
    return sw, (neq & (sfull == 1)).sum(dtype=torch.int32)


def seq_index_buffer(seqs: list[bytes], k: int,
                     add_revcomp: bool = False) -> np.ndarray:
    """A :class:`DeviceSeqIndex`'s construction buffer, written from the
    contigs' raw bytes by the native library (:func:`native.index_text`):
    :func:`make_flat_buffer` of each contig's codes, with ``add_revcomp``
    also its reverse complement's, one INVALID between neighbours.
    :func:`seq_index_buffer_plain` is its numpy form."""
    if not seqs:
        raise ValueError("cannot build an index from empty input")
    return native.index_text(seqs, k, add_revcomp, False, _bucket)[0]


def seq_index_buffer_plain(seqs: list[bytes], k: int,
                           add_revcomp: bool = False) -> np.ndarray:
    """The numpy form of :func:`seq_index_buffer`, same bytes: the plain
    version the tests hold the native pass against."""
    if not seqs:
        raise ValueError("cannot build an index from empty input")
    parts = []
    sep = np.array([INVALID], dtype=np.uint8)
    for s in seqs:
        s = bytes(s)
        parts += [encode_ascii(s), sep]
        if add_revcomp:
            parts += [encode_ascii(revcomp_ascii(s)), sep]
    buf, _ = make_flat_buffer(np.concatenate(parts[:-1]), k)
    return buf


class DeviceSeqIndex:
    """An ephemeral, device-built find index: the sequences' sorted 3-bit
    window keys. No host SBWT construction -- for one-shot ``find`` runs
    where building the full index dominates wall time. Supports the MS
    value path only (find/matches); map/call refinement needs the full
    :class:`SbwtIndex`. The build's host clock goes to the run's stats as
    :class:`DeviceFullIndex`'s does.
    """

    def __init__(self, seqs: list[bytes], k: int, add_revcomp: bool = False,
                 device=None):
        with stage("build_pack"):
            buf = seq_index_buffer(seqs, k, add_revcomp)
            get_stats().add("build_pack_bytes", buf.size)
        self.device = resolve_device(device)
        with stage("build_sort"):
            self.ref_words, n_kmers = _seq_keys3(
                torch.from_numpy(buf).to(self.device), k
            )
        with stage("build_fetch"):
            self.n_kmers = int(n_kmers)
        self.k = k


def ms3_values_vs_sorted_seq_core(ref_words, codes, k: int):
    """Per-position MS of a [Q, L] batch against sorted sequence keys
    (:class:`DeviceSeqIndex`): the merge path at bits = 3.

    Tail-pad positions hold garbage; callers mask by length downstream
    (the derandomize pass reads only the true length)."""
    Q, L = codes.shape
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8,
                     device=codes.device)
    buf = torch.cat([pad, codes], dim=1).reshape(-1)
    q_words = pack_windows_3bit(buf, k, pad_chunk=7)
    meta = torch.arange(buf.shape[0], dtype=torch.int32, device=buf.device)
    cap = torch.full((ref_words.shape[1],), k, dtype=torch.int32,
                     device=buf.device)
    c = _neighbor_best(ref_words, cap, q_words, meta, bits=3)
    return torch.clamp(c, max=k).reshape(Q, L + k - 1)[:, k - 1 :]


# ------------------------------------------------ device-built full index

# the all-ones uint32 sentinel key as an int32 bit pattern: it sorts after
# every real key and probe (real 3-bit words keep 2 zero lead bits), since
# every sort and merge here compares words as unsigned
_SENT = -1


def _build_full_core(buf, k: int):
    """The complete join-table set of an index, built on the device.

    buf: uint8 [T] -- k '$' (0) codes before each maximal ACGT segment,
    INVALID tail padding. Three radix sorts: the colex order of every
    selected window (sentinels last, position and window length riding
    along), the deduplicated rows moved to the front (kept keys are
    distinct, so the stable sort keeps their colex order), and the 2-bit
    keys of the kept rows with their caps.

    The row set is the host build's (index/build.py): the distinct
    k-windows ending at the root '$' (position k - 1) and at every ACGT
    position. Duplicates and unselected positions become sentinel rows
    after ``n_rows``: all-ones keys3 (after every probe) with row position
    -1, and in keys2 all-ones keys with cap 0, which the clamped-LCP scan
    treats as contributing nothing.

    Returns (keys3 int32 [W3, T], row_pos int32 [T], keys2 int32 [W2, T],
    cap2 int32 [T], meta int32 [6] = (n_rows, n_kmers, C[0..3])).
    """
    T = buf.shape[0]
    idx = torch.arange(T, dtype=torch.int32, device=buf.device)
    valid = (buf >= 1) & (buf <= 4)
    v = window_limits(buf, k)
    selected = valid | (idx == k - 1)
    w3s = torch.where(selected[None], pack_windows_3bit(buf, k, pad_chunk=0),
                      _SENT)

    # sort 1: colex order, sentinels last
    sw, (spos, sv) = _radix_sort(w3s, [idx, v])
    prev = torch.cat([sw[:, :1] ^ 1, sw[:, :-1]], dim=1)
    keep = (sw[0] != _SENT) & (sw != prev).any(dim=0)
    top = u32(sw[0]) >> 27
    meta = torch.stack(
        [keep.sum(), (keep & (sv == k)).sum()]
        + [(keep & (top <= b)).sum() for b in range(4)]
    ).to(torch.int32)

    # sort 2: deduplicated duplicates join the sentinel tail
    keys3, (row_pos, row_v) = _radix_sort(
        torch.where(keep[None], sw, _SENT),
        [torch.where(keep, spos, -1), torch.where(keep, sv, 0)],
    )

    # sort 3: 2-bit keys of the kept rows, gathered by position; sentinel
    # rows get cap 0
    w2_all, _ = pack_windows_2bit(buf, k)
    kept = row_pos >= 0
    w2g = torch.where(
        kept[None], w2_all[:, torch.clamp(row_pos, min=0).to(torch.int64)],
        _SENT,
    )
    cap = torch.where(kept, torch.clamp(row_v, max=k), 0).to(torch.int32)
    keys2, (cap2,) = _radix_sort(w2g, [cap])
    return keys3, row_pos, keys2, cap2, meta


def full_index_buffer(seqs: list[bytes], k: int, add_revcomp: bool = False):
    """A :class:`DeviceFullIndex`'s construction buffer, written from the
    contigs' raw bytes by the native library (:func:`native.index_text`):
    (buf uint8 [_bucket(n)], n), the text ``buf[:n]`` holding k '$' (0)
    codes before each maximal ACGT segment of each contig, then with
    ``add_revcomp`` of its reverse complement (a literal '$' breaks as any
    non-ACGT byte does, as in :func:`split_segments`), INVALID after.
    :func:`full_index_buffer_plain` is its numpy form."""
    buf, n = native.index_text(seqs, k, add_revcomp, True, _bucket)
    assert n, "cannot build an index from empty input"
    return buf, n


def full_index_buffer_plain(seqs: list[bytes], k: int,
                            add_revcomp: bool = False):
    """The numpy form of :func:`full_index_buffer`, same bytes: the plain
    version the tests hold the native pass against."""
    parts = []
    for s in seqs:
        s = bytes(s)
        segs = split_segments(encode_ascii(s))
        if add_revcomp:
            segs += split_segments(encode_ascii(revcomp_ascii(s)))
        for seg in segs:
            parts.append(np.zeros(k, dtype=np.uint8))
            parts.append(seg)
    assert parts, "cannot build an index from empty input"
    text = np.concatenate(parts)
    buf = np.full(_bucket(text.size), INVALID, dtype=np.uint8)
    buf[: text.size] = text
    return buf, text.size


class DeviceFullIndex(DeviceIndex):
    """An SBWT index built and kept on a device (counterpart of
    kbo_tpu.kernels.ms.DeviceFullIndex; reference build path:
    src/index.rs:56-99).

    It serves the whole query surface (find / matches / map / call) as a
    :class:`DeviceIndex` does: the value join (``keys2`` / ``cap2``), the
    sparse interval probes and the map sweep (``keys3``, whose ``lcs3`` and
    ``rows_packed`` are made at the first read), membership probes
    (:meth:`member_widths`) and k-mer extraction (row positions gathered on
    the device, the text sliced on the host). Its tables carry a sentinel
    tail after ``n_rows`` (see :func:`_build_full_core`). The rank
    bitvectors are never built: no query path of the device execution
    reads them. Only the six metadata scalars cross to the host. The host
    clock of the build goes to the run's stats: ``build_pack`` (the
    construction buffer written on the host, its bytes counted as
    ``build_pack_bytes``), ``build_sort`` (its upload and the sorts'
    launches) and ``build_fetch`` (the scalars), as for
    :class:`DeviceSeqIndex`.
    """

    def __init__(self, seqs: list[bytes], k: int, add_revcomp: bool = False,
                 device=None):
        assert 1 < k < 64
        with stage("build_pack"):
            buf, n = full_index_buffer(seqs, k, add_revcomp)
            get_stats().add("build_pack_bytes", buf.size)
        self.device = resolve_device(device)
        # the tables are plain attributes here, where DeviceIndex uploads
        # keys3 at its first read; lcs3 and rows_packed stay lazy
        with stage("build_sort"):
            self.keys3, self.row_pos, self.keys2, self.cap2, meta = (
                _build_full_core(torch.from_numpy(buf).to(self.device), k)
            )
        self.text = buf[:n]  # host copy of the construction text
        with stage("build_fetch"):
            meta = meta.cpu().numpy()
        self.n_rows = int(meta[0])
        self.n_kmers = int(meta[1])
        self.C = meta[2:6].astype(np.int32)
        self.k = k

    def alphabet(self) -> bytes:
        return b"ACGT"

    def access_kmers_codes(self, rows: np.ndarray) -> np.ndarray:
        """[R, k] code matrix of colex rows: the row positions gather on
        the device (a small fetch), the text slices on the host."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        if rows.size and (rows.min() < 0 or rows.max() >= self.n_rows):
            # sentinel rows carry row_pos -1: slicing with it would wrap
            # into the text's end and return plausible garbage
            raise IndexError(f"colex row out of range [0, {self.n_rows})")
        pos = self.row_pos[torch.from_numpy(rows).to(self.device)]
        pos = pos.cpu().numpy().astype(np.int64)
        offs = np.arange(-self.k + 1, 1, dtype=np.int64)
        return self.text[pos[:, None] + offs[None, :]]

    def access_kmer_codes(self, row: int) -> np.ndarray:
        return self.access_kmers_codes(np.asarray([row]))[0]

    def access_kmer(self, row: int) -> bytes:
        return decode_codes(self.access_kmer_codes(int(row)))

    def member_widths(self, probes: np.ndarray) -> np.ndarray:
        """Colex interval widths (0 or 1: rows are distinct length-k
        strings) of [P, k] full-length code probes: the gap filler's
        membership test, one interval probe on the device."""
        probes = np.asarray(probes, dtype=np.uint8)
        P = probes.shape[0]
        Pb = 64
        while Pb < P:
            Pb <<= 1
        windows = np.full((Pb, self.k), INVALID, dtype=np.uint8)
        windows[:P] = probes
        ms = torch.full((Pb,), self.k, dtype=torch.int32, device=self.device)
        l, r = intervals3_windows_core(
            self.keys3, torch.from_numpy(windows).to(self.device), ms, self.k
        )
        return (r - l)[:P].cpu().numpy().astype(np.int32)
