"""Variant calling between a query and a reference (host numpy around the
device joins; counterpart of kbo_tpu/refine/variant_calling.py).

Mirrors the reference module (reference: src/variant_calling.rs):

- :class:`Variant`                      (src/variant_calling.rs:8-19)
- :func:`resolve_variant`               (src/variant_calling.rs:139-201)
- :func:`call_variants`                 (src/variant_calling.rs:249-294)

The MS row of the streamed sequence, the sparse intervals at the anchor
candidates and the per-candidate k-mer MS re-runs all come from the sort
joins on the chosen device (kbo_tpu_torch.engine); the case analysis runs
on the host, where the candidates (one per variant site) are few.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kbo_tpu_torch import engine
from kbo_tpu_torch.index.encode import CODE_TO_ASCII, DOLLAR, encode_ascii
from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels import ms as ms_kernels
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.utils.stats import get_stats, stage

# the most candidate positions one anchor probe of the device branch takes
# (:func:`_anchors_device` splits the drops into slabs of at most this
# many candidates; 2 * this + the index's rows stays under 2**31)
_ANCHOR_SLAB = 1 << 22


@dataclasses.dataclass
class Variant:
    """A difference between query and reference at ``query_pos``.

    Empty ``query_chars`` = deletion; empty ``ref_chars`` = insertion
    (reference: src/variant_calling.rs:8-19).
    """

    query_pos: int
    query_chars: bytes
    ref_chars: bytes


class ResolveVariantErr(Exception):
    """Raised when a variant cannot be resolved (codes mirror the reference)."""

    def __init__(self, code: int, message: str = ""):
        self.code = code
        super().__init__(f"{message}: Could not resolve variant." if code == 1
                         else "Could not resolve variant.")


def get_kmer_ending_at(query: bytes, end_pos: int, k: int) -> bytes:
    """k-mer of `query` ending at `end_pos`, $-padded on the left if short
    (reference: src/variant_calling.rs:46-58)."""
    if end_pos >= k - 1:
        return bytes(query[end_pos + 1 - k : end_pos + 1])
    n_dollars = k - 1 - end_pos
    return b"$" * n_dollars + bytes(query[: end_pos + 1])


def longest_common_suffix(x: bytes, y: bytes) -> int:
    n = 0
    for i in range(min(len(x), len(y))):
        if x[len(x) - 1 - i] == y[len(y) - 1 - i]:
            n += 1
        else:
            break
    return n


def get_rightmost_significant_peak(ms: np.ndarray, threshold: int):
    """Rightmost i with ms[i] >= threshold and ms[i] > ms[i+1], or None
    (reference: src/variant_calling.rs:73-83)."""
    for i in range(len(ms) - 2, -1, -1):
        if ms[i] >= threshold and ms[i] > ms[i + 1]:
            return i
    return None


def resolve_variant(
    query_kmer: bytes,
    ref_kmer: bytes,
    ms_vs_query: np.ndarray,
    ms_vs_ref: np.ndarray,
    significant_match_threshold: int,
) -> tuple[bytes, bytes]:
    """Resolve the variant between two k-mers just before their common suffix.

    ``ms_vs_query`` is the MS of ``ref_kmer`` against the query index;
    ``ms_vs_ref`` the MS of ``query_kmer`` against the reference index
    (reference: src/variant_calling.rs:139-201). Raises ResolveVariantErr.
    """
    k = len(query_kmer)
    assert len(ref_kmer) == k
    assert len(ms_vs_query) == k
    assert len(ms_vs_ref) == k

    common_suffix_len = longest_common_suffix(query_kmer, ref_kmer)
    assert common_suffix_len > 0

    query_ms_peak = get_rightmost_significant_peak(
        ms_vs_ref, significant_match_threshold)
    ref_ms_peak = get_rightmost_significant_peak(
        ms_vs_query, significant_match_threshold)

    if query_ms_peak is not None and ref_ms_peak is not None:
        suffix_match_start = k - common_suffix_len
        # negative gap means overlap
        query_gap = suffix_match_start - query_ms_peak - 1
        ref_gap = suffix_match_start - ref_ms_peak - 1
        if query_gap > 0 and ref_gap > 0:
            return (
                bytes(query_kmer[query_ms_peak + 1 : suffix_match_start]),
                bytes(ref_kmer[ref_ms_peak + 1 : suffix_match_start]),
            )
        query_overlap = -query_gap
        ref_overlap = -ref_gap
        if query_overlap == ref_overlap:
            raise ResolveVariantErr(1, "query_overlap == ref_overlap")
        variant_len = abs(query_overlap - ref_overlap)
        if query_overlap > ref_overlap:
            # deletion in query
            return (b"", bytes(
                ref_kmer[ref_ms_peak + 1 : ref_ms_peak + 1 + variant_len]))
        # insertion in query
        return (bytes(
            query_kmer[query_ms_peak + 1 : query_ms_peak + 1 + variant_len]),
            b"")

    raise ResolveVariantErr(0)


def call_variants(
    sbwt_ref: SbwtIndex,
    sbwt_query,
    query: bytes,
    max_error_prob: float,
    noisy_ms: np.ndarray | None = None,
    ivals=None,
    drops: np.ndarray | None = None,
    anchors: np.ndarray | None = None,
    anchor_rows: np.ndarray | None = None,
    resident=None,
    ms_many=None,
    device=None,
) -> list[Variant]:
    """Call all variants between `query` and the reference index.

    Semantics mirror the reference exactly (src/variant_calling.rs:249-294),
    restructured for batch execution:

    1. the MS drops below the threshold (the variant-start signal), from
       ``noisy_ms`` (the full-length MS of ``query`` against ``sbwt_ref``),
       or ``drops`` given by the caller, or one 2-bit join here;
    2. per drop, the first anchor j in (i, i+k] with ms[j] >= d and a
       unique colex interval: given (``anchors`` / ``anchor_rows``, aligned
       with ``drops``, -1 = unanchored), or on the device from
       ``resident`` = (the query's int32 MS row, the uint8 flat code
       buffer it was computed from, both resident; see
       :func:`kbo_tpu_torch.kernels.ms.query_ms_row_and_buffer_device`)
       in one gated probe per slab of drops (:func:`_anchors_device`), or
       from ``ivals`` (an :class:`kbo_tpu_torch.engine.SparseIntervals`)
       in rounds of 8 offsets, or from one sparse interval probe over all
       k offsets;
    3. the query k-mer ending at each anchor and the reference k-mer of its
       row re-run against the other side, both batches on the device and
       fetched together as ONE uint8 transfer, then the vectorized case
       analysis (:func:`_resolve_all`). ``ms_many(index, codes)`` takes
       the re-runs against an index instead (a ``data`` mesh's sharded
       form, kbo_tpu_torch.parallel.mesh.ms_values_many_sharded); the
       other phases run on ``device``.

    ``sbwt_query`` is an :class:`SbwtIndex` or a raw code array (the
    reference's build-an-index-inside-call(), src/lib.rs:553: its k-mer
    re-runs join against the sequence's own window keys). ``device`` is the
    device of the joins (None: the CUDA card). The host clock of each phase
    goes to the run's stats (``call_drops``, ``call_anchors`` with the
    ``call_anchor_rounds`` counter (a round or a device probe each), the
    ``call_anchor_probe_positions`` counter (the device probes' gated
    positions) and, inside it, ``call_anchor_fetch`` around the anchor
    search's fetches, ``call_kmer_joins``,
    ``call_resolve``); the first three end in a fetch, so they include
    their device work.
    """
    if isinstance(sbwt_query, SbwtIndex):
        assert sbwt_ref.k == sbwt_query.k
    k = sbwt_ref.k
    d = random_match_threshold(k, sbwt_ref.n_kmers, 4, max_error_prob)

    query = bytes(query)
    n = len(query)
    codes = encode_ascii(query)
    ms = np.asarray(noisy_ms) if noisy_ms is not None else None
    if drops is None:
        with stage("call_drops"):
            if ms is None:
                ms = engine.compute_ms_values(sbwt_ref, codes, device)
            # phase 1: MS drops below threshold (the variant-start signal)
            drops = np.flatnonzero(
                (ms[1:] < ms[:-1]) & (ms[:-1] >= d) & (ms[1:] < d)
            ) + 1
    else:
        drops = np.asarray(drops, dtype=np.int64)
    if drops.size == 0:
        return []
    with stage("call_anchors"):
        sites, anchors, anchor_rows = _anchors(
            sbwt_ref, codes, n, k, d, drops, ms, ivals, anchors, anchor_rows,
            resident, device,
        )
    if sites.size == 0:
        return []

    # phase 3: the k-mers at each anchor. Query k-mers ending at the anchor
    # come from ONE window gather over the encoded query ('$'-padding for
    # anchors < k-1, reference: src/variant_calling.rs:46-58); the raw
    # ASCII windows ride along so that resolved slices keep the original
    # bytes
    with stage("call_kmer_joins"):
        ref_kmers_codes = sbwt_ref.access_kmers_codes(anchor_rows)
        qbytes = np.frombuffer(query, dtype=np.uint8)
        widx = anchors[:, None] + np.arange(-(k - 1), 1,
                                            dtype=np.int64)[None, :]
        in_range = widx >= 0
        qk_ascii = np.where(
            in_range, qbytes[np.maximum(widx, 0)], np.uint8(ord("$"))
        ).astype(np.uint8)
        qk_mat = np.where(in_range, codes[np.maximum(widx, 0)],
                          np.uint8(DOLLAR))
        qk_codes = list(qk_mat.astype(np.uint8))
        rk_codes = [ref_kmers_codes[t] for t in range(len(sites))]

        if ms_many is not None:
            # the re-runs against an index by the caller's form; those
            # against the raw sequence stay on one device
            ms_vs_ref = np.stack(ms_many(sbwt_ref, qk_codes))
            if isinstance(sbwt_query, SbwtIndex):
                ms_vs_query = np.stack(ms_many(sbwt_query, rk_codes))
            else:
                ms_vs_query = np.stack(engine.compute_ms_values_vs_seq(
                    sbwt_query, rk_codes, k, device))
        else:
            # both batches are independent: dispatch both, then ONE fetch
            # of the stacked pair
            ms_vs_ref_dev = engine.compute_ms_values_many_device(
                sbwt_ref, qk_codes, device
            )
            if isinstance(sbwt_query, SbwtIndex):
                ms_vs_query_dev = engine.compute_ms_values_many_device(
                    sbwt_query, rk_codes, device
                )
            else:
                # raw encoded sequence: the join against its window keys
                ms_vs_query_dev = engine.compute_ms_values_vs_seq_device(
                    sbwt_query, rk_codes, k, ms_vs_ref_dev.device
                )
            # MS values are in [0, k] (k <= 254): the pair crosses as uint8
            both = torch.stack([ms_vs_ref_dev, ms_vs_query_dev]).to(torch.uint8)
            both = both.cpu().numpy().astype(np.int64)
            ms_vs_ref, ms_vs_query = both[0], both[1]
    with stage("call_resolve"):
        return _resolve_all(sites, ref_kmers_codes, qk_ascii,
                            ms_vs_ref[:, :k], ms_vs_query[:, :k], d)


def _anchors(sbwt_ref, codes, n: int, k: int, d: int, drops, ms, ivals,
             anchors, anchor_rows, resident, device):
    """Phase 2 of :func:`call_variants`: (sites, anchors, anchor rows) of
    the drops that anchor: the first j in (i, i+k] with ms[j] >= d and a
    unique interval, read sparsely at the candidate windows only. The
    branch follows what the caller holds: anchors, a resident row and
    code buffer, an interval provider, or neither."""
    anchor = np.full(drops.size, -1, dtype=np.int64)
    pre_rows = None
    if anchors is not None:
        anchor = np.asarray(anchors, dtype=np.int64)
        pre_rows = np.asarray(anchor_rows, dtype=np.int64)
    elif resident is not None:
        anchor, pre_rows = _anchors_device(sbwt_ref, *resident, drops, k, d)
    elif ivals is not None:
        # rounds of 8 offsets: almost every drop anchors within a few
        # positions (MS recovers right after the variant), so only the
        # unresolved drops go on to the next round
        pending = np.arange(drops.size)
        for off0 in range(1, k + 1, 8):
            offs = np.arange(off0, min(off0 + 8, k + 1), dtype=np.int64)
            j = drops[pending][:, None] + offs[None, :]
            valid = j < n
            pos = np.unique(j[valid])
            if pos.size == 0:
                break
            get_stats().add("call_anchor_rounds")
            with stage("call_anchor_fetch"):
                iv = ivals.get_batch(pos)
                msb = ivals.get_ms_batch(pos)
            ok_at = (msb >= d) & (iv[:, 1] - iv[:, 0] == 1)
            loc = np.searchsorted(pos, np.minimum(j, pos[-1]))
            good = (
                valid
                & ok_at[np.minimum(loc, ok_at.size - 1)]
                & (pos[np.minimum(loc, pos.size - 1)] == j)
            )
            has = good.any(axis=1)
            first = np.argmax(good, axis=1)
            anchor[pending[has]] = np.take_along_axis(
                j, first[:, None], axis=1
            ).ravel()[has]
            pending = pending[~has]
            if pending.size == 0:
                break
    else:
        cand = np.unique(
            (drops[:, None] + np.arange(1, k + 1)[None, :]).reshape(-1)
        )
        cand = cand[cand < n]
        cand_ms, cand_iv = engine.compute_ms_intervals_at(
            sbwt_ref, codes, cand, ms=ms, device=device
        )
        good_c = (cand_ms >= d) & (cand_iv[:, 1] - cand_iv[:, 0] == 1)
        for off in range(1, k + 1):
            j = drops + off
            m = (anchor < 0) & (j < n)
            cidx = np.searchsorted(cand, j[m])
            m[m] = good_c[cidx]
            anchor[m] = j[m]
    sel = anchor >= 0
    sites = drops[sel]
    if pre_rows is not None:
        return sites, anchor[sel], pre_rows[sel]
    if ivals is not None:
        with stage("call_anchor_fetch"):
            rows = ivals.get_batch(anchor[sel])[:, 0]
        return sites, anchor[sel], rows
    return sites, anchor[sel], cand_iv[np.searchsorted(cand, anchor[sel]), 0]


def _anchors_device(sbwt_ref, ms_row, code_buf, drops, k: int, d: int):
    """(anchor or -1, its row or -1) int64 [D] per drop, searched on the
    device over the resident MS row (int32 [n]) and code buffer (k-1
    INVALID, then the codes).

    The candidates j = drop + off, off in 1..k, form [D, k] on the device;
    those with j < n and ms[j] >= d (the only ones that can anchor) are
    compacted and probed for their colex intervals in one
    :func:`kbo_tpu_torch.kernels.ms._intervals_from_keys` a slab of drops
    (at most ``_ANCHOR_SLAB`` candidates), their keys gathered from one
    3-bit pack of the code buffer. A drop's anchor is its first candidate
    with a unique interval, its row that interval's start. Two fetches
    whatever the number of drops: the gated counts (sizing the
    compactions), then one stacked int32 [2, D].
    """
    device = ms_row.device
    keys3 = engine.device_index(sbwt_ref, device).keys3
    n, D = ms_row.shape[0], drops.size
    none = np.full(D, -1, dtype=np.int64)
    if D == 0:
        return none, none
    drops_t = torch.from_numpy(drops.astype(np.int32)).to(device)
    offs = torch.arange(1, k + 1, dtype=torch.int32, device=device)
    per = max(1, _ANCHOR_SLAB // k)
    slabs = [(s, min(s + per, D)) for s in range(0, D, per)]

    def gated(s, e):
        j = (drops_t[s:e, None] + offs[None, :]).reshape(-1)
        ms_j = ms_row[torch.clamp(j, max=n - 1).long()]
        return j, ms_j, (j < n) & (ms_j >= d)

    counts = torch.stack([gated(s, e)[2].sum() for s, e in slabs])
    with stage("call_anchor_fetch"):
        counts = counts.cpu().tolist()
    if not any(counts):
        return none, none
    words = ms_kernels.pack_windows_3bit(code_buf, k)
    out = torch.full((2, D), -1, dtype=torch.int32, device=device)
    for (s, e), G in zip(slabs, counts):
        if G == 0:
            continue
        j, ms_j, ok = gated(s, e)
        # compaction to the G gated slots, whose count is known (no
        # sync): every other slot scatters to the spare entry G
        dest = torch.where(ok, torch.cumsum(ok, 0) - 1, G)
        slot = torch.zeros(G + 1, dtype=torch.int64, device=device)
        slot.scatter_(0, dest, torch.arange(j.shape[0], device=device))
        slot = slot[:G]
        jg = j[slot].long()
        l, r = ms_kernels._intervals_from_keys(
            keys3, words[:, jg + (k - 1)], ms_j[slot]
        )
        get_stats().add("call_anchor_rounds")
        get_stats().add("call_anchor_probe_positions", G)
        good = torch.zeros(j.shape[0], dtype=torch.bool, device=device)
        good.scatter_(0, slot, r - l == 1)
        rows = torch.zeros(j.shape[0], dtype=torch.int32, device=device)
        rows.scatter_(0, slot, l)
        first = torch.where(
            good.reshape(-1, k), offs[None, :] - 1, k
        ).amin(dim=1)
        has = first < k
        row = rows.reshape(-1, k).gather(
            1, torch.clamp(first, max=k - 1).long()[:, None]
        )[:, 0]
        out[0, s:e] = torch.where(has, drops_t[s:e] + first + 1, -1)
        out[1, s:e] = torch.where(has, row, -1)
    with stage("call_anchor_fetch"):
        res = out.cpu().numpy().astype(np.int64)
    return res[0], res[1]


def _rightmost_peaks(ms: np.ndarray, d: int) -> np.ndarray:
    """Per row: rightmost i <= k-2 with ms[i] >= d and ms[i] > ms[i+1],
    else -1 (vectorized src/variant_calling.rs:73-83)."""
    mask = (ms[:, :-1] >= d) & (ms[:, :-1] > ms[:, 1:])
    has = mask.any(axis=1)
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    return np.where(has, last, -1)


def _resolve_all(
    sites, ref_kmers_codes, qk_ascii,
    ms_vs_ref, ms_vs_query, d: int,
) -> list[Variant]:
    """Vectorized resolve_variant over all candidate sites.

    Case analysis identical to the scalar spec :func:`resolve_variant`
    (reference: src/variant_calling.rs:139-201). Sites that the reference
    rejects (no significant peak, equal overlaps) drop out via masks
    instead of exceptions.
    """
    sites = np.asarray(sites)
    if sites.size == 0:
        return []
    k = qk_ascii.shape[1]
    rk_ascii = CODE_TO_ASCII[np.asarray(ref_kmers_codes, dtype=np.uint8)]
    ms_vs_ref = np.asarray(ms_vs_ref)[:, :k]
    ms_vs_query = np.asarray(ms_vs_query)[:, :k]

    eq = qk_ascii == rk_ascii
    csl = np.cumprod(eq[:, ::-1], axis=1).sum(axis=1)  # common suffix len
    assert (csl > 0).all()

    qpeak = _rightmost_peaks(ms_vs_ref, d)  # peak in the query k-mer's MS
    rpeak = _rightmost_peaks(ms_vs_query, d)
    ok = (qpeak >= 0) & (rpeak >= 0)

    sms = k - csl  # suffix_match_start
    qgap = sms - qpeak - 1
    rgap = sms - rpeak - 1
    subst = ok & (qgap > 0) & (rgap > 0)
    indel = ok & ~subst & (qgap != rgap)  # equal overlaps are unresolvable
    is_del = indel & (-qgap > -rgap)  # query overlap larger = deletion
    vlen = np.abs(qgap - rgap)

    calls: list[Variant] = []
    for t in np.flatnonzero(subst | indel).tolist():
        if subst[t]:
            qc = qk_ascii[t, qpeak[t] + 1 : sms[t]].tobytes()
            rc = rk_ascii[t, rpeak[t] + 1 : sms[t]].tobytes()
        elif is_del[t]:
            qc = b""
            rc = rk_ascii[t, rpeak[t] + 1 : rpeak[t] + 1 + vlen[t]].tobytes()
        else:
            qc = qk_ascii[t, qpeak[t] + 1 : qpeak[t] + 1 + vlen[t]].tobytes()
            rc = b""
        calls.append(
            Variant(query_pos=int(sites[t]), query_chars=qc, ref_chars=rc)
        )
    return calls
