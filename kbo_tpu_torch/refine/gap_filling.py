"""Gap filling: batched candidate evaluation over colex intervals (host
numpy; counterpart of kbo_tpu/refine/gap_filling.py).

Semantics mirror the reference module (reference: src/gap_filling.rs:
nearest_unique_context :127-151, left_extend_kmer :205-232,
left_extend_over_gap :295-361, fill_gaps :444-526), phase-batched instead
of per-gap sequential:

1. enumerate every gap of the translation (vectorized run detection);
2. ONE batched sparse-interval fetch covers every gap's search window
   (an [n, 2] interval array, or engine.SparseIntervals: one device probe),
   or the device sweep's candidate grid stands in for it (the map path);
3. every unique-context candidate of every gap is evaluated at once: k-mer
   texts from the index, left/right reference-overlap run lengths as
   cumprod reductions over [n_candidates, k] matrices;
4. candidates that need left extension run together: on a device index,
   one walk a lane along its chain table's links (kernels/refine.py
   ``ext_walk``); on a host index, a lane-batched search of membership
   probes for full-length patterns (a binary search over its keys), rank
   probes for shorter ones;
5. per gap, the accepted fill is the first successful candidate in
   descending position order -- the one the reference's sequential scan
   commits to, because candidate evaluations are independent.

The scalar helpers (``nearest_unique_context``, ``left_extend_kmer``,
``left_extend_over_gap``) are the public spec API over the batched core.
The device scorer of the map path (kernels/refine.py ``score_gaps_core``)
hands the gaps over its budgets to ``fill_gaps_patches(..., grid=...)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kbo_tpu_torch.index.encode import (
    CODE_TO_ASCII,
    DOLLAR,
    decode_codes,
    encode_ascii,
)
from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.kernels.ms import DeviceIndex
from kbo_tpu_torch.kernels.refine import ext_walk, get_ext_links
from kbo_tpu_torch.ops.derandomize import log_rm_max_cdf
from kbo_tpu_torch.utils.stats import get_stats

#: sentinel codes that can never equal a k-mer code (0..4)
_OOB = np.uint8(250)


# --------------------------------------------------------------- interval IO
def _intervals_at(ivals, positions: np.ndarray) -> np.ndarray:
    """[P, 2] colex intervals at reference positions, from either a
    materialized [n, 2] array or a lazy provider (engine.SparseIntervals)."""
    positions = np.asarray(positions, dtype=np.int64)
    if hasattr(ivals, "get_batch"):
        return ivals.get_batch(positions)
    return np.asarray(ivals)[positions].reshape(positions.size, 2)


# ------------------------------------------------------- batched SBWT search
def _rank_batch(sbwt: SbwtIndex, base: int, pos: np.ndarray) -> np.ndarray:
    """Vectorized rank: set bits of bitvector `base` in rows [0, pos)."""
    pos = np.asarray(pos, dtype=np.int64)
    nw = sbwt.n_words
    w = pos >> 5
    b = (pos & 31).astype(np.uint32)
    over = w >= nw
    wc = np.minimum(w, nw - 1)
    word = sbwt.bits[base, wc]
    mask = ((np.uint32(1) << b) - np.uint32(1)).astype(np.uint32)
    part = np.bitwise_count(word & mask).astype(np.int64)
    ranks = sbwt.cum[base, wc].astype(np.int64) + part
    if over.any():
        total = int(sbwt.cum[base, -1]) + int(
            np.bitwise_count(sbwt.bits[base, -1])
        )
        ranks = np.where(over, total, ranks)
    return ranks


def search_codes_batch(
    sbwt: SbwtIndex, codes: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Colex intervals of many patterns at once (empty -> l == r).

    codes: uint8 [E, L]. The lane-parallel form of ``SbwtIndex.search_codes``
    (reference: src/gap_filling.rs:217): L extend steps, each a masked
    vectorized rank per base over every live lane.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    E, L = codes.shape
    l = np.zeros(E, dtype=np.int64)
    r = np.full(E, sbwt.n_rows, dtype=np.int64)
    C = np.asarray(sbwt.C, dtype=np.int64)
    for t in range(L):
        c = codes[:, t]
        alive = l < r
        l2 = np.zeros(E, dtype=np.int64)
        r2 = np.zeros(E, dtype=np.int64)
        for b in range(4):
            m = alive & (c == b + 1)
            if not m.any():
                continue
            l2[m] = C[b] + _rank_batch(sbwt, b, l[m])
            r2[m] = C[b] + _rank_batch(sbwt, b, r[m])
        l, r = l2, r2
        if not (l < r).any():
            break
    return l, r


def _row_key_bytes(sbwt: SbwtIndex) -> np.ndarray:
    """Colex row keys as big-endian byte strings (memcmp order == colex
    order), cached on the index. Enables binary-search membership tests:
    a length-k pattern's interval is empty or a singleton (all rows are
    length k), so search reduces to one searchsorted per probe."""
    cached = getattr(sbwt, "_keys3_bytes", None)
    if cached is None:
        w3 = np.ascontiguousarray(np.asarray(sbwt.keys3).T).astype(">u4")
        cached = w3.view(f"|S{4 * w3.shape[1]}").ravel()
        sbwt._keys3_bytes = cached
    return cached


def _pack_probe_bytes(probes: np.ndarray, k: int, W3: int) -> np.ndarray:
    """Pack [P, k] code probes into the index's colex key byte strings."""
    c = probes.astype(np.uint32)
    words = np.zeros((probes.shape[0], W3), dtype=np.uint32)
    for w in range(W3):
        acc = words[:, w]
        for j in range(10):
            t = w * 10 + j
            if t >= k:
                break
            acc |= c[:, k - 1 - t] << np.uint32(27 - 3 * j)
    return np.ascontiguousarray(words).astype(">u4").view(
        f"|S{4 * W3}"
    ).ravel()


def _member_rows(sbwt, probes: np.ndarray) -> np.ndarray:
    """Bool [P]: is each length-k probe exactly an index row? Probes
    containing '$' never match (the oracle's extend() rejects code 0, even
    though a dummy row with that text exists). Host-resident indexes use
    binary search over cached key bytes; device-built indexes probe on
    device (kernels.ms.DeviceFullIndex.member_widths)."""
    no_dollar = ~(probes == DOLLAR).any(axis=1)
    if not isinstance(sbwt, SbwtIndex):
        return (sbwt.member_widths(probes) == 1) & no_dollar
    row_bytes = _row_key_bytes(sbwt)
    pb = _pack_probe_bytes(probes, sbwt.k, sbwt.keys3.shape[0])
    loc = np.searchsorted(row_bytes, pb)
    locc = np.minimum(loc, row_bytes.size - 1)
    return (row_bytes[locc] == pb) & (loc < row_bytes.size) & no_dollar


def _left_extend_batch(
    sbwt: SbwtIndex, kmers: np.ndarray, budgets: np.ndarray
) -> list[np.ndarray]:
    """Left-extend each lane's code k-mer while exactly one of the four
    possible preceding characters yields a unique full-length hit
    (reference: src/gap_filling.rs:205-232), up to the lane's budget.

    kmers: uint8 [E, K0]; budgets: int64 [E]. Every probe keeps the
    original pattern length K0 (prepend one char, drop the trailing char),
    so the probed window slides left one step per round. Probes of length
    K0 == k match at most one row, so each round is a batched binary
    search against the packed colex keys (no rank loops); K0 != k falls
    back to rank probes. Returns the extended code arrays
    (length K0 + e_lane). Each round (one batched probe; a host sync on a
    device-built index) counts in the run's stats as ``host_ext_rounds``.
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    E, K0 = kmers.shape
    budgets = np.asarray(budgets, dtype=np.int64)
    assert K0 == sbwt.k or isinstance(sbwt, SbwtIndex), (
        "short-pattern extension needs a rank-backed host index"
    )

    # Per round and char: (nonempty, singleton) interval masks. The
    # acceptance rule (reference: src/gap_filling.rs:224) is "exactly one
    # char gives a NONEMPTY interval, and that interval is a singleton".
    if K0 == sbwt.k and sbwt.keys3 is not None:
        # full-length probes: rows are distinct length-k strings, so
        # nonempty == singleton == membership (binary search over the
        # packed colex key bytes)
        def probe_intervals(probes, n_lanes):
            m = _member_rows(sbwt, probes).reshape(4, n_lanes)
            return m, m
    else:
        # short patterns: rank-walk interval probes
        def probe_intervals(probes, n_lanes):
            l, r = search_codes_batch(sbwt, probes)
            nonempty = (r > l).reshape(4, n_lanes)
            singleton = ((r - l) == 1).reshape(4, n_lanes)
            return nonempty, singleton

    prefix = kmers[:, : K0 - 1].copy()  # current first K0-1 codes per lane
    prepended: list[list[int]] = [[] for _ in range(E)]
    active = budgets > 0
    spent = np.zeros(E, dtype=np.int64)
    stats = get_stats()
    while active.any():
        stats.add("host_ext_rounds")
        lanes = np.flatnonzero(active)
        P = prefix[lanes]
        probes = np.empty((4, lanes.size, K0), dtype=np.uint8)
        for b in range(4):
            probes[b, :, 0] = b + 1
            probes[b, :, 1:] = P
        nonempty, singleton = probe_intervals(
            probes.reshape(4 * lanes.size, K0), lanes.size
        )
        n_hits = nonempty.sum(axis=0)
        choice = np.argmax(nonempty, axis=0)  # valid only where n_hits == 1
        ok = (n_hits == 1) & singleton[choice, np.arange(lanes.size)]
        for i in np.flatnonzero(ok):
            prepended[lanes[i]].append(int(choice[i]) + 1)
        good = lanes[ok]
        prefix[good, 1:] = prefix[good, :-1]
        prefix[good, 0] = choice[ok] + 1
        spent[good] += 1
        active[:] = False
        active[good] = spent[good] < budgets[good]
    return [
        np.concatenate(
            [np.asarray(prepended[i][::-1], dtype=np.uint8), kmers[i]]
        )
        for i in range(E)
    ]


def _left_extend(sbwt, kmers: np.ndarray, rows: np.ndarray,
                 budgets: np.ndarray) -> list[np.ndarray]:
    """:func:`_left_extend_batch`'s extended codes for lanes whose k-mers
    are the index's colex ``rows``. A device index walks its chain links
    (kernels/refine.py ``ext_walk``: one upload, one launch, one fetch; the
    lanes count in the run's stats as ``host_ext_walk_lanes``); a host
    index takes the rounds."""
    if not isinstance(sbwt, DeviceIndex):
        return _left_extend_batch(sbwt, kmers, budgets)
    link = get_ext_links(sbwt)
    lanes = torch.from_numpy(
        np.stack([rows, budgets]).astype(np.int64)
    ).to(link.device)
    chars, n_ext = ext_walk(link, lanes[0], lanes[1], int(budgets.max()))
    chars = chars.cpu().numpy()
    n_ext = n_ext.cpu().numpy()
    get_stats().add("host_ext_walk_lanes", kmers.shape[0])
    return [
        np.concatenate([chars[i, : n_ext[i]][::-1], kmers[i]])
        for i in range(kmers.shape[0])
    ]


# ----------------------------------------------------- overlap run counting
def count_right_overlaps(kmer: bytes, ref_seq: bytes, ref_match_end: int) -> int:
    """Length of the exact backward match between the tail of `kmer`
    (never consuming kmer[0]) and `ref_seq` ending at `ref_match_end`
    (reference: src/gap_filling.rs:20-42)."""
    assert len(kmer) > 0 and len(ref_seq) > 0
    assert len(ref_seq) >= ref_match_end
    run = 0
    for i in range(min(len(kmer) - 1, ref_match_end)):
        if kmer[len(kmer) - 1 - i] != ref_seq[ref_match_end - 1 - i]:
            break
        run += 1
    return run


def count_left_overlaps(kmer: bytes, ref_seq: bytes, ref_match_start: int) -> int:
    """Length of the exact forward match between the head of `kmer` and
    `ref_seq` starting at `ref_match_start`
    (reference: src/gap_filling.rs:44-67)."""
    assert len(kmer) > 0 and len(ref_seq) > 0
    assert len(ref_seq) > ref_match_start
    run = 0
    for i in range(min(len(kmer), len(ref_seq) - ref_match_start)):
        if kmer[i] != ref_seq[ref_match_start + i]:
            break
        run += 1
    return run


def _trailing_runs(eq: np.ndarray) -> np.ndarray:
    """Per-row length of the trailing all-True run of a bool matrix."""
    if eq.shape[1] == 0:
        return np.zeros(eq.shape[0], dtype=np.int64)
    return np.cumprod(eq[:, ::-1], axis=1).sum(axis=1).astype(np.int64)


def _leading_runs(eq: np.ndarray) -> np.ndarray:
    """Per-row length of the leading all-True run of a bool matrix."""
    if eq.shape[1] == 0:
        return np.zeros(eq.shape[0], dtype=np.int64)
    return np.cumprod(eq, axis=1).sum(axis=1).astype(np.int64)


# ----------------------------------------------------------- the spec layer
def nearest_unique_context(
    ivals, sbwt: SbwtIndex, search_start: int, search_end: int
) -> tuple[int, bytes]:
    """Rightmost position in [search_start, search_end] (inclusive) whose
    colex interval has exactly one row, plus that row's k-mer text;
    (search_start - 1, b"") when none exists
    (reference: src/gap_filling.rs:127-151)."""
    assert search_end >= search_start
    assert search_end < len(ivals)
    positions = np.arange(search_start, search_end + 1, dtype=np.int64)
    iv = _intervals_at(ivals, positions)
    unique = np.flatnonzero(iv[:, 1] - iv[:, 0] == 1)
    if unique.size == 0:
        return search_start - 1, b""
    top = unique[-1]
    return int(positions[top]), sbwt.access_kmer(int(iv[top, 0]))


def left_extend_kmer(
    kmer_start: bytes, sbwt: SbwtIndex, max_extension_len: int
) -> bytes:
    """Left-extend one k-mer (reference: src/gap_filling.rs:205-232)."""
    assert len(kmer_start) > 0
    codes = encode_ascii(bytes(kmer_start))[None, :]
    out = _left_extend_batch(
        sbwt, codes, np.asarray([max_extension_len], dtype=np.int64)
    )[0]
    return decode_codes(out)


def left_extend_over_gap(
    ivals,
    ref_seq: bytes,
    sbwt: SbwtIndex,
    left_overlap_req: int,
    right_overlap_req: int,
    gap_start: int,
    gap_end: int,
    search_radius: int,
) -> bytes:
    """Unique-context k-mer spanning the gap [gap_start, gap_end), left-
    extended when required (reference: src/gap_filling.rs:295-361)."""
    k = sbwt.k
    assert len(ivals) == len(ref_seq)
    assert left_overlap_req <= gap_start
    assert right_overlap_req <= len(ref_seq) - gap_end
    assert gap_end > gap_start
    assert gap_end < len(ivals)
    gap = _GapTask(
        gap_start=gap_start,
        gap_end=gap_end,
        left_req=left_overlap_req,
        right_req=right_overlap_req,
        search_lo=gap_end + right_overlap_req,
        search_hi=min(gap_end + search_radius, len(ref_seq) - 1),
    )
    fills = _evaluate_gaps(
        [gap], ivals, np.frombuffer(bytes(ref_seq), dtype=np.uint8), sbwt
    )
    return decode_codes(fills[0]) if fills[0] is not None else b""


# ------------------------------------------------------------ batched core
class _GapTask:
    __slots__ = (
        "gap_start", "gap_end", "left_req", "right_req",
        "search_lo", "search_hi",
    )

    def __init__(self, gap_start, gap_end, left_req, right_req,
                 search_lo, search_hi):
        self.gap_start = gap_start
        self.gap_end = gap_end
        self.left_req = left_req
        self.right_req = right_req
        self.search_lo = search_lo  # lowest candidate position (inclusive)
        self.search_hi = search_hi  # highest candidate position (inclusive)


def _evaluate_gaps(
    gaps: list[_GapTask],
    ivals,
    ref_ascii: np.ndarray,
    sbwt: SbwtIndex,
) -> list[np.ndarray | None]:
    """For every gap, the spanning k-mer (codes) committed by the
    reference's descending candidate scan, or None.

    Every unique-context candidate of every gap is scored in one
    vectorized pass; left extensions run lane-batched. Per gap the first
    success in descending position order wins -- identical to the
    sequential scan because candidate evaluations have no side effects.
    """
    k = sbwt.k
    n_ref = ref_ascii.size
    n_gaps = len(gaps)

    # ---- phase A: one interval fetch over the union of search windows
    pos_parts = [
        np.arange(g.search_lo, g.search_hi + 1, dtype=np.int64)
        for g in gaps
        if g.search_hi >= g.search_lo
    ]
    if not pos_parts:
        return [None] * n_gaps
    all_pos = np.unique(np.concatenate(pos_parts))
    iv = _intervals_at(ivals, all_pos)
    uniq = iv[:, 1] - iv[:, 0] == 1

    # ---- phase B: candidate table (gap id, position, row), descending pos
    # per gap. Fully vectorized: per-gap unique-candidate spans come from
    # two batched searchsorted calls over the compacted unique positions,
    # then one repeat/arange expansion emits every (gap, candidate) pair
    # in the reference's descending scan order.
    uniq_idx = np.flatnonzero(uniq)
    search_lo = np.asarray([g.search_lo for g in gaps], dtype=np.int64)
    search_hi = np.asarray([g.search_hi for g in gaps], dtype=np.int64)
    lo_u = np.searchsorted(uniq_idx, np.searchsorted(all_pos, search_lo))
    hi_u = np.searchsorted(
        uniq_idx, np.searchsorted(all_pos, search_hi, side="right")
    )
    counts = np.maximum(hi_u - lo_u, 0) * (search_hi >= search_lo)
    C = int(counts.sum())
    if C == 0:
        return [None] * n_gaps
    gidx = np.repeat(np.arange(n_gaps, dtype=np.int64), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(C, dtype=np.int64) - starts[gidx]
    sel = uniq_idx[hi_u[gidx] - 1 - within]  # descending position per gap
    jpos = all_pos[sel]
    rows = iv[sel, 0]
    return _score_candidates(gaps, gidx, jpos, rows, ref_ascii, sbwt)


def _candidates_from_grid(
    gaps: list[_GapTask], grid: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(gidx, jpos, rows) candidate table from a device probe grid
    (kernels.mapsweep.map_postprocess3_core): grid[g, c] is the colex row of
    position search_lo_g + c when unique, else -1. Emitted gap-major with
    descending position per gap -- the reference's scan order."""
    n_gaps = len(gaps)
    W = grid.shape[1]
    lo = np.asarray([g.search_lo for g in gaps], dtype=np.int64)
    gi, c_rev = np.nonzero(grid[:n_gaps, ::-1] >= 0)
    cols = W - 1 - c_rev  # descending within each gap row
    jpos = lo[gi] + cols
    rows = grid[gi, cols].astype(np.int64)
    return gi.astype(np.int64), jpos, rows


def _score_candidates(
    gaps: list[_GapTask],
    gidx: np.ndarray,
    jpos: np.ndarray,
    rows: np.ndarray,
    ref_ascii: np.ndarray,
    sbwt: SbwtIndex,
) -> list[np.ndarray | None]:
    """Phases C-E of the gap evaluation: k-mer texts + vectorized overlap
    runs, lane-batched left extension, first-success-per-gap commit.

    Overlap comparisons run in RAW ASCII space (uppercase k-mer bytes vs
    the reference bytes as given): the reference's count_left/right_
    overlaps never match soft-masked lowercase bases
    (src/gap_filling.rs:20-67) and neither does this."""
    k = sbwt.k
    n_ref = ref_ascii.size
    n_gaps = len(gaps)
    C = gidx.size
    if C == 0:
        return [None] * n_gaps

    gs = np.asarray([g.gap_start for g in gaps], dtype=np.int64)[gidx]
    ge = np.asarray([g.gap_end for g in gaps], dtype=np.int64)[gidx]
    lreq = np.asarray([g.left_req for g in gaps], dtype=np.int64)[gidx]
    rreq = np.asarray([g.right_req for g in gaps], dtype=np.int64)[gidx]
    gap_len = ge - gs

    # ---- phase C: k-mer texts + vectorized overlap run lengths
    kmers = sbwt.access_kmers_codes(rows).astype(np.uint8)  # [C, k] codes
    kmers_ascii = CODE_TO_ASCII[kmers]
    padded = np.full(n_ref + 2 * k, _OOB, dtype=np.uint8)
    padded[k : k + n_ref] = ref_ascii

    # backward match ending at the candidate position (kmer[0] never joins)
    offs = np.arange(k, dtype=np.int64)[None, :]
    right_win = padded[(jpos - (k - 1))[:, None] + offs + k]
    rg = _trailing_runs((kmers_ascii == right_win)[:, 1:])
    want = jpos - ge + 1

    # forward match from the gap's left flank
    rsp = np.where(gs > lreq, gs - lreq, 0)
    left_win = padded[rsp[:, None] + offs + k]
    lg = _leading_runs(kmers_ascii == left_win)

    right_ok = rg >= np.minimum(want, k)
    case_a = right_ok & (lg >= lreq)

    # ---- phase D: lane-batched left extension for the remaining viable set
    should_extend = k < lreq + gap_len + rg
    case_b = should_extend & right_ok & (lg < lreq)
    ext_ok = np.zeros(C, dtype=bool)
    ext_lm = np.zeros(C, dtype=np.int64)
    ext_kmers: dict[int, np.ndarray] = {}
    lanes = np.flatnonzero(case_b)
    if lanes.size:
        budgets = (lreq + gap_len + rg - k)[lanes]
        extended = _left_extend(
            sbwt, kmers[lanes], rows[lanes], np.maximum(budgets, 0)
        )
        for lane, ext in zip(lanes.tolist(), extended):
            L = ext.size
            stop = min(L, n_ref - int(rsp[lane]))
            seg = ref_ascii[int(rsp[lane]) : int(rsp[lane]) + stop]
            eq = CODE_TO_ASCII[ext[:stop]] == seg
            lm = int(_leading_runs(eq[None, :])[0])
            ext_lm[lane] = lm
            if lm >= lreq[lane]:
                ext_ok[lane] = True
                ext_kmers[lane] = ext

    ok = case_a | ext_ok

    # ---- phase E: first success per gap in descending position order
    fills: list[np.ndarray | None] = [None] * n_gaps
    win = np.flatnonzero(ok)
    for c in win.tolist():
        gi = int(gidx[c])
        if fills[gi] is not None:
            continue  # an earlier (higher-position) candidate already won
        if case_a[c]:
            start = int(lg[c] - lreq[c])
            end = int(k - (rg[c] - rreq[c]))
            fills[gi] = kmers[c, start:end]
        else:
            ext = ext_kmers[c]
            start = int(ext_lm[c] - lreq[c])
            end = int(ext.size - (rg[c] - rreq[c]))
            fills[gi] = ext[start:end]
    return fills


def _gap_runs(translation: list[str], threshold: int) -> list[tuple[int, int]]:
    """Maximal ['-'|'X'] + '-'* blocks with start in
    [threshold, n - threshold - 1) (reference: src/gap_filling.rs:466-475).

    Filled gaps are painted with 'M'/nucleotides, never '-'/'X', and writes
    land strictly left of the reference's scan point, so enumerating on the
    ORIGINAL translation is equivalent to its incremental rescan.
    """
    n = len(translation)
    arr = np.frombuffer(
        "".join(translation).encode("latin-1"), dtype=np.uint8
    )
    is_dash = arr == ord("-")
    is_gap_char = is_dash | (arr == ord("X"))
    # run ends: first non-dash at or after each index
    not_dash_next = np.flatnonzero(~is_dash)
    gaps: list[tuple[int, int]] = []
    lo, hi = threshold, n - threshold - 1
    p = lo
    for p0 in (np.flatnonzero(is_gap_char[lo:hi]) + lo).tolist():
        if p0 < p:
            continue
        t = np.searchsorted(not_dash_next, p0 + 1)
        q = int(not_dash_next[t]) if t < not_dash_next.size else n
        gaps.append((p0, q))
        p = q
    return gaps


def _run_log_prob(matching: np.ndarray, bound: float) -> bool:
    """Sum of per-run match CDFs over consecutive-match pair runs; a run
    that reaches the final pair contributes nothing
    (reference: src/gap_filling.rs:496-512)."""
    if matching.size < 2:
        return 0.0 > bound
    pairs = matching[:-1] & matching[1:]
    log_probs = 0.0
    idx = np.flatnonzero(pairs)
    if idx.size:
        splits = np.flatnonzero(np.diff(idx) > 1)
        starts = np.concatenate([[0], splits + 1])
        ends = np.concatenate([splits, [idx.size - 1]])
        for s, e in zip(starts.tolist(), ends.tolist()):
            if idx[e] == pairs.size - 1:
                continue  # trailing run never flushes
            run = e - s + 1
            log_probs += log_rm_max_cdf(run + 1, 4, 1)
    return log_probs > bound


def _gap_tasks(
    runs: list[tuple[int, int]], n_ref: int, k: int, threshold: int
) -> list[_GapTask]:
    """Gap tasks (window arithmetic per src/gap_filling.rs:470-478) for raw
    (start, next-non-dash) runs -- the ONE place the end clamp / radius /
    search window rule lives (the device grid,
    kernels.mapsweep.map_postprocess3_core, follows it)."""
    tasks = []
    for start_index, run_end in runs:
        end_index = min(run_end, n_ref - threshold)
        gap_len = end_index - start_index
        fits_without_extension = gap_len + 2 * threshold <= k
        radius = k - (threshold if fits_without_extension else 0)
        tasks.append(
            _GapTask(
                gap_start=start_index,
                gap_end=end_index,
                left_req=threshold,
                right_req=threshold,
                search_lo=end_index + threshold,
                search_hi=min(end_index + radius, n_ref - 1),
            )
        )
    return tasks


def gap_probe_positions(
    runs: list[tuple[int, int]], n_ref: int, k: int, threshold: int
) -> np.ndarray:
    """Every reference position whose colex interval the gap evaluator will
    read for these runs -- lets a caller prefetch them together with other
    consumers' positions in one device probe."""
    parts = [
        np.arange(t.search_lo, t.search_hi + 1, dtype=np.int64)
        for t in _gap_tasks(runs, n_ref, k, threshold)
        if t.search_hi >= t.search_lo
    ]
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(parts))


def fill_gaps_patches(
    runs: list[tuple[int, int]],
    ivals,
    ref_seq: bytes,
    query_sbwt: SbwtIndex,
    threshold: int,
    max_err_prob: float,
    grid: np.ndarray | None = None,
) -> list[tuple[int, int]]:
    """Evaluate gap runs and return fill writes as (position, ascii) patches.

    ``runs`` are raw (start, next-non-dash) pairs -- from :func:`_gap_runs`
    on host or from the device sweep's compacted gap table
    (kernels/mapsweep.py). Acceptance and painting semantics mirror
    fill_gaps (reference: src/gap_filling.rs:476-519); a patch writes 'M'
    where the filler agrees with the reference and the filler nucleotide
    where it does not. The patch form lets the sparse-fetch map path
    scatter the writes into the device-resident translation instead of
    materializing the full char string on host.
    """
    n = len(ref_seq)
    k = query_sbwt.k
    assert k > 0
    ref_seq = bytes(ref_seq)
    ref_ascii = np.frombuffer(ref_seq, dtype=np.uint8)
    bound = math.log1p(-max_err_prob)
    patches: list[tuple[int, int]] = []
    if not runs:
        return patches

    tasks = _gap_tasks(runs, n, k, threshold)

    if grid is not None:
        # the device sweep's candidate grid
        # (kernels.mapsweep.map_postprocess3_core): candidates are already
        # resolved, no interval provider is read
        gidx, jpos, rows = _candidates_from_grid(tasks, np.asarray(grid))
        fills = _score_candidates(
            tasks, gidx, jpos, rows, ref_ascii, query_sbwt
        )
    else:
        fills = _evaluate_gaps(tasks, ivals, ref_ascii, query_sbwt)

    stats = get_stats()
    pos_parts: list[np.ndarray] = []
    val_parts: list[np.ndarray] = []
    for task, fill in zip(tasks, fills):
        stats.add("gaps_seen")
        gs, ge = task.gap_start, task.gap_end
        gap_len = ge - gs
        kmer = fill if fill is not None else np.zeros(0, dtype=np.uint8)
        L = kmer.size
        if L == 0 or L != 2 * threshold + gap_len or (kmer == DOLLAR).any():
            continue  # not found / '$'-containing / indel-length: rejected

        seg = kmer[threshold : threshold + gap_len]
        matching = CODE_TO_ASCII[seg] == ref_ascii[gs:ge]

        # acceptance (reference: src/gap_filling.rs:476-509); the run
        # probability analysis only matters when the k-mer cannot span the
        # gap + both flanks (gap_len + 2*threshold > k)
        ok = gap_len + 2 * threshold <= k
        if not ok:
            ok = _run_log_prob(matching, bound) or (
                matching.size > 0
                and not matching[0]
                and not matching[-1]
                and int(matching.sum()) + 2 == gap_len
            )
        if ok:
            stats.add("gaps_filled")
            # paint: 'M' where the filler agrees with the RAW reference
            # bytes (ASCII comparison, distinct from the code-space
            # acceptance comparison above -- a lowercase reference char
            # never paints 'M'), the filler nucleotide where it does not
            filler = CODE_TO_ASCII[seg]
            pos_parts.append(np.arange(gs, ge, dtype=np.int64))
            val_parts.append(
                np.where(
                    filler == ref_ascii[gs:ge], np.uint8(ord("M")), filler
                )
            )
    if pos_parts:
        pos = np.concatenate(pos_parts)
        val = np.concatenate(val_parts)
        patches.extend(zip(pos.tolist(), val.tolist()))
    return patches


def fill_gaps(
    translation: list[str],
    noisy_ms,
    ivals,
    ref_seq: bytes,
    query_sbwt: SbwtIndex,
    threshold: int,
    max_err_prob: float,
) -> list[str]:
    """Resolve '-'/'X' runs in the translation with query k-mers spanning
    each gap (reference: src/gap_filling.rs:444-526), batch-evaluated."""
    n = len(translation)
    assert n > 0
    if noisy_ms is not None:
        assert n == len(noisy_ms)
    refined = list(translation)
    runs = _gap_runs(translation, threshold)
    for pos, ch in fill_gaps_patches(
        runs, ivals, bytes(ref_seq), query_sbwt, threshold, max_err_prob
    ):
        refined[pos] = chr(ch)
    return refined
