"""Gap filling on the host, from a device candidate grid (numpy; the part of
kbo_tpu/refine/gap_filling.py that ``fill_gaps_patches(..., grid=...)``
reaches).

The device scorer (kernels/refine.py ``score_gaps_core``) flags the gaps
whose left-extension lanes do not fit its static budgets; map_devref_finish
(refine/device_map.py) scores those here, exactly, from the candidate rows
the device already resolved. Semantics mirror the reference module
(reference: src/gap_filling.rs: left_extend_kmer :205-232, fill_gaps
:444-526); per gap the accepted fill is the first successful candidate in
descending position order, as the reference's sequential scan commits.

The interval-provider path (``_evaluate_gaps`` over colex intervals, with
``search_codes_batch`` for short patterns) comes with the intervals, ROADMAP
Queue 1 item 6.
"""

from __future__ import annotations

import math

import numpy as np

from kbo_tpu_torch.index.encode import CODE_TO_ASCII, DOLLAR
from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.ops.derandomize import log_rm_max_cdf
from kbo_tpu_torch.utils.stats import get_stats

#: sentinel codes that can never equal a k-mer code (0..4)
_OOB = np.uint8(250)


def _row_key_bytes(sbwt: SbwtIndex) -> np.ndarray:
    """Colex row keys as big-endian byte strings (memcmp order == colex
    order), cached on the index: a length-k pattern's interval is empty or a
    singleton, so membership is one searchsorted per probe."""
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


def _member_rows(sbwt: SbwtIndex, probes: np.ndarray) -> np.ndarray:
    """Bool [P]: is each length-k probe exactly an index row? Probes
    containing '$' never match (the oracle's extend() rejects code 0, even
    though a dummy row with that text exists)."""
    no_dollar = ~(probes == DOLLAR).any(axis=1)
    row_bytes = _row_key_bytes(sbwt)
    pb = _pack_probe_bytes(probes, sbwt.k, sbwt.keys3.shape[0])
    loc = np.searchsorted(row_bytes, pb)
    locc = np.minimum(loc, row_bytes.size - 1)
    return (row_bytes[locc] == pb) & (loc < row_bytes.size) & no_dollar


def _left_extend_batch(
    sbwt: SbwtIndex, kmers: np.ndarray, budgets: np.ndarray
) -> list[np.ndarray]:
    """Left-extend each lane's code k-mer while exactly one of the four
    possible preceding characters yields a full-length index row
    (reference: src/gap_filling.rs:205-232), up to the lane's budget.

    kmers: uint8 [E, k]; budgets: int64 [E]. Every probe keeps length k
    (prepend one char, drop the trailing char), so nonempty == singleton ==
    membership: one batched binary search per round. Returns the extended
    code arrays (length k + e_lane)."""
    kmers = np.asarray(kmers, dtype=np.uint8)
    E, K0 = kmers.shape
    if K0 != sbwt.k or sbwt.keys3 is None:
        raise NotImplementedError(
            "left extension of patterns shorter than k takes the rank-walk "
            "interval search: ROADMAP Queue 1 item 6"
        )
    budgets = np.asarray(budgets, dtype=np.int64)
    prefix = kmers[:, : K0 - 1].copy()  # current first K0-1 codes per lane
    prepended: list[list[int]] = [[] for _ in range(E)]
    active = budgets > 0
    spent = np.zeros(E, dtype=np.int64)
    while active.any():
        lanes = np.flatnonzero(active)
        P = prefix[lanes]
        probes = np.empty((4, lanes.size, K0), dtype=np.uint8)
        for b in range(4):
            probes[b, :, 0] = b + 1
            probes[b, :, 1:] = P
        member = _member_rows(sbwt, probes.reshape(4 * lanes.size, K0))
        member = member.reshape(4, lanes.size)
        n_hits = member.sum(axis=0)
        choice = np.argmax(member, axis=0)  # valid only where n_hits == 1
        ok = (n_hits == 1) & member[choice, np.arange(lanes.size)]
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


def _candidates_from_grid(
    gaps: list[_GapTask], grid: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(gidx, jpos, rows) candidate table from a device probe grid:
    grid[g, c] is the colex row of position search_lo_g + c when unique,
    else -1. Emitted gap-major with descending position per gap -- the
    reference's scan order."""
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
        extended = _left_extend_batch(
            sbwt, kmers[lanes], np.maximum(budgets, 0)
        )
        for lane, ext in zip(lanes.tolist(), extended):
            stop = min(ext.size, n_ref - int(rsp[lane]))
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
    for c in np.flatnonzero(ok).tolist():
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


def _run_log_prob(matching: np.ndarray, bound: float) -> bool:
    """Sum of per-run match CDFs over consecutive-match pair runs, > bound;
    a run that reaches the final pair contributes nothing
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
            log_probs += log_rm_max_cdf(e - s + 2, 4, 1)
    return log_probs > bound


def _gap_tasks(
    runs: list[tuple[int, int]], n_ref: int, k: int, threshold: int
) -> list[_GapTask]:
    """Gap tasks (window arithmetic per src/gap_filling.rs:470-478) for raw
    (start, next-non-dash) runs; the device grid
    (kernels.mapsweep.map_postprocess3_core) follows the same rule."""
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

    ``runs`` are raw (start, next-non-dash) pairs from the device sweep's
    compacted gap table; ``grid`` is their device candidate grid
    (kernels.mapsweep.map_postprocess3_core), so no interval provider is
    read. Acceptance and painting mirror fill_gaps (reference:
    src/gap_filling.rs:476-519): a patch writes 'M' where the filler agrees
    with the reference and the filler nucleotide where it does not.
    """
    k = query_sbwt.k
    assert k > 0
    ref_seq = bytes(ref_seq)
    ref_ascii = np.frombuffer(ref_seq, dtype=np.uint8)
    bound = math.log1p(-max_err_prob)
    patches: list[tuple[int, int]] = []
    if not runs:
        return patches
    if grid is None:
        raise NotImplementedError(
            "gap filling from colex intervals (_evaluate_gaps): ROADMAP "
            "Queue 1 item 6"
        )

    tasks = _gap_tasks(runs, len(ref_seq), k, threshold)
    gidx, jpos, rows = _candidates_from_grid(tasks, np.asarray(grid))
    fills = _score_candidates(tasks, gidx, jpos, rows, ref_ascii, query_sbwt)

    stats = get_stats()
    pos_parts: list[np.ndarray] = []
    val_parts: list[np.ndarray] = []
    for task, fill in zip(tasks, fills):
        stats.add("gaps_seen")
        gs, ge = task.gap_start, task.gap_end
        gap_len = ge - gs
        kmer = fill if fill is not None else np.zeros(0, dtype=np.uint8)
        if (kmer.size == 0 or kmer.size != 2 * threshold + gap_len
                or (kmer == DOLLAR).any()):
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
            # bytes, the filler nucleotide where it does not
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
