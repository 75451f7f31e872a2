"""SBWT construction (host, vectorized numpy over packed keys).

Construction is a preprocessing step in the reference as well (it forwards
to the sbwt crate's bit-packed k-mer sorting, reference: src/index.rs:56-99).
Here every window packs into W3 = ceil(k/10) uint32 words of 3-bit chunks
(last char most significant, '$' = 0), so the colex sort is a lexsort over
W3 uint32 columns instead of k uint8 columns, and the LCS array, C array,
subset-matrix edges, and the sort-join key tables all derive from the same
packed words -- no [n, k] window matrix is ever materialized.

Row-set semantics (pinned by the golden MS vector, reference:
src/index.rs:224-241): rows are the distinct length-k windows of
``$^k + segment`` over every maximal ACGT run of every input sequence.
"""

from __future__ import annotations

import numpy as np

from kbo_tpu_torch.index.encode import encode_ascii, revcomp_ascii, split_segments
from kbo_tpu_torch.index.sbwt import N_BASES, SbwtIndex
from kbo_tpu_torch.opts import BuildOpts

try:  # numpy >= 2.0
    _popcount32 = np.bitwise_count
except AttributeError:  # pragma: no cover - fallback for old numpy
    _LUT16 = np.array([bin(i).count("1") for i in range(1 << 16)], dtype=np.uint8)

    def _popcount32(words):
        w = words.astype(np.uint32)
        return _LUT16[w & 0xFFFF].astype(np.int32) + _LUT16[w >> 16]


def _shift_up(x: np.ndarray, t: int) -> np.ndarray:
    """y[p] = x[p - t], zero-filled (static t)."""
    if t == 0:
        return x
    out = np.zeros_like(x)
    out[t:] = x[:-t]
    return out


def _pack_positions(buf: np.ndarray, k: int):
    """Packed keys for every position of a code buffer (values 0..4).

    Returns (w3: list of W3 uint32 [T] -- 3-bit chunks, '$'=0;
    w2: list of W2 uint32 [T] -- 2-bit chunks, '$' packs to 3;
    v: int32 [T] -- min(k, valid run ending at the position)).
    """
    T = buf.size
    c3 = buf.astype(np.uint32)
    c2 = (c3 - 1) & 3
    w3 = []
    for w in range((k + 9) // 10):
        acc = np.zeros(T, dtype=np.uint32)
        for j in range(10):
            t = w * 10 + j
            if t >= k:
                break
            acc |= _shift_up(c3, t) << np.uint32(27 - 3 * j)
        w3.append(acc)
    w2 = []
    for w in range((k + 15) // 16):
        acc = np.zeros(T, dtype=np.uint32)
        for j in range(16):
            t = w * 16 + j
            if t >= k:
                break
            acc |= _shift_up(c2, t) << np.uint32(30 - 2 * j)
        w2.append(acc)
    idx = np.arange(T, dtype=np.int64)
    last_bad = np.maximum.accumulate(np.where(buf == 0, idx, -1))
    v = np.minimum(k, idx - last_bad).astype(np.int32)
    return w3, w2, v


def _common_chunks_np(a, b):
    """Common 3-bit-chunk prefix length between word lists (numpy)."""
    total = np.zeros(a[0].shape, dtype=np.int32)
    alive = np.ones(a[0].shape, dtype=bool)
    for w in range(len(a)):
        x = a[w] ^ b[w]
        nz = x != 0
        # highest set bit via frexp (exact for < 2^53)
        hb = np.frexp(x.astype(np.float64))[1] - 1
        cw = np.where(nz, (29 - hb) // 3, 10).astype(np.int32)
        total += np.where(alive, cw, 0)
        alive &= ~nz
    return total


def _lexsort_words(words, num_threads: int = 1) -> np.ndarray:
    """Sort order over parallel uint32 word columns (most significant
    first). With num_threads > 1, partitions by the top chunk (the last
    character, primary colex key) and sorts buckets concurrently."""
    n = words[0].size
    keys = tuple(reversed(words))  # lexsort: last key is primary
    if num_threads > 1 and n > (1 << 16):
        from concurrent.futures import ThreadPoolExecutor

        # partition by the top FIVE bits so the same code is correct for
        # both keyspaces: 3-bit chunks top out at 4, 2-bit words use the
        # full 0..31 range (a 0..4 partition silently dropped rows there)
        top = words[0] >> np.uint32(27)

        def sort_bucket(c):
            sel = np.flatnonzero(top == c)
            if sel.size == 0:
                return sel
            sub = np.lexsort(tuple(w[sel] for w in keys))
            return sel[sub]

        with ThreadPoolExecutor(max_workers=num_threads) as ex:
            parts = list(ex.map(sort_bucket, range(32)))
        return np.concatenate(parts)
    return np.lexsort(keys)


def join_tables_from_packed(
    w2: list, v: np.ndarray, k: int, num_threads: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """2-bit join table for the sort-join MS engine: ALL rows (real +
    dummy) sorted by 2-bit key with per-row caps. Inputs are the colex-
    ordered per-word 2-bit key columns and the real-suffix lengths. Real
    rows are already 2-bit-sorted (for '$'-free strings the 3-bit colex
    order IS the 2-bit order); dummies merge in."""
    n = w2[0].size
    real = v == k
    w2r = [w[real] for w in w2]
    w2d = [w[~real] for w in w2]
    vd = v[~real]
    W2 = len(w2)
    if w2d[0].size == 0:
        keys2 = np.stack(w2r)
        cap2 = np.full(n, k, dtype=np.int32)
    elif W2 <= 2:
        # exact u64 proxy of the full key for k <= 32; tie placement among
        # equal keys is irrelevant to the clamped-LCP scan
        lo_r = w2r[1] if W2 == 2 else np.zeros_like(w2r[0])
        lo_d = w2d[1] if W2 == 2 else np.zeros_like(w2d[0])
        proxy_r = (w2r[0].astype(np.uint64) << np.uint64(32)) | lo_r
        proxy_d = (w2d[0].astype(np.uint64) << np.uint64(32)) | lo_d
        dorder = np.argsort(proxy_d, kind="stable")
        ins = np.searchsorted(proxy_r, proxy_d[dorder])
        keys2 = np.stack(
            [np.insert(w2r[w], ins, w2d[w][dorder]) for w in range(W2)]
        )
        cap2 = np.insert(
            np.full(w2r[0].size, k, dtype=np.int32), ins, vd[dorder]
        )
    else:
        order2 = _lexsort_words(w2, num_threads)
        keys2 = np.stack([w[order2] for w in w2])
        cap2 = v[order2].astype(np.int32)
    return keys2, cap2


def build_index_from_segments(
    segments: list[np.ndarray], k: int, num_threads: int = 1
) -> SbwtIndex:
    """Core construction from pre-encoded valid segments."""
    assert segments, "cannot build an index from empty input"
    assert 1 < k < 255, (
        "k must be in (1, 255): cap byte 255 is the join engine's "
        "query-slot marker (kernels/ms.py _neighbor_best)"
    )
    W3 = (k + 9) // 10

    # one flat buffer: k '$'s before each segment; window ending at the
    # last '$' of the first pad is the all-$ root row
    parts = []
    for seg in segments:
        parts.append(np.zeros(k, dtype=np.uint8))
        parts.append(np.asarray(seg, dtype=np.uint8))
    buf = np.concatenate(parts)
    w3_all, w2_all, v_all = _pack_positions(buf, k)
    pos = np.concatenate(
        [np.array([k - 1], dtype=np.int64), np.flatnonzero(buf != 0)]
    )
    w3 = [w[pos] for w in w3_all]
    w2 = [w[pos] for w in w2_all]
    v = v_all[pos]

    order = _lexsort_words(w3, num_threads)
    w3 = [w[order] for w in w3]
    m = w3[0].size
    keep = np.ones(m, dtype=bool)
    if m > 1:
        eq = np.ones(m - 1, dtype=bool)
        for w in range(W3):
            eq &= w3[w][1:] == w3[w][:-1]
        keep[1:] = ~eq
    sel = np.flatnonzero(keep)
    idx_sel = order[sel]  # one combined gather instead of w[order][sel]
    w3 = [w[sel] for w in w3]
    w2 = [w[idx_sel] for w in w2]
    v = v[idx_sel]
    row_pos = pos[idx_sel]
    return _finish_index_from_sorted(buf, k, w3, w2, v, row_pos, num_threads)


def _finish_index_from_sorted(
    buf: np.ndarray,
    k: int,
    w3: list[np.ndarray],
    w2: list[np.ndarray],
    v: np.ndarray,
    row_pos: np.ndarray,
    num_threads: int = 1,
) -> SbwtIndex:
    """Construction tail shared by the in-memory and disk-backed builds:
    inputs are the colex-sorted deduplicated row keys."""
    W3 = (k + 9) // 10
    n = w3[0].size

    # LCS: common suffix of colex-adjacent rows == common packed chunks
    # ('$'-'$' ties can only occur below the first difference, so the chunk
    # count equals the character count)
    lcs = np.zeros(n, dtype=np.uint8)
    if n > 1:
        lcs[1:] = _common_chunks_np(
            [w[1:] for w in w3], [w[:-1] for w in w3]
        ).astype(np.uint8)

    # C array from the (sorted, non-decreasing) last-character chunk
    top = (w3[0] >> np.uint32(27)).astype(np.uint8)
    C = np.searchsorted(top, np.arange(1, N_BASES + 1)).astype(np.int32)
    n_kmers = int(np.count_nonzero(v == k))

    # Incoming edge of every non-root row y: set bit `last char of y` on
    # the colex-smallest row whose (k-1)-suffix equals y's (k-1)-prefix.
    # suffix key = row key with the lowest real chunk (char 0) cleared;
    # prefix key = row key shifted up one chunk (drops the last char,
    # char 0 becomes the lowest real chunk). Both are (k-1)-char strings
    # in the same alignment, so dense ranks over their union match them.
    lcw, lsh = (k - 1) // 10, 27 - 3 * ((k - 1) % 10)
    suffix_w = [w.copy() for w in w3]
    suffix_w[lcw] &= ~np.uint32(0x7 << lsh)
    prefix_w = []
    for w in range(W3):
        nxt = w3[w + 1] >> np.uint32(27) if w + 1 < W3 else np.uint32(0)
        prefix_w.append(((w3[w] << np.uint32(3)) | nxt) & np.uint32(0x3FFFFFFF))
    union = [
        np.concatenate([suffix_w[w], prefix_w[w]]) for w in range(W3)
    ]
    uorder = _lexsort_words(union, num_threads)
    differs = np.zeros(2 * n - 1, dtype=bool)
    for w in range(W3):
        s = union[w][uorder]
        differs |= s[1:] != s[:-1]
    new_group = np.ones(2 * n, dtype=np.int64)
    new_group[1:] = differs
    ranks_sorted = np.cumsum(new_group) - 1
    ranks = np.empty(2 * n, dtype=np.int64)
    ranks[uorder] = ranks_sorted
    r_suffix, r_prefix = ranks[:n], ranks[n:]
    y = np.arange(1, n)  # row 0 is the all-$ root: no incoming edge
    pred = np.searchsorted(r_suffix, r_prefix[y])
    if not np.all(r_suffix[pred] == r_prefix[y]):
        raise AssertionError("every non-root row must have a predecessor")
    edge_char = top[y]  # 1..4

    # one guard word past the last row: rank queries at pos == n_rows (the
    # initial full interval's right end) index word n_rows >> 5, which falls
    # outside ceil(n/32) words exactly when n_rows % 32 == 0
    n_words = n // 32 + 1
    bits = np.zeros((N_BASES, n_words), dtype=np.uint32)
    for b in range(N_BASES):
        s = pred[edge_char == b + 1]
        np.bitwise_or.at(
            bits[b], s >> 5, (np.uint32(1) << (s & 31).astype(np.uint32))
        )
    pc = _popcount32(bits).astype(np.int64)
    cum = np.zeros((N_BASES, n_words), dtype=np.int64)
    cum[:, 1:] = np.cumsum(pc, axis=1)[:, :-1]
    assert cum.max(initial=0) < 2**31

    keys2, cap2 = join_tables_from_packed(w2, v, k, num_threads)

    return SbwtIndex(
        k=k,
        n_rows=n,
        n_kmers=n_kmers,
        bits=bits,
        cum=cum.astype(np.int32),
        C=C,
        lcs=lcs,
        keys2=keys2,
        cap2=cap2,
        keys3=np.stack(w3),
        row_pos=row_pos.astype(np.int64),
        text=buf,
    )


def build_index_from_segments_disk(
    segments: list[np.ndarray],
    k: int,
    temp_dir: str,
    mem_gb: int = 4,
    dedup_batches: bool = False,
    num_threads: int = 1,
) -> SbwtIndex:
    """Disk-backed construction: the reference's ``BitPackedKmerSorting``
    execution plan (reference: src/index.rs:64-81 -- ``temp_dir``,
    ``mem_gb``, ``dedup_batches``).

    The colex sort's working set is what blows up the in-memory build
    (packed keys + lexsort scratch are several times the final index);
    here positions are packed in ``mem_gb``-bounded chunks and scattered
    to 256 temp-file buckets by the top byte of the leading key word
    (= the most recent ~2.7 characters, so buckets are contiguous colex
    ranges). Each bucket then sorts and deduplicates in memory (equal
    keys always share a bucket) and the concatenated buckets feed the
    SAME downstream construction as the in-memory path -- the output is
    bit-identical (tests/test_index.py pins it). ``dedup_batches``
    additionally deduplicates each chunk before writing, shrinking temp
    files for repetitive inputs at the cost of a sort per chunk.
    """
    import os
    import tempfile

    assert segments, "cannot build an index from empty input"
    assert 1 < k < 255, (
        "k must be in (1, 255): cap byte 255 is the join engine's "
        "query-slot marker (kernels/ms.py _neighbor_best)"
    )
    W3 = (k + 9) // 10
    W2 = (k + 15) // 16

    parts = []
    for seg in segments:
        parts.append(np.zeros(k, dtype=np.uint8))
        parts.append(np.asarray(seg, dtype=np.uint8))
    buf = np.concatenate(parts)
    T = buf.size

    # packed row record: W3 + W2 uint32 words, v int32, pos int64
    rec = np.dtype(
        [("w3", np.uint32, (W3,)), ("w2", np.uint32, (W2,)),
         ("v", np.int32), ("pos", np.int64)]
    )
    # chunk size: keep the pass-1 working set (packed words + scratch,
    # ~10x the record bytes) within the budget
    chunk = max(1 << 16, int(mem_gb * (1 << 30) / (10 * rec.itemsize)))

    dollars = np.flatnonzero(buf == 0)
    os.makedirs(temp_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(
        prefix="kbo-bpks-", dir=temp_dir
    ) as tdir:
        files = [
            open(os.path.join(tdir, f"bucket{b:03d}.bin"), "wb")
            for b in range(256)
        ]
        try:
            for s in range(0, T, chunk):
                e = min(T, s + chunk)
                # pack windows for positions [s, e): slice with k-1 left
                # overlap so windows are complete
                lo = max(0, s - (k - 1))
                w3c, w2c, vc = _pack_positions(buf[lo:e], k)
                off = s - lo
                # selected rows: the root '$' row + every non-'$' position
                selm = buf[s:e] != 0
                if s <= k - 1 < e:
                    selm = selm.copy()
                    selm[k - 1 - s] = True
                sel = np.flatnonzero(selm) + off
                if s > 0:
                    # v in the slice is clamped by the slice start; the
                    # left overlap guarantees correctness only when a '$'
                    # occurs within the overlap -- recompute from the
                    # global buffer for the selected rows
                    gpos = sel + lo
                    vg = np.minimum(
                        np.int64(k),
                        gpos - _last_invalid_before(dollars, gpos),
                    ).astype(np.int32)
                else:
                    gpos = sel + lo
                    vg = vc[sel]
                out = np.empty(sel.size, dtype=rec)
                for w in range(W3):
                    out["w3"][:, w] = w3c[w][sel]
                for w in range(W2):
                    out["w2"][:, w] = w2c[w][sel]
                out["v"] = vg
                out["pos"] = gpos
                if dedup_batches and out.size:
                    key = np.ascontiguousarray(out["w3"]).view(
                        f"|S{4 * W3}"
                    ).ravel()
                    order = np.argsort(key, kind="stable")
                    out = out[order]
                    keyo = key[order]
                    keep = np.ones(out.size, dtype=bool)
                    keep[1:] = keyo[1:] != keyo[:-1]
                    out = out[keep]
                tops = out["w3"][:, 0] >> np.uint32(24)
                for b in np.unique(tops):
                    files[int(b)].write(out[tops == b].tobytes())
        finally:
            for f in files:
                f.close()

        # pass 2: per-bucket in-memory sort + dedup, in colex bucket order
        w3_parts, w2_parts, v_parts, pos_parts = [], [], [], []
        for b in range(256):
            path = os.path.join(tdir, f"bucket{b:03d}.bin")
            data = np.fromfile(path, dtype=rec)
            if data.size == 0:
                continue
            bw3 = [np.ascontiguousarray(data["w3"][:, w]) for w in range(W3)]
            order = _lexsort_words(bw3, num_threads)
            data = data[order]
            keep = np.ones(data.size, dtype=bool)
            if data.size > 1:
                eq = np.ones(data.size - 1, dtype=bool)
                for w in range(W3):
                    eq &= data["w3"][1:, w] == data["w3"][:-1, w]
                keep[1:] = ~eq
            data = data[keep]
            w3_parts.append(np.ascontiguousarray(data["w3"]))
            w2_parts.append(np.ascontiguousarray(data["w2"]))
            v_parts.append(data["v"].copy())
            pos_parts.append(data["pos"].copy())

    w3_mat = np.concatenate(w3_parts)
    w2_mat = np.concatenate(w2_parts)
    w3 = [np.ascontiguousarray(w3_mat[:, w]) for w in range(W3)]
    w2 = [np.ascontiguousarray(w2_mat[:, w]) for w in range(W2)]
    v = np.concatenate(v_parts)
    row_pos = np.concatenate(pos_parts)
    return _finish_index_from_sorted(
        buf, k, w3, w2, v, row_pos, num_threads
    )


def _last_invalid_before(
    dollars: np.ndarray, gpos: np.ndarray
) -> np.ndarray:
    """For each global position, the index of the last '$' at-or-before it
    (the buffer always starts with k '$'s, so one exists). ``dollars`` is
    the precomputed sorted '$' position array (invariant across chunks)."""
    loc = np.searchsorted(dollars, gpos, side="right") - 1
    return dollars[loc]


def build_sbwt_from_seqs(seqs, opts: BuildOpts | None = None) -> SbwtIndex:
    """Build an SBWT index from ASCII sequences.

    Mirrors ``build_sbwt_from_vecs`` (reference: src/index.rs:56-99): all
    sequences are merged into one index; non-ACGT characters break sequences
    into independent segments; ``add_revcomp`` also indexes reverse
    complements.
    """
    opts = opts or BuildOpts()
    segments: list[np.ndarray] = []
    for seq in seqs:
        if isinstance(seq, str):
            seq = seq.encode()
        elif isinstance(seq, np.ndarray):
            seq = seq.tobytes()
        segments.extend(split_segments(encode_ascii(seq)))
        if opts.add_revcomp:
            segments.extend(split_segments(encode_ascii(revcomp_ascii(seq))))
    if opts.temp_dir is not None:
        # disk-backed k-mer sorting (reference: src/index.rs:64-81)
        return build_index_from_segments_disk(
            segments, opts.k, opts.temp_dir,
            mem_gb=opts.mem_gb, dedup_batches=opts.dedup_batches,
            num_threads=opts.num_threads,
        )
    return build_index_from_segments(segments, opts.k, opts.num_threads)
