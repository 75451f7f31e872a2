"""Plain NumPy reference of kbo's ``find``, ``call`` and ``map`` semantics.

It imports nothing of the measured program and takes nothing it made: it
works everything out again from the generated sequence bytes.

The index is the set of rows of an SBWT over the indexed sequences: for every
maximal ACGT run ``seg`` of every sequence (and of its reverse complement when
``add_revcomp``), the length-k windows of ``$^k + seg`` that end inside
``seg``, plus the all-``$`` root row, deduplicated. A row is held as its
reversed text packed two bits a base, most significant first (``w0``: the
first 32 reversed bases; ``w1``: the rest, then the count of real bases in the
low 8 bits). With ``$`` smaller than every base, sorting ``(w0, w1)`` is the
colex order of the rows, and the rows that end in a string ``s`` are the run
whose reversed text starts with ``reversed(s)``.

Matching statistics: ``ms[i]`` is the length (at most k) of the longest suffix
of ``query[..=i]``, not crossing a non-ACGT character, that ends some row. In
sorted order that is the longer common prefix of the query's reversed window
with its two neighbours. The colex interval of that suffix has one row exactly
when one of the two neighbours shares it and the row beyond does not.

Derandomize, translate, run lengths, variant calling, gap filling and the map
assembly follow kbo (github.com/tmaklin/kbo: src/derandomize.rs,
src/translate.rs, src/format.rs, src/variant_calling.rs, src/gap_filling.rs,
src/lib.rs ``map``).
"""

from __future__ import annotations

import math

import numpy as np

BASES = b"ACGT"
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _chs in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
    for _c in _chs:
        _CODE[_c] = _i
_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[_a] = _b
_ASCII = np.frombuffer(BASES, dtype=np.uint8)
_OOB = np.uint8(250)  # never equals an ASCII base or '$'


def revcomp(seq: bytes) -> bytes:
    return _COMP[np.frombuffer(seq, dtype=np.uint8)][::-1].tobytes()


# ------------------------------------------------------------ thresholds
def log_rm_max_cdf(t: int, alphabet_size: int, n_kmers: int) -> float:
    q = math.exp(math.log(1.0) - math.log(float(alphabet_size)))
    return n_kmers * math.log1p(-(q ** (t + 1)))


def random_match_threshold(k: int, n_kmers: int, alphabet_size: int,
                           max_error_prob: float) -> int:
    bound = math.log1p(-max_error_prob)
    for i in range(1, k):
        if log_rm_max_cdf(i, alphabet_size, n_kmers) > bound:
            return i
    return k


# ------------------------------------------------------------ packed keys
def _bitlen64(x: np.ndarray) -> np.ndarray:
    """Bit length of each uint64 (0 for 0), exact: each 32-bit half goes
    through float64, which holds it exactly."""
    hi = (x >> np.uint64(32)).astype(np.float64)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.float64)
    ehi = np.frexp(hi)[1].astype(np.int64)
    elo = np.frexp(lo)[1].astype(np.int64)
    return np.where(hi > 0, 32 + ehi, elo)


def _runs(codes: np.ndarray) -> np.ndarray:
    """Length of the ACGT run ending at each position (0 where invalid)."""
    valid = codes < 4
    idx = np.arange(codes.size, dtype=np.int64)
    last_bad = np.maximum.accumulate(np.where(valid, -1, idx))
    return np.where(valid, idx - last_bad, 0)


def pack_windows(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(w0, w1) keys of the reversed window ending at every position: at
    most k bases, cut at a non-ACGT code or the start."""
    assert 1 < k <= 60
    n = codes.size
    a = np.minimum(_runs(codes), k)
    c = np.where(codes < 4, codes, 0).astype(np.uint64)
    # x[p]: bases p, p-1, .., p-31 from the top bits down (by doubling)
    x = c << np.uint64(62)
    for step in (1, 2, 4, 8, 16):
        x[step:] |= x[:-step] >> np.uint64(2 * step)
    w0 = x
    nb1 = 2 * max(0, k - 32)
    w1 = np.zeros(n, dtype=np.uint64)
    if nb1:
        w1[32:] = (x[:-32] >> np.uint64(64 - nb1)) << np.uint64(8)
    # clear the bases past each window's own length
    lut0 = np.array([sum(3 << (62 - 2 * j) for j in range(m))
                     for m in range(33)], dtype=np.uint64)
    lut1 = np.array([sum(3 << (8 + 2 * (k - 1 - j)) for j in range(32, 32 + m))
                     for m in range(max(0, k - 32) + 1)], dtype=np.uint64)
    w0 &= lut0[np.minimum(a, 32)]
    w1 &= lut1[np.maximum(a - 32, 0)]
    w1 |= a.astype(np.uint64)
    return w0, w1


def lcp(k: int, w0a, w1a, w0b, w1b) -> np.ndarray:
    """Common leading real bases of two reversed windows."""
    la = (w1a & np.uint64(0xFF)).astype(np.int64)
    lb = (w1b & np.uint64(0xFF)).astype(np.int64)
    x0 = w0a ^ w0b
    x1 = (w1a ^ w1b) >> np.uint64(8)
    nb1 = 2 * max(0, k - 32)
    d0 = (64 - _bitlen64(x0)) // 2
    d1 = 32 + (nb1 - _bitlen64(x1)) // 2
    diff = np.where(x0 != 0, d0, np.where(x1 != 0, d1, k))
    return np.minimum(diff, np.minimum(la, lb))


def _sort_keys(w0: np.ndarray, w1: np.ndarray):
    """(w0, w1) sorted by w0, then w1: one sort of w0, then the runs of
    equal w0 (few) sorted again by both."""
    order = np.argsort(w0)
    s0 = w0[order]
    tie = np.zeros(s0.size, dtype=bool)
    eq = s0[1:] == s0[:-1]
    tie[1:] |= eq
    tie[:-1] |= eq
    t = np.flatnonzero(tie)
    if t.size:
        sub = order[t]
        order[t] = sub[np.lexsort((w1[sub], w0[sub]))]
    return w0[order], w1[order]


class Rows:
    """The colex-sorted row set of an index over ``seqs`` (ASCII bytes)."""

    def __init__(self, seqs: list[bytes], k: int, add_revcomp: bool = False):
        self.k = k
        parts = []
        sep = np.array([255], dtype=np.uint8)
        for s in seqs:
            parts += [_CODE[np.frombuffer(bytes(s), dtype=np.uint8)], sep]
            if add_revcomp:
                parts += [_CODE[np.frombuffer(revcomp(bytes(s)),
                                              dtype=np.uint8)], sep]
        codes = np.concatenate(parts)
        w0, w1 = pack_windows(codes, k)
        keep = codes < 4
        w0 = np.concatenate([np.zeros(1, np.uint64), w0[keep]])
        w1 = np.concatenate([np.zeros(1, np.uint64), w1[keep]])
        w0, w1 = _sort_keys(w0, w1)
        uniq = np.ones(w0.size, dtype=bool)
        uniq[1:] = (w0[1:] != w0[:-1]) | (w1[1:] != w1[:-1])
        self.w0, self.w1 = w0[uniq], w1[uniq]
        self.n_rows = int(self.w0.size)
        self.n_kmers = int(np.count_nonzero(
            (self.w1 & np.uint64(0xFF)) == np.uint64(k)))
        # lcp of each row with the row before it (row 0: -1)
        self.row_lcp = np.full(self.n_rows, -1, dtype=np.int64)
        self.row_lcp[1:] = lcp(k, self.w0[1:], self.w1[1:],
                               self.w0[:-1], self.w1[:-1])
        starts = np.flatnonzero(np.r_[True, self.w0[1:] != self.w0[:-1]])
        self.max_group = int(np.diff(np.r_[starts, self.n_rows]).max())

    def locate(self, w0q, w1q) -> np.ndarray:
        """Number of rows strictly below each key."""
        qo = np.argsort(w0q)  # sorted probes search the table far faster
        lo = np.empty(w0q.size, dtype=np.int64)
        lo[qo] = np.searchsorted(self.w0, w0q[qo], side="left")
        ins = lo.copy()
        last = self.n_rows - 1
        for j in range(self.max_group):
            idx = np.minimum(lo + j, last)
            ins += ((lo + j <= last) & (self.w0[idx] == w0q)
                    & (self.w1[idx] < w1q))
        return ins

    def texts(self, rows: np.ndarray) -> np.ndarray:
        """[R, k] ASCII text of rows ('$' for padding)."""
        k = self.k
        rows = np.asarray(rows, dtype=np.int64)
        w0, w1 = self.w0[rows], self.w1[rows]
        a = (w1 & np.uint64(0xFF)).astype(np.int64)
        out = np.full((rows.size, k), ord("$"), dtype=np.uint8)
        for j in range(k):
            if j < 32:
                ch = (w0 >> np.uint64(62 - 2 * j)) & np.uint64(3)
            else:
                ch = (w1 >> np.uint64(8 + 2 * (k - 1 - j))) & np.uint64(3)
            out[:, k - 1 - j] = np.where(j < a, _ASCII[ch.astype(np.int64)],
                                         ord("$"))
        return out

    def members(self, probes: np.ndarray) -> np.ndarray:
        """Bool [P]: is each [P, k] ASCII probe exactly a row ('$' never)?"""
        k = self.k
        P = probes.shape[0]
        codes = np.full((P, k + 1), 255, dtype=np.uint8)
        codes[:, :k] = _CODE[probes]
        w0, w1 = pack_windows(codes.reshape(-1), k)
        ends = np.arange(P) * (k + 1) + k - 1
        w0q, w1q = w0[ends], w1[ends]
        ins = self.locate(w0q, w1q)
        insc = np.minimum(ins, self.n_rows - 1)
        hit = (ins < self.n_rows) & (self.w0[insc] == w0q) & (
            self.w1[insc] == w1q)
        return hit & (w1q & np.uint64(0xFF) == np.uint64(k))


def ms_query(rows: Rows, codes: np.ndarray, exact_only: bool = False):
    """(ms, unique_row) of every position of a code array (non-ACGT codes
    break windows). ``unique_row`` is the row of a one-row interval, else -1.

    ``exact_only`` is the control: a position counts only a whole k-mer that
    is a row (ms = k), nothing shorter (ms = 0)."""
    k = rows.k
    n_rows = rows.n_rows
    w0q, w1q = pack_windows(codes, k)
    ins = rows.locate(w0q, w1q)
    pred = ins - 1
    succ = ins
    predc = np.maximum(pred, 0)
    succc = np.minimum(succ, n_rows - 1)
    lp = np.where(pred >= 0,
                  lcp(k, w0q, w1q, rows.w0[predc], rows.w1[predc]), -1)
    ls = np.where(succ < n_rows,
                  lcp(k, w0q, w1q, rows.w0[succc], rows.w1[succc]), -1)
    ms = np.maximum(lp, ls)
    if exact_only:
        ms = np.where(ms == k, k, 0)
    pm = lp >= ms
    sm = ls >= ms
    p_more = pm & (pred >= 1) & (rows.row_lcp[predc] >= ms)
    nxt = np.minimum(succ + 1, n_rows - 1)
    s_more = sm & (succ + 1 < n_rows) & (rows.row_lcp[nxt] >= ms)
    uniq = (pm ^ sm) & ~p_more & ~s_more
    urow = np.where(uniq, np.where(pm, pred, succ), -1)
    return ms.astype(np.int64), urow.astype(np.int64)


def encode(seq: bytes) -> np.ndarray:
    return _CODE[np.frombuffer(bytes(seq), dtype=np.uint8)]


def ms_of_rows(rows: Rows, mat: np.ndarray, exact_only: bool = False):
    """MS of each row of an [R, L] ASCII matrix, each read on its own."""
    R, L = mat.shape
    codes = np.full((R, L + 1), 255, dtype=np.uint8)
    codes[:, :L] = _CODE[mat]
    ms, _ = ms_query(rows, codes.reshape(-1), exact_only)
    return ms.reshape(R, L + 1)[:, :L]


# ---------------------------------------------- derandomize and translate
def derandomize(noisy: np.ndarray, k: int, threshold: int) -> np.ndarray:
    """kbo's right-to-left derandomization (src/derandomize.rs:221-288)."""
    vals = np.asarray(noisy, dtype=np.int64).tolist()
    n = len(vals)
    out = [0] * n
    nxt = vals[-1] if vals[-1] > threshold else 0
    out[-1] = nxt
    for i in range(n - 2, -1, -1):
        cur = vals[i]
        run = nxt - 1
        if cur == k:
            run = k
        if cur > threshold and nxt < cur:
            run = cur
        out[i] = run
        nxt = run
    return np.asarray(out, dtype=np.int64)


def translate(ms: np.ndarray, k: int, threshold: int) -> np.ndarray:
    """kbo's translation (src/translate.rs:180-293) as a uint8 array.

    Per position: 'R' where ms > t and the next is in (0, t) (it also makes
    the next position 'R'); '-' or 'X' where ms <= 0; else 'M'. The next
    position's own value is then skipped, except at position 1 (kbo tests
    ``pos > 1``) and at the last position (never written)."""
    ms = np.asarray(ms, dtype=np.int64)
    n = ms.size
    assert n > 2
    prev = np.empty(n, dtype=np.int64)
    prev[:2] = k
    prev[2:] = ms[1:-1]
    nxt = np.empty(n, dtype=np.int64)
    nxt[:-1] = ms[1:]
    nxt[-1] = ms[-1]
    trig = (ms > threshold) & (nxt > 0) & (nxt < threshold)
    out = np.full(n, ord("M"), dtype=np.uint8)
    low = ms <= 0
    out[low] = np.where((nxt[low] == 1) & (prev[low] > 0), ord("X"), ord("-"))
    out[trig] = ord("R")
    tp = np.flatnonzero(trig) + 1
    tp = tp[(tp < n - 1) & (tp > 1)]
    out[tp] = ord("R")
    return out


def run_lengths(chars: np.ndarray) -> list[tuple]:
    """kbo's RLE segments with no gap allowed (src/format.rs:98-193) as
    tuples (start, end, matches, mismatches, jumps, gap_bases, gap_opens)."""
    s = bytes(chars).decode("latin-1")
    n = len(s)
    segs = []
    pos = 0
    while pos < n:
        if s[pos] == "-" or s[pos] == " ":
            pos += 1
            continue
        start, end, mat, mis, jumps, gb, go = pos, 0, 0, 0, 0, 0, 0
        in_dash = False
        run_dashes = 0
        while pos < n and s[pos] != " ":
            c = s[pos]
            if c == "-":
                if not in_dash:
                    in_dash = True
                    go += 1
                    run_dashes = 0
                run_dashes += 1
            else:
                in_dash = False
            gap = c == "-" or c == "D"
            if c in "MRI":
                mat += 1
            elif gap:
                gb += 1
            else:
                mis += 1
            if not gap:
                end = pos + 1
            if c == "R" and pos > 0 and s[pos - 1] == "R":
                jumps += 1
            pos += 1
            if run_dashes > 0 or (gap and pos == n and go > 0):
                go -= 1
                gb -= run_dashes
                break
        segs.append((start, end, mat, mis, jumps, gb, go))
    return segs


# --------------------------------------------------------------- find
def find_batch(rows: Rows, queries: list[bytes], max_error_prob: float = 1e-7,
               exact_only: bool = False) -> list[list[tuple]]:
    """kbo ``find`` of each query against the index (``FindOpts()``)."""
    k = rows.k
    t = random_match_threshold(k, rows.n_kmers, 4, max_error_prob)
    codes = np.concatenate(
        [np.r_[encode(q), np.uint8(255)] for q in queries])
    ms, _ = ms_query(rows, codes, exact_only)
    out = []
    pos = 0
    for q in queries:
        m = ms[pos:pos + len(q)]
        pos += len(q) + 1
        out.append(run_lengths(translate(derandomize(m, k, t), k, t)))
    return out


# ------------------------------------------------------- variant calling
def _rightmost_peaks(ms: np.ndarray, d: int) -> np.ndarray:
    mask = (ms[:, :-1] >= d) & (ms[:, :-1] > ms[:, 1:])
    has = mask.any(axis=1)
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    return np.where(has, last, -1)


def call_variants(rows: Rows, seq: bytes, max_error_prob: float = 1e-7,
                  add_revcomp: bool = False, ms=None, urow=None,
                  exact_only: bool = False) -> list[tuple[int, bytes, bytes]]:
    """kbo ``call`` of an indexed query against a reference sequence
    (src/variant_calling.rs:249-294): (position in ``seq``, the query's
    characters, the reference's characters). ``rows`` is the query's index;
    ``seq`` is streamed through it."""
    k = rows.k
    seq = bytes(seq)
    n = len(seq)
    d = random_match_threshold(k, rows.n_kmers, 4, max_error_prob)
    if ms is None:
        ms, urow = ms_query(rows, encode(seq), exact_only)
    drops = np.flatnonzero((ms[1:] < ms[:-1]) & (ms[:-1] >= d)
                           & (ms[1:] < d)) + 1
    if drops.size == 0:
        return []
    good = (ms >= d) & (urow >= 0)
    idx = np.arange(n, dtype=np.int64)
    big = np.int64(1 << 62)
    next_good = np.minimum.accumulate(np.where(good, idx, big)[::-1])[::-1]
    nxt = np.where(drops + 1 < n, next_good[np.minimum(drops + 1, n - 1)],
                   big)
    has = nxt <= drops + k
    sites = drops[has]
    anchors = nxt[has]
    if sites.size == 0:
        return []
    rk = rows.texts(urow[anchors])
    sb = np.frombuffer(seq, dtype=np.uint8)
    widx = anchors[:, None] + np.arange(-(k - 1), 1, dtype=np.int64)[None, :]
    qk = np.where(widx >= 0, sb[np.maximum(widx, 0)], np.uint8(ord("$")))
    qk = qk.astype(np.uint8)
    ms_vs_ref = ms_of_rows(rows, qk, exact_only)
    seq_rows = Rows([seq], k, add_revcomp)
    ms_vs_query = ms_of_rows(seq_rows, rk, exact_only)

    eq = qk == rk
    csl = np.cumprod(eq[:, ::-1], axis=1).sum(axis=1)
    qpeak = _rightmost_peaks(ms_vs_ref, d)
    rpeak = _rightmost_peaks(ms_vs_query, d)
    ok = (qpeak >= 0) & (rpeak >= 0) & (csl > 0)
    sms = k - csl
    qgap = sms - qpeak - 1
    rgap = sms - rpeak - 1
    subst = ok & (qgap > 0) & (rgap > 0)
    indel = ok & ~subst & (qgap != rgap)
    is_del = indel & (-qgap > -rgap)
    vlen = np.abs(qgap - rgap)
    calls = []
    for t in np.flatnonzero(subst | indel).tolist():
        if subst[t]:
            qc = qk[t, qpeak[t] + 1: sms[t]].tobytes()
            rc = rk[t, rpeak[t] + 1: sms[t]].tobytes()
        elif is_del[t]:
            qc = b""
            rc = rk[t, rpeak[t] + 1: rpeak[t] + 1 + vlen[t]].tobytes()
        else:
            qc = qk[t, qpeak[t] + 1: qpeak[t] + 1 + vlen[t]].tobytes()
            rc = b""
        calls.append((int(sites[t]), qc, rc))
    return calls


def variant_patches(variants) -> list[tuple[int, int]]:
    """kbo ``add_variants`` (src/translate.rs:350-386) as writes."""
    out = []
    for pos, q, r in variants:
        if len(q) == len(r):
            out += [(pos + i, nt) for i, nt in enumerate(r)]
        elif len(q) == 0:
            out += [(pos - 1, ord("I")), (pos, ord("I"))]
        elif len(r) == 0:
            out += [(pos + i, ord("D")) for i in range(len(q))]
        else:
            fill = r[0] if len(set(r)) == 1 else ord("N")
            out += [(pos + i, fill) for i in range(len(q))]
    return out


# ------------------------------------------------------------ gap filling
def _trailing(eq: np.ndarray) -> np.ndarray:
    if eq.shape[1] == 0:
        return np.zeros(eq.shape[0], dtype=np.int64)
    return np.cumprod(eq[:, ::-1], axis=1).sum(axis=1).astype(np.int64)


def _leading(eq: np.ndarray) -> np.ndarray:
    if eq.shape[1] == 0:
        return np.zeros(eq.shape[0], dtype=np.int64)
    return np.cumprod(eq, axis=1).sum(axis=1).astype(np.int64)


def gap_runs(chars: np.ndarray, threshold: int) -> list[tuple[int, int]]:
    """Maximal ('-' | 'X') '-'* runs starting in [t, n - t - 1)
    (src/gap_filling.rs:466-475): (start, first non-'-' after it)."""
    n = chars.size
    dash = chars == ord("-")
    gapc = dash | (chars == ord("X"))
    not_dash = np.flatnonzero(~dash)
    runs = []
    p = threshold
    for p0 in (np.flatnonzero(gapc[threshold: n - threshold - 1])
               + threshold).tolist():
        if p0 < p:
            continue
        i = np.searchsorted(not_dash, p0 + 1)
        q = int(not_dash[i]) if i < not_dash.size else n
        runs.append((p0, q))
        p = q
    return runs


def _left_extend(rows: Rows, kmers: np.ndarray, budgets: np.ndarray):
    """Prepend to each ASCII k-mer, while exactly one base b makes
    ``b + first k-1`` a row, up to its budget (src/gap_filling.rs:205-232)."""
    k = rows.k
    E = kmers.shape[0]
    prefix = kmers[:, : k - 1].copy()
    pre = [[] for _ in range(E)]
    spent = np.zeros(E, dtype=np.int64)
    active = budgets > 0
    while active.any():
        lanes = np.flatnonzero(active)
        probes = np.empty((4, lanes.size, k), dtype=np.uint8)
        for b in range(4):
            probes[b, :, 0] = BASES[b]
            probes[b, :, 1:] = prefix[lanes]
        hit = rows.members(probes.reshape(4 * lanes.size, k)).reshape(
            4, lanes.size)
        ok = hit.sum(axis=0) == 1
        ch = _ASCII[np.argmax(hit, axis=0)]
        for i in np.flatnonzero(ok).tolist():
            pre[lanes[i]].append(int(ch[i]))
        good = lanes[ok]
        prefix[good, 1:] = prefix[good, :-1]
        prefix[good, 0] = ch[ok]
        spent[good] += 1
        active[:] = False
        active[good] = spent[good] < budgets[good]
    return [np.concatenate([np.asarray(pre[i][::-1], dtype=np.uint8),
                            kmers[i]]) for i in range(E)]


def fill_gaps(runs, urow: np.ndarray, seq: bytes, rows: Rows,
              threshold: int, max_error_prob: float) -> list[tuple[int, int]]:
    """kbo's gap filling (src/gap_filling.rs:295-361, :444-526): per gap the
    first unique-context k-mer, scanning down from the far end of its search
    window, that overlaps both flanks (left-extended where it must), painted
    'M' where it agrees with the reference and with its base elsewhere."""
    k = rows.k
    n = len(seq)
    ref = np.frombuffer(bytes(seq), dtype=np.uint8)
    if not runs:
        return []
    t = threshold
    gs = np.asarray([r[0] for r in runs], dtype=np.int64)
    ge = np.minimum(np.asarray([r[1] for r in runs], dtype=np.int64), n - t)
    glen = ge - gs
    radius = np.where(glen + 2 * t <= k, k - t, k)
    lo = ge + t
    hi = np.minimum(ge + radius, n - 1)
    # candidates: (gap, position) with a one-row interval, descending
    gi_parts, j_parts = [], []
    for g in range(gs.size):
        if hi[g] < lo[g]:
            continue
        js = np.arange(hi[g], lo[g] - 1, -1, dtype=np.int64)
        js = js[urow[js] >= 0]
        gi_parts.append(np.full(js.size, g, dtype=np.int64))
        j_parts.append(js)
    fills: list = [None] * gs.size
    if gi_parts:
        gidx = np.concatenate(gi_parts)
        jpos = np.concatenate(j_parts)
    else:
        gidx = jpos = np.zeros(0, dtype=np.int64)
    if gidx.size:
        kmers = rows.texts(urow[jpos])
        padded = np.full(n + 2 * k, _OOB, dtype=np.uint8)
        padded[k: k + n] = ref
        offs = np.arange(k, dtype=np.int64)[None, :]
        g_s, g_e = gs[gidx], ge[gidx]
        right_win = padded[(jpos - (k - 1))[:, None] + offs + k]
        rg = _trailing((kmers == right_win)[:, 1:])
        want = jpos - g_e + 1
        rsp = np.where(g_s > t, g_s - t, 0)
        lg = _leading(kmers == padded[rsp[:, None] + offs + k])
        right_ok = rg >= np.minimum(want, k)
        case_a = right_ok & (lg >= t)
        gl = g_e - g_s
        case_b = (k < t + gl + rg) & right_ok & (lg < t)
        ext_ok = np.zeros(gidx.size, dtype=bool)
        ext_lm = np.zeros(gidx.size, dtype=np.int64)
        ext = {}
        lanes = np.flatnonzero(case_b)
        if lanes.size:
            budgets = np.maximum((t + gl + rg - k)[lanes], 0)
            for lane, e in zip(lanes.tolist(),
                               _left_extend(rows, kmers[lanes], budgets)):
                stop = min(e.size, n - int(rsp[lane]))
                eq = e[:stop] == ref[int(rsp[lane]): int(rsp[lane]) + stop]
                lm = int(_leading(eq[None, :])[0])
                ext_lm[lane] = lm
                if lm >= t:
                    ext_ok[lane] = True
                    ext[lane] = e
        for c in np.flatnonzero(case_a | ext_ok).tolist():
            g = int(gidx[c])
            if fills[g] is not None:
                continue
            if case_a[c]:
                fills[g] = kmers[c, int(lg[c] - t): int(k - (rg[c] - t))]
            else:
                e = ext[c]
                fills[g] = e[int(ext_lm[c] - t): int(e.size - (rg[c] - t))]
    bound = math.log1p(-max_error_prob)
    patches = []
    for g in range(gs.size):
        f = fills[g]
        L = 0 if f is None else f.size
        a, b = int(gs[g]), int(ge[g])
        if L == 0 or L != 2 * t + (b - a) or (f == ord("$")).any():
            continue
        seg = f[t: t + (b - a)]
        matching = seg == ref[a:b]
        ok = (b - a) + 2 * t <= k
        if not ok:
            ok = _run_log_prob(matching, bound) or (
                matching.size > 0 and not matching[0] and not matching[-1]
                and int(matching.sum()) + 2 == b - a)
        if ok:
            vals = np.where(seg == ref[a:b], np.uint8(ord("M")), seg)
            patches += list(zip(range(a, b), vals.tolist()))
    return patches


def _run_log_prob(matching: np.ndarray, bound: float) -> bool:
    if matching.size < 2:
        return 0.0 > bound
    pairs = matching[:-1] & matching[1:]
    total = 0.0
    run = 0
    for i, p in enumerate(pairs.tolist()):
        if p:
            run += 1
            continue
        if run:
            total += log_rm_max_cdf(run + 1, 4, 1)
        run = 0
    return total > bound


# ------------------------------------------------------------------ map
def map_(rows: Rows, seq: bytes, max_error_prob: float = 1e-7,
         exact_only: bool = False) -> bytes:
    """kbo ``map`` with ``MapOpts()`` (src/lib.rs:720-761): the indexed
    query laid onto the streamed reference ``seq``, gaps filled, variants
    called, relative to the reference."""
    k = rows.k
    seq = bytes(seq)
    t = random_match_threshold(k, rows.n_kmers, 4, max_error_prob)
    ms, urow = ms_query(rows, encode(seq), exact_only)
    chars = translate(derandomize(ms, k, t), k, t)
    patches = fill_gaps(gap_runs(chars, t), urow, seq, rows, t,
                        max_error_prob)
    patches += variant_patches(call_variants(
        rows, seq, max_error_prob, ms=ms, urow=urow))
    for p, v in patches:  # in order: a later write wins
        chars[p] = v
    ref = np.frombuffer(seq, dtype=np.uint8)
    out = chars.copy()
    take = (chars == ord("M")) | (chars == ord("R")) | (chars == ord("I"))
    dash = (chars == ord("X")) | (chars == ord("D")) | (chars == ord("-"))
    out[take] = ref[take]
    out[dash] = ord("-")
    return out.tobytes()
