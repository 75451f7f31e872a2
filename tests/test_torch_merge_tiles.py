"""The index arithmetic of the port's merge and scan kernels
(csrc/merge_path.cu, csrc/clamp_scan.cu), on the CPU.

CUDA cannot run here, so these emulate the two kernels in numpy with their
own constants (read from the sources) and index arithmetic, and hold the
result to the plain versions bit for bit. The plain versions are held to
kbo_tpu in test_torch_kernels.py and test_torch_ms.py.

- merge: the tile partition, each tile's slab bounds (A run, then B run),
  each thread's diagonal inside the slabs, its serial merge recording
  source indices, and the row-by-row gather of the output;
- scan: the staged rows with their padding and scan-side neighbour, ell
  per scan position, the per-thread run and the CTA's exclusive scan as
  the warp shuffles compose it, and the decoupled look-back through
  64-bit status words, under shuffled orders in which tiles publish.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import kbo_tpu_torch
from kbo_tpu_torch.kernels.join import clamp_scan_plain
from kbo_tpu_torch.kernels.sort import _radix_sort, merge_path_plain, to_i32

torch.set_num_threads(2)

CSRC = Path(kbo_tpu_torch.__file__).resolve().parent / "kernels" / "csrc"
U32 = 0xFFFFFFFF


def _constants(name):
    text = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (0x[0-9a-f]+|\d+);", text)
            if not v.startswith("0x")}


MERGE = _constants("merge_path")
SCAN = _constants("clamp_scan")
for _c in (MERGE, SCAN):  # constexpr int kTile = kThreads * kItems;
    _c["kTile"] = _c["kThreads"] * _c["kItems"]


def _sorted(rng, W, n, top=U32, alphabet=9, pad_share=0.0):
    raw = rng.integers(0, alphabet, (W, n)).astype(np.int64) * (top // 8)
    raw[:, rng.random(n) < pad_share] = U32
    words, _ = _radix_sort(to_i32(torch.from_numpy(raw)))
    return words


# ----------------------------------------------------------------- merge


def _lt(yk, xk):
    """Column-wise y <lex x over the key rows (uint32 values in int64)."""
    lt = np.zeros(yk.shape[1:], dtype=bool)
    eq = np.ones(yk.shape[1:], dtype=bool)
    for c in range(yk.shape[0]):
        lt |= eq & (yk[c] < xk[c])
        eq &= yk[c] == xk[c]
    return lt


def _diagonals(a, b, t, lo, hi):
    """The smallest x in [lo, hi] with b[t-x-1] <lex a[x], else hi, for
    arrays of diagonals at once (the kernels' binary search)."""
    lo, hi = lo.copy(), hi.copy()
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        ai = np.where(act, mid, 0)
        bi = np.where(act, t - mid - 1, 0)
        pred = _lt(b[:, bi], a[:, ai])
        hi = np.where(act & pred, mid, hi)
        lo = np.where(act & ~pred, mid + 1, lo)
    return lo


def _merge_items(W):
    """Outputs a thread merges at W key rows: kItems, or kItemsWide above
    kMaxWFull (half-length tiles, so that W + 1 slabs fit)."""
    assert W <= MERGE["kMaxW"]
    return MERGE["kItemsWide"] if W > MERGE["kMaxWFull"] else MERGE["kItems"]


def _merge_emulated(a_keys, a_pay, b_keys, b_pay):
    W = a_keys.shape[0]
    nthr, items = MERGE["kThreads"], _merge_items(W)
    T = nthr * items
    assert T <= 1 << 16  # 16-bit source indices
    ak = np.concatenate([a_keys.numpy().astype(np.int64) & U32,
                         a_pay.numpy()[None].astype(np.int64)])
    bk = np.concatenate([b_keys.numpy().astype(np.int64) & U32,
                         b_pay.numpy()[None].astype(np.int64)])
    na, nb = ak.shape[1], bk.shape[1]
    total = na + nb
    n_tiles = -(-total // T)
    # launch 1: every tile's A offset
    t = np.minimum(np.arange(n_tiles + 1) * T, total)
    a_off = _diagonals(ak[:W], bk[:W], t, np.maximum(0, t - nb),
                       np.minimum(t, na))
    out = np.full((W + 1, total), -7, dtype=np.int64)
    written = np.zeros(total, dtype=np.int64)
    for tile in range(n_tiles):
        t0 = tile * T
        n = min(T, total - t0)
        a_lo = a_off[tile]
        b_lo = t0 - a_lo
        n_a = a_off[tile + 1] - a_lo
        n_b = n - n_a
        assert 0 <= n_a <= n and b_lo + n_b <= nb
        # a. the slabs: A run, then B run, of every row
        slab = np.full((W + 1, T), -9, dtype=np.int64)
        slab[:, :n_a] = ak[:, a_lo:a_lo + n_a]
        slab[:, n_a:n] = bk[:, b_lo:b_lo + n_b]
        # b. each thread's diagonal in the slabs, then its serial merge
        d = np.minimum(np.arange(nthr) * items, n)
        A, B = slab[:W, :n_a], slab[:W, n_a:n]
        ai = _diagonals(A if n_a else np.zeros((W, 1)), B if n_b else
                        np.zeros((W, 1)), d, np.maximum(0, d - n_b),
                        np.minimum(d, n_a))
        bi = d - ai
        src = np.full(T, -1, dtype=np.int64)
        for r in range(items):
            o = d + r
            live = o < np.minimum(d + items, n)
            ac, bc = np.minimum(ai, T - 1), np.minimum(n_a + bi, T - 1)
            take_a = (bi >= n_b) | ((ai < n_a) & ~_lt(slab[:W, bc],
                                                      slab[:W, ac]))
            src[o[live]] = np.where(take_a, ai, n_a + bi)[live]
            ai = ai + (live & take_a)
            bi = bi + (live & ~take_a)
        # each output of the tile has one source, each slab element one use
        assert sorted(src[:n].tolist()) == list(range(n))
        # c. row by row: thread j writes outputs j, j + nthr, ...
        for r in range(items):
            o = r * nthr + np.arange(nthr)
            o = o[o < n]
            out[:, t0 + o] = slab[:, src[o]]
            written[t0 + o] += 1
    assert (written == 1).all()
    return to_i32(torch.from_numpy(out[:W])), to_i32(torch.from_numpy(out[W]))


def _merge_case(a_keys, b_keys):
    na, nb = a_keys.shape[1], b_keys.shape[1]
    a_pay = torch.arange(na, dtype=torch.int32)
    b_pay = torch.arange(na, na + nb, dtype=torch.int32) | (1 << 30)
    got = _merge_emulated(a_keys, a_pay, b_keys, b_pay)
    want = merge_path_plain(a_keys, a_pay, b_keys, b_pay)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("W", [4, 6, 7, 27])
@pytest.mark.parametrize("case", ["ragged", "a_empty", "b_empty",
                                  "a_before_b", "b_before_a", "all_equal"])
def test_merge_tiles_equal_plain(W, case):
    """Bit-equal to the plain merge: a total that the tile does not
    divide, na = 0, nb = 0, one side entirely before the other, and
    all-equal keys across more than five tiles (stability: A first). W = 27
    (the interval probe at k = 251..254) takes the half-length tiles."""
    T = MERGE["kThreads"] * _merge_items(W)
    rng = np.random.default_rng(W * 10 + len(case))
    if case == "ragged":
        a, b = _sorted(rng, W, 2 * T + 333), _sorted(rng, W, T + 71)
    elif case == "a_empty":
        a, b = _sorted(rng, W, 0), _sorted(rng, W, 2 * T + 5)
    elif case == "b_empty":
        a, b = _sorted(rng, W, 3 * T - 1), _sorted(rng, W, 0)
    elif case in ("a_before_b", "b_before_a"):
        lo = _sorted(rng, W, T + 100, top=0x7FFFFFFF)
        hi = to_i32((_sorted(rng, W, 2 * T - 3, top=0x7FFFFFFF).to(torch.int64)
                     & U32) | 0x80000000)
        a, b = (lo, hi) if case == "a_before_b" else (hi, lo)
    else:
        a = _sorted(rng, W, 3 * T + 17, alphabet=1)
        b = _sorted(rng, W, 3 * T - 250, alphabet=1)
        assert (a.shape[1] + b.shape[1]) // T >= 5
    _merge_case(a, b)


@pytest.mark.parametrize("W", [4, 6, 7, 26, 27])
def test_merge_slabs_fit_a_block(W):
    """A tile's W + 1 slabs and its 16-bit source indices fit the 232 448 B
    of shared memory a Hopper block may ask for; at W = 27 the full-length
    tile would not, which is why it takes the half-length one."""
    tile = MERGE["kThreads"] * _merge_items(W)
    assert tile * (W + 1) * 4 + tile * 2 <= 232_448
    full = MERGE["kTile"]
    assert (full * (W + 1) * 4 + full * 2 <= 232_448) == (
        W <= MERGE["kMaxWFull"])


def test_merge_tiles_few_keys():
    """Long runs of equal keys on both sides, several per tile edge."""
    rng = np.random.default_rng(3)
    T = MERGE["kTile"]
    _merge_case(_sorted(rng, 4, 4 * T + 1, alphabet=3),
                _sorted(rng, 4, 3 * T + 9, alphabet=3))


# ------------------------------------------------------------------ scan

ID_A, ID_B = 2**31 - 1, -(2**31 - 1)
FLAG_AGG, FLAG_PREFIX = 1 << 62, 2 << 62
ENC_ID_A = (1 << 30) - 1


def _compose(o, c):
    return min(o[0], c[0]), max(min(o[1], c[0]), c[1])


def _pack(flag, x):
    ea = ENC_ID_A if x[0] == ID_A else x[0] + 1
    assert 0 <= ea <= ENC_ID_A
    return flag | (ea << 32) | (x[1] & U32)


def _unpack(s):
    ea = (s >> 32) & ENC_ID_A
    b = s & U32
    return (ID_A if ea == ENC_ID_A else ea - 1,
            b - (1 << 32) if b >= 1 << 31 else b)


def test_status_word_round_trip():
    """Both sentinels, ell = -1 (a bits=3 pad), the largest ell and any
    int32 cap survive the 64-bit status word, flags apart."""
    for a in (-1, 0, 1, 26 * 16, ID_A):
        for b in (-1, 0, 254, 265, ID_B, -(2**31), 2**31 - 1):
            for flag in (FLAG_AGG, FLAG_PREFIX):
                s = _pack(flag, (a, b))
                assert s >> 62 == flag >> 62 and s < 1 << 64
                assert _unpack(s) == (a, b)
    assert _pack(FLAG_AGG, (ID_A, ID_B)) >> 62 == 1
    # an empty status word is 0: flag 0
    assert (0 >> 62) == 0


def _clz(x):
    _, e = np.frexp(x.astype(np.float64))
    return np.where(x == 0, 32, 32 - e)


def _pad(u):
    return u + (u >> 5)


def _tile_transforms(words, cap, bits, reverse, tile):
    """One tile as the kernel stages and reads it: per-item transforms
    (a, b) in scan order, the number of valid positions, the staged slot
    of each position, and the ells seen."""
    T, nthr, items = SCAN["kTile"], SCAN["kThreads"], SCAN["kItems"]
    W, M = words.shape
    p0 = tile * T
    n = min(T, M - p0)
    s_lo = M - p0 - n if reverse else p0
    off = 0 if reverse else 1
    row = _pad(T) + 1
    rows = np.full((W + 1, row), -5, dtype=np.int64)
    u = np.arange(n)
    assert _pad(n - 1 + off) < row and len(set(_pad(u + off))) == n
    rows[:, _pad(u + off)] = np.concatenate([words, cap[None]])[:, s_lo + u]
    if tile > 0:
        nb_slot = s_lo + n if reverse else s_lo - 1
        rows[:W, _pad(n if reverse else 0)] = words[:, nb_slot]
    q = np.arange(nthr)[:, None] * items + np.arange(items)[None, :]
    valid = q < n
    i = np.where(reverse, n - 1 - q, q + 1)
    j = np.where(reverse, i + 1, i - 1)
    i, j = np.where(valid, i, 0), np.where(valid, j, 0)
    per_word, lead = (16, 0) if bits == 2 else (10, 2)
    ell = np.zeros(q.shape, dtype=np.int64)
    alive = np.ones(q.shape, dtype=bool)
    for c in range(W):
        x = rows[c, _pad(i)] ^ rows[c, _pad(j)]
        nz = x != 0
        ell += np.where(alive, np.where(nz, (_clz(x) - lead) // bits,
                                        per_word), 0)
        alive &= ~nz
    ell = np.where(p0 + q == 0, 0, ell)
    capv = rows[W, _pad(i)]
    return ell, capv, valid, i, s_lo, off, n


def _warp_scan_exclusive(run):
    """cta_exclusive as the shuffles compute it: inclusive shfl_up scan per
    warp, then over the warp totals; returns (exclusive, total)."""
    nthr = len(run)
    inc = list(run)
    for w0 in range(0, nthr, 32):
        d = 1
        while d < 32:
            prev = inc[w0:w0 + 32]
            for lane in range(d, 32):
                inc[w0 + lane] = _compose(prev[lane - d], prev[lane])
            d <<= 1
    wt = [inc[w0 + 31] for w0 in range(0, nthr, 32)]
    acc, wexcl = (ID_A, ID_B), []
    for x in wt:
        wexcl.append(acc)
        acc = _compose(acc, x)
    excl = []
    for t in range(nthr):
        lane_excl = (ID_A, ID_B) if t % 32 == 0 else inc[t - 1]
        excl.append(_compose(wexcl[t // 32], lane_excl))
    return excl, acc


def _look_back(status, tile):
    """Warp 0's look-back, a generator that yields while a window holds an
    empty status word; returns the tile's exclusive prefix."""
    excl = (ID_A, ID_B)
    base = tile - 1
    while True:
        while True:
            s = [status[base - lane] if base - lane >= 0
                 else _pack(FLAG_PREFIX, (ID_A, ID_B)) for lane in range(32)]
            if all(x >> 62 for x in s):
                break
            yield
        pre = [lane for lane in range(32) if s[lane] >> 62 == 2]
        stop = pre[0] if pre else 31
        v = [_unpack(s[lane]) if lane <= stop else (ID_A, ID_B)
             for lane in range(32)]
        d = 1
        while d < 32:
            v = [_compose(v[lane + d], v[lane]) if lane + d < 32 else v[lane]
                 for lane in range(32)]
            d <<= 1
        excl = _compose(v[0], excl)
        if pre:
            return excl
        base -= 32


def _scan_emulated(words, cap, bits, reverse, order_rng):
    T = SCAN["kTile"]
    W, M = words.shape
    words = words.numpy().astype(np.int64) & U32
    cap = cap.numpy().astype(np.int64)
    n_tiles = -(-M // T)
    status = [0] * n_tiles
    out = np.full(M, -77, dtype=np.int64)
    seen_pad = False

    def cta(tile):
        nonlocal seen_pad
        ell, capv, valid, idx, s_lo, off, n = _tile_transforms(
            words, cap, bits, reverse, tile)
        seen_pad |= bool((ell[valid] == -1).any())
        runs, v = [], np.empty(ell.shape, dtype=object)
        for t in range(ell.shape[0]):
            run = (ID_A, ID_B)
            for r in range(ell.shape[1]):
                if valid[t, r]:
                    run = _compose(run, (int(ell[t, r]), int(capv[t, r])))
                v[t, r] = run
            runs.append(run)
        thread_excl, total = _warp_scan_exclusive(runs)
        yield  # other CTAs run between the scan and the publish
        if tile == 0:
            status[0] = _pack(FLAG_PREFIX, total)
            tile_excl = (ID_A, ID_B)
        else:
            status[tile] = _pack(FLAG_AGG, total)
            yield
            tile_excl = yield from _look_back(status, tile)
            status[tile] = _pack(FLAG_PREFIX, _compose(tile_excl, total))
        staged = {}
        for t in range(ell.shape[0]):
            c0 = _compose(tile_excl, thread_excl[t])
            for r in range(ell.shape[1]):
                if valid[t, r]:
                    c = _compose(c0, v[t, r])
                    staged[_pad(int(idx[t, r]))] = max(min(-1, c[0]), c[1])
        u = np.arange(n)
        out[s_lo + u] = [staged[x] for x in _pad(u + off)]

    # tickets go out in order; running CTAs advance in a shuffled order
    running, started = [], 0
    while started < n_tiles or running:
        if started < n_tiles and (not running or order_rng.random() < 0.3):
            running.append(cta(started))
            started += 1
            continue
        g = running[order_rng.integers(len(running))]
        try:
            next(g)
        except StopIteration:
            running.remove(g)
    assert all(s >> 62 == 2 for s in status)
    return torch.from_numpy(out.astype(np.int32)), seen_pad


@pytest.mark.parametrize("bits", [2, 3])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("m_of_t", ["1", "T-1", "T", "T+1", "9T+77"])
def test_scan_look_back_equals_plain(bits, reverse, m_of_t):
    """Bit-equal to the plain scan at M = 1, T - 1, T, T + 1 and several
    tiles, in three shuffled orders of the CTAs; with bits = 3 the
    all-ones pads give ell = -1."""
    T = SCAN["kTile"]
    M = {"1": 1, "T-1": T - 1, "T": T, "T+1": T + 1, "9T+77": 9 * T + 77}[m_of_t]
    W = 4 if bits == 2 else 6
    rng = np.random.default_rng(bits * 100 + reverse * 10 + len(m_of_t))
    top = U32 if bits == 2 else 0x3FFFFFFF
    words = _sorted(rng, W, M, top=top, pad_share=0.02)
    per = 16 if bits == 2 else 10
    cap = torch.from_numpy(np.where(
        rng.random(M) < 0.4, rng.integers(0, W * per + 1, M), -1
    ).astype(np.int32))
    want = clamp_scan_plain(words, cap, bits, reverse)
    for seed in range(3 if M > T else 1):
        got, seen_pad = _scan_emulated(words, cap, bits, reverse,
                                       np.random.default_rng(seed))
        assert torch.equal(got, want)
        if bits == 3 and M > T:
            assert seen_pad


def test_scan_look_back_many_windows():
    """More than 32 predecessors publish only their aggregates before the
    last tiles look back: the look-back walks several windows of 32."""
    T = SCAN["kTile"]
    M = 70 * T + 5
    rng = np.random.default_rng(11)
    words = _sorted(rng, 2, M, pad_share=0.01)
    cap = torch.from_numpy(np.where(rng.random(M) < 0.3,
                                    rng.integers(0, 33, M), -1)
                           .astype(np.int32))

    class NewestFirst:
        """Starts every CTA, then advances them in turn, newest first."""
        k = 0

        def random(self):
            return 0.0

        def integers(self, n):
            self.k += 1
            return (n - self.k) % n

    got, _ = _scan_emulated(words, cap, 2, False, NewestFirst())
    assert torch.equal(got, clamp_scan_plain(words, cap, 2, False))
