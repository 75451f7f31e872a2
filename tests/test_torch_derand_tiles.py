"""The tile arithmetic of the port's derandomize + translate kernel
(csrc/derand_translate.cu), on the CPU.

CUDA cannot run here, so these emulate the kernel in numpy with its own
constants (read from the source) and hold the result to the plain version,
derandomize_translate_plain, bit for bit below each row's true length, and
to 0 at and past it:

- the tickets (row by row, inside a row from the rightmost tile leftwards),
  each thread's block of 8 consecutive positions in registers, its run
  over them, the CTA's exclusive scan as the warp shuffles compose it;
- the 64-bit status words (the aggregate's three 20-bit fields relative to
  the tile's first position, the inclusive prefix's exact phi), at their
  field limits and for aggregates that do not fit;
- the look-back under shuffled orders in which CTAs advance, over several
  windows of 32, never across a row;
- the short-row form (one CTA per row, the carry in registers);
- the derandomize by a right-to-left walk from the exclusive prefix, the
  neighbours of each block from the next lanes and warps, the halos at the
  tile's edges, and the translate stencil at true lengths 0, 1, 2, on a
  tile edge, mid-tile and L.

The plain version is held to kbo_tpu in test_torch_postprocess.py; one
multi-tile case here is held to kbo_tpu's cores directly.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kbo_tpu_torch
from kbo_tpu.kernels import postprocess as jpp
from kbo_tpu_torch.kernels.postprocess import derandomize_translate_plain

torch.set_num_threads(2)

SRC = (Path(kbo_tpu_torch.__file__).resolve().parent / "kernels" / "csrc"
       / "derand_translate.cu").read_text()
C = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SRC)}
THREADS, ITEMS, FIELD_BITS = C["kThreads"], C["kItems"], C["kFieldBits"]
WARPS = THREADS // 32
T = THREADS * ITEMS  # constexpr int kTile = kThreads * kItems;
assert "constexpr int kTile = kThreads * kItems;" in SRC

FLAG_AGG, FLAG_PREFIX, ID_BIT = 1 << 62, 2 << 62, 1 << 61
FIELD_MASK = (1 << FIELD_BITS) - 1
FIELD_MIN, FIELD_MAX = -(1 << (FIELD_BITS - 1)), (1 << (FIELD_BITS - 1)) - 1
LANE = np.arange(THREADS) % 32
WARP = np.arange(THREADS) // 32


# ------------------------------------------------- descriptors, vectorised
# (id, q, v, r) as numpy arrays: identity if id, else x == q ? v : r


def ident(shape=()):
    z = np.zeros(shape, np.int64)
    return (np.ones(shape, bool), z, z, z)


def apply(f, x):
    fid, fq, fv, fr = f
    return np.where(fid, x, np.where(x == fq, fv, fr))


def compose(first, after):
    """(function applied first) then (function applied after it)."""
    fid, fq, fv, fr = first
    return (fid & after[0], np.where(fid, after[1], fq),
            np.where(fid, after[2], apply(after, fv)),
            np.where(fid, after[3], apply(after, fr)))


def where(c, f, g):
    return tuple(np.where(c, a, b) for a, b in zip(f, g))


def take(f, idx):
    return tuple(np.asarray(a)[idx] for a in f)


def element(n, u, ii, nl, k, t):
    """The kernel's element() of local position u (ii = lo + u; nl =
    min(tl - lo, T + 1)): identity past nl - 1, the constant at nl - 1
    (true_len - 1), constant a at n == k, the point function (a-1, a-1, a)
    above t, identity else; a = n - ii; constants carry q == v."""
    n, ii = np.asarray(n, np.int64), np.asarray(ii, np.int64)
    a = n - ii
    vl = np.where(n > t, n, 0) - ii
    last = u == nl - 1
    idn = (u > nl - 1) | (~last & (n != k) & (n <= t))
    q = np.where(last, vl, np.where(n == k, a, a - 1))
    r = np.where(last, vl, a)
    z = np.zeros_like(a)
    return (idn, np.where(idn, z, q), np.where(idn, z, q), np.where(idn, z, r))


def step(n, u, ii, nl, k, t, phi):
    """The kernel's step(): apply(element(...), phi) written out."""
    n, ii = np.asarray(n, np.int64), np.asarray(ii, np.int64)
    a = n - ii
    ordinary = np.where(n == k, a, np.where(
        n > t, np.where(phi == a - 1, a - 1, a), phi))
    return np.where(u > nl - 1, phi, np.where(
        u == nl - 1, np.where(n > t, n, 0) - ii, ordinary))


def shfl_up(x, d):
    """__shfl_up_sync within each warp (lanes below d keep their own)."""
    src = np.where(LANE >= d, np.arange(THREADS) - d, np.arange(THREADS))
    return take(x, src)


def cta_exclusive(run):
    """cta_exclusive() as the shuffles compute it: an inclusive shfl_up
    scan per warp, each warp's scan of the warp totals in its first lanes,
    then the exclusive value of each thread; returns (exclusive, total)."""
    inc = run
    d = 1
    while d < 32:
        inc = where(LANE >= d, compose(shfl_up(inc, d), inc), inc)
        d <<= 1
    lanes = np.arange(32)
    tot = take(inc, np.minimum(lanes, WARPS - 1) * 32 + 31)
    v = where(lanes < WARPS, tot, ident(32))
    d = 1
    while d < WARPS:
        src = np.where(lanes >= d, lanes - d, lanes)
        v = where(lanes >= d, compose(take(v, src), v), v)
        d <<= 1
    lane_excl = where(LANE == 0, ident(THREADS), shfl_up(inc, 1))
    warp_excl = where(WARP == 0, ident(THREADS), take(v, np.maximum(WARP - 1, 0)))
    return compose(warp_excl, lane_excl), take(v, WARPS - 1)


# ------------------------------------------------------------ status words


def pack_aggregate(f, lo):
    fid, q, v, r = (int(x) for x in f)
    if fid:
        return FLAG_AGG | ID_BIT
    fields = (q + lo, v + lo, r + lo)
    if min(fields) < FIELD_MIN or max(fields) > FIELD_MAX:
        return 0
    return (FLAG_AGG | (fields[0] & FIELD_MASK) << 40
            | (fields[1] & FIELD_MASK) << 20 | (fields[2] & FIELD_MASK))


def pack_prefix(f):
    fid, _, v, _ = (int(x) for x in f)
    return FLAG_PREFIX | ID_BIT if fid else FLAG_PREFIX | (v & 0xFFFFFFFF)


def unpack(s, lo):
    if s & ID_BIT:
        return ident()
    if s >> 62 == 2:
        v = (s & 0xFFFFFFFF) - ((s & 0x80000000) << 1)
        return (np.bool_(False), *(np.int64(v),) * 3)

    def unfield(shift):
        x = (s >> shift) & FIELD_MASK
        half = 1 << (FIELD_BITS - 1)
        return np.int64(((x ^ half) - half) - lo)

    return (np.bool_(False), unfield(40), unfield(20), unfield(0))


def same_fn(f, g):
    """Equal as functions of phi (q matters only when v != r)."""
    fid, fq, fv, fr = (int(x) for x in f)
    gid, gq, gv, gr = (int(x) for x in g)
    if fid or gid:
        return bool(fid) == bool(gid)
    return fv == gv and fr == gr and (fv == fr or fq == gq)


def test_status_word_round_trip():
    """Aggregates at the field limits round-trip relative to their tile's
    first position; one past a limit does not fit; prefixes keep any int32
    phi exactly; identity words carry only the id bit."""
    for lo in (0, T, 2297 * T):
        for q, v, r in ((FIELD_MIN, FIELD_MAX, FIELD_MIN),
                        (FIELD_MAX, FIELD_MIN, FIELD_MAX), (-1, -1, 0),
                        (5, 5, 5)):
            f = (False, q - lo, v - lo, r - lo)
            s = pack_aggregate(f, lo)
            assert s >> 62 == 1 and same_fn(unpack(s, lo), f)
        assert pack_aggregate((False, FIELD_MAX + 1 - lo, 0, 0), lo) == 0
        assert pack_aggregate((False, 0, FIELD_MIN - 1 - lo, 0), lo) == 0
        assert pack_aggregate((False, 0, 0, FIELD_MAX + 1 - lo), lo) == 0
        assert unpack(pack_aggregate(ident(), lo), lo)[0]
    for phi in (0, -1, 2**31 - 1, -(2**31), -4_718_592, 254):
        s = pack_prefix((False, phi, phi, phi))
        assert s >> 62 == 2 and int(unpack(s, 12345)[2]) == phi
    assert pack_prefix(ident()) == FLAG_PREFIX | ID_BIT
    # every element of rows with ms at either end of [-(2^19 - T),
    # 2^19 - 1] fits (constants, point functions, the last position), so
    # every composition of them does
    rng = np.random.default_rng(3)
    for lo in (0, 7 * T):
        i = lo + rng.integers(0, T, 64)
        for n in (FIELD_MAX, -(2**19 - T)):
            for k in (n, n + 1):
                for tl in (lo + T + 1, int(i[0]) + 1):
                    f = element(np.full(64, n), i - lo, i, min(tl - lo, T + 1),
                                k=k, t=-(2**20))
                    for x in range(64):
                        assert pack_aggregate(take(f, x), lo) != 0


# ----------------------------------------------------------------- tiles


class Rows:
    """The kernel's inputs: ms rows of length L, row_stride apart from a
    flat int32 buffer starting at `base` (a strided view), and the clamped
    true lengths."""

    def __init__(self, ms, tls, base=0, stride_extra=0):
        Q, self.L = ms.shape
        self.stride = self.L + stride_extra
        self.base = base
        self.flat = np.full(base + Q * self.stride, -(2**30), np.int64)
        for q in range(Q):
            s = base + q * self.stride
            self.flat[s : s + self.L] = ms[q]
        self.tls = np.clip(tls, 0, self.L).astype(np.int64)
        self.n_tiles = -(-self.L // T)
        self.out = np.full((Q, self.L), 0xAA, np.uint8)  # unwritten marker

    def row(self, q):
        s = self.base + q * self.stride
        return self.flat[s : s + self.L]


def tile_scan(ms_row, lo, tl, k, t):
    """The loads and the CTA scan of the tile at lo (lo < tl): thread x
    holds block b = THREADS - 1 - x, positions u0 + e (u0 = b * ITEMS, e
    ascending); returns its ms values, its exclusive prefix within the
    tile, and the tile's aggregate."""
    nl = min(tl - lo, T + 1)
    u0 = (THREADS - 1 - np.arange(THREADS))[:, None] * ITEMS
    u = u0 + np.arange(ITEMS)[None]
    count = min(nl, T) - u0  # load_block's in-length count
    nv = np.where(np.arange(ITEMS)[None] < count,
                  ms_row[np.minimum(lo + u, len(ms_row) - 1)], 0)
    ms_left = ms_row[lo - 1] if lo > 0 else 0
    run = ident(THREADS)
    for e in range(ITEMS - 1, -1, -1):
        run = compose(run, element(nv[:, e], u[:, e], lo + u[:, e], nl, k, t))
    thread_excl, total = cta_exclusive(run)
    return (nv, u, nl, ms_left, thread_excl), total


def tile_finish(scan, tile_excl, out_row, lo, L, k, t):
    """The right-to-left walk from the exclusive prefix into d, the
    neighbours of each block (lanes, then warps through shared memory, then
    the two halos), the translate stencil and the block stores."""
    nv, u, nl, ms_left, thread_excl = scan
    excl = tuple(np.broadcast_to(a, (THREADS,)) for a in tile_excl)
    phi = apply(compose(excl, thread_excl), 0)
    d = np.zeros_like(nv)
    for e in range(ITEMS - 1, -1, -1):
        phi = step(nv[:, e], u[:, e], lo + u[:, e], nl, k, t, phi)
        d[:, e] = phi + lo + u[:, e]
    x = np.arange(THREADS)
    d_first = d[LANE == 31, 0]  # shared memory, by warp
    d_last = d[LANE == 0, ITEMS - 1]
    d_right = d[np.maximum(x - 1, 0), 0]  # __shfl_up_sync(d[0], 1)
    d_left = d[np.minimum(x + 1, THREADS - 1), ITEMS - 1]  # __shfl_down
    d_right = np.where(LANE == 0, np.where(
        WARP > 0, d_first[np.maximum(WARP - 1, 0)],
        apply(tile_excl, 0) + lo + T), d_right)
    halo = step(ms_left, -1, lo - 1, nl, k, t, phi[THREADS - 1]) + lo - 1
    d_left = np.where(LANE == 31, np.where(
        WARP < WARPS - 1, d_last[np.minimum(WARP + 1, WARPS - 1)], halo),
        d_left)
    prev_in = np.concatenate([d_left[:, None], d[:, :-1]], axis=1)
    next_in = np.concatenate([d[:, 1:], d_right[:, None]], axis=1)
    far = lo + u > 1
    inner = u < nl - 1
    prev = np.where(far, prev_in, k)
    nxt = np.where(inner, next_in, d)
    rr = (d > t) & (nxt > 0) & (nxt < t)
    second = far & inner & (prev > t) & (d > 0) & (d < t)
    c = np.where(rr | second, ord("R"), np.where(
        d > 0, ord("M"), np.where((nxt == 1) & (prev > 0), ord("X"),
                                  ord("-"))))
    c = np.where(u < nl, c, 0)
    keep = lo + u < L  # store_block's count
    out_row[(lo + u)[keep]] = c[keep]


def look_back(status, tk, row_first, n_tiles, stats):
    """Warp 0's look-back, a generator that yields while a window's lanes
    up to its first inclusive prefix hold an empty word; returns the
    tile's exclusive prefix."""
    lanes = np.arange(32)
    excl = ident()
    base = tk - 1
    while True:
        while True:
            j = base - lanes
            s = [status[x] if x >= row_first else FLAG_PREFIX | ID_BIT
                 for x in j]
            flags = [x >> 62 for x in s]
            pre = [lane for lane in range(32) if flags[lane] == 2]
            stop = pre[0] if pre else 31
            if all(f != 0 for f in flags[: stop + 1]):
                break
            yield
        stats["windows"] += 1
        lo = (n_tiles - 1 - (j - row_first)) * T
        v = [unpack(s[lane], int(lo[lane])) if lane <= stop else ident()
             for lane in range(32)]
        stats["aggregates"] += sum(flags[lane] == 1 for lane in range(stop + 1))
        v = tuple(np.array([x[c] for x in v]) for c in range(4))
        d = 1
        while d < 32:
            older = take(v, np.minimum(lanes + d, 31))
            v = where(lanes + d < 32, compose(older, v), v)
            d <<= 1
        excl = compose(take(v, 0), excl)
        if pre:
            return excl
        base -= 32


def emulate_lookback(rows, k, t, sched):
    """The look-back form: one CTA per ticket, CTAs started in ticket order
    and advanced in the order `sched` picks."""
    Q = rows.out.shape[0]
    n_tiles, L = rows.n_tiles, rows.L
    status = [0] * (Q * n_tiles)
    stats = {"windows": 0, "aggregates": 0, "unfit": 0}

    def cta(tk):
        row, j = divmod(tk, n_tiles)
        row_first = row * n_tiles
        lo = (n_tiles - 1 - j) * T
        tl = int(rows.tls[row])
        if lo >= tl:
            status[tk] = pack_prefix(ident())
            rows.out[row, lo : lo + T] = 0
            return
        scan, total = tile_scan(rows.row(row), lo, tl, k, t)
        yield  # other CTAs run between the scan and the publish
        if lo + T >= tl:
            status[tk] = pack_prefix(total)
            excl = ident()
        else:
            agg = pack_aggregate(total, lo)
            if agg:
                status[tk] = agg
            else:
                stats["unfit"] += 1
            yield
            excl = yield from look_back(status, tk, row_first, n_tiles, stats)
            status[tk] = pack_prefix(compose(excl, total))
        tile_finish(scan, excl, rows.out[row], lo, L, k, t)

    running, started = [], 0
    while started < len(status) or running:
        if started < len(status) and (not running or sched.random() < 0.3):
            running.append(cta(started))
            started += 1
            continue
        g = running[sched.integers(len(running))]
        try:
            next(g)
        except StopIteration:
            running.remove(g)
    assert all(s >> 62 == 2 for s in status)
    return stats


def emulate_short(rows, k, t):
    """The short-row form: one CTA per row, its tiles right to left, the
    carry composed in registers."""
    for row in range(rows.out.shape[0]):
        tl = int(rows.tls[row])
        carry = ident()
        for j in range(rows.n_tiles):
            lo = (rows.n_tiles - 1 - j) * T
            if lo >= tl:
                rows.out[row, lo : lo + T] = 0
                continue
            scan, total = tile_scan(rows.row(row), lo, tl, k, t)
            tile_finish(scan, carry, rows.out[row], lo, rows.L, k, t)
            carry = compose(carry, total)


def _ms_rows(rng, Q, L, k, kind):
    if kind == "lipschitz":
        steps = rng.choice(np.array([1, 1, 1, 0, -5, -40]), (Q, L))
        return np.clip(np.cumsum(steps, axis=1) % (k + 9), 0, k)
    if kind == "arbitrary":  # the descriptor algebra must hold here too
        return rng.integers(-3, k + 3, (Q, L))
    # values far beyond any caller's: some tiles' aggregates do not fit
    big = rng.integers(-(2**21), 2**21, (Q, L))
    return np.where(rng.random((Q, L)) < 0.5, big, rng.integers(0, k + 1,
                                                                  (Q, L)))


def _check(rows, ms, k, t):
    want = derandomize_translate_plain(
        torch.from_numpy(ms.astype(np.int32)), k, t,
        torch.from_numpy(rows.tls.astype(np.int32))).numpy()
    in_len = np.arange(rows.L)[None, :] < rows.tls[:, None]
    np.testing.assert_array_equal(rows.out[in_len], want[in_len])
    assert not rows.out[~in_len].any()


def _corner_lengths(rng, Q, L):
    tls = rng.integers(0, L + 1, Q)
    corners = [L, 0, 1, 2, T, 2 * T, T + T // 2 + 3, L - 1, T - 1, T + 1]
    tls[: min(Q, len(corners))] = corners[: min(Q, len(corners))]
    return tls


K, TH = 51, 19


@pytest.mark.parametrize("kind", ["lipschitz", "arbitrary"])
@pytest.mark.parametrize("L_of_t", ["1", "T-1", "T", "T+1", "5T+301"])
def test_look_back_equals_plain(kind, L_of_t):
    """Q > 1 rows of strided, unaligned views (offset 50, as find_batch's
    buffer), true lengths 0, 1, 2, on a tile edge, mid-tile and L, under
    three shuffled orders of the CTAs."""
    L = {"1": 1, "T-1": T - 1, "T": T, "T+1": T + 1, "5T+301": 5 * T + 301}[
        L_of_t]
    Q = 10 if L > T else 4
    rng = np.random.default_rng(L + len(kind))
    ms = _ms_rows(rng, Q, L, K, kind)
    tls = _corner_lengths(rng, Q, L)
    for seed in range(3 if L > T else 1):
        rows = Rows(ms, tls, base=50, stride_extra=50)
        stats = emulate_lookback(rows, K, TH, np.random.default_rng(seed))
        _check(rows, ms, K, TH)
        if L > 2 * T:  # a tile two left of the last one reads an aggregate
            assert stats["aggregates"] > 0


def test_look_back_many_windows():
    """More than 32 tiles to the right publish only their aggregates
    before the leftmost tiles look back: the look-back walks several
    windows of 32, in two rows that it must not cross."""
    L = 70 * T + 5
    rng = np.random.default_rng(11)
    ms = _ms_rows(rng, 2, L, K, "lipschitz")
    tls = np.array([L, 69 * T + 3])

    class NewestFirst:
        """Starts every CTA, then advances them in turn, newest first."""
        k = 0

        def random(self):
            return 0.0

        def integers(self, n):
            self.k += 1
            return (n - self.k) % n

    rows = Rows(ms, tls)
    stats = emulate_lookback(rows, K, TH, NewestFirst())
    _check(rows, ms, K, TH)
    assert stats["windows"] > 2 * 70 and stats["aggregates"] > 32


def test_look_back_unfit_aggregates():
    """ms values beyond the 20-bit fields: such tiles publish no aggregate
    and wait for their own look-back, and the result stays exact."""
    L = 12 * T + 9
    rng = np.random.default_rng(5)
    ms = _ms_rows(rng, 2, L, K, "big")
    ms[0, 4 * T : 6 * T] = rng.integers(0, K + 1, 2 * T)  # these tiles fit
    rows = Rows(ms, np.array([L, 7 * T + 11]))
    stats = emulate_lookback(rows, K, TH, np.random.default_rng(1))
    _check(rows, ms, K, TH)
    assert stats["unfit"] > 0 and stats["aggregates"] > 0


@pytest.mark.parametrize("L", [1, 300, T, 2 * T, 3 * T + 77])
@pytest.mark.parametrize("kind", ["lipschitz", "arbitrary"])
def test_short_rows_equal_plain(L, kind):
    """The short-row form over strided rows, true lengths at the corners."""
    rng = np.random.default_rng(L * 3 + len(kind))
    Q = 12
    ms = _ms_rows(rng, Q, L, K, kind)
    rows = Rows(ms, _corner_lengths(rng, Q, L), base=50, stride_extra=50)
    emulate_short(rows, K, TH)
    _check(rows, ms, K, TH)


@jax.jit
def _jax_rows(ms, lengths, k, t):
    d = jax.vmap(lambda m, n: jpp.derandomize_core(m, k, t, n))(ms, lengths)
    return jax.vmap(lambda m, n: jpp.translate_core(m, k, t, n))(d, lengths)


def test_look_back_equals_kbo_tpu():
    """A multi-tile batch through the emulated look-back equals kbo_tpu's
    derandomize_core + translate_core below each row's true length."""
    L = 4 * T + 333
    rng = np.random.default_rng(21)
    ms = _ms_rows(rng, 3, L, K, "lipschitz")
    tls = np.array([L, 2 * T, 3 * T + 100])
    rows = Rows(ms, tls)
    emulate_lookback(rows, K, TH, np.random.default_rng(2))
    want = np.asarray(_jax_rows(jnp.asarray(ms.astype(np.int32)),
                                jnp.asarray(tls.astype(np.int32)),
                                jnp.int32(K), jnp.int32(TH)))
    for q in range(3):
        np.testing.assert_array_equal(rows.out[q, : tls[q]],
                                      want[q, : tls[q]])
        assert not rows.out[q, tls[q]:].any()
