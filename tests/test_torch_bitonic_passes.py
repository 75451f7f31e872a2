"""The pass schedule of the port's CUDA bitonic network (kernels/sort.py,
csrc/bitonic.cu), on the CPU.

CUDA cannot run here, so these check the two things the kernel's output
rests on: the schedule of passes is the network's stage sequence, and a
torch emulation of the two pass kernels -- with the kernel's own index
arithmetic: which 2^r elements a thread owns, its direction bit, the
tile's pair indices, the first pass's read of A / pads / reversed B and
its write of every element, the later passes' write of moved elements
only -- equals the plain versions bit for bit, payloads and pads included.
The plain versions are held to kbo_tpu's Pallas kernels in
test_torch_bitonic.py.
"""

import numpy as np
import pytest
import torch

from kbo_tpu_torch.kernels.sort import (
    RegsPass,
    _bitonic_len,
    _bitonic_passes,
    _bitonic_r,
    _bitonic_tile_log,
    _sort_stages,
    bitonic_merge_plain,
    bitonic_sort_plain,
)

torch.set_num_threads(2)


def _flatten(passes, M):
    """The (distance, phase) stages the passes run, in order."""
    out = []
    for p in passes:
        if isinstance(p, RegsPass):
            out += [(1 << (p.j - q), p.k) for q in range(p.r)]
        else:
            ks = [p.k] if p.k is None else range(p.k, p.k_end + 1)
            for k in ks:
                top = p.j if k == p.k else k - 1
                assert top < p.log_tile <= M.bit_length() - 1
                out += [(1 << j, k) for j in range(top, -1, -1)]
    return out


@pytest.mark.parametrize("n_ops", [3, 5, 7, 9, 17])
def test_schedule_is_the_network(n_ops):
    for lm in range(16, 25):
        M = 1 << lm
        merge = _bitonic_passes(M, n_ops, sort=False)
        assert _flatten(merge, M) == [(1 << j, None)
                                      for j in range(lm - 1, -1, -1)]
        sort = _bitonic_passes(M, n_ops, sort=True)
        assert _flatten(sort, M) == list(_sort_stages(M))
        # every register pass stays on coalesced rows, every tile fits
        r, lt = _bitonic_r(n_ops), _bitonic_tile_log(n_ops, M)
        for p in merge + sort:
            if isinstance(p, RegsPass):
                assert p.r == r and p.j - r + 1 >= 5
            else:
                assert 1 <= p.log_tile <= lt
                assert (1 << p.log_tile) * n_ops * 4 <= 232_448


def test_schedule_pass_counts():
    """The largest tiles and the pass counts at the chip's shapes."""
    assert [1 << _bitonic_tile_log(n, 1 << 24) for n in (3, 5, 7, 9, 17)] == [
        16384, 8192, 8192, 4096, 2048]
    # find-core's merge (5 rows) and the map sweep's (7 rows) at 2^24
    assert len(_bitonic_passes(1 << 24, 5, sort=False)) == 4
    assert len(_bitonic_passes(1 << 24, 7, sort=False)) == 5
    # the find-core query-side sort at 2^23: 1 block sort, 18 register
    # passes, 10 tile passes
    passes = _bitonic_passes(1 << 23, 5, sort=True)
    assert len(passes) == 29
    assert sum(isinstance(p, RegsPass) for p in passes) == 18
    # 17 rows (the 2-bit join at k = 241..254: 16 key words and the
    # payload) take register passes of 2 stages; 18 is beyond every caller
    assert _bitonic_r(17) == 2
    assert len(_bitonic_passes(1 << 24, 17, sort=False)) == 8
    with pytest.raises(ValueError, match="operand rows"):
        _bitonic_r(18)


def _layout(a, b, idx, M):
    """Words [n_ops, *idx.shape] of the layout A ++ all-ones ++ reverse(B)
    at element indices idx, as csrc/bitonic.cu's layout_word reads it."""
    na, nb = a.shape[1], b.shape[1]
    out = torch.full((a.shape[0], *idx.shape), -1, dtype=torch.int32)
    in_a = idx < na
    in_b = idx >= M - nb
    out[:, in_a] = a[:, idx[in_a]]
    out[:, in_b] = b[:, M - 1 - idx[in_b]]
    return out


def _cmp(u, v, n_comps):
    """-1, 0, 1 per column as u <, ==, > v over the first n_comps rows
    (uint32 order)."""
    cmp = torch.zeros(u.shape[1:], dtype=torch.int8)
    for c in range(n_comps):
        uc, vc = u[c] ^ -(2**31), v[c] ^ -(2**31)  # signed order of uint32
        sign = (uc > vc).to(torch.int8) - (uc < vc).to(torch.int8)
        cmp = torch.where(cmp == 0, sign, cmp)
    return cmp


def _swap_where(swap, u, v):
    return torch.where(swap, v, u), torch.where(swap, u, v)


def _group(x, w, idx, base, k, q, n_comps, write_all):
    """csrc/bitonic.cu's regs_pass network over every group at once: w holds
    the words [n_ops, groups, 2^q] of elements idx [groups, 2^q], base the
    groups' lowest indices; the stages at local distances 2^(q-1)..1, one
    direction per group (bit k of base); then the write-back to x of the
    elements that took part in a swap (of all of them with write_all)."""
    n_ops, G = w.shape[:2]
    desc = ((base >> k) & 1).bool()[:, None, None]
    moved = torch.zeros(idx.shape, dtype=torch.bool)
    for r in range(q - 1, -1, -1):
        # slots e (bit r clear) and e | 2^r of each group, as views
        v = w.view(n_ops, G, -1, 2, 1 << r)
        m = moved.view(G, -1, 2, 1 << r)
        cmp = _cmp(v[:, :, :, 0], v[:, :, :, 1], n_comps)
        swap = torch.where(desc, cmp < 0, cmp > 0)
        v[:, :, :, 0], v[:, :, :, 1] = _swap_where(swap, v[:, :, :, 0],
                                                   v[:, :, :, 1])
        m[:, :, 0] |= swap
        m[:, :, 1] |= swap
    x[:, idx] = w if write_all else torch.where(moved, w, x[:, idx])


def _owned(t, j, q):
    """The lowest index b of thread t's group of distances 2^j..2^(j-q+1)
    and the group's 2^q element indices b + e * 2^(j-q+1)."""
    lo = j - q + 1
    b = (t & ((1 << lo) - 1)) | ((t >> lo) << (j + 1))
    return b, b[:, None] + (torch.arange(1 << q) << lo)[None, :]


def _regs_pass(x, p, k, n_comps, first, a, b, M):
    """csrc/bitonic.cu's regs_pass for every thread at once."""
    base, idx = _owned(torch.arange(M >> p.r), p.j, p.r)
    w = _layout(a, b, idx, M) if first else x[:, idx]
    _group(x, w, idx, base, k, p.r, n_comps, first)


def _tile_pass(x, p, k, k_end, n_comps, first, a, b, M):
    """csrc/bitonic.cu's tile_pass for every tile at once: one stage at a
    time, pair p of a tile at slots i = (p >> j) << (j + 1) | p mod 2^j
    and i + 2^j, direction bit k of the tile's start plus i."""
    tile = 1 << p.log_tile
    if first:
        x[:] = _layout(a, b, torch.arange(M), M)
    starts = torch.arange(M // tile)[:, None] * tile
    pair = torch.arange(tile // 2)
    for kk in range(k, k_end + 1):
        for j in range(p.j if kk == k else kk - 1, -1, -1):
            i = ((pair >> j) << (j + 1)) | (pair & ((1 << j) - 1))
            lo = (starts + i[None, :]).reshape(-1)
            hi = lo + (1 << j)
            u, v = x.index_select(1, lo), x.index_select(1, hi)
            cmp = _cmp(u, v, n_comps)
            swap = torch.where(((lo >> kk) & 1).bool(), cmp < 0, cmp > 0)
            u, v = _swap_where(swap, u, v)
            x.index_copy_(1, lo, u)
            x.index_copy_(1, hi, v)


def _emulate(a, b, n_comps, sort):
    """The wrapper's launches over the schedule into an uninitialised
    buffer (random words stand in for torch.empty's contents)."""
    n_ops = a.shape[0]
    M = _bitonic_len(a.shape[1] + b.shape[1])
    lm = M.bit_length() - 1
    x = torch.from_numpy(
        np.random.default_rng(0).integers(-(2**31), 2**31, (n_ops, M),
                                          dtype=np.int32))
    for n, p in enumerate(_bitonic_passes(M, n_ops, sort)):
        k = lm if p.k is None else p.k
        if isinstance(p, RegsPass):
            _regs_pass(x, p, k, n_comps, n == 0, a, b, M)
        else:
            k_end = lm if p.k_end is None else p.k_end
            _tile_pass(x, p, k, k_end, n_comps, n == 0, a, b, M)
    return x


def _table(rng, n_ops, n, n_comps):
    """Operand rows sorted by their first n_comps rows: few distinct key
    words (ties, some equal to the all-ones pads), distinct payloads."""
    keys = rng.integers(0, 5, (n_comps, n)).astype(np.int64) * 0x3FFFFFFF
    keys = np.minimum(keys, 0xFFFFFFFF)
    pay = rng.integers(0, 2**32, (n_ops - n_comps, n), dtype=np.uint32)
    order = np.lexsort(keys[::-1])
    ops = np.concatenate([keys[:, order].astype(np.uint32), pay[:, order]])
    return torch.from_numpy(ops.view(np.int32))


# (M, n_ops, na, nb): the cross-stage counts above the largest tile leave
# remainders 0, 1 and 2 of r; na = 0, nb = 0 and na + nb = M at the edges
MERGES = [(M, n_ops, na, nb)
          for n_ops in (3, 5, 7, 9)
          for M, na, nb in ((1 << 16, 40_000, 20_001), (1 << 17, 0, 70_000),
                            (1 << 18, 150_000, 0))] + [
    (1 << 17, 5, 65_536, 65_536), (1 << 16, 9, 1, 65_535),
    (1 << 16, 17, 30_000, 30_001), (1 << 17, 17, 0, 70_000)]


@pytest.mark.parametrize("M,n_ops,na,nb", MERGES)
def test_merge_passes_equal_plain(M, n_ops, na, nb):
    rng = np.random.default_rng(M + n_ops + na)
    n_comps = n_ops - 1
    a, b = _table(rng, n_ops, na, n_comps), _table(rng, n_ops, nb, n_comps)
    want = bitonic_merge_plain(a, b, n_comps)
    assert want.shape == (n_ops, M)
    assert torch.equal(_emulate(a, b, n_comps, sort=False), want)


@pytest.mark.parametrize("n,n_ops,n_comps", [
    (50_000, 3, 2), (65_536, 5, 4), (40_000, 7, 6), (60_000, 9, 8),
    (100_000, 5, 3), (200_000, 3, 1), (40_000, 17, 16)])
def test_sort_passes_equal_plain(n, n_ops, n_comps):
    rng = np.random.default_rng(n + n_ops)
    ops = _table(rng, n_ops, n, n_comps)
    ops = ops[:, torch.from_numpy(rng.permutation(n))]
    got = _emulate(ops, ops[:, :0], n_comps, sort=True)
    assert torch.equal(got[:, :n], bitonic_sort_plain(ops, n_comps))
    assert (got[:, n:] == -1).all()
