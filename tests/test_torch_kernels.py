"""Plain versions of the port's two kernels (kernels/sort.py merge_path,
kernels/join.py clamp_scan) against independent oracles and kbo_tpu's
non-TPU paths, on the CPU. The CUDA kernels themselves are held against
these plain versions on the card (chip_smoke.py, tests marked ``cuda``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kbo_tpu.kernels import ms as jms
from kbo_tpu_torch.kernels.join import _clz32, _common_chunks, clamp_scan
from kbo_tpu_torch.kernels.ms import _merge_scan
from kbo_tpu_torch.kernels.sort import (
    _pack_key_words,
    _radix_sort,
    merge_path,
    to_i32,
    u32,
)

torch.set_num_threads(2)


def _t(words_u32):
    """uint32 numpy [W, n] -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32))


def _top_heavy_words(rng, W, n):
    """uint32 words dense in the top bit, with ties and all-ones pads."""
    vals = np.array(
        [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xC0000000, 0xFFFFFFFE,
         0xFFFFFFFF], dtype=np.uint32,
    )
    return vals[rng.integers(0, vals.size, (W, n))]


def test_u32_roundtrip_keeps_pads():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = _t(x[None])[0]
    assert u32(t).tolist() == x.astype(np.int64).tolist()
    assert torch.equal(to_i32(u32(t)), t)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_pair_key_order_top_bit(W):
    """Pair keys (hi - 2**31) * 2**32 + lo keep unsigned lexicographic
    order in int64 with no overflow, top bit set or not."""
    rng = np.random.default_rng(W)
    words = _top_heavy_words(rng, W, 3000)
    keys = _pack_key_words(_t(words))
    assert len(keys) == (W + 1) // 2
    # order by the packed keys == numpy's unsigned lexsort of the words
    got = np.lexsort(tuple(k.numpy() for k in reversed(keys)))
    want = np.lexsort(tuple(reversed(list(words))))
    np.testing.assert_array_equal(words[:, got], words[:, want])
    sw, (pay,) = _radix_sort(_t(words), [torch.arange(3000, dtype=torch.int32)])
    np.testing.assert_array_equal(pay.numpy(), want)  # lexsort is stable too
    np.testing.assert_array_equal(sw.numpy().view(np.uint32), words[:, want])


@pytest.mark.parametrize("seed,na,nb", [(0, 500, 700), (1, 1, 900), (2, 800, 0)])
def test_merge_plain_vs_lexsort(seed, na, nb):
    """The merge is stable: on equal keys every A row precedes every B row,
    and each side keeps its own order -- the np.lexsort (stable) order of
    A ++ B."""
    rng = np.random.default_rng(seed)
    W = 3
    a = _top_heavy_words(rng, W, na)
    b = _top_heavy_words(rng, W, nb)
    a = a[:, np.lexsort(tuple(reversed(list(a))))]
    b = b[:, np.lexsort(tuple(reversed(list(b))))]
    a_pay = torch.arange(na, dtype=torch.int32)
    b_pay = torch.arange(na, na + nb, dtype=torch.int32)
    keys, pay = merge_path(_t(a), a_pay, _t(b), b_pay)
    both = np.concatenate([a, b], axis=1)
    order = np.lexsort(tuple(reversed(list(both))))
    np.testing.assert_array_equal(pay.numpy(), order)
    np.testing.assert_array_equal(keys.numpy().view(np.uint32), both[:, order])
    # stability spelled out: within each run of equal keys, payloads rise
    p = pay.numpy()
    same = np.all(both[:, order][:, 1:] == both[:, order][:, :-1], axis=0)
    assert np.all(p[1:][same] > p[:-1][same])


@pytest.mark.parametrize("bits", [2, 3])
def test_merge_scan_equals_kbo_tpu(bits):
    """The port's packed merge (query radix sort + merge) gives kbo_tpu's
    concat + radix merged order bit for bit, and the same scans."""
    rng = np.random.default_rng(10 + bits)
    W, n, L = 2, 900, 600
    top = 0xFFFFFFFF if bits == 2 else 0x3FFFFFFF
    ref = (rng.integers(0, 9, (W, n)) * (top // 8)).astype(np.uint32)
    ref = ref[:, np.lexsort(tuple(reversed(list(ref))))]
    cap = rng.integers(1, 20, n).astype(np.int32)
    q = (rng.integers(0, 9, (W, L)) * (top // 8)).astype(np.uint32)
    meta = np.arange(L, dtype=np.int32)
    got = _merge_scan(_t(ref), torch.from_numpy(cap), _t(q),
                      torch.from_numpy(meta), bits)
    common = jms._common2 if bits == 2 else jms._common3
    want = jms._merge_scan(
        [jnp.asarray(w) for w in ref], jnp.asarray(cap),
        [jnp.asarray(w) for w in q], jnp.asarray(meta), bits, common,
    )
    np.testing.assert_array_equal(
        got[0].numpy().view(np.uint32), np.stack([np.asarray(w) for w in want[0]])
    )
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _common_np(words, i, j, bits):
    per = 16 if bits == 2 else 10
    lead = 0 if bits == 2 else 2
    total = 0
    for w in range(len(words)):
        x = int(words[w][i]) ^ int(words[w][j])
        if x == 0:
            total += per
            continue
        lz = 32 - x.bit_length()
        total += (lz - lead) // bits
        break
    return total


def _oracle_scan(words, cap, bits, reverse):
    """Sequential clamp recurrence (independent of the doubling scan)."""
    M = cap.size
    out = np.empty(M, dtype=np.int64)
    order = range(M - 1, -1, -1) if reverse else range(M)
    x = -1
    prev = None
    for i in order:
        if prev is not None:
            x = min(x, _common_np(words, prev, i, bits))
        x = max(x, int(cap[i]))
        out[i] = x
        prev = i
    return out


@pytest.mark.parametrize("seed,bits,W,reverse", [
    (0, 2, 2, False), (1, 2, 2, True), (2, 3, 4, False), (3, 3, 4, True),
])
def test_clamp_scan_plain(seed, bits, W, reverse):
    """Against the sequential oracle and kbo_tpu's _clamp_scan_jnp, with
    all-ones pads at the tail (where bits=3 chunk counts floor to -1)."""
    rng = np.random.default_rng(seed)
    M = 3000
    top = 0xFFFFFFFF if bits == 2 else 0x3FFFFFFF
    raw = (rng.integers(0, 17, (W, M)).astype(np.int64) * (top // 16)).astype(
        np.uint32
    )
    raw[:, rng.random(M) < 0.05] = 0xFFFFFFFF
    words = raw[:, np.lexsort(tuple(reversed(list(raw))))]
    per = 16 if bits == 2 else 10
    cap = np.where(
        rng.random(M) < 0.4, rng.integers(0, W * per + 1, M), -1
    ).astype(np.int32)

    got = clamp_scan(_t(words), torch.from_numpy(cap), bits, reverse).numpy()
    np.testing.assert_array_equal(got, _oracle_scan(words, cap, bits, reverse))
    common = jms._common2 if bits == 2 else jms._common3
    jw = [jnp.asarray(w) for w in words]
    want = jms._clamp_scan_jnp(
        jms._edge_lcp(jw, common, reverse), jnp.asarray(cap), reverse
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def test_common_chunks_floor_and_clz():
    x = np.array([0, 1, 2, 0x00FFFFFF, 0x40000000, 0x80000000, 0xFFFFFFFF],
                 np.uint32)
    got = _clz32(torch.from_numpy(x.astype(np.int64))).tolist()
    assert got == [32 - int(v).bit_length() for v in x]
    pad = np.full((1, 3), 0xFFFFFFFF, np.uint32)
    real = np.array([[0x12345678, 0x3FFFFFFF, 0xFFFFFFFF]], np.uint32)
    # bits=3: clz 0 or 1 floors to -1 (C division would give 0)
    assert _common_chunks(_t(pad), _t(real), 3).tolist() == [-1, -1, 10]
    assert _common_chunks(_t(pad), _t(real), 2).tolist() == [0, 0, 16]
    np.testing.assert_array_equal(
        _common_chunks(_t(pad), _t(real), 3).numpy(),
        np.asarray(jms._common3([jnp.asarray(pad[0])], [jnp.asarray(real[0])])),
    )


def test_wrappers_check_arguments():
    w = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="bits"):
        clamp_scan(w, torch.zeros(5, dtype=torch.int32), 4, False)
