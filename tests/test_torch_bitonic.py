"""The plain versions of the port's bitonic merge and bitonic sort
(kernels/sort.py) against kbo_tpu's Pallas kernels in interpret mode, on
the CPU.

The network fixes the output, so the two agree bit for bit, payloads and
pads included, although a bitonic network is not stable. M = 131 072 runs
one stage across kbo_tpu's 65 536-slot blocks and the stages inside them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kbo_tpu.kernels import pallas_sort
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.kernels.sort import (
    _radix_sort,
    bitonic_merge,
    bitonic_merge_plain,
    bitonic_sort,
    bitonic_sort_plain,
)

torch.set_num_threads(2)


def _table(rng, n, w0_top):
    """[w0, w1, payload] uint32 rows sorted by (w0, w1): many ties in w0,
    the top bit set in w1 (unsigned order), payloads distinct."""
    w0 = rng.integers(0, w0_top, n).astype(np.uint32)
    w1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    w1[rng.random(n) < 0.02] = 0xFFFFFFFF  # ties with the all-ones pads
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    order = np.lexsort((w1, w0))
    return np.stack([w0[order], w1[order], pay[order]])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_bitonic_merge_plain_equals_kbo_tpu():
    rng = np.random.default_rng(3)
    a, b = _table(rng, 70_000, 40), _table(rng, 50_000, 40)
    want = pallas_sort.bitonic_merge(
        [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b],
        n_comps=2, interpret=True, slice_output=False,
    )
    want = np.stack([np.asarray(x) for x in want]).view(np.int32)
    got = bitonic_merge(_t(a), _t(b), 2)
    assert got.shape == (3, 131_072)
    assert np.array_equal(got.numpy(), want)
    # the keys come out sorted, followed by the pads
    keys = got[:2, :120_000]
    assert torch.equal(keys, _radix_sort(keys)[0])
    assert (got[:, 120_000:] == -1).all()


def test_bitonic_sort_plain_equals_kbo_tpu():
    rng = np.random.default_rng(4)
    n = 100_000
    ops = np.stack([
        rng.integers(0, 97, n).astype(np.uint32),
        rng.integers(0, 2**32, n, dtype=np.uint32),
        np.arange(n, dtype=np.uint32),
    ])
    want = pallas_sort.bitonic_sort(
        [jnp.asarray(x) for x in ops], n_comps=2, interpret=True
    )
    want = np.stack([np.asarray(x) for x in want]).view(np.int32)
    got = bitonic_sort(_t(ops), 2)
    assert np.array_equal(got.numpy(), want)
    keys, (pay,) = _radix_sort(_t(ops)[:2], [_t(ops)[2]])
    assert torch.equal(got[:2], keys)
    # payloads agree with the stable sort's as multisets per key group
    canon = _radix_sort(got)[0]
    assert torch.equal(canon, _radix_sort(torch.cat([keys, pay[None]]))[0])


@pytest.mark.parametrize("bits", [2, 3])
def test_merge_bitonic_rows_and_values_equal_path(bits):
    """``merge="bitonic"`` in the joins: the padded merge gives the same MS
    (value join) and the same (MS, uniq, rows) (rows join) as merge_path;
    the pads' slot id 0xFFFFFF is dropped by both back-to-order steps."""
    rng = np.random.default_rng(10 + bits)
    import kbo_tpu_torch

    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)]
    idx = kbo_tpu_torch.build([text.tobytes()], kbo_tpu_torch.BuildOpts(k=21))
    codes = text.copy()
    codes[rng.integers(0, 3000, 60)] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 60)
    ]
    from kbo_tpu_torch.index.encode import encode_ascii

    buf, _ = tms.make_flat_buffer(encode_ascii(codes.tobytes()), 21)
    buf = torch.from_numpy(buf)
    if bits == 2:
        k2 = _t(idx.keys2)
        cap2 = torch.from_numpy(np.asarray(idx.cap2, np.int32))
        assert torch.equal(tms.ms2_core(k2, cap2, buf, 21, merge="bitonic"),
                           tms.ms2_core(k2, cap2, buf, 21))
    else:
        k3 = _t(idx.keys3)
        packed = tms.rows_ref_packed(tms.lcs3_from_keys3(k3, 21), 21)
        got = tms.ms3_rows_core(k3, packed, buf, 21, merge="bitonic")
        want = tms.ms3_rows_core(k3, packed, buf, 21)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="merge"):
        tms.ms2_core(_t(idx.keys2), torch.from_numpy(
            np.asarray(idx.cap2, np.int32)), buf, 21, merge="radix")


def test_plain_versions_take_cpu_tensors_only_by_device():
    """The wrappers dispatch by the tensor's device: CPU tensors run the
    plain versions (bit-equal to calling them directly)."""
    rng = np.random.default_rng(5)
    ops = _t(_table(rng, 1000, 5))
    assert torch.equal(bitonic_sort(ops, 2), bitonic_sort_plain(ops, 2))
    assert torch.equal(bitonic_merge(ops, ops, 3),
                       bitonic_merge_plain(ops, ops, 3))
    assert bitonic_sort.launches == 0 and bitonic_merge.launches == 0
