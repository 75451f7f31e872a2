"""The port's 3-bit rows join (kernels/ms.py) against kbo_tpu's, on the CPU.

kbo_tpu runs its non-TPU branch here (concat + radix sort, the jnp clamp
scan); the port runs its kernels' plain versions. Exact equality of every
buffer position (``row`` where ``uniq``: elsewhere it is not a result).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kbo_tpu_torch
from kbo_tpu.kernels import ms as jms
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import ms as tms

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _i32(table):
    return torch.from_numpy(np.ascontiguousarray(table).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _pair(seed, n_ref=900, n_q=700):
    rng = np.random.default_rng(300 + seed)
    ref = bytearray(BASES[rng.integers(0, 4, n_ref)].tobytes())
    ref[200] = ord("N")  # a second segment: more dummy rows
    ref[400:460] = ref[100:160]  # a repeat: non-unique matches
    q = bytearray(BASES[rng.integers(0, 4, n_q)].tobytes())
    q[50:350] = ref[80:380]
    q[120] = ord("N")
    for p in rng.integers(0, n_q, 8):
        q[p] = BASES[rng.integers(0, 4)]
    q[500:560] = ref[0:60]  # overlaps a segment start (dummy territory)
    return bytes(ref), bytes(q)


@pytest.mark.parametrize("k", [3, 7, 10, 11, 20, 31, 51, 64])
def test_pack_windows_3bit_equal(k):
    rng = np.random.default_rng(k)
    buf = rng.choice(np.array([0, 1, 2, 3, 4, 255], np.uint8), 500)
    for pad in (7, 5, 0):
        got = tms.pack_windows_3bit(torch.from_numpy(buf), k, pad)
        want = jms.pack_windows_3bit(jnp.asarray(buf), k, pad)
        np.testing.assert_array_equal(
            _u32(got), np.stack([np.asarray(w) for w in want])
        )
    assert tms.w3_for_k(k) == jms.w3_for_k(k) == got.shape[0]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 37, 4096, 4097, 5000])
def test_carry_nearest_equal(n, reverse):
    rng = np.random.default_rng(n + reverse)
    v = np.where(rng.random(n) < 0.02, rng.integers(0, 128, n), -1).astype(np.int32)
    v[: n // 3] = -1  # a long stretch with no source on one side
    got = tms._carry_nearest(torch.from_numpy(v), reverse).numpy()
    want = np.asarray(jms._carry_nearest(jnp.asarray(v), reverse))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [7, 31, 51])
def test_lcs3_and_window_limits_equal(k):
    ref, q = _pair(k)
    idx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    got = tms.lcs3_from_keys3(_i32(idx.keys3), k).numpy()
    want = np.asarray(jms.lcs3_from_keys3(jnp.asarray(idx.keys3), k))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got.max() <= k
    buf, _ = tms.make_flat_buffer(encode_ascii(q), k)
    np.testing.assert_array_equal(
        tms.window_limits(torch.from_numpy(buf), k).numpy(),
        np.asarray(jms.window_limits(jnp.asarray(buf), k)),
    )


@pytest.mark.parametrize("k,seed", [(7, 0), (31, 1), (51, 2), (51, 3)])
def test_ms3_rows_core_equal(k, seed):
    ref, q = _pair(seed)
    idx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    keys3 = _i32(idx.keys3)
    lcs3 = tms.lcs3_from_keys3(keys3, k)
    buf, _ = tms.make_flat_buffer(encode_ascii(q), k)
    packed = tms.rows_ref_packed(lcs3, k)
    ms, uniq, row, (qw, ql) = tms.ms3_rows_core(
        keys3, packed, torch.from_numpy(buf), k, want_qtable=True
    )
    jk = jnp.asarray(idx.keys3)
    jms_, juniq, jrow, (jqw, jql) = jms.ms3_rows_core(
        jk, jms.lcs3_from_keys3(jk, k), jnp.asarray(buf), k, want_qtable=True
    )
    np.testing.assert_array_equal(ms.numpy(), np.asarray(jms_))
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    u = uniq.numpy()
    assert u.any() and not u.all()
    np.testing.assert_array_equal(row.numpy()[u], np.asarray(jrow)[u])
    np.testing.assert_array_equal(_u32(qw), np.stack([np.asarray(w) for w in jqw]))
    np.testing.assert_array_equal(ql.numpy(), np.asarray(jql))
    # without the table
    ms2, uniq2, row2 = tms.ms3_rows_core(keys3, packed, torch.from_numpy(buf), k)
    assert torch.equal(ms, ms2) and torch.equal(uniq, uniq2)
    assert torch.equal(row, row2)


@pytest.mark.parametrize("k", [7, 31, 51])
def test_ms3_core_equals_ms2_core(k):
    """The 3-bit all-rows join and the 2-bit join give the same MS."""
    ref, q = _pair(10 + k)
    idx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    buf, L = tms.make_flat_buffer(encode_ascii(q), k)
    tb = torch.from_numpy(buf)
    ms3 = tms.ms3_core(_i32(idx.keys3), tb, k).numpy()
    ms2 = tms.ms2_core(_i32(idx.keys2), torch.from_numpy(idx.cap2), tb, k).numpy()
    want = np.asarray(jms.ms3_core(jnp.asarray(idx.keys3), jnp.asarray(buf), k))
    np.testing.assert_array_equal(ms3, want)
    s = slice(k - 1, k - 1 + L)
    np.testing.assert_array_equal(ms3[s], ms2[s])


def test_rows_join_asserts():
    idx = kbo_tpu_torch.build([b"ACGTACGTAGGATTACA"], kbo_tpu_torch.BuildOpts(k=5))
    keys3 = _i32(idx.keys3)
    packed = tms.rows_ref_packed(tms.lcs3_from_keys3(keys3, 5), 5)
    buf = torch.from_numpy(np.full(64, 1, np.uint8))
    with pytest.raises(AssertionError, match="k < 128|7 bits"):
        tms._rows_scan_pieces(keys3, packed, buf, 128)
    big = torch.empty((1 << 24), dtype=torch.uint8)
    with pytest.raises(AssertionError, match="16.7M slots"):
        tms._rows_scan_pieces(keys3, packed, big, 5)


def test_device_index_tables_equal(monkeypatch):
    """DeviceIndex.keys3 / lcs3 equal kbo_tpu's uploaded-table branch."""
    monkeypatch.setenv("KBO_TPU_UPLOAD_INDEX", "1")
    import kbo_tpu

    ref, _ = _pair(77)
    k = 31
    tdev = tms.DeviceIndex(kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k)), "cpu")
    # the map path's tables are made at the first read, not for find alone
    assert not {"keys3", "lcs3", "rows_packed"} & set(vars(tdev))
    jdev = jms.DeviceIndex(kbo_tpu.build([ref], kbo_tpu.BuildOpts(k=k)))
    np.testing.assert_array_equal(_u32(tdev.keys3), np.asarray(jdev.keys3))
    np.testing.assert_array_equal(tdev.lcs3.numpy(), np.asarray(jdev.lcs3))
    lcs = tdev.lcs3.numpy().astype(np.int64)
    up = np.concatenate([lcs[1:], [0]])
    np.testing.assert_array_equal(
        _u32(tdev.rows_packed), (((lcs | (up << 7)) << 8) | k).astype(np.uint32)
    )
