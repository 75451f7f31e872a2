"""The port's 2-bit sort-join (kernels/ms.py) against kbo_tpu's, on the CPU.

kbo_tpu runs its non-TPU branch here (concat + radix sort, the jnp clamp
scan); the port runs its kernels' plain versions. Exact equality of every
buffer position, pads included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.kernels import ms as jms
from kbo_tpu.ops.ms import query_ms_codes
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import ms as tms

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
GOLDEN = [1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2]


def _both(index, buf, k):
    """(port ms2_core, kbo_tpu ms2_core) over the same flat buffer."""
    got = tms.ms2_core(
        torch.from_numpy(index.keys2.view(np.int32)),
        torch.from_numpy(index.cap2),
        torch.from_numpy(buf),
        k,
    ).numpy()
    want = np.asarray(
        jms._ms2_jit(
            jnp.asarray(index.keys2), jnp.asarray(index.cap2), jnp.asarray(buf), k
        )
    )
    return got, want


def test_golden_vector():
    # reference: src/index.rs:238-240
    idx = kbo_tpu_torch.build([b"AAAGAACCA-TCAGGGCG"], kbo_tpu_torch.BuildOpts(k=3))
    codes = encode_ascii(b"CAAGCCACTCATTGGGTC")
    assert tms.query_ms_values_device(idx, codes, "cpu").tolist() == GOLDEN
    buf, _ = tms.make_flat_buffer(codes, 3)
    got, want = _both(idx, buf, 3)
    np.testing.assert_array_equal(got, want)


def _pair(k, seed):
    rng = np.random.default_rng(900 + seed)
    ref = bytearray(BASES[rng.integers(0, 4, 600)].tobytes())
    ref[150] = ord("N")  # a second segment: more dummy rows
    q = bytearray(BASES[rng.integers(0, 4, 400)].tobytes())
    q[50:250] = ref[100:300]
    q[300] = ord("N")
    q[320:360] = ref[0:40]  # overlaps a segment start (dummy territory)
    return bytes(ref), bytes(q)


@pytest.mark.parametrize("k", [3, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64])
def test_ms2_core_equal(k):
    ref, q = _pair(k, k)
    idx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    buf, _ = tms.make_flat_buffer(encode_ascii(q), k)
    got, want = _both(idx, buf, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [7, 31])
def test_query_values_vs_host_oracle(k):
    ref, q = _pair(k, 100 + k)
    tidx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build([ref], kbo_tpu.BuildOpts(k=k))
    got = tms.query_ms_values_device(tidx, encode_ascii(q), "cpu")
    np.testing.assert_array_equal(got, query_ms_codes(jidx, encode_ascii(q))[0])


def test_slot_limit_fallback(monkeypatch):
    """Past the 24-bit packed-slot limit the join carries cap and meta as
    separate operands; forcing the limit down reproduces the packed path
    and kbo_tpu's fallback bit for bit."""
    rng = np.random.default_rng(14)
    ref = BASES[rng.integers(0, 4, 3000)].tobytes()
    idx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=31))
    q = bytearray(ref[1000:2000])
    for p in rng.integers(0, len(q), 6):
        q[p] = BASES[rng.integers(0, 4)]
    buf, L = tms.make_flat_buffer(encode_ascii(bytes(q)), 31)
    packed, _ = _both(idx, buf, 31)
    monkeypatch.setattr(tms, "_PACKED_SLOT_LIMIT", 1)
    monkeypatch.setattr(jms, "_PACKED_SLOT_LIMIT", 1)
    got, want = _both(idx, buf, 31)
    s = slice(30, 30 + L)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[s], packed[s])


def test_pack_windows_equal():
    rng = np.random.default_rng(2)
    buf = rng.choice(np.array([0, 1, 2, 3, 4, 255], np.uint8), 700)
    for k in (5, 16, 33, 51):
        words, limit = tms.pack_windows_2bit(torch.from_numpy(buf), k)
        jw, jl = jms.pack_windows_2bit(jnp.asarray(buf), k)
        np.testing.assert_array_equal(
            words.numpy().view(np.uint32), np.stack([np.asarray(w) for w in jw])
        )
        np.testing.assert_array_equal(limit.numpy(), np.asarray(jl))


@pytest.mark.parametrize("n", [1, 2, 4096, 5000])
def test_doubling_cummax_equal(n):
    """Against kbo_tpu's (flat below 4 blocks, two-level above)."""
    x = np.random.default_rng(n).integers(-(2**31), 2**31 - 1, n, dtype=np.int32)
    got = tms._doubling_cummax(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jms._doubling_cummax(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.maximum.accumulate(x))


def test_bucket_and_flat_buffer_equal():
    for n in (1, 64, 1000, 1025, 4097, 123457, 4_600_000):
        assert tms._bucket(n) == jms._bucket(n)
    codes = encode_ascii(b"ACGTNACGT")
    got, L = tms.make_flat_buffer(codes, 7)
    want, JL = jms.make_flat_buffer(codes, 7)
    np.testing.assert_array_equal(got, want)
    assert L == JL


def test_device_none_raises_without_card():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    idx = kbo_tpu_torch.build([b"ACGTACGTAGGA"], kbo_tpu_torch.BuildOpts(k=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.DeviceIndex(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kbo_tpu_torch.find(b"ACGTAC", idx)
