"""The port's reference helpers on the CPU: ``kernels.ms.query_ms_device`` /
``engine.compute_ms`` (MS values and colex intervals from the 3-bit join and
the interval probe) and ``kernels.postprocess.derandomize_ms_device`` /
``translate_ms_device`` (numpy in, numpy out), each against kbo_tpu's
helper of the same name, the port's host oracles and the reference's golden
vectors. Exact equality throughout.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.kernels import ms as jms
from kbo_tpu.kernels import postprocess as jpost
from kbo_tpu_torch import api as tapi
from kbo_tpu_torch import engine as tengine
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.kernels import postprocess as tpost
from kbo_tpu_torch.ops.derandomize import (
    derandomize_ms_vec,
    random_match_threshold,
)
from kbo_tpu_torch.ops.ms import query_ms_codes
from kbo_tpu_torch.ops.translate import translate_ms_vec

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _both(seqs, k):
    return (kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=k)),
            kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=k)))


def test_golden_vector():
    # reference: src/index.rs:238-240
    t_idx, j_idx = _both([b"AAAGAACCA-TCAGGGCG"], 3)
    codes = encode_ascii(b"CAAGCCACTCATTGGGTC")
    ms, iv = tms.query_ms_device(t_idx, codes, device="cpu")
    assert ms.dtype == np.int64 and iv.dtype == np.int64
    assert iv.shape == (codes.size, 2)
    assert ms.tolist() == [1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2]
    ms_ref, iv_ref = query_ms_codes(t_idx, codes)
    np.testing.assert_array_equal(ms, ms_ref)
    np.testing.assert_array_equal(iv, iv_ref)
    ms_j, iv_j = jms.query_ms_device(j_idx, codes)
    np.testing.assert_array_equal(ms, ms_j)
    np.testing.assert_array_equal(iv, iv_j)


@pytest.mark.parametrize("k", [3, 7, 31, 63])
def test_differential_random(k):
    rng = np.random.default_rng(k)
    ref = BASES[rng.integers(0, 4, 400)].tobytes()
    q = bytearray(BASES[rng.integers(0, 4, 300)].tobytes())
    q[50:150] = ref[100:200]
    q[200:260] = ref[30:90]
    for p in rng.integers(0, 300, 5):
        q[p : p + 1] = b"N"
    t_idx, j_idx = _both([ref], k)
    codes = encode_ascii(bytes(q))
    ms_ref, iv_ref = query_ms_codes(t_idx, codes)
    ms_j, iv_j = jms.query_ms_device(j_idx, codes)
    for ms, iv in (tms.query_ms_device(t_idx, codes, device="cpu"),
                   tengine.compute_ms(t_idx, codes, device="cpu")):
        np.testing.assert_array_equal(ms, ms_ref)
        np.testing.assert_array_equal(iv, iv_ref)
        np.testing.assert_array_equal(ms, ms_j)
        np.testing.assert_array_equal(iv, iv_j)


def test_device_indexes_taken_as_they_are():
    """A DeviceIndex and a device-built DeviceFullIndex (sentinel tail
    past n_rows) give the host index's MS and intervals; compute_ms takes
    a short query through the join too (no host cutoff)."""
    rng = np.random.default_rng(4)
    ref = BASES[rng.integers(0, 4, 700)].tobytes()
    q = bytearray(ref[100:400])
    q[50] = BASES[(BASES.tolist().index(q[50]) + 1) % 4]
    codes = encode_ascii(bytes(q))
    t_idx, _ = _both([ref], 15)
    want = query_ms_codes(t_idx, codes)
    full = tapi.build_device([ref], kbo_tpu_torch.BuildOpts(k=15), full=True,
                             device="cpu")
    assert full.keys3.shape[1] > full.n_rows
    for index in (tengine.device_index(t_idx, "cpu"), full):
        for ms, iv in (tms.query_ms_device(index, codes),
                       tengine.compute_ms(index, codes)):
            np.testing.assert_array_equal(ms, want[0])
            np.testing.assert_array_equal(iv, want[1])
    short = codes[:40]
    got = tengine.compute_ms(t_idx, short, device="cpu")
    ref_s = query_ms_codes(t_idx, short)
    np.testing.assert_array_equal(got[0], ref_s[0])
    np.testing.assert_array_equal(got[1], ref_s[1])


def test_interval_probe_names_its_slot_limit():
    """A probe past the int32 slot payload raises, naming the limit, before
    any work (the slot count is read off the shapes)."""
    keys3 = torch.zeros((1, 4), dtype=torch.int32)
    q_words = torch.empty((1, 2**30), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*31 - 1 slots"):
        tms._intervals_from_keys(keys3, q_words, q_words[0])


def _lipschitz_ms(rng, L, k):
    """Random vector with noisy[i+1] <= noisy[i]+1, values in [0, k]."""
    out = np.zeros(L, dtype=np.int64)
    cur = int(rng.integers(0, k + 1))
    for i in range(L):
        out[i] = cur
        step = rng.choice([1, 1, 1, 0, -rng.integers(0, k + 1)])
        cur = int(np.clip(cur + step, 0, k))
    return out


def test_derandomize_golden():
    noisy = np.array([1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2])
    expected = [0, 1, 2, 3, 1, 2, 3, 0, 1, 2, 3, -1, 0, 1, 2, 3, -1, 0]
    got = tpost.derandomize_ms_device(noisy, 3, 2, device="cpu")
    assert got.dtype == np.int64 and got.tolist() == expected
    assert jpost.derandomize_ms_device(noisy, 3, 2).tolist() == expected


def test_translate_golden():
    ms = [0, 1, 2, 3, 1, 2, 3, 0, 1, 2, 3, -1, 0, 1, 2, 3, -1, 0]
    assert tpost.translate_ms_device(np.array(ms), 3, 2, device="cpu") == \
        list("XMMRRMMXMMM--MMM--")
    ms = [1, 2, 3, 1, 2, 3, 3, 3, 3, 1, 2, 3]
    assert tpost.translate_ms_device(np.array(ms), 3, 2, device="cpu") == \
        list("MMRRMMMMRRMM")


@pytest.mark.parametrize("seed", range(4))
def test_derandomize_translate_differential_real_ms(seed):
    """On genuine MS vectors from mutated pairs: the two helpers against
    kbo_tpu's and the sequential oracles."""
    rng = np.random.default_rng(100 + seed)
    ref_seq = BASES[rng.integers(0, 4, 500)].tobytes()
    q = bytearray(ref_seq)
    for p in rng.integers(10, 490, 12):
        q[p] = BASES[rng.integers(0, 4)]
    k = int(rng.integers(5, 33))
    t_idx, _ = _both([bytes(q)], k)
    noisy, _ = query_ms_codes(t_idx, encode_ascii(ref_seq))
    t = max(2, random_match_threshold(k, t_idx.n_kmers, 4, 0.001))
    d = tpost.derandomize_ms_device(noisy, k, t, device="cpu")
    np.testing.assert_array_equal(d, derandomize_ms_vec(noisy, k, t))
    np.testing.assert_array_equal(d, jpost.derandomize_ms_device(noisy, k, t))
    chars = tpost.translate_ms_device(d, k, t, device="cpu")
    assert chars == translate_ms_vec(d, k, t)
    assert chars == jpost.translate_ms_device(d, k, t)


@pytest.mark.parametrize("seed", range(3))
def test_synthetic_rows(seed):
    """+1-Lipschitz rows across k and threshold, 300 positions."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(3, 64))
    t = int(rng.integers(2, k))
    noisy = _lipschitz_ms(rng, 300, k)
    d = tpost.derandomize_ms_device(noisy, k, t, device="cpu")
    np.testing.assert_array_equal(d, jpost.derandomize_ms_device(noisy, k, t))
    assert tpost.translate_ms_device(d, k, t, device="cpu") == \
        jpost.translate_ms_device(d, k, t)


def test_helpers_take_the_card_by_default():
    """No device named: the card, and without one the helpers raise rather
    than run on the CPU."""
    noisy = np.array([1, 2, 3])
    t_idx, _ = _both([b"ACGTTGCAAGGCT"], 3)
    calls = (lambda: tpost.derandomize_ms_device(noisy, 3, 2),
             lambda: tpost.translate_ms_device(noisy, 3, 2),
             lambda: tengine.compute_ms(t_idx, encode_ascii(b"ACGT")))
    for fn in calls:
        if torch.cuda.is_available():
            fn()
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
