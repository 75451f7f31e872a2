"""The port's batched derandomize / translate / RLE cores (kernels/
postprocess.py) against kbo_tpu's vmapped cores, on the CPU.

Whole [Q, L] outputs are compared, positions past each row's length
included, on ragged batches with rows of length 0 and 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kbo_tpu_torch
from kbo_tpu.kernels import postprocess as jpp
from kbo_tpu.ops.derandomize import derandomize_ms_vec
from kbo_tpu.ops.format import run_lengths
from kbo_tpu.ops.translate import translate_ms_vec
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import postprocess as tpp
from kbo_tpu_torch.kernels.ms import query_ms_values_device
from kbo_tpu_torch.pipeline import _rle_from_device_chars

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@jax.jit
def _jax_rows(ms, lengths, k, t):
    d = jax.vmap(lambda m, n: jpp.derandomize_core(m, k, t, n))(ms, lengths)
    c = jax.vmap(lambda m, n: jpp.translate_core(m, k, t, n))(d, lengths)
    return d, c


def _both(noisy, lengths, k, t):
    got_d = tpp.derandomize_core(
        torch.from_numpy(noisy), k, t, torch.from_numpy(lengths)
    )
    got_c = tpp.translate_core(got_d, k, t, torch.from_numpy(lengths))
    want_d, want_c = _jax_rows(
        jnp.asarray(noisy), jnp.asarray(lengths), jnp.int32(k), jnp.int32(t)
    )
    return got_d.numpy(), got_c.numpy(), np.asarray(want_d), np.asarray(want_c)


def _lipschitz_rows(rng, lengths, L, k):
    """+1-Lipschitz rows in [0, k], zero past each row's length."""
    out = np.zeros((len(lengths), L), dtype=np.int32)
    for q, n in enumerate(lengths):
        steps = rng.choice([1, 1, 1, 0, -3, -9, -30], size=n)
        cur = int(rng.integers(0, k + 1))
        for i in range(n):
            out[q, i] = cur
            cur = min(max(cur + int(steps[i]), 0), k)
    return out


def test_golden():
    noisy = torch.tensor([1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2])
    d = tpp.derandomize_core(noisy, 3, 2)
    assert d.tolist() == [0, 1, 2, 3, 1, 2, 3, 0, 1, 2, 3, -1, 0, 1, 2, 3, -1, 0]
    assert d.tolist() == jpp.derandomize_ms_device(noisy.numpy(), 3, 2).tolist()
    chars = tpp.translate_core(d, 3, 2).numpy().tobytes().decode()
    assert chars == "XMMRRMMXMMM--MMM--"
    assert list(chars) == jpp.translate_ms_device(d.numpy(), 3, 2)


@pytest.mark.parametrize("seed", range(4))
def test_ragged_batch_synthetic(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(3, 64))
    t = int(rng.integers(2, k))
    L = 257
    lengths = np.array([L, 0, 1, 2, 100, 256, 37], np.int32)
    noisy = _lipschitz_rows(rng, lengths, L, k)
    got_d, got_c, want_d, want_c = _both(noisy, lengths, k, t)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c, want_c)
    # and the host oracles on every row long enough for them
    for q, n in enumerate(lengths):
        if n > 2:
            d = derandomize_ms_vec(noisy[q, :n], k, t)
            np.testing.assert_array_equal(got_d[q, :n], d)
            assert [chr(c) for c in got_c[q, :n]] == translate_ms_vec(d, k, t)


@pytest.mark.parametrize("seed", range(2))
def test_real_ms(seed):
    """Genuine MS rows of mutated queries (from the port's own join)."""
    rng = np.random.default_rng(100 + seed)
    ref = BASES[rng.integers(0, 4, 800)].tobytes()
    k = int(rng.integers(9, 33))
    idx = kbo_tpu_torch.build([ref], kbo_tpu_torch.BuildOpts(k=k))
    rows = []
    for n in (500, 120, 3):
        s = int(rng.integers(0, 800 - n))
        q = bytearray(ref[s : s + n])
        for p in rng.integers(0, n, 4):
            q[p] = BASES[rng.integers(0, 4)]
        rows.append(query_ms_values_device(idx, encode_ascii(bytes(q)), "cpu"))
    lengths = np.array([r.size for r in rows], np.int32)
    noisy = np.zeros((len(rows), 512), np.int32)
    for q, r in enumerate(rows):
        noisy[q, : r.size] = r
    got_d, got_c, want_d, want_c = _both(noisy, lengths, k, 2 + seed)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c, want_c)


def test_blocked_suffix_scan():
    """Rows longer than 4 scan blocks take the two-level suffix scan."""
    rng = np.random.default_rng(9)
    L, k, t = 4096 + 1123, 31, 11
    lengths = np.array([L, 0, 4500], np.int32)
    noisy = _lipschitz_rows(rng, lengths, L, k)
    got_d, got_c, want_d, want_c = _both(noisy, lengths, k, t)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c, want_c)


def _chars_batch(rng, Q, L):
    alphabet = np.frombuffer(b"MXR- ", np.uint8)
    chars = alphabet[rng.integers(0, 5, (Q, L))]
    chars[2, :] = ord("-")  # all-gap row: zero segments
    chars[3, :] = ord("M")  # one full-row segment
    return chars


@pytest.mark.parametrize("seed", range(3))
def test_rle_segments_global(seed):
    rng = np.random.default_rng(seed)
    Q, L = 7, 256
    chars = _chars_batch(rng, Q, L)
    lengths = np.asarray([L, 100, 50, L, 0, 1, 37], np.int32)
    got = tpp.rle_segments_global_core(
        torch.from_numpy(chars), torch.from_numpy(lengths), 512
    ).numpy()
    want = np.asarray(
        jpp.rle_segments_global(jnp.asarray(chars), jnp.asarray(lengths), 512)
    )
    np.testing.assert_array_equal(got, want)


def test_rle_capacity_retry():
    """More segments than the first capacity guess: the retry grows the
    table until it fits, and the lists equal the host run_lengths."""
    Q, L = 3, 1024
    chars = np.tile(np.frombuffer(b"M-", np.uint8), (Q, L // 2))
    lengths = np.array([L, 700, 1], np.int32)
    got = _rle_from_device_chars(
        torch.from_numpy(chars), torch.from_numpy(lengths)
    )
    for q in range(Q):
        want = run_lengths(chars[q, : lengths[q]])
        assert [dataclasses.asdict(r) for r in got[q]] == [
            dataclasses.asdict(r) for r in want
        ]
    assert sum(len(r) for r in got) > 128
