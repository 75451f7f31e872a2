"""The port's host index build and carry-across against kbo_tpu's.

Exact equality of every table; inputs from numpy.random.default_rng.
"""

import dataclasses

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.index.encode import encode_ascii as jax_encode
from kbo_tpu.ops.derandomize import derandomize_ms_vec, random_match_threshold
from kbo_tpu.ops.format import run_lengths
from kbo_tpu.ops.ms import query_ms_codes
from kbo_tpu.ops.translate import translate_ms_vec
from kbo_tpu_torch.index.encode import encode_ascii, split_segments
from kbo_tpu_torch.index.sbwt import index_from_arrays

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
FIELDS = ("k", "n_rows", "n_kmers", "bits", "cum", "C", "lcs", "keys2",
          "cap2", "keys3", "row_pos", "text")


def _contigs(seed: int):
    """Three contigs with N runs and a soft-masked stretch."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (700, 300, 90):
        s = bytearray(BASES[rng.integers(0, 4, n)].tobytes())
        s[int(rng.integers(10, n - 20))] = ord("N")
        p = int(rng.integers(0, n - 12))
        s[p : p + 5] = b"NNNNN"
        s[1:9] = bytes(s[1:9]).lower()
        out.append(bytes(s))
    return out


def _assert_same_index(a, b):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)
        else:
            assert va == vb, f


@pytest.mark.parametrize("k", [3, 16, 17, 31, 33, 51])
def test_build_tables_equal(k):
    seqs = _contigs(k)
    _assert_same_index(
        kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=k)),
        kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=k)),
    )


def test_build_revcomp_equal():
    seqs = _contigs(5)
    _assert_same_index(
        kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=21, add_revcomp=True)),
        kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=21, add_revcomp=True)),
    )


def test_disk_build_equal(tmp_path):
    seqs = _contigs(6)
    got = kbo_tpu_torch.build(
        seqs, kbo_tpu_torch.BuildOpts(k=19, temp_dir=str(tmp_path / "t"))
    )
    want = kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=19, temp_dir=str(tmp_path / "j")))
    _assert_same_index(got, want)


def test_encode_and_segments_equal():
    rng = np.random.default_rng(3)
    raw = bytes(rng.choice(list(b"ACGTacgtN$-x"), 500).astype(np.uint8))
    np.testing.assert_array_equal(encode_ascii(raw), jax_encode(raw))
    from kbo_tpu.index.encode import split_segments as jax_split

    ours, theirs = split_segments(encode_ascii(raw)), jax_split(jax_encode(raw))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_opts_defaults_equal():
    for name in ("BuildOpts", "FindOpts", "MatchOpts", "CallOpts", "MapOpts"):
        from kbo_tpu import opts as jopts
        from kbo_tpu_torch import opts as topts

        assert dataclasses.asdict(getattr(topts, name)()) == dataclasses.asdict(
            getattr(jopts, name)()
        ), name


@pytest.mark.parametrize("k", [15, 31])
def test_index_from_arrays_serves_find(k):
    """A kbo_tpu index carried across gives the same find output as the
    port's own build and as kbo_tpu's host oracle chain."""
    seqs = _contigs(40 + k)
    jidx = kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=k))
    carried = index_from_arrays(dataclasses.asdict(jidx))
    _assert_same_index(carried, jidx)
    own = kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=k))

    rng = np.random.default_rng(k)
    q = bytearray(seqs[0][100:600])
    for p in rng.integers(0, len(q), 8):
        q[p] = BASES[rng.integers(0, 4)]
    q = bytes(q)
    got = kbo_tpu_torch.find(q, carried, device="cpu")
    assert got == kbo_tpu_torch.find(q, own, device="cpu")

    thr = random_match_threshold(k, jidx.n_kmers, 4, 1e-7)
    ms, _ = query_ms_codes(jidx, jax_encode(q))
    want = run_lengths(translate_ms_vec(derandomize_ms_vec(ms, k, thr), k, thr))
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want
    ]
