"""The port's single-core engine (kbo_tpu_torch/native.py over
native_src/kbo_cpu.cpp and kbo_refine.cpp, built with g++) on the CPU:
streaming MS, derandomize, translate and the index build against
kbo_tpu.native and the port's Python oracles, and ``map_e2e`` against
kbo_tpu's and against the port's own ``map_(device="cpu")``. Exact equality
throughout: MS values, intervals, rank arrays, chars and map bytes.
"""

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu import native as jnative
from kbo_tpu_torch import native
from kbo_tpu_torch.index.build import build_index_from_segments
from kbo_tpu_torch.index.encode import encode_ascii, split_segments
from kbo_tpu_torch.ops.derandomize import (
    derandomize_ms_vec,
    random_match_threshold,
)
from kbo_tpu_torch.ops.ms import query_ms_codes
from kbo_tpu_torch.ops.translate import translate_ms_vec

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _both(seqs, k, **kw):
    return (kbo_tpu_torch.build(seqs, kbo_tpu_torch.BuildOpts(k=k, **kw)),
            kbo_tpu.build(seqs, kbo_tpu.BuildOpts(k=k, **kw)))


def test_sources_are_the_ports_own():
    assert native.SOURCES == ("pack.cpp", "fastx.cpp", "kbo_cpu.cpp",
                              "kbo_refine.cpp")
    assert all((native.SRC_DIR / s).is_file() for s in native.SOURCES)
    assert native.SRC_DIR.name == "native_src"


def test_ms_stream_golden():
    t_idx, j_idx = _both([b"AAAGAACCA-TCAGGGCG"], 3)
    codes = encode_ascii(b"CAAGCCACTCATTGGGTC")
    ms, iv = native.ms_stream(t_idx, codes)
    assert ms.dtype == np.int64 and iv.dtype == np.int64
    assert iv.shape == (codes.size, 2)
    assert ms.tolist() == [1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2]
    ms_ref, iv_ref = query_ms_codes(t_idx, codes)
    np.testing.assert_array_equal(ms, ms_ref)
    np.testing.assert_array_equal(iv, iv_ref)
    ms_j, iv_j = jnative.ms_stream(j_idx, codes)
    np.testing.assert_array_equal(ms, ms_j)
    np.testing.assert_array_equal(iv, iv_j)


@pytest.mark.parametrize("k", [3, 9, 31, 63])
def test_ms_stream_differential(k):
    rng = np.random.default_rng(k + 1000)
    ref = BASES[rng.integers(0, 4, 600)].tobytes()
    q = bytearray(BASES[rng.integers(0, 4, 400)].tobytes())
    q[40:160] = ref[100:220]
    q[220:300] = ref[20:100]
    for p in rng.integers(0, 400, 6):
        q[p : p + 1] = b"N"
    t_idx, j_idx = _both([ref], k)
    codes = encode_ascii(bytes(q))
    ms_ref, iv_ref = query_ms_codes(t_idx, codes)
    ms_nat, iv_nat = native.ms_stream(t_idx, codes)
    np.testing.assert_array_equal(ms_nat, ms_ref)
    np.testing.assert_array_equal(iv_nat, iv_ref)
    ms_j, iv_j = jnative.ms_stream(j_idx, codes)
    np.testing.assert_array_equal(ms_nat, ms_j)
    np.testing.assert_array_equal(iv_nat, iv_j)


def test_derandomize_translate_native():
    noisy = np.array([1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2])
    d = native.derandomize(noisy, 3, 2)
    assert d.dtype == np.int64
    assert d.tolist() == derandomize_ms_vec(noisy, 3, 2).tolist()
    t = native.translate(d, 3, 2)
    assert t.dtype == np.uint8
    assert [chr(c) for c in t] == translate_ms_vec(d, 3, 2)

    rng = np.random.default_rng(77)
    ref = BASES[rng.integers(0, 4, 800)].tobytes()
    q = bytearray(ref)
    for p in rng.integers(5, 795, 25):
        q[p] = BASES[rng.integers(0, 4)]
    t_idx, _ = _both([bytes(q)], 21)
    noisy, _ = query_ms_codes(t_idx, encode_ascii(ref))
    for thr in (2, 5, 11):
        d_py = derandomize_ms_vec(noisy, 21, thr)
        d_na = native.derandomize(noisy, 21, thr)
        np.testing.assert_array_equal(d_na, d_py)
        np.testing.assert_array_equal(d_na, jnative.derandomize(noisy, 21, thr))
        t_py = translate_ms_vec(d_py, 21, thr)
        t_na = native.translate(d_na, 21, thr)
        assert [chr(c) for c in t_na] == t_py
        np.testing.assert_array_equal(t_na, jnative.translate(d_na, 21, thr))


def test_native_build_matches_python():
    """The C++ construction gives the rank arrays of the numpy build, and
    kbo_tpu's native build's."""
    rng = np.random.default_rng(5)
    seq = bytearray(BASES[rng.integers(0, 4, 5000)].tobytes())
    seq[1200:1203] = b"NNN"  # segment break
    codes = encode_ascii(bytes(seq))
    for k in (15, 31, 51, 63):
        py = build_index_from_segments(split_segments(codes), k)
        nat = native.build_arrays(codes, k)
        want = jnative.build_arrays(codes, k)
        assert nat["n_rows"] == py.n_rows == want["n_rows"]
        assert nat["n_words"] == py.n_words
        assert np.array_equal(nat["C"], py.C)
        assert np.array_equal(nat["lcs"], py.lcs)
        assert np.array_equal(nat["bits"].reshape(4, -1), py.bits)
        assert np.array_equal(nat["cum"].reshape(4, -1), py.cum)
        for key in ("bits", "cum", "C", "lcs", "row_pos", "text"):
            assert nat[key].dtype == want[key].dtype
            np.testing.assert_array_equal(nat[key], want[key])
    with pytest.raises(ValueError, match="k <= 63"):
        native.build_arrays(codes, 64)
    with pytest.raises(ValueError, match="empty"):
        native.build_arrays(encode_ascii(b"NNNN"), 31)


def test_index_dtypes_are_checked_not_converted():
    """The rank arrays go in as the host index holds them; another dtype is
    a ctypes ArgumentError, never a quiet conversion."""
    import ctypes
    import dataclasses

    t_idx, _ = _both([BASES[np.random.default_rng(3).integers(
        0, 4, 300)].tobytes()], 9)
    bad = dataclasses.replace(t_idx, cum=t_idx.cum.astype(np.int64))
    with pytest.raises(ctypes.ArgumentError):
        native.ms_stream(bad, encode_ascii(b"ACGTACGTAC"))


def _pair(seed, n, snp_every=1100, indels=True):
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    q = bytearray(ref)
    for pos in range(700, n - 700, snp_every):
        q[pos] = BASES[(BASES.tolist().index(q[pos]) + 1) % 4]
    if indels:
        del q[n // 3 : n // 3 + 3]
        q[2 * n // 3 : 2 * n // 3] = b"GGA"
    return ref, bytes(q)


@pytest.mark.parametrize("k,seed", [(51, 3), (31, 7), (63, 11)])
def test_native_map_e2e_parity(k, seed):
    """map_e2e equals kbo_tpu's native map_e2e and the port's device path
    (map_ with the default MapOpts() and the index's BuildOpts) on the CPU,
    byte for byte, over a 40 kbase pair."""
    ref, query = _pair(seed, 40000)
    t_idx, j_idx = _both([query], k, build_select=True)
    thr = random_match_threshold(k, t_idx.n_kmers, 4, 1e-7)
    out, n_var = native.map_e2e(t_idx, ref, thr, 1e-7)
    want, want_var = jnative.map_e2e(j_idx, ref, thr, 1e-7)
    assert out == want and n_var == want_var
    assert len(out) == len(ref)
    # k = 31 resolves no SNP at this threshold (k < 2 * threshold + 1)
    assert (n_var > 0) == (k >= 2 * thr + 1)
    mo = kbo_tpu_torch.MapOpts(
        sbwt_build_opts=kbo_tpu_torch.BuildOpts(k=k, build_select=True))
    assert kbo_tpu_torch.map_(ref, t_idx, mo, device="cpu") == out


def test_map_e2e_cap_retry(monkeypatch):
    """More variants than the first buffer holds: the call runs again with
    four times the room, and the output is the one-buffer output."""
    ref, query = _pair(13, 12000, snp_every=200, indels=False)
    t_idx, _ = _both([query], 51, build_select=True)
    thr = random_match_threshold(51, t_idx.n_kmers, 4, 1e-7)
    want = native.map_e2e(t_idx, ref, thr, 1e-7)
    assert want[1] > 2
    caps = []
    real = native.lib().kbo_call_variants

    def recording(*a):
        caps.append(a[-1])
        return real(*a)

    monkeypatch.setattr(native, "_variant_cap", lambda n: 2)
    monkeypatch.setattr(native.lib(), "kbo_call_variants", recording)
    assert native.map_e2e(t_idx, ref, thr, 1e-7) == want
    assert caps[0] == 2 and len(caps) >= 2 and caps[-1] > want[1]
    assert caps == [2 * 4**i for i in range(len(caps))]
