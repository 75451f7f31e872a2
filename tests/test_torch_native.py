"""The port's native host library (kbo_tpu_torch/native.py: the 2-bit pack
and the FASTA/FASTQ scanner, built with g++ from kbo_tpu_torch/native_src)
against their plain versions, and the chunked upload that packs chunk by
chunk, on the CPU. Exact equality throughout.
"""

import gzip

import numpy as np
import pytest
import torch

from kbo_tpu.io import fastx as jfastx
from kbo_tpu.kernels import mapsweep as jmap
from kbo_tpu_torch import native
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.io import fastx as tfastx
from kbo_tpu_torch.kernels import mapsweep as tmap
from kbo_tpu_torch.kernels import ms as tms

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _assert_pack_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None and len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _matrix(seed, Q, L, lengths, n_exc):
    rng = np.random.default_rng(seed)
    mat = np.zeros((Q, L), np.uint8)
    for q, n in enumerate(lengths):
        mat[q, :n] = BASES[rng.integers(0, 4, n)]
    odd = np.frombuffer(b"NnacgtRY$-*", dtype=np.uint8)
    for _ in range(n_exc):
        q = int(rng.integers(0, Q))
        i = int(rng.integers(0, L))  # in-length and past it (tail)
        mat[q, i] = odd[rng.integers(0, odd.size)]
    return mat


@pytest.mark.parametrize(
    "seed,Q,L,lengths,n_exc",
    [
        (0, 1, 4096, [4096], 0),  # no exceptions
        (1, 1, 4096, [4000], 70),  # exceptions past 64: padded to 128
        (2, 4, 1024, [1024, 700, 0, 5], 40),  # ragged rows, an empty row
        (3, 3, 1000, [1000, 999, 3], 20),  # L % 4 == 0, odd lengths
        (4, 2, 1022, [1022, 10], 5),  # L % 4 != 0: None
        (5, 2, 512, [512, 512], 300),  # dense exceptions: None
        (6, 1, 2048, [2048], 128),  # at most Q*L/16 = 128 in length
    ],
)
def test_pack_native_equals_plain(seed, Q, L, lengths, n_exc):
    """pack_ascii_host (the native loop) equals pack_ascii_plain (numpy)
    and kbo_tpu's pack byte for byte: packed bases, the exception list
    padded to a power of two with Q*L, the declines."""
    mat = _matrix(seed, Q, L, lengths, n_exc)
    lens = np.asarray(lengths, np.int32)
    got = tmap.pack_ascii_host(mat, lens)
    want = tmap.pack_ascii_plain(mat, lens)
    _assert_pack_equal(got, want)
    _assert_pack_equal(got, jmap.pack_ascii_host(mat, lens))
    if got is not None:
        raw, _ = tmap.decode_packed4_encode_device(
            *(torch.from_numpy(a) for a in got), torch.from_numpy(lens)
        )
        in_len = np.arange(L)[None, :] < lens[:, None]
        np.testing.assert_array_equal(raw.numpy(), np.where(in_len, mat, 0))


def test_pack_dense_boundary():
    """One exception past max(64, Q*L/16) declines in both forms."""
    mat = np.full((1, 2048), ord("A"), np.uint8)
    lens = np.asarray([2048], np.int32)
    mat[0, :128] = ord("N")
    assert tmap.pack_ascii_host(mat, lens)[1].size == 128
    mat[0, 128] = ord("N")
    assert tmap.pack_ascii_host(mat, lens) is None
    assert tmap.pack_ascii_plain(mat, lens) is None


def test_native_library_named_by_its_sources():
    """The library builds into _build under a hash of its sources and
    flags, and loads from there."""
    native.lib()
    path = native._lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.build() == 0.0


@pytest.mark.parametrize("chunk", [256, 1000, 1024])
def test_upload_sweep_chunked_pipelined(chunk):
    """The chunk-by-chunk upload and sweep equal the one-shot upload
    followed by the chunked sweep: raw bytes, codes, ms / uniq / rows and
    the per-chunk query tables."""
    import kbo_tpu_torch

    k = 31
    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, 3000)].tobytes()
    idx = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=k))
    dev = tms.DeviceIndex(idx, "cpu")
    refs = [bytearray(genome[:2900]), bytearray(genome[500:1700])]
    refs[0][700:705] = b"NNNNN"
    refs[1][40] = ord("a")
    L = 3000
    mat = np.zeros((2, L), np.uint8)
    for q, r in enumerate(refs):
        mat[q, : len(r)] = np.frombuffer(bytes(r), np.uint8)
    lens = np.asarray([len(r) for r in refs], np.int32)
    got = tmap.upload_sweep_chunked_pipelined(
        dev.keys3, dev.rows_packed, mat, lens, k, chunk, want_qtable=True
    )
    packed = tmap.pack_ascii_host(mat, lens)
    raw, codes = tmap.decode_packed4_encode_device(
        *(torch.from_numpy(a) for a in packed), torch.from_numpy(lens)
    )
    want = tmap.ms3_rows_sweep_chunked(
        dev.keys3, dev.rows_packed, codes, k, chunk, want_qtable=True
    )
    assert torch.equal(got[0], raw) and torch.equal(got[1], codes)
    for g, w in zip(got[2:5], want[:3]):
        assert torch.equal(g, w)
    assert len(got[5]) == len(want[3]) == -(-L // chunk)
    for (gw, gl), (ww, wl) in zip(got[5], want[3]):
        assert torch.equal(gw, ww) and torch.equal(gl, wl)
    assert tmap.upload_sweep_chunked_pipelined(
        dev.keys3, dev.rows_packed, mat, lens, k, 258) is None  # chunk % 4
    dense = np.full((1, 1024), ord("a"), np.uint8)
    assert tmap.upload_sweep_chunked_pipelined(
        dev.keys3, dev.rows_packed, dense, np.asarray([1024], np.int32), k,
        256) is None


FASTA_CASES = {
    "plain": b">a desc\nACGT\nACGT\n>b\nTTTT\n",
    "crlf_blank_lead": b"\n\r\n>x  \r\nACG T\r\nNNac\r\n\n>y\n>z\nGG",
    "wrapped_long": b">chr1 x\n" + b"ACGTN\n" * 200 + b">chr2\nacgt\n",
}
FASTQ_CASES = {
    "plain": b"@r1\nACGTA\n+\nIIIII\n@r2\nGGG\n+\nIII\n",
    "blank_lines": b"\n\n@r1 d\nACGTA\n+r1\nIIIII\n\n  \n@r2\nGG\n+\nII",
}


def _write(tmp_path, name, data, gz):
    path = tmp_path / (name + (".gz" if gz else ""))
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        path.write_bytes(data)
    return path


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize(
    "case", [("fa", n) for n in FASTA_CASES] + [("fq", n) for n in FASTQ_CASES]
)
def test_fastx_native_equals_python(tmp_path, case, gz):
    """read_fastx (the native scanner) equals read_fastx_py and kbo_tpu's
    reader, plain and gzip."""
    kind, name = case
    data = (FASTA_CASES if kind == "fa" else FASTQ_CASES)[name]
    path = _write(tmp_path, f"{name}.{kind}", data, gz)
    got = tfastx.read_fastx(path)
    assert got == tfastx.read_fastx_py(path)
    assert got == jfastx.read_fastx(path) == jfastx.read_fastx_py(path)
    assert got


def test_fastx_random_records(tmp_path):
    """Many random records with ragged line wrapping."""
    rng = np.random.default_rng(4)
    lines = []
    for r in range(50):
        seq = BASES[rng.integers(0, 4, int(rng.integers(0, 300)))].tobytes()
        lines.append(b">rec%d some description" % r)
        w = int(rng.integers(1, 80))
        lines += [seq[i : i + w] for i in range(0, len(seq), w)]
    path = _write(tmp_path, "r.fa", b"\n".join(lines) + b"\n", gz=True)
    got = tfastx.read_fastx(path)
    assert len(got) == 50 and got == tfastx.read_fastx_py(path)
    assert all(encode_ascii(s).max(initial=1) <= 4 for _, s in got)


def test_fastx_malformed(tmp_path):
    bad = tmp_path / "bad.fq"
    bad.write_bytes(b"@r1\nACGT\nIIII\n")  # no '+' line
    with pytest.raises(ValueError, match="malformed"):
        tfastx.read_fastx(bad)
    with pytest.raises(ValueError, match="malformed"):
        tfastx.read_fastx_py(bad)
    other = tmp_path / "x.txt"
    other.write_bytes(b"hello\n")
    with pytest.raises(ValueError, match="not a FASTA/FASTQ"):
        tfastx.read_fastx(other)
