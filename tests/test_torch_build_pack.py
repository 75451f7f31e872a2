"""The device index builds' host pack (``build_pack``): the construction
buffer written by the native pass (``kernels/ms.py::seq_index_buffer`` /
``full_index_buffer``, ``native_src/pack.cpp``) against its numpy form
(``seq_index_buffer_plain`` / ``full_index_buffer_plain``), byte for byte,
and the indexes built from either, on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from kbo_bench import run as bench_run
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.utils.stats import get_stats, reset_stats

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ALL_BYTES = bytes(range(256))


def _bulk(seed=5, n=40):
    """Contigs of 0-3000 bytes: mostly bases of either case, some with
    sprinkled N, IUPAC codes, '$' and control bytes (runs of bases of
    every length, so words and tails of every alignment)."""
    rng = np.random.default_rng(seed)
    odd = np.frombuffer(b"NnRYKMSWBDHV$-*\x00\xff", dtype=np.uint8)
    soft = np.frombuffer(b"ACGTacgt", dtype=np.uint8)
    out = []
    for _ in range(n):
        L = int(rng.integers(0, 3000))
        share = float(rng.choice([0.0, 0.0, 0.002, 0.05, 0.5]))
        seq = np.where(rng.random(L) < share, odd[rng.integers(0, odd.size, L)],
                       soft[rng.integers(0, soft.size, L)])
        out.append(seq.astype(np.uint8).tobytes())
    return out


CONTIGS = {
    # every byte value, both ways round: _LUT and _COMP on all 256
    "all_bytes": [ALL_BYTES, ALL_BYTES[::-1], b"ACGT" + ALL_BYTES * 2],
    # lowercase bases, N and IUPAC runs, a literal '$'
    "soft_iupac": [b"acgtACGTacgtnnnnACGTRYKMSWBDHVNNNNNNNNNNacgtgg",
                   b"ACGTAC$GTACGTACGTACGTAC$$acgtacgtacgtacgtacgt",
                   b"NNNNNNNNNNNNNNNNNNNN",
                   b"ttttttttttttttttttttttttttttttttttttttttttttttttttttttttt"
                   b"tRtt"],
    # an empty contig among others, one base, contigs shorter than k
    "short": [b"ACGTACGTAC", b"", b"G", b"ACGTTGCA" * 3, b"T" * 70, b"",
              b"CA"],
    "bulk": _bulk(),
}


@pytest.mark.parametrize("contigs", sorted(CONTIGS))
@pytest.mark.parametrize("k", [2, 31, 51, 63])
@pytest.mark.parametrize("add_revcomp", [False, True])
@pytest.mark.parametrize("layout", ["seq", "full"])
def test_native_pack_equals_plain(layout, add_revcomp, k, contigs):
    """The native pass writes the numpy form's buffer byte for byte, the
    bucket padding included; the full layout's text size too."""
    seqs = CONTIGS[contigs]
    if layout == "seq":
        got = tms.seq_index_buffer(seqs, k, add_revcomp)
        want = tms.seq_index_buffer_plain(seqs, k, add_revcomp)
        L = sum(map(len, seqs)) * (1 + add_revcomp) \
            + len(seqs) * (1 + add_revcomp) - 1
        assert got.size == k - 1 + tms._bucket(L)
    else:
        got, n = tms.full_index_buffer(seqs, k, add_revcomp)
        want, m = tms.full_index_buffer_plain(seqs, k, add_revcomp)
        assert n == m and got.size == tms._bucket(n)
        assert (got[n:] == tms.INVALID).all()
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_empty_input_errors():
    """Both forms and both constructors keep their errors for empty input:
    ValueError for the sequence index, the assertion for the full index
    (no contig, or no base in any contig)."""
    for fn in (tms.seq_index_buffer, tms.seq_index_buffer_plain):
        with pytest.raises(ValueError, match="empty input"):
            fn([], 31)
    with pytest.raises(ValueError, match="empty input"):
        tms.DeviceSeqIndex([], 31, device="cpu")
    for seqs in ([], [b"NNNN", b"$$", b""]):
        for fn in (tms.full_index_buffer, tms.full_index_buffer_plain):
            with pytest.raises(AssertionError, match="empty input"):
                fn(seqs, 31, True)
        with pytest.raises(AssertionError, match="empty input"):
            tms.DeviceFullIndex(seqs, 31, device="cpu")
    # an empty contig alone is a sequence index of no windows
    assert (tms.seq_index_buffer([b""], 31) == tms.INVALID).all()


def _draft():
    rng = np.random.default_rng(21)
    genome = BASES[rng.integers(0, 4, 3000)].tobytes()
    return [genome[:1400].lower(), genome[1400:2100] + b"NNRY" + genome[2100:],
            b"ACGTACGT", genome[500:900]]


@pytest.mark.parametrize("k", [15, 51])
@pytest.mark.parametrize("add_revcomp", [False, True])
def test_indexes_equal_from_the_plain_buffer(monkeypatch, add_revcomp, k):
    """DeviceSeqIndex and DeviceFullIndex built through the native pass
    hold the tables built from the numpy form's buffer; the full index's
    text is the buffer's first text-size bytes. The numpy form's helpers
    in kernels/ms.py raise during the builds, so they pack through the
    native pass alone."""
    seqs = _draft()
    sbuf = tms.seq_index_buffer_plain(seqs, k, add_revcomp)
    fbuf, n = tms.full_index_buffer_plain(seqs, k, add_revcomp)
    words, n_kmers = tms._seq_keys3(torch.from_numpy(sbuf), k)
    keys3, row_pos, keys2, cap2, meta = tms._build_full_core(
        torch.from_numpy(fbuf), k)
    meta = meta.numpy()

    def refuse(*args, **kwargs):
        raise AssertionError("build_pack took the numpy form")

    for name in ("encode_ascii", "revcomp_ascii", "split_segments",
                 "make_flat_buffer"):
        monkeypatch.setattr(tms, name, refuse)
    seq = tms.DeviceSeqIndex(seqs, k, add_revcomp, device="cpu")
    full = tms.DeviceFullIndex(seqs, k, add_revcomp, device="cpu")
    assert torch.equal(seq.ref_words, words) and seq.n_kmers == int(n_kmers)
    for name, want in (("keys3", keys3), ("row_pos", row_pos),
                       ("keys2", keys2), ("cap2", cap2)):
        assert torch.equal(getattr(full, name), want), name
    assert (full.n_rows, full.n_kmers) == (int(meta[0]), int(meta[1]))
    np.testing.assert_array_equal(full.C, meta[2:6].astype(np.int32))
    assert full.text.dtype == np.uint8 and full.text.size == n
    np.testing.assert_array_equal(full.text, fbuf[:n])


def test_build_pack_bytes_counter_and_readers():
    """Each build adds its bucketed buffer's bytes to ``build_pack_bytes``
    once; the benchmark's readers give them per request, and None for a
    program without the counter."""
    seqs = _draft()
    reset_stats()
    tms.DeviceSeqIndex(seqs, 31, True, device="cpu")
    d = get_stats().as_dict()
    seq_bytes = tms.seq_index_buffer_plain(seqs, 31, True).size
    assert d["build_pack_bytes"] == seq_bytes and d["build_pack_calls"] == 1
    tms.DeviceFullIndex(seqs, 31, device="cpu")
    full_bytes = tms.full_index_buffer_plain(seqs, 31)[0].size
    d = get_stats().as_dict()
    assert d["build_pack_bytes"] == seq_bytes + full_bytes
    assert d["build_pack_calls"] == 2

    bench = json.loads((bench_run.HERE.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for cell in ("map", "find"):
        name = f"build_pack_bytes.{cell}"
        m, twin = entries[name], entries[f"build_pack_ms.{cell}"]
        assert (m["source"], m["unit"], m["layer"]) == (
            "program_counter", "bytes/req", "index build")
        assert (m["moves"], m["workloads"]) == (twin["moves"],
                                                twin["workloads"])
        read = bench_run.load(bench_run.HERE / "metrics" / f"{name}.py").read
        stats = {"build_sort_calls": 4, "build_pack_bytes": 4 * full_bytes}
        assert read(bench_run.Run([{}] * 4, 1.0, 1.0, stats, None, None)) \
            == full_bytes
        assert read(bench_run.Run([{}] * 4, 1.0, 1.0, {"build_sort_calls": 4},
                                  None, None)) is None
        assert read(bench_run.Run([], 1.0, 1.0, stats, None, None)) is None
