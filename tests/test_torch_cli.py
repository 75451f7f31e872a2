"""The port's command line (kbo_tpu_torch/cli.py) and the index files it
reads and writes (index/serialize.py, index/sbwt_format.py), on the CPU.

The fixtures of tests/test_cli_fixtures.py byte for byte; every verb of
tests/test_cli.py against kbo_tpu.cli.main's output on the same files;
the .sbwt / .lcs pair byte-identical between the packages, and each
package's .kbo.npz and .sbwt files loaded by the other.
"""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.cli import main as jmain
from kbo_tpu.index import serialize as jser
from kbo_tpu_torch import engine
from kbo_tpu_torch.cli import main
from kbo_tpu_torch.index import sbwt_format as tfmt
from kbo_tpu_torch.index import serialize as tser
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.io.fastx import read_fastx
from kbo_tpu_torch.ops.ms import query_ms_codes

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
BASES = b"ACGT"


def _fx(name):
    return str(FIXTURES / name)


def _run(argv, capsys):
    main(argv, device="cpu")
    return capsys.readouterr().out


def _run_both(argv, capsys):
    """(port stdout, kbo_tpu stdout) of one command line."""
    got = _run(argv, capsys)
    jmain(argv)
    return got, capsys.readouterr().out


# ------------------------------------------------------------ fixtures


def test_cli_call_vcf_fixture(capsys):
    """The call doctest pair (src/lib.rs:525-544) as VCF; the date line
    is today's, the source line names the package's version."""
    out = _run(["call", "-k", "20", "--max-error-prob", "0.001",
                "-r", _fx("call_ref.fasta"), _fx("call_query.fasta")], capsys)
    lines = out.splitlines()
    assert lines[2].startswith("##fileDate=")
    assert lines[3] == f"##source=kbo-tpu v{kbo_tpu_torch.__version__}"
    lines[2] = "##fileDate=NORMALIZED"
    assert lines[:2] + lines[4:] == [
        "##fileformat=VCFv4.4",
        "##contig=<ID=ref,length=71>",
        "##reference=call_ref.fasta",
        "##phasing=none",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tunknown",
        "ref\t22\t.\tCAGG\tC\t.\t.\tINDEL\tGT\t1",
        "ref\t43\t.\tT\tC\t.\t.\t.\tGT\t1",
        "ref\t60\t.\tC\tCC\t.\t.\tINDEL\tGT\t1",
    ]


def test_cli_find_tsv_fixture(capsys):
    """The find doctest (src/lib.rs:779-806) as the 13-column TSV."""
    out = _run(["find", "--max-gap-len", "50", "-r", _fx("find_ref.fasta"),
                _fx("find_query.fasta")], capsys)
    header = (
        "query\tref\tq.start\tq.end\tstrand\tlength\tmismatches\tgap_bases"
        "\tgap_opens\tidentity\tcoverage\tquery.contig\tref.contig"
    )
    assert out == "\n".join([
        header,
        "find_query.fasta\tfind_ref.fasta\t1\t513\t+\t513\t1\t0\t0"
        "\t99.81\t41.50\tquery\tfind_ref.fasta",
        "find_query.fasta\tfind_ref.fasta\t594\t1340\t+\t747\t0\t38\t3"
        "\t94.91\t57.36\tquery\tfind_ref.fasta",
    ]) + "\n"


def test_cli_map_aln_fixture(capsys):
    """Map doctest 1 (src/lib.rs:646-660, k=3) as .aln."""
    out = _run(["map", "-k", "3", "-r", _fx("map_ref.fasta"),
                _fx("map_query.fasta")], capsys)
    assert out == ">map_query.fasta\n---------AGG--\n"


# ---------------------------------------------- every verb vs kbo_tpu


@pytest.fixture
def genome_pair(tmp_path):
    """tests/test_cli.py's pair (a 3000-base reference, SNPs every 700),
    plus a second reference contig and a gzip copy of the query."""
    rng = np.random.default_rng(11)
    ref = bytes(BASES[i] for i in rng.integers(0, 4, 3000))
    q = bytearray(ref)
    for p in range(400, 2600, 700):
        q[p] = BASES[(BASES.index(bytes([q[p]])) + 1) % 4]
    ref_path = tmp_path / "ref.fasta"
    q_path = tmp_path / "query.fasta"
    ref_path.write_text(">chr1 test reference\n" + ref.decode() + "\n"
                        + ">chr2\n" + ref[1000:1800].decode() + "\n")
    q_path.write_text(">q1 test query\n" + bytes(q).decode() + "\n")
    gz = tmp_path / "query.fa.gz"
    gz.write_bytes(gzip.compress(q_path.read_bytes()))
    return ref_path, q_path, gz


def test_cli_call_equals_kbo_tpu(genome_pair, capsys):
    ref, q, _ = genome_pair
    got, want = _run_both(["call", "-r", str(ref), str(q), "-k", "51"], capsys)
    assert got == want
    records = [l for l in got.splitlines() if not l.startswith("#")]
    assert [int(r.split("\t")[1]) for r in records if r.startswith("chr1")] \
        == [401, 1101, 1801, 2501]


@pytest.mark.parametrize("extra", [
    [], ["--max-gap-len", "10"], ["--detailed"], ["--device-index"],
    ["--device-index", "--detailed", "-k", "25"],
])
def test_cli_find_equals_kbo_tpu(genome_pair, capsys, extra):
    ref, q, gz = genome_pair
    got, want = _run_both(["find", "-r", str(ref), str(q), str(gz), *extra],
                          capsys)
    assert got == want
    assert len(got.splitlines()) > 2


def test_cli_map_equals_kbo_tpu(genome_pair, capsys):
    ref, q, _ = genome_pair
    got, want = _run_both(["map", "-r", str(ref), str(q), "-k", "51"], capsys)
    assert got == want
    lines = got.splitlines()
    assert lines[0] == ">query.fasta" and len(lines[1]) == 3000


def test_cli_map_k151_equals_api(genome_pair, capsys):
    """map -k 151 (the 2-bit map path) prints the API's map_batch output
    for both reference contigs."""
    ref, q, _ = genome_pair
    got = _run(["map", "-r", str(ref), str(q), "-k", "151"], capsys)
    contigs = [seq for _, seq in read_fastx(str(ref))]
    bo = kbo_tpu_torch.BuildOpts(k=151, build_select=True)
    idx = kbo_tpu_torch.build(
        [seq for _, seq in read_fastx(str(q))], bo)
    want = kbo_tpu_torch.map_batch(
        contigs, idx, kbo_tpu_torch.MapOpts(sbwt_build_opts=bo), device="cpu")
    assert got == ">query.fasta\n" + "".join(a.decode() + "\n" for a in want)
    assert [len(line) for line in got.splitlines()[1:]] == [3000, 800]


@pytest.mark.parametrize("fmt", ["npz", "sbwt"])
def test_cli_build_and_find_prebuilt(genome_pair, tmp_path, capsys, fmt):
    """build -o (either file form) then find -i on the built index: the
    same rows as kbo_tpu's find on kbo_tpu's own build, and kbo_tpu's find
    reads the port's files (and the other way round)."""
    ref, q, _ = genome_pair
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    main(["build", "-o", mine, "--format", fmt, str(ref)], device="cpu")
    jmain(["build", "-o", theirs, "--format", fmt, str(ref)])
    capsys.readouterr()
    if fmt == "sbwt":
        for ext in (".sbwt", ".lcs"):
            assert Path(mine + ext).read_bytes() == Path(theirs + ext).read_bytes()
    for prefix in (mine, theirs):  # the rows name the index file
        got = _run(["find", "-i", prefix, str(q)], capsys)
        jmain(["find", "-i", prefix, str(q)])
        assert got == capsys.readouterr().out
        assert len(got.splitlines()) >= 2
    assert got == _run(["find", "-i", mine, str(q)], capsys).replace(
        "mine", "theirs")


def test_cli_find_checkpoint_resume(genome_pair, tmp_path):
    """-o / --resume: the checkpoint records each (target, file) pair with
    its byte offset, a resume appends nothing, a torn tail is cut, a fresh
    run overwrites; the file equals kbo_tpu's."""
    ref, q, gz = genome_pair
    out = str(tmp_path / "hits.tsv")
    jout = str(tmp_path / "jhits.tsv")
    argv = ["find", str(q), str(gz), "-r", str(ref)]
    main(argv + ["-o", out], device="cpu")
    jmain(argv + ["-o", jout])
    first = open(out).read()
    assert first == open(jout).read()
    ckpt = open(f"{out}.ckpt").read().splitlines()
    assert len(ckpt) == 2
    assert int(ckpt[-1].rsplit("\t", 1)[1]) == len(first.encode())
    main(argv + ["-o", out, "--resume"], device="cpu")
    assert open(out).read() == first
    with open(out, "a") as fh:
        fh.write("torn partial row")
    main(argv + ["-o", out, "--resume"], device="cpu")
    assert open(out).read() == first
    main(argv + ["-o", out], device="cpu")
    assert open(out).read() == first


def test_cli_stats_and_profile_dir(genome_pair, tmp_path, capsys):
    """--stats prints the run's statistics as JSON on stderr;
    --profile-dir writes a torch.profiler trace into the directory."""
    ref, q, _ = genome_pair
    prof = tmp_path / "prof"
    main(["--stats", "--profile-dir", str(prof), "find", "-r", str(ref),
          str(q)], device="cpu")
    captured = capsys.readouterr()
    stats = json.loads(captured.err.strip().splitlines()[-1])
    assert stats["find_batch_calls"] >= 1
    assert any(f.name.endswith(".json") for f in prof.rglob("*"))


def test_cli_requires_reference(genome_pair):
    _, q, _ = genome_pair
    with pytest.raises(SystemExit, match="requires --reference"):
        main(["find", str(q)], device="cpu")


def test_module_entry_point_runs_on_the_card(genome_pair):
    """python -m kbo_tpu_torch runs main() on the CUDA card: without one it
    exits nonzero naming the missing device; its parser answers --help."""
    ref, q, _ = genome_pair
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    helped = subprocess.run([sys.executable, "-m", "kbo_tpu_torch", "--help"],
                            capture_output=True, text=True, env=env)
    assert helped.returncode == 0 and "call" in helped.stdout
    if torch.cuda.is_available():
        return
    run = subprocess.run(
        [sys.executable, "-m", "kbo_tpu_torch", "find", "-r", str(ref), str(q)],
        capture_output=True, text=True, env=env,
    )
    assert run.returncode != 0 and "no CUDA device" in run.stderr


# ----------------------------------------------------------- index files


REFERENCE = b"AAAGAACCA-TCAGGGCG"
QUERY = b"CAAGCCACTCATTGGGTC"


def _assert_same_index(a, b):
    assert (a.k, a.n_rows, a.n_kmers) == (b.k, b.n_rows, b.n_kmers)
    for name in ("bits", "cum", "C", "lcs", "keys3", "keys2", "cap2",
                 "row_pos", "text"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert bool(a.text_is_access) == bool(b.text_is_access)


def test_sbwt_golden_roundtrip(tmp_path):
    """The golden MS vector (src/index.rs:238-240) through a written and
    re-read .sbwt pair, by the scalar walk and by the port's join."""
    idx = kbo_tpu_torch.build([REFERENCE], kbo_tpu_torch.BuildOpts(k=3))
    prefix = str(tmp_path / "g")
    tfmt.write_kbo_sbwt(prefix, idx)
    loaded = tfmt.read_kbo_sbwt(prefix)
    codes = encode_ascii(QUERY)
    gold = [1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2]
    assert query_ms_codes(loaded, codes)[0].tolist() == gold
    assert engine.compute_ms_values(loaded, codes, "cpu").tolist() == gold


@pytest.mark.parametrize("k", [7, 31, 33, 63])
def test_index_files_cross_load(tmp_path, k):
    """A multi-segment index at k: the .sbwt / .lcs bytes equal kbo_tpu's;
    each package loads the other's .sbwt pair and .kbo.npz to the same
    arrays; the loaded index keeps every row's k-mer."""
    rng = np.random.default_rng(k)
    seq = bytearray(np.frombuffer(BASES, np.uint8)[rng.integers(0, 4, 3000)])
    for p in range(100, 2900, 371):
        seq[p] = ord("N")
    seq = bytes(seq)
    tidx = kbo_tpu_torch.build([seq], kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build([seq], kbo_tpu.BuildOpts(k=k))
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    tser.serialize_sbwt(mine, tidx)
    jser.serialize_sbwt(theirs, jidx)
    for ext in (".sbwt", ".lcs"):
        assert Path(mine + ext).read_bytes() == Path(theirs + ext).read_bytes()
    t_loaded, j_loaded = tser.load_sbwt(theirs), jser.load_sbwt(mine)
    _assert_same_index(t_loaded, j_loaded)
    rows = np.arange(tidx.n_rows)
    np.testing.assert_array_equal(
        t_loaded.access_kmers_codes(rows), tidx.access_kmers_codes(rows))
    np.testing.assert_array_equal(t_loaded.keys3, tidx.keys3)
    tser.save_index(mine, tidx)
    jser.save_index(theirs, jidx)
    _assert_same_index(tser.load_index(theirs), jser.load_index(mine))
    _assert_same_index(tser.load_index(mine), tidx)
    # an index loaded from .sbwt survives the .npz checkpoint
    tser.save_index(mine + "2", t_loaded)
    _assert_same_index(jser.load_index(mine + "2"), j_loaded)


def test_sbwt_defensive_reader(tmp_path):
    """A wrong variant name and a corrupted popcount raise ValueError."""
    import struct

    idx = kbo_tpu_torch.build([REFERENCE], kbo_tpu_torch.BuildOpts(k=3))
    sbwt_path, lcs_path = tfmt.write_kbo_sbwt(str(tmp_path / "i"), idx)
    raw = open(sbwt_path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    bad = str(tmp_path / "bad")
    Path(bad + ".sbwt").write_bytes(struct.pack("<Q", 6) + b"Plain!" + raw[20:])
    Path(bad + ".lcs").write_bytes(open(lcs_path, "rb").read())
    with pytest.raises(ValueError, match="Plain!"):
        tfmt.read_kbo_sbwt(bad)
    corrupt = bytearray(raw)
    corrupt[8 + n + 16 : 8 + n + 24] = struct.pack("<Q", 999999)
    Path(bad + ".sbwt").write_bytes(bytes(corrupt))
    with pytest.raises(ValueError, match="popcount"):
        tfmt.read_kbo_sbwt(bad)
