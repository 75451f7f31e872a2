"""The plain reference: its vectorised pieces against their definitions,
and its answers against the port's CPU path on small inputs."""

import numpy as np
import pytest

from kbo_bench import generate
from kbo_bench.reference import kbo_ref as R
from kbo_bench.tests.bench_fixtures import TINY_CFG, tiny_traffic


def _brute_rows(seqs, k, revcomp=False):
    rows = {"$" * k}
    for s in seqs:
        for t in ([s, R.revcomp(s.encode()).decode()] if revcomp else [s]):
            for seg in "".join(c if c in "ACGT" else " " for c in t).split():
                pad = "$" * k + seg
                rows |= {pad[p + 1: p + k + 1] for p in range(len(seg))}
    return rows


def _brute_ms(rows, q, k):
    ms, uniq = [], []
    for i in range(len(q)):
        best = 0
        for length in range(1, k + 1):
            suf = q[max(0, i - length + 1): i + 1]
            if len(suf) < length or any(c not in "ACGT" for c in suf):
                break
            if any(r.endswith(suf) for r in rows):
                best = length
        ms.append(best)
        suf = q[i - best + 1: i + 1] if best else ""
        uniq.append(sum(r.endswith(suf) for r in rows) == 1)
    return ms, uniq


@pytest.mark.parametrize("k", [5, 7, 33])
def test_ms_and_unique_rows_against_their_definition(k):
    g = np.random.default_rng(k)
    seqs = ["".join(g.choice(list("ACGT"), size=n)) for n in (60, 9, 120)]
    seqs[2] = seqs[2][:50] + "N" + seqs[2][51:]
    q = "".join(g.choice(list("ACGT"), size=80)) + seqs[0][10:50] + "NA"
    for revcomp in (False, True):
        rows = R.Rows([s.encode() for s in seqs], k, revcomp)
        brute = _brute_rows(seqs, k, revcomp)
        assert rows.n_rows == len(brute)
        assert rows.n_kmers == sum("$" not in r for r in brute)
        ms, urow = R.ms_query(rows, R.encode(q.encode()))
        bms, buniq = _brute_ms(brute, q, k)
        assert ms.tolist() == bms
        assert (urow >= 0).tolist() == buniq
        texts = rows.texts(urow[urow >= 0])
        for t, i in zip(texts, np.flatnonzero(urow >= 0)):
            assert t.tobytes().decode().endswith(q[i - ms[i] + 1: i + 1])


def _translate_scalar(ms, k, t):
    n = len(ms)
    res = [" "] * n
    for pos in range(n):
        prev = ms[pos - 1] if pos > 1 else k
        cur = ms[pos]
        nxt = ms[pos + 1] if pos < n - 1 else ms[pos]
        if pos > 1 and res[pos - 1] == "R" and res[pos] == "R":
            continue
        nx = " "
        if cur > t and 0 < nxt < t:
            c, nx = "R", "R"
        elif cur <= 0:
            c = "X" if nxt == 1 and prev > 0 else "-"
        else:
            c = "M"
        res[pos] = c
        if pos + 1 < n - 1 and nx != " ":
            res[pos + 1] = nx
    return "".join(res)


def test_translate_matches_the_sequential_rule():
    g = np.random.default_rng(3)
    for _ in range(200):
        ms = g.integers(-5, 12, size=int(g.integers(3, 40)))
        got = R.translate(ms, 11, 4).tobytes().decode()
        assert got == _translate_scalar(ms.tolist(), 11, 4)


@pytest.fixture(scope="module")
def tiny():
    return generate.make(TINY_CFG, tiny_traffic("ecoli_mg1655.find_panel"),
                         2**31 + 5)


def test_map_call_find_equal_the_ports_cpu_path(tiny):
    from kbo_tpu_torch import api
    from kbo_tpu_torch.opts import BuildOpts, CallOpts, FindOpts, MapOpts

    bo = BuildOpts(k=51, build_select=True)
    asm = tiny["pool"][0]
    idx = api.build_device(asm, bo, full=True, device="cpu")
    rows = R.Rows(asm, 51)
    assert idx.n_kmers == rows.n_kmers
    ref = tiny["reference"][0]
    assert api.map_(ref, idx, MapOpts(sbwt_build_opts=bo),
                    device="cpu") == R.map_(rows, ref)
    n_var = 0
    for contig in tiny["reference"]:
        got = [(v.query_pos, bytes(v.query_chars), bytes(v.ref_chars))
               for v in api.call(idx, contig, CallOpts(sbwt_build_opts=bo),
                                 device="cpu")]
        assert got == R.call_variants(rows, contig)
        n_var += len(got)
    assert n_var > 5
    sidx = api.build_device(asm, BuildOpts(k=51, add_revcomp=True),
                            device="cpu")
    got = [[(s.start, s.end, s.matches, s.mismatches, s.jumps, s.gap_bases,
             s.gap_opens) for s in segs]
           for segs in api.find_batch(tiny["panel"], sidx, FindOpts())]
    assert got == R.find_batch(R.Rows(asm, 51, True), tiny["panel"])
    assert sum(map(len, got)) > 0
