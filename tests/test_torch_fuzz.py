"""Seeded multi-config fuzz of the port's batch pipeline against kbo_tpu's
scalar host oracle chain (ops/ms.py -> ops/derandomize.py ->
ops/translate.py -> ops/format.py), on the CPU: the generators and seeds of
tests/test_fuzz_differential.py, bit-exact chars, MS and RLE lists."""

import dataclasses

import numpy as np
import pytest
import torch

import kbo_tpu
import kbo_tpu_torch
from kbo_tpu.index.encode import encode_ascii
from kbo_tpu.ops.derandomize import derandomize_ms_vec, random_match_threshold
from kbo_tpu.ops.format import run_lengths
from kbo_tpu.ops.ms import query_ms_codes
from kbo_tpu.ops.translate import translate_ms_vec
from kbo_tpu_torch.pipeline import matches_ms_batch

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
KS = [7, 15, 21, 31, 41, 63]


def _n_run(rng, seq: bytearray):
    p = int(rng.integers(0, len(seq) - 20))
    ln = int(rng.integers(1, 12))
    seq[p : p + ln] = b"N" * ln
    return seq


@pytest.mark.parametrize("seed", range(12))
def test_matches_vs_kbo_tpu_oracle(seed):
    rng = np.random.default_rng([seed, 991])
    n = int(rng.integers(1500, 6000))
    genome = BASES[rng.integers(0, 4, n)].tobytes()
    k = int(rng.choice(KS))
    n_contigs = int(rng.integers(1, 4))
    cuts = sorted(rng.integers(k + 2, n - k - 2, n_contigs - 1).tolist())
    contigs = [genome[a:b] for a, b in zip([0] + cuts, cuts + [n])]
    seq = bytearray(genome)
    snp_rate = float(rng.choice([0.002, 0.01, 0.05]))
    for p in np.nonzero(rng.random(n) < snp_rate)[0]:
        seq[p] = BASES[rng.integers(0, 4)]
    for _ in range(int(rng.integers(0, 4))):
        p = int(rng.integers(50, len(seq) - 60))
        ln = int(rng.integers(1, 6))
        if rng.random() < 0.5:
            del seq[p : p + ln]
        else:
            seq[p:p] = BASES[rng.integers(0, 4, ln)].tobytes()
    if rng.random() < 0.5:
        p = int(rng.integers(0, len(seq) - 40))
        seq[p : p + 30] = bytes(seq[p : p + 30]).lower()
    if rng.random() < 0.5:
        _n_run(rng, seq)
    seq = bytes(seq)

    index = kbo_tpu_torch.build(contigs, kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build(contigs, kbo_tpu.BuildOpts(k=k))
    threshold = min(
        max(2, k - 1),
        max(2, random_match_threshold(k, jidx.n_kmers, 4, 1e-7)),
    )
    codes = encode_ascii(seq)
    got_chars, got_ms = matches_ms_batch(index, [codes], threshold, device="cpu")

    want_ms, _ = query_ms_codes(jidx, codes)
    want_chars = translate_ms_vec(
        derandomize_ms_vec(want_ms, k, threshold), k, threshold
    )
    msg = f"seed={seed} k={k} thr={threshold} L={len(seq)}"
    np.testing.assert_array_equal(got_ms[0], np.asarray(want_ms), err_msg=msg)
    assert [chr(c) for c in got_chars[0]] == want_chars, msg


@pytest.mark.parametrize("seed", range(2))
def test_compute_ms_values_many_vs_kbo_tpu(seed):
    """The port's one-batch engine entry (every query on the join, however
    short) against kbo_tpu's, which takes the host oracle below its cutoff
    and the device join above it: the MS values agree either way."""
    from kbo_tpu import engine as jengine
    from kbo_tpu_torch import engine as tengine

    rng = np.random.default_rng([seed, 77])
    genome = BASES[rng.integers(0, 4, 3000)].tobytes()
    k = int(rng.choice([15, 31]))
    lens = [1, 40, 300] if seed == 0 else [500, 700, 129]
    code_list = []
    for ln in lens:
        s = int(rng.integers(0, len(genome) - ln))
        q = bytearray(genome[s : s + ln])
        for p in np.nonzero(rng.random(ln) < 0.02)[0]:
            q[p] = BASES[rng.integers(0, 4)]
        code_list.append(encode_ascii(bytes(q)))
    index = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=k))
    jidx = kbo_tpu.build([genome], kbo_tpu.BuildOpts(k=k))
    got = tengine.compute_ms_values_many(index, code_list, device="cpu")
    want = jengine.compute_ms_values_many(jidx, code_list)
    assert len(got) == len(want) == len(code_list)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert tengine.compute_ms_values_many(index, [], device="cpu") == []
    assert tengine.compute_ms_values_many_device(index, [], device="cpu") is None


@pytest.mark.parametrize("seed", range(6))
def test_find_batch_vs_kbo_tpu_oracle(seed):
    rng = np.random.default_rng([seed, 313])
    n = int(rng.integers(1200, 5000))
    genome = BASES[rng.integers(0, 4, n)].tobytes()
    k = int(rng.choice([15, 31, 51]))
    queries = []
    for _ in range(5):
        ln = int(rng.integers(200, 1100))
        s = int(rng.integers(0, n - ln))
        q = bytearray(genome[s : s + ln])
        for p in np.nonzero(rng.random(ln) < 0.02)[0]:
            q[p] = BASES[rng.integers(0, 4)]
        queries.append(bytes(q))

    index = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=k))
    got = kbo_tpu_torch.find_batch(queries, index, device="cpu")
    jidx = kbo_tpu.build([genome], kbo_tpu.BuildOpts(k=k))
    thr = random_match_threshold(k, jidx.n_kmers, 4, 1e-7)
    for g, q in zip(got, queries):
        ms, _ = query_ms_codes(jidx, encode_ascii(q))
        want = run_lengths(translate_ms_vec(derandomize_ms_vec(ms, k, thr), k, thr))
        assert [dataclasses.asdict(r) for r in g] == [
            dataclasses.asdict(r) for r in want
        ], (seed, k)
