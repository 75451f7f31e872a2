#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kbo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--genome BASES]

Phases, each printed as it passes; any failure exits non-zero:

1. probe: a CUDA device must exist (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from kbo_tpu_torch/kernels/csrc into
   kbo_tpu_torch/_build (or loads them from there);
   then the reference's golden MS vector and matches doctest on the card;
3. kernels: merge_path, clamp_scan (bits 2 and 3, both directions) and
   derandomize_translate against their plain PyTorch versions on the card,
   bit-exact, at the find and map shapes and at edge shapes;
4. the find slice at full size on bench.py's workload (a 4.6 Mbase genome
   from default_rng(42) with a SNP per kb and sparse 3-base deletions,
   k=51): find-core (ms2_core -> derandomize_translate over the streamed
   sequence) and serving (api.find_batch on a 512 x 4096 batch), with the
   kernels' launch counts read around each of the two calls alone (and the
   kernel held against its plain version on find-core's own full-length
   row); outputs must equal
   the port's own device="cpu" run of the same calls (the CPU run of
   find-core takes the first quarter of the sequence);
5. the map slice at full size on the same pair: api.map_ with
   MapOpts(fill_gaps=False, call_variants=False), format true and false,
   one 8-contig api.map_batch, and the chunked sweep against the
   single-shot one, launch counts read around each entry-point call alone;
   outputs must equal the port's own device="cpu" run byte for byte;
6. times on the card (CUDA events or the host clock, medians of 7; by
   stage), each with the card's name and power limit, then one
   torch.profiler run of each workload: device busy share and the kernels
   that take the time.

Prints the per-kernel JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

K = 51
QN, QL = 512, 4096
REPS = 7


def _hbm_bytes_per_s(name: str) -> float:
    """Published memory rate of the named H100 variant (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM, 80 GB HBM3


def _workload(n: int):
    """bench.py's genome pair: the streamed side and the indexed side."""
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = bases[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(500, n - 500, 1000):
        query[p] = bases[rng.integers(0, 4)]
    for p in range(n // 50, n - n // 50, n // 10):
        del query[p : p + 3]
    return ref, bytes(query)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=float, default=4.6e6)
    args = ap.parse_args()

    import torch

    from kbo_tpu_torch import BuildOpts, FindOpts, MapOpts, api
    from kbo_tpu_torch.engine import compute_ms_values_many_device, device_index
    from kbo_tpu_torch.index.encode import encode_ascii
    from kbo_tpu_torch.kernels import _build
    from kbo_tpu_torch.kernels.join import _lib as join_lib
    from kbo_tpu_torch.kernels.join import clamp_scan, clamp_scan_plain
    from kbo_tpu_torch.kernels import mapsweep
    from kbo_tpu_torch.kernels.ms import (
        _bucket,
        _merge_scan,
        make_flat_buffer,
        ms2_core,
        pack_windows_2bit,
        pack_windows_3bit,
        query_ms_values_device,
    )
    from kbo_tpu_torch.kernels.postprocess import (
        _lib as post_lib,
        derandomize_core,
        derandomize_translate,
        derandomize_translate_plain,
        translate_core,
    )
    from kbo_tpu_torch.kernels.sort import (
        _lib as sort_lib,
        _pack_key_words,
        _radix_sort,
        merge_path,
        merge_path_plain,
        to_i32,
        u32,
    )
    from kbo_tpu_torch.ops.derandomize import random_match_threshold
    from kbo_tpu_torch.pipeline import pad_batch
    from kbo_tpu_torch.refine.device_map import _pow2_cap, map_devref_finish

    # ---- 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    hbm = _hbm_bytes_per_s(kind)
    cuda = torch.device("cuda")

    # ---- 2. build
    t0 = time.perf_counter()
    secs = _build.build(["merge_path", "clamp_scan", "derand_translate"])
    sort_lib(), join_lib(), post_lib()
    print(f"build: merge_path, clamp_scan, derand_translate compiled/loaded in "
          f"{time.perf_counter() - t0:.1f}s (nvcc {secs:.1f}s)", flush=True)

    # ---- reference values on a small input, through the entry points
    # (reference: src/index.rs:238-240 MS vector, src/lib.rs:594-610 matches)
    small = api.build([b"AAAGAACCA-TCAGGGCG"], BuildOpts(k=3))
    ms_small = query_ms_values_device(
        small, encode_ascii(b"CAAGCCACTCATTGGGTC"), cuda
    ).tolist()
    if ms_small != [1, 2, 2, 3, 2, 2, 3, 2, 1, 2, 3, 1, 1, 1, 2, 3, 1, 2]:
        raise SystemExit(f"FAIL golden MS vector on the card: {ms_small}")
    aln = api.matches(b"GTGACTATGAGGAT", small, device=cuda)
    if "".join(aln) != "---------MMM--":
        raise SystemExit(f"FAIL matches doctest on the card: {aln}")
    print("reference: golden MS vector and matches doctest equal on the card",
          flush=True)

    # ---- workload and index (host build, as a user would)
    n = int(args.genome)
    t0 = time.perf_counter()
    ref, query = _workload(n)
    index = api.build([query], BuildOpts(k=K))
    threshold = random_match_threshold(K, index.n_kmers, 4, 1e-7)
    print(f"index: {n} bases, k={K}, {index.n_rows} rows, threshold "
          f"{threshold}, built in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = device_index(index, cuda)
    codes = encode_ascii(ref)
    buf_np, L = make_flat_buffer(codes, K)
    buf = torch.from_numpy(buf_np).to(cuda)
    q_list = []
    for i in range(QN):
        s0 = (i * 3901) % (n - QL)
        q_list.append(ref[s0 : s0 + QL])
    bcodes, _ = pad_batch([encode_ascii(q) for q in q_list], bucket=True)
    bbuf = torch.cat(
        [torch.full((QN, K - 1), 255, dtype=torch.uint8),
         torch.from_numpy(bcodes)], dim=1,
    ).reshape(-1).to(cuda)

    # ---- 3. kernels vs plain versions on the card
    def join_operands(b):
        """The merge's operands on the find path for query buffer b."""
        q_words, _ = pack_windows_2bit(b, K)
        meta = torch.arange(b.shape[0], dtype=torch.int32, device=cuda)
        q_packed = to_i32((meta.to(torch.int64) << 8) | 0xFF)
        qs, (qp,) = _radix_sort(q_words, [q_packed])
        a_pay = to_i32(0xFFFFFF00 | u32(dev.cap2))
        return dev.keys2, a_pay, qs, qp

    def join_operands3(b):
        """The merge's operands on the map path (the 3-bit rows join: W=6
        key words, the reference payload carrying the LCS pair per row)."""
        q_words = pack_windows_3bit(b, K)
        meta = torch.arange(b.shape[0], dtype=torch.int32, device=cuda)
        q_packed = to_i32((meta.to(torch.int64) << 8) | 0xFF)
        qs, (qp,) = _radix_sort(q_words, [q_packed])
        return dev.keys3, dev.rows_packed, qs, qp

    def cap_of(pay):
        cb = pay & 0xFF
        return torch.where(cb == 0xFF, -1, cb)

    errs = {"merge_path": 0, "clamp_scan": 0, "derandomize_translate": 0}

    def check(name, what, got, want):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise SystemExit(f"FAIL {name} {what}: differs from plain")
            d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
                if g.numel() else 0
            errs[name] = max(errs[name], d)
        print(f"kernel {name} {what}: bit-equal to plain", flush=True)

    # the streamed side as the map path holds it: one [1, Lm] row of codes
    Lm = _bucket(n)
    mcodes = torch.full((1, Lm), 255, dtype=torch.uint8)
    mcodes[0, :n] = torch.from_numpy(codes)
    mcodes = mcodes.to(cuda)
    mbuf = torch.cat(
        [torch.full((1, K - 1), 255, dtype=torch.uint8, device=cuda), mcodes],
        dim=1,
    ).reshape(-1)

    shapes = {}
    for label, b, bits in (("find-core", buf, 2), ("batch", bbuf, 2),
                           ("map", mbuf, 3)):
        ops = join_operands(b) if bits == 2 else join_operands3(b)
        shapes[label] = (ops, bits)
        mk = merge_path(*ops)
        check("merge_path", f"{label} W={ops[0].shape[0]} na={ops[0].shape[1]} "
              f"nb={ops[2].shape[1]}", mk, merge_path_plain(*ops))
        sw, sp = mk
        for rev in (False, True):
            check("clamp_scan",
                  f"{label} bits={bits} reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cap_of(sp), bits, rev)],
                  [clamp_scan_plain(sw, cap_of(sp), bits, rev)])
        del mk, sw, sp

    # 3-bit words (10 chunks after 2 lead bits) with all-ones pads, sorted
    g = np.random.default_rng(7)
    M3, W3 = 4_000_000, 6
    raw = g.integers(0, 17, (W3, M3)).astype(np.int64) * (0x3FFFFFFF // 16)
    raw[:, g.random(M3) < 0.01] = 0xFFFFFFFF
    w3 = to_i32(torch.from_numpy(raw).to(cuda))
    w3, _ = _radix_sort(w3)
    cap3 = torch.from_numpy(np.where(
        g.random(M3) < 0.4, g.integers(0, W3 * 10 + 1, M3), -1
    ).astype(np.int32)).to(cuda)
    for rev in (False, True):
        check("clamp_scan", f"bits=3 pads reverse={rev} M={M3}",
              [clamp_scan(w3, cap3, 3, rev)],
              [clamp_scan_plain(w3, cap3, 3, rev)])
    del raw, w3, cap3

    # edge shapes: under one tile, not a tile multiple, tiny or empty sides
    def rand_sorted(m, w=4):
        x = torch.from_numpy(
            g.integers(0, 8, (w, m)).astype(np.int64) * 0x24924924
        ).to(cuda)
        keys, _ = _radix_sort(to_i32(x))
        return keys, torch.arange(m, dtype=torch.int32, device=cuda)

    for na, nb in ((100, 37), (1, 5000), (5000, 1), (3, 0), (0, 7),
                   (2048 * 3 + 17, 4096 + 5)):
        a, b = rand_sorted(na), rand_sorted(nb)
        check("merge_path", f"edge na={na} nb={nb}", merge_path(*a, *b),
              merge_path_plain(*a, *b))
    for m in (1, 100, 1024 * 3 + 17):
        for bits in (2, 3):
            for rev in (False, True):
                kw, _ = rand_sorted(m, 3)
                cp = torch.from_numpy(np.where(
                    g.random(m) < 0.4, g.integers(0, 31, m), -1
                ).astype(np.int32)).to(cuda)
                check("clamp_scan", f"edge M={m} bits={bits} reverse={rev}",
                      [clamp_scan(kw, cp, bits, rev)],
                      [clamp_scan_plain(kw, cp, bits, rev)])

    # derandomize_translate: equal to the plain version below each row's
    # true length, 0 at and past it
    def check_dt(what, ms, tl):
        got = derandomize_translate(ms, K, threshold, tl)
        want = derandomize_translate_plain(ms, K, threshold, tl)
        torch.cuda.synchronize()
        g2, w2 = got.reshape(-1, got.shape[-1]), want.reshape(-1, got.shape[-1])
        tl_t = torch.as_tensor(tl, device=cuda).reshape(-1, 1)
        in_len = torch.arange(g2.shape[1], device=cuda)[None, :] < tl_t
        if g2[~in_len.expand_as(g2)].any():
            raise SystemExit(f"FAIL derandomize_translate {what}: non-zero "
                             "byte past a row's true length")
        zero = torch.zeros_like(g2)
        check("derandomize_translate", what, [torch.where(in_len, g2, zero)],
              [torch.where(in_len, w2, zero)])

    ms_batch = compute_ms_values_many_device(
        index, [encode_ascii(q) for q in q_list], cuda
    )
    batch_tl = torch.full((QN,), QL, dtype=torch.int32, device=cuda)
    check_dt(f"real MS batch {QN}x{ms_batch.shape[1]} (strided rows)",
             ms_batch, batch_tl)
    ms_row = mapsweep.ms3_rows_sweep(dev.keys3, dev.rows_packed, mcodes, K)[0]
    map_tl = torch.tensor([n], dtype=torch.int32, device=cuda)
    check_dt(f"real MS row 1x{Lm} true_len={n}", ms_row, map_tl)
    for lip in (True, False):
        Qs, Ls = 64, 1024 * 9 + 301
        if lip:
            steps = g.choice(np.array([1, 1, 1, 0, -5, -40]), (Qs, Ls))
            syn = np.clip(np.cumsum(steps, axis=1) % (K + 9), 0, K)
        else:
            syn = g.integers(-3, K + 3, (Qs, Ls))
        tls = g.integers(0, Ls + 1, Qs)
        tls[:8] = [Ls, 0, 1, 2, 1024, 1025, 2048, Ls - 1]
        check_dt(f"synthetic {'Lipschitz' if lip else 'arbitrary'} rows "
                 f"{Qs}x{Ls}, true_len 0, 1, 2, on a tile edge, L",
                 torch.from_numpy(syn.astype(np.int32)).to(cuda),
                 torch.from_numpy(tls.astype(np.int32)).to(cuda))
    check_dt("edge 1x1", torch.full((1, 1), K, dtype=torch.int32, device=cuda),
             1)
    check_dt("edge 512x300 scalar true_len",
             torch.from_numpy(g.integers(0, K + 1, (512, 300)).astype(np.int32))
             .to(cuda), 300)

    counters = {"merge_path": merge_path, "clamp_scan": clamp_scan,
                "derandomize_translate": derandomize_translate}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    # launches of each entry-point call, read around that call alone
    launches = {}

    def read_counts(path):
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        for name, cnt in got.items():
            if cnt == 0:
                raise SystemExit(f"FAIL {name} was not launched on the "
                                 f"{path} path")
        return got

    # ---- 4. the find slice at full size; launch counts around this phase
    def find_core(b, keys2, cap2):
        ms = ms2_core(keys2, cap2, b, K)
        return ms, derandomize_translate(ms, K, threshold, b.shape[0])

    def serve(device):
        return api.find_batch(q_list, index, FindOpts(), device=device)

    T = buf.shape[0]
    t0 = time.perf_counter()
    reset_counts()
    ms_gpu, chars_gpu = find_core(buf, dev.keys2, dev.cap2)
    launches["find-core"] = read_counts("find-core")
    reset_counts()
    rle_gpu = serve(cuda)
    launches["find_batch"] = read_counts("find_batch")
    print(f"find path on the card: {time.perf_counter() - t0:.2f}s "
          f"(first runs), launches per call {json.dumps(launches)}", flush=True)
    # the kernel at the shape find-core gives it (one flat row, true length
    # = the whole buffer), against its plain version and against the path's
    # own output
    check_dt(f"find-core 1-D row L={T} true_len={T}", ms_gpu, T)
    if not torch.equal(
        chars_gpu, derandomize_translate_plain(ms_gpu, K, threshold, T)
    ):
        raise SystemExit("FAIL find-core chars differ from the plain version "
                         "at full length")

    # the CPU run of find-core takes the first quarter of the sequence (the
    # map phase below holds the card against the CPU at the full length)
    t0 = time.perf_counter()
    cpu_dev = device_index(index, "cpu")
    n4 = n // 4
    buf4, L4 = make_flat_buffer(codes[:n4], K)
    buf4 = torch.from_numpy(buf4)
    ms4_gpu, chars4_gpu = find_core(buf4.to(cuda), dev.keys2, dev.cap2)
    ms_cpu, chars_cpu = find_core(buf4, cpu_dev.keys2, cpu_dev.cap2)
    rle_cpu = serve("cpu")
    print(f"CPU run of the same calls: {time.perf_counter() - t0:.1f}s "
          f"(find-core at {n4} bases)", flush=True)
    s = slice(K - 1, K - 1 + L4)
    if not torch.equal(ms4_gpu[s].cpu(), ms_cpu[s]):
        raise SystemExit("FAIL find-core MS differs from the CPU run")
    if not torch.equal(chars4_gpu[s].cpu(), chars_cpu[s]):
        raise SystemExit("FAIL find-core chars differ from the CPU run")
    # the full-length run agrees with the quarter where both are defined
    # (windows are local: position p reads codes[p-k+1 .. p]); the last
    # derandomized stretch of the quarter depends on its own end
    s_in = slice(K - 1, K - 1 + L4 - 4 * K)
    if not torch.equal(ms_gpu[s_in], ms4_gpu[s_in]):
        raise SystemExit("FAIL find-core MS at full length differs from the "
                         "quarter-length run")
    if rle_gpu != rle_cpu:
        raise SystemExit("FAIL find_batch RLE lists differ from the CPU run")
    ms_v = ms_gpu[K - 1 : K - 1 + L]
    if int(ms_v.min()) < 0 or int(ms_v.max()) > K or len(rle_gpu) != QN:
        raise SystemExit("FAIL outputs out of range")
    if set(chars_gpu[K - 1 : K - 1 + L].unique().tolist()) - set(b"MX-R"):
        raise SystemExit("FAIL find-core chars outside the alphabet")
    n_seg = sum(len(r) for r in rle_gpu)
    print(f"find-core: MS and chars over {L4} bases equal the CPU run; "
          f"find_batch: {QN} RLE lists ({n_seg} segments) equal the CPU run",
          flush=True)
    del ms4_gpu, chars4_gpu, ms_cpu, chars_cpu

    # ---- 5. the map slice at full size; launch counts around this phase
    def mopts(fmt):
        return MapOpts(fill_gaps=False, call_variants=False, format=fmt)

    step = n // 8
    contigs = [ref[i * step : i * step + min(500_000, step)] for i in range(8)]
    t0 = time.perf_counter()
    map_gpu = {}
    for fmt in (True, False):
        reset_counts()
        map_gpu[fmt] = api.map_(ref, index, mopts(fmt), device=cuda)
        launches[f"map_ format={fmt}"] = read_counts(f"map_ format={fmt}")
    reset_counts()
    batch_gpu = api.map_batch(contigs, index, mopts(True), device=cuda)
    launches["map_batch"] = read_counts("map_batch")
    torch.cuda.synchronize()
    print(f"map path on the card: {time.perf_counter() - t0:.2f}s (first "
          f"runs), launches per call {json.dumps(launches)}", flush=True)
    # the chunked sweep against the single-shot one, outside the counts
    chunked = mapsweep.ms3_rows_sweep_chunked(
        dev.keys3, dev.rows_packed, mcodes, K, 1_000_000
    )
    single = mapsweep.ms3_rows_sweep(dev.keys3, dev.rows_packed, mcodes, K)
    uq = single[1]
    if not (torch.equal(chunked[0], single[0]) and torch.equal(chunked[1], uq)
            and torch.equal(chunked[2][uq], single[2][uq])):
        raise SystemExit("FAIL ms3_rows_sweep_chunked (1 Mbase chunks) differs "
                         "from the single-shot sweep")
    print(f"map sweep: {-(-Lm // 1_000_000)} chunks of 1 Mbase equal the "
          f"single-shot sweep over {Lm} positions ({int(uq.sum())} unique)",
          flush=True)
    del chunked

    t0 = time.perf_counter()
    for fmt in (True, False):
        if map_gpu[fmt] != api.map_(ref, index, mopts(fmt), device="cpu"):
            raise SystemExit(f"FAIL map_ format={fmt} differs from the CPU run")
    if batch_gpu != api.map_batch(contigs, index, mopts(True), device="cpu"):
        raise SystemExit("FAIL map_batch differs from the CPU run")
    print(f"CPU run of the same map calls: {time.perf_counter() - t0:.1f}s",
          flush=True)
    out_t, out_f = map_gpu[True], map_gpu[False]
    if len(out_t) != n or len(out_f) != n or set(out_t) - set(b"ACGT-") \
            or set(out_f) - set(b"MX-R"):
        raise SystemExit("FAIL map_ output has the wrong length or alphabet")
    if [len(b) for b in batch_gpu] != [len(c) for c in contigs]:
        raise SystemExit("FAIL map_batch output lengths")
    same = int((np.frombuffer(out_t, np.uint8)
                == np.frombuffer(ref, np.uint8)).sum())
    print(f"map_: {n} bases, format true and false equal the CPU run "
          f"({n - same} bases differ from the reference, "
          f"{out_f.count(b'-')} '-' in the translation); map_batch: 8 contigs "
          f"of {len(contigs[0])} bases equal the CPU run", flush=True)

    # ---- 6. times on the card
    def dev_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            fn()
            s1.record()
            s1.synchronize()
            ts.append(s0.elapsed_time(s1))
        return statistics.median(ts)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    t_find = dev_ms(lambda: find_core(buf, dev.keys2, dev.cap2))
    print(f"{tag} find-core: {t_find:.3f} ms ({n / t_find * 1e3 / 1e6:.2f} "
          f"Mbases/s) over {n} bases", flush=True)
    # find-core by stage: ms2_core = pack + (query sort, merge, scans) +
    # back-sort; then derandomize + translate, as the one kernel the path
    # runs and as the two torch cores it replaced
    q_words, _ = pack_windows_2bit(buf, K)
    meta = torch.arange(T, dtype=torch.int32, device=cuda)
    derand = derandomize_core(ms_gpu, K, threshold, T)
    stages = {
        "ms2_core": lambda: ms2_core(dev.keys2, dev.cap2, buf, K),
        "pack_windows_2bit": lambda: pack_windows_2bit(buf, K),
        "_merge_scan": lambda: _merge_scan(dev.keys2, dev.cap2, q_words, meta, 2),
        "derandomize_translate": lambda: derandomize_translate(
            ms_gpu, K, threshold, T),
        "derandomize_core (plain, not on the path)": lambda: derandomize_core(
            ms_gpu, K, threshold, T),
        "translate_core (plain, not on the path)": lambda: translate_core(
            derand, K, threshold, T),
    }
    for name, fn in stages.items():
        print(f"{tag} find-core stage {name}: {dev_ms(fn):.3f} ms", flush=True)
    del q_words, meta, derand
    t_batch = host_ms(lambda: serve(cuda))
    print(f"{tag} find_batch[{QN}x{QL}]: {t_batch:.3f} ms "
          f"({QN / t_batch * 1e3:.1f} queries/s, "
          f"{QN * QL / t_batch * 1e3 / 1e6:.2f} Mbases/s)", flush=True)

    for fmt in (True, False):
        t_map = host_ms(lambda: api.map_(ref, index, mopts(fmt), device=cuda))
        print(f"{tag} map_ format={fmt}: {t_map:.3f} ms "
              f"({n / t_map * 1e3 / 1e6:.2f} Mbases/s) over {n} bases, host "
              f"clock around the call", flush=True)
    t_mb = host_ms(lambda: api.map_batch(contigs, index, mopts(True), device=cuda))
    print(f"{tag} map_batch[8x{len(contigs[0])}]: {t_mb:.3f} ms "
          f"({8 * len(contigs[0]) / t_mb * 1e3 / 1e6:.2f} Mbases/s)", flush=True)

    # map_ by stage, as api.map_batch runs them for this one contig
    ref_mat = np.zeros((1, Lm), dtype=np.uint8)
    ref_mat[0, :n] = np.frombuffer(ref, dtype=np.uint8)
    seq_lens = np.asarray([n], dtype=np.int32)
    cap_d, cap_g = _pow2_cap(Lm // 1024), _pow2_cap(Lm // 1536)
    w_grid = max(K - threshold + 1, 1)

    def upload():
        packed_up = mapsweep.pack_ascii_host(ref_mat, seq_lens)
        return mapsweep.decode_packed4_encode_device(
            *(torch.from_numpy(a).to(cuda) for a in packed_up), map_tl
        )

    ref_mat_dev, codes_dev = upload()
    if not torch.equal(codes_dev, mcodes):
        raise SystemExit("FAIL packed upload decodes to other codes")

    def sweep():
        return mapsweep.ms3_rows_sweep(dev.keys3, dev.rows_packed, codes_dev, K)

    def post():
        return mapsweep.map_postprocess3_core(
            *single, map_tl, K, threshold, cap_d, cap_g, w_grid
        )

    chars_dev, _packed, pieces = post()
    counts = pieces["counts"].cpu().numpy()
    print(f"map candidates: pieces['counts'] = {counts.tolist()} (drops, gap "
          f"runs per contig; capacities {cap_d}, {cap_g}), anchors found "
          f"{int((pieces['apos'] >= 0).sum())}, clamped gap bases "
          f"{int(pieces['clamped_gap'].sum())}", flush=True)
    if counts[0, 0] == 0 or counts[0, 1] == 0 or counts.max() > cap_d:
        raise SystemExit("FAIL map candidate counts out of range")

    def finish():
        return map_devref_finish(
            chars_dev, map_tl, pieces, [ref], mopts(True), cap_d, cap_g,
            total_gap_slack=cap_g * 2 + 64, ref_mat=ref_mat,
            ref_mat_dev=ref_mat_dev,
        )

    if finish()[0] != out_t:
        raise SystemExit("FAIL staged map run differs from api.map_")
    # device stages by CUDA events; the two stages that begin or end on the
    # host (numpy pack before the upload, paint after the fetch) by the
    # host clock around a synchronise
    for name, fn, clock in (
        ("upload+decode (host pack included, host clock)", upload, host_ms),
        ("ms3_rows_sweep", sweep, dev_ms),
        ("map_postprocess3_core", post, dev_ms),
        ("assemble + fetch + paint (host clock)", finish, host_ms),
    ):
        print(f"{tag} map_ stage {name}: {clock(fn):.3f} ms", flush=True)
    del _packed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    api.map_(ref, index, mopts(True), device=cuda)
    torch.cuda.synchronize()
    print(f"{tag} map_ peak device memory: "
          f"{(torch.cuda.max_memory_allocated() - base_mem) / 2**20:.1f} MiB "
          f"above the {base_mem / 2**20:.1f} MiB the script holds", flush=True)

    # each kernel alone at the find-core and map shapes, beside its plain
    # version, its byte bound and (where there is one) a library call
    rows = {}
    for label, ((ak, ap, bk, bp), bits) in shapes.items():
        W = ak.shape[0]
        na, nb = ak.shape[1], bk.shape[1]
        M = na + nb
        keys = [k.contiguous() for k in _pack_key_words(torch.cat([ak, bk], 1))]

        def lib_sort():
            for key in reversed(keys):
                torch.sort(key, stable=True)

        r = {
            "merge_path": (
                dev_ms(lambda: merge_path(ak, ap, bk, bp)),
                dev_ms(lambda: merge_path_plain(ak, ap, bk, bp)),
                2 * M * (W + 1) * 4 / hbm * 1e3,
                dev_ms(lib_sort),
                f"M={M}, W={W}",
            ),
        }
        del keys
        sw, sp = merge_path(ak, ap, bk, bp)
        cp = cap_of(sp)
        r["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, bits, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, bits, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
            f"M={M}, W={W}, bits={bits}, one direction",
        )
        del sw, sp, cp
        rows[label] = r
    # derandomize_translate: ms read once, one byte written per position,
    # the true lengths read once
    for label, ms_in, tl_in in (("find-core", ms_gpu, T),
                                ("batch", ms_batch, batch_tl),
                                ("map", single[0], map_tl)):
        q_rows = 1 if ms_in.dim() == 1 else ms_in.shape[0]
        width = ms_in.shape[-1]
        rows[label]["derandomize_translate"] = (
            dev_ms(lambda: derandomize_translate(ms_in, K, threshold, tl_in)),
            dev_ms(lambda: derandomize_translate_plain(ms_in, K, threshold, tl_in)),
            (5 * q_rows * width + 4 * q_rows) / hbm * 1e3,
            None,
            f"Q={q_rows}, L={width}",
        )
    for label, r in rows.items():
        for name, (t_k, t_p, t_b, t_l, shape) in r.items():
            lib = f", torch.sort passes {t_l:.3f} ms" if t_l is not None else ""
            print(f"{tag} {name} {label} ({shape}): kernel {t_k:.3f} ms, "
                  f"plain {t_p:.3f} ms, bound {t_b:.3f} ms (bytes){lib}",
                  flush=True)

    # ---- where the device time goes: one profiled run of each workload
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def breakdown(label, fn):
        fn()
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        print(f"{tag} profile {label}: wall {wall:.3f} ms under the profiler, "
              f"kernels {busy:.3f} ms ({100 * busy / wall:.1f}% busy), "
              f"{sum(e.count for e in kern)} device launches", flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:100]}", flush=True)

    breakdown("find-core", lambda: find_core(buf, dev.keys2, dev.cap2))
    breakdown(f"find_batch[{QN}x{QL}]", lambda: serve(cuda))
    breakdown("map_ format=True",
              lambda: api.map_(ref, index, mopts(True), device=cuda))

    src = "kbo_tpu_torch/kernels/csrc/"
    sources = {
        "merge_path": ("merge_path.cu", "kbo_tpu/kernels/pallas_sort.py:353"),
        "clamp_scan": ("clamp_scan.cu", "kbo_tpu/kernels/pallas_join.py:191"),
        "derandomize_translate": ("derand_translate.cu",
                                  "attic/pallas_postprocess.py:258"),
    }
    out = []
    for name, (fname, replaces) in sources.items():
        def entry(label, count):
            t_k, t_p, t_b, t_l, shape = rows[label][name]
            return {"launches": count, "ms": t_k, "plain_ms": t_p,
                    "bound_ms": t_b, "bound_by": "bytes", "library_ms": t_l,
                    "shape": f"{label}: {shape}"}

        # the numbers of the newest path (one map_ call); the find paths'
        # beside them, each with the launches of its own one call
        out.append({
            "name": name, "route": "cuda", "source": src + fname,
            "replaces": replaces, "max_abs_err": errs[name],
            **entry("map", launches["map_ format=True"][name]),
            "other_paths": [entry("find-core", launches["find-core"][name]),
                            entry("batch", launches["find_batch"][name])],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
