#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kbo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--genome BASES]

Phases, each printed as it passes; any failure exits non-zero:

1. probe: a CUDA device must exist (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from kbo_tpu_torch/kernels/csrc into
   kbo_tpu_torch/_build (or loads them from there);
   then the reference's golden MS vector and matches doctest on the card;
3. kernels: merge_path and clamp_scan (bits 2 and 3, both directions, edge
   shapes) against their plain PyTorch versions on the card, bit-exact;
4. the slice at full size on bench.py's workload (a 4.6 Mbase genome from
   default_rng(42) with a SNP per kb and sparse 3-base deletions, k=51):
   find-core (ms2_core -> derandomize_core -> translate_core over the
   streamed sequence) and serving (api.find_batch on a 512 x 4096 batch),
   with the kernels' launch counts read around this phase alone; outputs
   must equal the port's own device="cpu" run of the same calls;
5. times on the card (CUDA events, medians of 7; find-core also by stage),
   each with the card's name and power limit, then one torch.profiler run
   of each workload: device busy share and the kernels that take the time.

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

    from kbo_tpu_torch import BuildOpts, FindOpts, api
    from kbo_tpu_torch.engine import device_index
    from kbo_tpu_torch.index.encode import encode_ascii
    from kbo_tpu_torch.kernels import _build
    from kbo_tpu_torch.kernels.join import _lib as join_lib
    from kbo_tpu_torch.kernels.join import clamp_scan, clamp_scan_plain
    from kbo_tpu_torch.kernels.ms import (
        _merge_scan,
        make_flat_buffer,
        ms2_core,
        pack_windows_2bit,
        query_ms_values_device,
    )
    from kbo_tpu_torch.kernels.postprocess import derandomize_core, translate_core
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
    secs = _build.build(["merge_path", "clamp_scan"])
    sort_lib(), join_lib()
    print(f"build: merge_path, clamp_scan compiled/loaded in "
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
        """The merge's operands on the main path for query buffer b."""
        q_words, _ = pack_windows_2bit(b, K)
        meta = torch.arange(b.shape[0], dtype=torch.int32, device=cuda)
        q_packed = to_i32((meta.to(torch.int64) << 8) | 0xFF)
        qs, (qp,) = _radix_sort(q_words, [q_packed])
        a_pay = to_i32(0xFFFFFF00 | u32(dev.cap2))
        return dev.keys2, a_pay, qs, qp

    def cap_of(pay):
        cb = pay & 0xFF
        return torch.where(cb == 0xFF, -1, cb)

    errs = {"merge_path": 0, "clamp_scan": 0}

    def check(name, what, got, want):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise SystemExit(f"FAIL {name} {what}: differs from plain")
            d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
                if g.numel() else 0
            errs[name] = max(errs[name], d)
        print(f"kernel {name} {what}: bit-equal to plain", flush=True)

    shapes = {}
    for label, b in (("find-core", buf), ("batch", bbuf)):
        ops = join_operands(b)
        shapes[label] = ops
        mk = merge_path(*ops)
        check("merge_path", f"{label} na={ops[0].shape[1]} "
              f"nb={ops[2].shape[1]}", mk, merge_path_plain(*ops))
        sw, sp = mk
        for rev in (False, True):
            check("clamp_scan", f"{label} bits=2 reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cap_of(sp), 2, rev)],
                  [clamp_scan_plain(sw, cap_of(sp), 2, rev)])

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

    # ---- 4. the slice at full size; launch counts around this phase only
    def find_core(b, keys2, cap2):
        ms = ms2_core(keys2, cap2, b, K)
        derand = derandomize_core(ms, K, threshold, L + K - 1)
        return ms, translate_core(derand, K, threshold, L + K - 1)

    def serve(device):
        return api.find_batch(q_list, index, FindOpts(), device=device)

    merge_path.launches = 0
    clamp_scan.launches = 0
    t0 = time.perf_counter()
    ms_gpu, chars_gpu = find_core(buf, dev.keys2, dev.cap2)
    rle_gpu = serve(cuda)
    torch.cuda.synchronize()
    launches = {"merge_path": merge_path.launches,
                "clamp_scan": clamp_scan.launches}
    print(f"main path on the card: {time.perf_counter() - t0:.2f}s "
          f"(first run), launches {json.dumps(launches)}", flush=True)
    for name, cnt in launches.items():
        if cnt == 0:
            raise SystemExit(f"FAIL {name} was not launched on the main path")

    t0 = time.perf_counter()
    cpu_dev = device_index(index, "cpu")
    ms_cpu, chars_cpu = find_core(buf.cpu(), cpu_dev.keys2, cpu_dev.cap2)
    rle_cpu = serve("cpu")
    print(f"CPU run of the same calls: {time.perf_counter() - t0:.1f}s "
          f"(find-core at {n} bases)", flush=True)
    s = slice(K - 1, K - 1 + L)
    if not torch.equal(ms_gpu[s].cpu(), ms_cpu[s]):
        raise SystemExit("FAIL find-core MS differs from the CPU run")
    if not torch.equal(chars_gpu[s].cpu(), chars_cpu[s]):
        raise SystemExit("FAIL find-core chars differ from the CPU run")
    if rle_gpu != rle_cpu:
        raise SystemExit("FAIL find_batch RLE lists differ from the CPU run")
    ms_v = ms_gpu[s]
    if int(ms_v.min()) < 0 or int(ms_v.max()) > K or len(rle_gpu) != QN:
        raise SystemExit("FAIL outputs out of range")
    n_seg = sum(len(r) for r in rle_gpu)
    print(f"find-core: MS and chars over {L} bases equal the CPU run; "
          f"find_batch: {QN} RLE lists ({n_seg} segments) equal the CPU run",
          flush=True)

    # ---- 5. times on the card
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
    # back-sort; then derandomize and translate
    q_words, _ = pack_windows_2bit(buf, K)
    meta = torch.arange(buf.shape[0], dtype=torch.int32, device=cuda)
    derand = derandomize_core(ms_gpu, K, threshold, L + K - 1)
    stages = {
        "ms2_core": lambda: ms2_core(dev.keys2, dev.cap2, buf, K),
        "pack_windows_2bit": lambda: pack_windows_2bit(buf, K),
        "_merge_scan": lambda: _merge_scan(dev.keys2, dev.cap2, q_words, meta, 2),
        "derandomize_core": lambda: derandomize_core(ms_gpu, K, threshold,
                                                     L + K - 1),
        "translate_core": lambda: translate_core(derand, K, threshold, L + K - 1),
    }
    for name, fn in stages.items():
        print(f"{tag} find-core stage {name}: {dev_ms(fn):.3f} ms", flush=True)
    t_batch = host_ms(lambda: serve(cuda))
    print(f"{tag} find_batch[{QN}x{QL}]: {t_batch:.3f} ms "
          f"({QN / t_batch * 1e3:.1f} queries/s, "
          f"{QN * QL / t_batch * 1e3 / 1e6:.2f} Mbases/s)", flush=True)

    rows = {}
    for label, (ak, ap, bk, bp) in shapes.items():
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
            ),
        }
        sw, sp = merge_path(ak, ap, bk, bp)
        cp = cap_of(sp)
        r["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, 2, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, 2, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
        )
        rows[label] = r
        for name, (t_k, t_p, t_b, t_l) in r.items():
            lib = f", torch.sort passes {t_l:.3f} ms" if t_l is not None else ""
            print(f"{tag} {name} {label} (M={M}, W={W}): kernel {t_k:.3f} ms, "
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
              f"kernels {busy:.3f} ms ({100 * busy / wall:.1f}% busy)", flush=True)
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"{tag}   {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:100]}", flush=True)

    breakdown("find-core", lambda: find_core(buf, dev.keys2, dev.cap2))
    breakdown(f"find_batch[{QN}x{QL}]", lambda: serve(cuda))

    src = "kbo_tpu_torch/kernels/csrc/"
    sources = {
        "merge_path": ("merge_path.cu", "kbo_tpu/kernels/pallas_sort.py:353"),
        "clamp_scan": ("clamp_scan.cu", "kbo_tpu/kernels/pallas_join.py:191"),
    }
    out = []
    for name, (fname, replaces) in sources.items():
        t_k, t_p, t_b, t_l = rows["find-core"][name]
        out.append({
            "name": name, "route": "cuda", "source": src + fname,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t_k, "plain_ms": t_p,
            "bound_ms": t_b, "bound_by": "bytes", "library_ms": t_l,
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
