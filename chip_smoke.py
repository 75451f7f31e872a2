#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kbo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--genome BASES]

(``--mesh-worker OUT`` runs one process of phase 6c's two-process run.)

Phases, each printed as it passes; any failure exits non-zero:

1. probe: a CUDA device must exist (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from kbo_tpu_torch/kernels/csrc into
   kbo_tpu_torch/_build (or loads them from there), prints each kernel's
   registers and spills as ptxas reported them (bitonic.cu's up to 17
   operand rows, derand_translate.cu's two forms) and the dynamic shared
   memory per CTA of merge_path.cu and clamp_scan.cu by W; builds the
   native host library (kbo_tpu_torch/native_src, g++) and prints its build
   time; profiles one derandomize_translate call at each shape the paths
   give it (find-core, find_batch, map_): one kernel, at most one memset,
   no host-to-device copy; then the reference's golden MS vector and
   matches doctest on the card;
3. kernels: merge_path, clamp_scan (bits 2 and 3, both directions),
   derandomize_translate, bitonic_merge and bitonic_sort against their plain
   PyTorch versions on the card, bit-exact, at the find and map shapes (the
   variant join's shape captured from one default map_ call) and at edge
   shapes (merge_path and clamp_scan also at their tile corners: a tile
   with an empty A or B part, the last partial tile, one side wholly
   before the other, all-equal keys over six tiles, scans of 1 to 70
   tiles, W = 2 and 3 through the runtime-W kernels, and 20 repeat scans
   at 4.2 M slots; bitonic_merge and bitonic_sort also at M = 2^16..2^18
   with 3, 5, 7 and 9 operand rows: na = 0, nb = 0, na + nb = M, and at
   17 rows, the 2-bit join at k = 254; derandomize_translate also in
   both of its forms over rows of 70 tiles, 8 rows of 500 kbase, rows of
   one tile and of several, unaligned strided rows, with an int true
   length, and in 20 back-to-back calls at 4.7 M positions), each bitonic
   call's passes over device memory and its tile blocks' shared memory;
   bitonic_sort also against the radix sort; the joins with
   merge="bitonic" against merge="path" (ms2_core at find-core length and
   at k = 254 on a slice of the genome, ms3_rows_core at the map shape),
   launch counts read around each;
4. the find slice at full size on bench.py's workload (a 4.6 Mbase genome
   from default_rng(42) with a SNP per kb and sparse 3-base deletions,
   k=51): find-core (ms2_core -> derandomize_translate over the streamed
   sequence) and serving (api.find_batch on a 512 x 4096 batch), with the
   kernels' launch counts read around each of the two calls alone (and the
   kernel held against its plain version on find-core's own full-length
   row); outputs must equal
   the port's own device="cpu" run of the same calls (the CPU run of
   find-core takes the first quarter of the sequence);
5. the map slice at full size on the same pair: api.map_ with the default
   MapOpts() (gap filling and variant calling on the card), format true and
   false, and one 8-contig api.map_batch (the tagged variant join); then the
   same with MapOpts(fill_gaps=False, call_variants=False), and the chunked
   sweep (and its chunk-by-chunk upload) against the single-shot one;
   launch counts read around each
   entry-point call alone; outputs must equal the port's own device="cpu"
   run byte for byte;
5b. the 2-bit map path (k >= 128, and batches past the rows join's slot
   budget): api.map_ with MapOpts() at k=151 over the whole pair (a host
   index built at k=151), format true and false, and an 8-contig
   api.map_batch, with launch counts; the same calls on a 1 Mbase slice
   (index and reference) equal the port's own device="cpu" run; map_ and
   an 8-contig map_batch at k=254 on phase 3's 400 kbase index equal the
   CPU run; the 2-bit flow at k=51 (api._map_classic) equal to phase 5's
   default map_ byte for byte; the sweep alone
   (map_sweep_compact_core) at an over-budget shape, 60 000 contigs of
   256 bases (past 2^24 slots: the join's unpacked branch, no merge), its
   first 12 000 contigs equal to the CPU run and all of them to the
   packed join in sub-batches; then merge_path, clamp_scan and
   derandomize_translate at the shapes these calls gave them (captured:
   the 2-bit sweep's join at W = 10 and 16, the interval merge at 17
   rows, the vs-sequence scans at 16 words, the over-budget scans and
   derandomize_translate's [60 000, 1024] rows) against their plain
   versions, bit for bit;
6. the call slice on the same pair: api.call at k=51 over the whole pair
   (the drop scan, the anchor rounds' interval joins, the vs-sequence
   join), also with add_revcomp, and at k=254 on a 400 kbase slice (27 key
   rows in the interval merge, 26 words in the vs-sequence scans), each
   equal to the port's own device="cpu" run of the whole input, with the
   variants called and the planted SNP and deletion sites recovered; the
   reference's call doctest (the short-reference branch, its three
   variants); api.build_device on the indexed side and phase 4's batch
   through api.find_batch against it, RLE for RLE equal to the CPU run;
   launch counts read around one call of each (a call: 2 merges plus one
   per anchor round, 6 scans); then the kernels at the shapes these calls
   gave them (captured from the calls: merge_path at the interval probe,
   7 and 27 key rows, and at the sequence index's join; clamp_scan at the
   vs-sequence join, 6 and 26 words, and at the sequence index's join;
   derandomize_translate at its batch; the interval probe with
   merge="bitonic" against merge="path", and that bitonic merge) against
   their plain versions, bit for bit;
6b. the native pack against its numpy form at full width; api.build_device(
   full=True) over the indexed side, its tables against the host build's
   (keys3[:, :n_rows], n_rows, n_kmers, C, rows' k-mers, the sentinel
   tail), then find_batch, map_ with MapOpts() and call against it, each
   equal to the same call against the host-built index, with launch
   counts; its membership probe (member_widths) against the host index's
   binary search; the kernels at its sentinel-tailed shapes against their
   plain versions; the interval gap path (fill_gaps over SparseIntervals
   of the card-resident MS row) on a 400 kbase slice against the CPU run
   and map_ with gap filling alone; the command line in-process on the
   pair written as FASTA (call, find, find --device-index, map, build -o
   then find -i), each verb's output equal to the rows formatted from the
   API's results;
6c. the mesh (kbo_tpu_torch.parallel.mesh) on the card: make_mesh(4,
   device="cuda:0"), four shards on the one card, and with two or more
   cards a mesh over all of them: api.find_batch 512x4096 over it
   (max_gap_len 0 and 5), matches_long_sharded over the streamed side,
   api.call at k=51, api.map_batch([genome]) with MapOpts() (the
   sequence-sharded route) format true and false and the 8-contig
   map_batch (the contig-sharded route), each equal to its single-device
   twin above byte for byte, with launch counts and the route (run stats)
   around each call on the four-shard mesh; the 8-contig map_batch at
   k=151 over it once (the classic mesh route) equal to phase 5b's; the
   kernels at the four-shard mesh's shapes (captured: a find_batch shard,
   a stage-1 chunk and a per-shard variant join of the sequence-sharded
   map, a shard of the 8-contig batch) against their plain versions; two
   processes on the one card (this script with --mesh-worker, joined by a
   gloo group): matches_batch_sharded over the 2 x 2 global mesh and the
   per-process map merge, both digests equal to one process's; then, with
   phase 5's index saved once (index.serialize) for both, five full-width
   calls over meshes that span the two processes, each equal in both to
   its one-process twin: map_batch([genome]) (route 1) and
   map_batch_index_sharded over 4 model shards to the default map_, the
   8-contig map_batch (route 2) and map_batch_2d_sharded over a 4 x 2 grid
   to the single-device map_batch, call to the single-device call; the
   routes, each process's launches, dist_bytes and dist time, the left
   extension's rounds and lanes and each process's peak memory;
6d. the single-core engine (kbo_tpu_torch/native.py over native_src's
   kbo_cpu.cpp and kbo_refine.cpp) as the oracle at bench size:
   native.map_e2e over the pair on one CPU core, its byte mismatches
   against phase 5's default map_ counted (any fails the run);
   native.ms_stream against the card's kernels.ms.query_ms_device, MS and
   colex intervals at every position; native derandomize + translate
   against the card's derandomize_translate on the same row; the kernels
   at query_ms_device's shapes (the 3-bit join, the interval merge of about
   14 M slots) against their plain versions;
6e. the model axis: make_mesh(4, axis="model", device="cuda:0"), the key
   table split over four shards on the one card (Sharded3Index: each
   shard's columns and bytes printed), ms3_rows_sweep_index_sharded over
   the streamed side against the single-device ms3_rows_sweep and
   matches_batch_index_sharded over phase 4's 512 x 4096 batch against the
   single-device matches_batch, with launch counts; merge_path and both
   clamp_scan directions at a rows shard (W = 6, bits = 3) and a matches
   shard (W = 4, bits = 2), and derandomize_translate at the matches'
   batch, against their plain versions; then the map over the sharded
   table: map_batch_index_sharded over the four model shards with
   MapOpts() against phase 5's default map_ byte for byte, and
   map_batch_2d_sharded over make_mesh((2, 4), axis=("data", "model"),
   device="cuda:0") on the 8 contigs against the single-device map_batch
   (when it returns None, a gap needing the host evaluator, the count is
   printed and the fill_gaps=False run is compared instead; None with no
   such gap fails), the 2 x 4 mesh holding four key shards, not eight,
   and map_batch_2d_sharded over make_mesh((4, 2), ...) with MapOpts(),
   two contigs a data row, its own refinement filling every gap, against
   the same map_batch (None fails); launches, the left extension's rounds and lanes and the gaps sent to
   the host; merge_path, both clamp_scan directions and
   derandomize_translate at these calls' shapes (the index-sharded
   variant join, a 2-D stage-1 shard, the 2-D variant join, a data row's
   block, over 2 x 4 and over 4 x 2, the two-process run's grid) against
   their plain versions;
7. times on the card (CUDA events or the host clock, medians of 7, of 3
   for gap filling's host numpy at full width; by
   stage, the refinement's stages and the per-index extension table
   included; call by the host clock around it and by phase from the run's
   stats, its device stages alone, find_batch against build_device's index
   beside the full index; merge_path, clamp_scan and derandomize_translate
   also per call in runs of 10 back-to-back calls; derandomize_translate's
   two forms by device time at 1 to 32 tiles a row; the native pack beside
   the numpy one; the device-built full index's build and its calls beside
   their host-index twins; gap filling at full width from intervals beside
   the device grid's, patch for patch; each CLI verb; the 2-bit map path
   at k=151 by the host clock, by its host steps from the run's stats and
   by device stage, the k=254 and 8-contig maps, the k=51 2-bit flow
   beside the default route, the over-budget sweep; each mesh call
   beside its single-device twin, the k=151 one once; the two-process
   run's calls (each process's median of 3) beside one process over the
   same shards, their launches summed over the processes; native ms_stream
   beside query_ms_device and map_e2e beside map_; the model axis's two
   calls beside their single-device twins; the sharded maps (the 2-D one
   over 2 x 4 and 4 x 2) beside theirs and the index-sharded map's stages: the placement, the rows
   join, sharded gap scoring beside the chain table's, the search loop
   over four shards and over one table, sharded variant resolution),
   each with the card's
   name and power limit, then one torch.profiler run of each workload (and
   of one bitonic merge and one bitonic sort, by pass kind): device busy
   share and the kernels that take the time.

Prints the per-kernel JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The script keeps about 33 GiB of indices and captured operands on the card
to its end, between transient allocations of up to 10 GiB, so it runs
PyTorch's allocator with expandable segments (PYTORCH_CUDA_ALLOC_CONF, for
this process and its children) unless the environment sets the allocator:
with fixed segments the profiled k = 151 map near the end has found no
free 9.44 GiB block on an H100 (80 GB) with 33.3 GiB held and 10.3 GiB
reserved but split.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 51
QN, QL = 512, 4096
_U32 = 0xFFFFFFFF
REPS = 7


def _hbm_bytes_per_s(name: str) -> float:
    """Published memory rate of the named H100 variant (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM, 80 GB HBM3


def _ptxas_summary(report: str):
    """(kernel, registers, stack bytes, spill store bytes, spill load
    bytes) of each entry function in a ``ptxas -v`` report."""
    out = []
    for block in report.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        name = mangled
        for kname in ("regs_pass", "tile_pass", "merge_kernel",
                      "partition_kernel", "scan_kernel", "lookback_kernel",
                      "short_rows_kernel"):
            if kname in mangled:
                args = re.match(r"I((?:Li-?\d+E)+)E",
                                mangled.split(kname, 1)[1])
                name = kname
                if args:
                    name += "<" + ", ".join(
                        re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
        regs = re.search(r"Used (\d+) registers", block)
        mem = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", block)
        out.append((name, int(regs.group(1)) if regs else None,
                    *(int(x) for x in (mem.groups() if mem else (-1,) * 3))))
    return out


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


def _contigs_of(seq):
    """Eight contigs of up to 500 kbase from along the sequence."""
    step = len(seq) // 8
    return [seq[i * step : i * step + min(500_000, step)] for i in range(8)]


def _out_digest(out) -> str:
    """sha256 of a map's output bytes, or of call's variants (position,
    query and reference chars); "None" for None."""
    import hashlib

    if out is None:
        return "None"
    if out and not isinstance(out[0], bytes):
        out = [repr((v.query_pos, v.query_chars, v.ref_chars)).encode()
               for v in out]
    return hashlib.sha256(b"\0".join(out)).hexdigest()


# the two-process run's full-width calls: name -> (what it equals, the
# one-process twin's launches key in phase 6c / 6e)
TWO_PROC_CALLS = {
    "map_batch([genome])": ("the default map_", "map_batch mesh format=True"),
    "map_batch 8 contigs": ("the single-device 8-contig map_batch",
                            "map_batch mesh 8 contigs"),
    "call": ("the single-device call", "call mesh"),
    "map_batch_index_sharded": ("the default map_",
                                "map_batch_index_sharded"),
    "map_batch_2d_sharded 4 x 2": ("the single-device 8-contig map_batch",
                                   "map_batch_2d_sharded 4 x 2"),
}


def _two_process_calls(index_path: str, n: int) -> dict:
    """One process's part of the two-process run at full width: phase 5's
    indexed side loaded from ``index_path`` (index.serialize), bench.py's
    pair at k = 51 with MapOpts(), each process a 2-shard data mesh, a
    2-shard model mesh and a 2 x 2 grid on cuda:0 (4 shards, and a 4 x 2
    grid, over both processes). Per call: the output's digest, the route
    and counters of the run's stats (dist_bytes, dist_s, ...), the kernel
    launches and the peak memory of one run, then the median of 3 on the
    host clock."""
    import torch

    from kbo_tpu_torch import BuildOpts, CallOpts, MapOpts, api
    from kbo_tpu_torch.index import serialize
    from kbo_tpu_torch.kernels.join import clamp_scan
    from kbo_tpu_torch.kernels.postprocess import derandomize_translate
    from kbo_tpu_torch.kernels.sort import merge_path
    from kbo_tpu_torch.parallel import mesh as pmesh
    from kbo_tpu_torch.utils.stats import get_stats, reset_stats

    t0 = time.perf_counter()
    index = serialize.load_index(index_path)
    ref, _ = _workload(n)
    contigs = _contigs_of(ref)
    load_s = time.perf_counter() - t0
    bo = BuildOpts(k=K, build_select=True)
    mo = MapOpts(sbwt_build_opts=bo)
    data = pmesh.make_mesh(2, device="cuda:0")
    model = pmesh.make_mesh(2, axis="model", device="cuda:0")
    grid = pmesh.make_mesh((2, 2), axis=("data", "model"), device="cuda:0")
    fns = {
        "map_batch([genome])": lambda: api.map_batch([ref], index, mo,
                                                     mesh=data),
        "map_batch 8 contigs": lambda: api.map_batch(contigs, index, mo,
                                                     mesh=data),
        "call": lambda: api.call(index, ref, CallOpts(sbwt_build_opts=bo),
                                 mesh=data),
        "map_batch_index_sharded": lambda: pmesh.map_batch_index_sharded(
            [ref], index, mo, model),
        "map_batch_2d_sharded 4 x 2": lambda: pmesh.map_batch_2d_sharded(
            contigs, index, mo, grid),
    }
    kernels = {"merge_path": merge_path, "clamp_scan": clamp_scan,
               "derandomize_translate": derandomize_translate}
    keep = ("mesh_", "dist_", "left_ext_", "gaps_", "call_anchor_rounds",
            "variants_called")
    out = {"load_s": load_s, "calls": {}}
    for name, fn in fns.items():
        for f in kernels.values():
            f.launches = 0
        reset_stats()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        stats = get_stats().as_dict()
        row = {"digest": _out_digest(got),
               "launches": {k: f.launches for k, f in kernels.items()},
               "stats": {k: v for k, v in stats.items() if k.startswith(keep)},
               "peak_bytes": torch.cuda.max_memory_allocated()}
        del got
        ts = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        row["ms"] = statistics.median(ts)
        out["calls"][name] = row
    return out


def _mesh_digests(mesh, rank):
    """The two-process run's digests over ``mesh``: sha256 of
    matches_batch_sharded's chars for 63 queries of 1500 bases against a
    200 kbase index (k = 31), and of the per-process map merge: each
    process's half of four 20 kbase contigs through map_batch with
    MapOpts() on cuda:0, the halves' digests gathered in process order
    (``rank`` None: one process computes both halves)."""
    import hashlib

    from kbo_tpu_torch import BuildOpts, MapOpts, api
    from kbo_tpu_torch.index.encode import encode_ascii
    from kbo_tpu_torch.ops.derandomize import random_match_threshold
    from kbo_tpu_torch.parallel import distributed, mesh as pmesh

    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, 200_000)].tobytes()
    bo = BuildOpts(k=31, build_select=True)
    index = api.build([genome], bo)
    thr = random_match_threshold(31, index.n_kmers, 4, 1e-7)
    queries = []
    for i in range(63):
        q = bytearray(genome[i * 3001 : i * 3001 + 1500])
        q[700] = bases[(bases.tolist().index(q[700]) + 1) % 4]
        queries.append(encode_ascii(bytes(q)))
    chars = pmesh.matches_batch_sharded(index, queries, thr, mesh=mesh)
    refs = []
    for i in range(4):
        r = bytearray(genome[i * 45_000 : i * 45_000 + 20_000])
        for p in range(300, 20_000, 1700):
            r[p] = bases[(bases.tolist().index(r[p]) + 1) % 4]
        refs.append(bytes(r))

    def half(r):
        out = api.map_batch(refs[r::2], index, MapOpts(sbwt_build_opts=bo),
                            device="cuda:0")
        return np.frombuffer(hashlib.sha256(b"".join(out)).digest(), np.uint8)

    if rank is None:
        merged = np.stack([half(0), half(1)])
    else:
        merged = distributed.process_allgather(half(rank))
    return [hashlib.sha256(b"".join(c.tobytes() for c in chars)).hexdigest(),
            hashlib.sha256(merged.tobytes()).hexdigest()]


def _mesh_worker(out_path: str, index_path: str, n: int) -> int:
    """One process of chip_smoke's two-process mesh run (torchrun's
    environment names the group): a 2-shard mesh on cuda:0 here, 4 shards
    over both processes; the two digests, then the full-width calls
    (:func:`_two_process_calls`), written to ``out_path`` as JSON."""
    import torch.distributed as dist

    from kbo_tpu_torch.parallel import distributed, mesh as pmesh

    if not distributed.initialize_from_env():
        return 1
    mesh = pmesh.make_mesh(2, device="cuda:0")
    if mesh.devices.size != 4:
        return 1
    out = {"digests": _mesh_digests(mesh, distributed.process_index())}
    out.update(_two_process_calls(index_path, n))
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=float, default=4.6e6)
    ap.add_argument("--mesh-worker", metavar="OUT",
                    help="run one process of the two-process mesh run")
    ap.add_argument("--mesh-index", metavar="PATH",
                    help="the two-process run's saved index")
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if args.mesh_worker:
        return _mesh_worker(args.mesh_worker, args.mesh_index,
                            int(args.genome))

    import torch

    from kbo_tpu_torch import BuildOpts, CallOpts, FindOpts, MapOpts, api
    from kbo_tpu_torch import cli as cli_mod
    from kbo_tpu_torch import engine as engine_mod
    from kbo_tpu_torch import native
    from kbo_tpu_torch import pipeline as pipeline_mod
    from kbo_tpu_torch.engine import compute_ms_values_many_device, device_index
    from kbo_tpu_torch.index import serialize
    from kbo_tpu_torch.index.encode import encode_ascii, revcomp_ascii
    from kbo_tpu_torch.kernels import _build
    from kbo_tpu_torch.kernels.join import _lib as join_lib
    from kbo_tpu_torch.kernels.join import clamp_scan, clamp_scan_plain
    from kbo_tpu_torch.kernels import mapsweep
    from kbo_tpu_torch.kernels import ms as ms_mod
    from kbo_tpu_torch.kernels.ms import (
        _bucket,
        _merge_scan,
        make_flat_buffer,
        ms2_core,
        ms3_rows_core,
        pack_windows_2bit,
        pack_windows_3bit,
        query_ms_values_device,
    )
    from kbo_tpu_torch.kernels import postprocess as post_mod
    from kbo_tpu_torch.kernels.postprocess import (
        _lib as post_lib,
        derandomize_core,
        derandomize_translate,
        derandomize_translate_plain,
        translate_core,
    )
    from kbo_tpu_torch.kernels import refine as refine_mod
    from kbo_tpu_torch.kernels.refine import (
        build_ext_table_core,
        ext_walk,
        ext_walk_plain,
        get_ext_table,
        prob_bound,
        resolve_variants_core,
        score_gaps_core,
    )
    from kbo_tpu_torch.kernels.sort import (
        RegsPass,
        _bitonic_len,
        _bitonic_lib,
        _bitonic_passes,
        _lib as sort_lib,
        _pack_key_words,
        _radix_sort,
        bitonic_merge,
        bitonic_merge_plain,
        bitonic_sort,
        bitonic_sort_plain,
        merge_path,
        merge_path_plain,
        to_i32,
        u32,
    )
    from kbo_tpu_torch.ops.derandomize import random_match_threshold
    from kbo_tpu_torch.parallel import mesh as pmesh
    from kbo_tpu_torch.pipeline import pad_batch
    from kbo_tpu_torch.refine import gap_filling
    from kbo_tpu_torch.refine.device_map import _pow2_cap, map_devref_finish
    from kbo_tpu_torch.utils.stats import get_stats, reset_stats

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
    secs = _build.build(["merge_path", "clamp_scan", "derand_translate",
                         "bitonic"])
    sort_lib(), join_lib(), post_lib(), _bitonic_lib()
    print(f"build: merge_path, clamp_scan, derand_translate, bitonic "
          f"compiled/loaded in {time.perf_counter() - t0:.1f}s (nvcc "
          f"{secs:.1f}s)", flush=True)
    t0 = time.perf_counter()
    secs = native.build()
    native.lib()
    print(f"build: the native host library (native_src/pack.cpp, fastx.cpp, "
          f"kbo_cpu.cpp, kbo_refine.cpp) compiled/loaded in {time.perf_counter() - t0:.1f}s (g++ "
          f"{secs:.1f}s)", flush=True)
    for src in ("merge_path", "clamp_scan", "bitonic", "derand_translate"):
        for name, regs, stack, st, ld in _ptxas_summary(
                _build.resource_report(src)):
            print(f"ptxas {src}.cu {name}: {regs} registers, {stack} B stack "
                  f"frame, {st} B spill stores, {ld} B spill loads",
                  flush=True)
    # W = 0 in a template argument is the runtime-W instantiation
    for src, lib, fn, ws in (
            ("merge_path", sort_lib(), "kbo_merge_path_smem",
             (2, 3, 4, 6, 7, 26, 27)),
            ("clamp_scan", join_lib(), "kbo_clamp_scan_smem",
             (2, 3, 4, 6, 7, 26))):
        smem = {w: getattr(lib, fn)(w) for w in ws}
        print(f"{src}.cu dynamic shared memory per CTA by W: "
              f"{json.dumps(smem)} B", flush=True)

    # one derandomize_translate call at each shape the paths give it
    # (find-core: a flat row, its true length an int; find_batch: 512
    # strided rows; map_: one strided row, its true length a tensor) is
    # one kernel, at most one memset (the look-back form's status words)
    # and no host-to-device copy. The launch structure depends on the
    # shapes, strides and argument kinds, not on the values, so zero rows
    # of those shapes serve; it runs here, early, because torch.profiler
    # was seen to lose device records in a process that has run for a
    # minute or more (PERF.md section 7)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_events(fn, n=1):
        """The device events of n calls of fn under torch.profiler."""
        fn()
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]

    n_len, L_map = int(args.genome), _bucket(int(args.genome))
    thr_any = random_match_threshold(K, n_len, 4, 1e-7)
    for label, ms_in, tl_in in (
        ("find-core", torch.zeros(K - 1 + L_map, dtype=torch.int32,
                                  device=cuda), K - 1 + L_map),
        ("batch", torch.zeros((QN, QL + K - 1), dtype=torch.int32,
                              device=cuda)[:, K - 1:],
         torch.full((QN,), QL, dtype=torch.int32, device=cuda)),
        ("map", torch.zeros((1, L_map + K - 1), dtype=torch.int32,
                            device=cuda)[:, K - 1:],
         torch.tensor([n_len], dtype=torch.int32, device=cuda)),
    ):
        dev_ev = device_events(
            lambda: derandomize_translate(ms_in, K, thr_any, tl_in))
        ev = {e.key: e.count for e in dev_ev}
        n_memset = sum(c for key, c in ev.items() if key.startswith("Memset"))
        n_h2d = sum(c for key, c in ev.items() if "HtoD" in key)
        n_kern = sum(c for key, c in ev.items()
                     if not key.startswith(("Memset", "Memcpy")))
        dev_us = {e.key[:40]: round(e.self_device_time_total / e.count, 3)
                  for e in dev_ev}
        print(f"{tag} profile derandomize_translate {label} "
              f"{tuple(ms_in.shape)}: {n_kern} kernel, {n_memset} memset, "
              f"{n_h2d} host-to-device copies per call; device us per event "
              f"{json.dumps(dev_us)}", flush=True)
        if n_kern != 1 or n_memset > 1 or n_h2d:
            raise SystemExit(f"FAIL derandomize_translate {label}: not one "
                             "launch a call")
    del ms_in, tl_in

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

    def dopts(fmt):
        """bench.py's map options: MapOpts() with the index's BuildOpts."""
        return MapOpts(format=fmt, sbwt_build_opts=BuildOpts(
            k=K, build_select=True))

    contigs_of = _contigs_of

    # ---- workload and index (host build, as a user would)
    n = int(args.genome)
    t0 = time.perf_counter()
    ref, query = _workload(n)
    index = api.build([query], BuildOpts(k=K, build_select=True))
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

    errs = {"merge_path": 0, "clamp_scan": 0, "derandomize_translate": 0,
            "bitonic_merge": 0, "bitonic_sort": 0, "ext_walk": 0}

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

    # the variant join's operands (the sweep's sorted query table against
    # the reference k-mers' probe windows), captured from one default map_
    # call; the call also builds the index's extension table
    captured = []
    real_merge = ms_mod.merge_path

    def recording(*a):
        captured.append(a)
        return real_merge(*a)

    ms_mod.merge_path = recording
    try:
        api.map_(ref, index, dopts(True), device=cuda)
    finally:
        ms_mod.merge_path = real_merge
    if len(captured) != 2:
        raise SystemExit(f"FAIL default map_ ran {len(captured)} merges, not 2")

    shapes = {}
    for label, b, bits in (("find-core", buf, 2), ("batch", bbuf, 2),
                           ("map", mbuf, 3), ("rk-vs-seq", None, 3)):
        if label == "rk-vs-seq":
            ops = captured[1]
        else:
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
        return keys.contiguous(), torch.arange(m, dtype=torch.int32,
                                               device=cuda)

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

    # the tiled merge's and the look-back scan's corners (as in
    # tests/test_torch_merge_tiles.py and tests/test_torch_cuda.py): tiles
    # whose A or B part is empty, the last partial tile, one side wholly
    # before the other, all-equal keys across six tiles; scans of one tile,
    # a tile and a slot, many tiles; W = 2 and 3 take the runtime-W kernels
    TILE = 2048

    def sorted_rows(m, w, top, pads=0.02):
        x = torch.from_numpy(
            g.integers(0, 9, (w, m)).astype(np.int64) * (top // 8)).to(cuda)
        x[:, torch.from_numpy(g.random(m) < pads).to(cuda)] = _U32
        return _radix_sort(to_i32(x))[0]

    def merge_corner(w, case):
        T = TILE
        if case == "ragged":
            return sorted_rows(2 * T + 333, w, _U32), sorted_rows(T + 71, w, _U32)
        if case == "a_empty":
            return sorted_rows(0, w, _U32), sorted_rows(2 * T + 5, w, _U32)
        if case == "b_empty":
            return sorted_rows(3 * T - 1, w, _U32), sorted_rows(0, w, _U32)
        if case in ("a_before_b", "b_before_a"):
            lo = sorted_rows(T + 100, w, 0x7FFFFFFF, 0)
            hi = sorted_rows(2 * T - 3, w, 0x7FFFFFFF, 0) | (-2**31)
            return (lo, hi) if case == "a_before_b" else (hi, lo)
        return (torch.zeros((w, 3 * T + 17), dtype=torch.int32, device=cuda),
                torch.zeros((w, 3 * T - 250), dtype=torch.int32, device=cuda))

    for w in (2, 4, 6, 7):
        for case in ("ragged", "a_empty", "b_empty", "a_before_b",
                     "b_before_a", "all_equal"):
            a, b = merge_corner(w, case)
            na, nb = a.shape[1], b.shape[1]
            ap = torch.arange(na, dtype=torch.int32, device=cuda)
            bp = torch.arange(na, na + nb, dtype=torch.int32,
                              device=cuda) | 2**30
            check("merge_path", f"tile corner W={w} {case} na={na} nb={nb}",
                  merge_path(a, ap, b, bp), merge_path_plain(a, ap, b, bp))

    def scan_operands(m, w, bits):
        words = sorted_rows(m, w, _U32 if bits == 2 else 0x3FFFFFFF)
        per = 16 if bits == 2 else 10
        cp = torch.from_numpy(np.where(
            g.random(m) < 0.4, g.integers(0, w * per + 1, m), -1
        ).astype(np.int32)).to(cuda)
        return words, cp

    for m in (1, TILE - 1, TILE, TILE + 1, 9 * TILE + 77, 70 * TILE + 5):
        for bits, w in ((2, 4), (3, 6), (3, 3)):
            kw, cp = scan_operands(m, w, bits)
            for rev in (False, True):
                check("clamp_scan", f"tile corner M={m} W={w} bits={bits} "
                      f"reverse={rev}", [clamp_scan(kw, cp, bits, rev)],
                      [clamp_scan_plain(kw, cp, bits, rev)])
    # a look-back race would show only in some runs: 20 runs, each equal
    kw, cp = scan_operands((1 << 22) + 1001, 6, 3)
    want = [clamp_scan_plain(kw, cp, 3, rev) for rev in (False, True)]
    for run in range(20):
        rev = run % 2 == 1
        if not torch.equal(clamp_scan(kw, cp, 3, rev), want[rev]):
            raise SystemExit(f"FAIL clamp_scan repeat run {run} of 20 "
                             f"(M={kw.shape[1]}) differs from plain")
    print(f"kernel clamp_scan: 20 repeat runs at M={kw.shape[1]}, W=6, "
          f"bits=3, both directions, each bit-equal to plain", flush=True)
    del kw, cp, want

    # bitonic_merge at the find-core and variant-join shapes, payloads and
    # pads included; bitonic_sort at the find-core query-side sort shape,
    # also against the (stable) radix sort: keys equal, payloads equal as
    # multisets within each equal-key group
    def ops_of(keys, pay):
        return torch.cat([keys, pay[None]])

    def passes_of(M, n_ops, sort):
        """The passes over device memory (one launch each) of one call and
        the most dynamic shared memory one of its tile blocks asks for."""
        ps = _bitonic_passes(M, n_ops, sort)
        regs = sum(isinstance(p, RegsPass) for p in ps)
        smem = max(4 * n_ops << p.log_tile for p in ps
                   if not isinstance(p, RegsPass))
        return (f"{len(ps)} passes ({regs} register, {len(ps) - regs} tile, "
                f"tile blocks of up to {smem} B shared memory)")

    bitonic_in = {}
    for label in ("find-core", "map", "rk-vs-seq"):
        (ak, ap, bk, bp), _ = shapes[label]
        bitonic_in[label] = (ops_of(ak, ap), ops_of(bk, bp), ak.shape[0])
        got = bitonic_merge(*bitonic_in[label])
        check("bitonic_merge", f"{label} W={ak.shape[0]} M={got.shape[1]}",
              [got], [bitonic_merge_plain(*bitonic_in[label])])
        print(f"bitonic_merge {label} M={got.shape[1]}, {got.shape[0]} rows: "
              f"{passes_of(got.shape[1], got.shape[0], False)}", flush=True)
        del got
    q_words, _ = pack_windows_2bit(buf, K)
    meta = torch.arange(buf.shape[0], dtype=torch.int32, device=cuda)
    sort_in = ops_of(q_words, to_i32((meta.to(torch.int64) << 8) | 0xFF))
    del q_words, meta
    got = bitonic_sort(sort_in, 4)
    check("bitonic_sort", f"find-core query side n={sort_in.shape[1]} W=4",
          [got], [bitonic_sort_plain(sort_in, 4)])
    sort_M = _bitonic_len(sort_in.shape[1])
    print(f"bitonic_sort query side M={sort_M}, {sort_in.shape[0]} rows: "
          f"{passes_of(sort_M, sort_in.shape[0], True)}", flush=True)
    keys, (pay,) = _radix_sort(sort_in[:4], [sort_in[4]])
    if not (torch.equal(got[:4], keys) and torch.equal(
            _radix_sort(got)[0], _radix_sort(ops_of(keys, pay))[0])):
        raise SystemExit("FAIL bitonic_sort differs from the radix sort")
    print("kernel bitonic_sort: keys equal the radix sort's, payloads as "
          "multisets per key group", flush=True)
    del got, keys, pay
    for na, nb in ((0, 7), (1, 5000), (2048 * 3 + 17, 4096 + 5)):
        a, b = rand_sorted(na, 8), rand_sorted(nb, 8)
        check("bitonic_merge", f"edge na={na} nb={nb} W=8",
              [bitonic_merge(ops_of(*a), ops_of(*b), 8)],
              [bitonic_merge_plain(ops_of(*a), ops_of(*b), 8)])
    # each pass type's corners: at M = 2^16..2^18 the stages above the
    # largest tile leave every remainder of a register pass's stages;
    # merges with na = 0, nb = 0 and na + nb = M exactly, and a sort
    for lm in (16, 17, 18):
        M = 1 << lm
        for n_ops in (3, 5, 7, 9):
            W = n_ops - 1
            for na, nb in ((0, M // 2 + 1), (M // 2 + 3, 0), (M // 2, M // 2)):
                a, b = ops_of(*rand_sorted(na, W)), ops_of(*rand_sorted(nb, W))
                check("bitonic_merge", f"corner M={M} rows={n_ops} na={na} "
                      f"nb={nb} ({passes_of(M, n_ops, False)})",
                      [bitonic_merge(a, b, W)], [bitonic_merge_plain(a, b, W)])
            perm = torch.from_numpy(g.permutation(M - 5)).to(cuda)
            s_in = ops_of(*rand_sorted(M - 5, W))[:, perm]
            check("bitonic_sort", f"corner n={M - 5} rows={n_ops} "
                  f"({passes_of(M, n_ops, True)})",
                  [bitonic_sort(s_in, W)], [bitonic_sort_plain(s_in, W)])
    # 17 operand rows, the most a caller passes: the 2-bit join at k = 254
    # (16 key words and the payload), alone and through ms2_core against
    # merge="path" on a slice of the genome
    a, b = ops_of(*rand_sorted(300_000, 16)), ops_of(*rand_sorted(200_001, 16))
    check("bitonic_merge", f"17 rows na=300000 nb=200001 "
          f"({passes_of(1 << 19, 17, False)})",
          [bitonic_merge(a, b, 16)], [bitonic_merge_plain(a, b, 16)])
    del a, b
    K254, n254 = 254, min(n, 400_000)
    idx254 = api.build([query[:n254]], BuildOpts(k=K254, build_select=True))
    dev254 = device_index(idx254, cuda)
    buf254, _ = make_flat_buffer(encode_ascii(ref[:n254]), K254)
    buf254 = torch.from_numpy(buf254).to(cuda)
    before = bitonic_merge.launches
    ms254 = ms2_core(dev254.keys2, dev254.cap2, buf254, K254, merge="bitonic")
    torch.cuda.synchronize()
    if bitonic_merge.launches != before + 1 or not torch.equal(
            ms254, ms2_core(dev254.keys2, dev254.cap2, buf254, K254)):
        raise SystemExit("FAIL ms2_core k=254 merge=bitonic differs from "
                         "merge=path")
    M254 = _bitonic_len(dev254.keys2.shape[1] + buf254.shape[0])
    print(f"merge=bitonic at k=254: ms2_core over {buf254.shape[0]} slots "
          f"({dev254.keys2.shape[0] + 1} operand rows, "
          f"{passes_of(M254, dev254.keys2.shape[0] + 1, False)}) equals "
          f"merge=path (max MS {int(ms254.max())})", flush=True)
    del dev254, buf254, ms254

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
        return got

    ms_batch = compute_ms_values_many_device(
        index, [encode_ascii(q) for q in q_list], cuda
    )
    batch_tl = torch.full((QN,), QL, dtype=torch.int32, device=cuda)
    check_dt(f"real MS batch {QN}x{ms_batch.shape[1]} (strided rows)",
             ms_batch, batch_tl)
    ms_row = mapsweep.ms3_rows_sweep(dev.keys3, dev.rows_packed, mcodes, K)[0]
    map_tl = torch.tensor([n], dtype=torch.int32, device=cuda)
    map_chars = check_dt(f"real MS row 1x{Lm} true_len={n}", ms_row, map_tl)
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
    # the one-launch kernel's corners (as in tests/test_torch_derand_tiles.py
    # and tests/test_torch_cuda.py), each in both forms (forced in turn):
    # 70 tiles a row (look-backs over several windows of 32), Q > 1 long
    # rows, rows of one tile and of several; true lengths 0, 1, 2, on a
    # tile edge, mid-tile, L - 1 and L; the same rows as unaligned strided
    # views (find_batch's layout)
    DT_TILE = post_lib().kbo_derand_translate_tile()
    own_choice = post_mod._short_rows

    def lipschitz_rows(qs, ls):
        steps = g.choice(np.array([1, 1, 1, 0, -5, -40]), (qs, ls))
        return torch.from_numpy(np.clip(np.cumsum(steps, axis=1) % (K + 9),
                                        0, K).astype(np.int32)).to(cuda)

    def forced(short):
        """Run derandomize_translate in one form (None: its own choice)."""
        post_mod._short_rows = own_choice if short is None else \
            (lambda *a: short)

    try:
        for qs, ls in ((1, 70 * DT_TILE + 5), (3, 70 * DT_TILE + 5),
                       (8, 500_000), (64, DT_TILE), (512, 3 * DT_TILE + 77)):
            syn = lipschitz_rows(qs, ls)
            tls = g.integers(0, ls + 1, qs)
            tls[: min(qs, 8)] = np.minimum(
                [ls, 0, 1, 2, DT_TILE, 2 * DT_TILE, DT_TILE + 777, ls - 1],
                ls)[: min(qs, 8)]
            tls = torch.from_numpy(tls.astype(np.int32)).to(cuda)
            wide = torch.zeros((qs, ls + K - 1), dtype=torch.int32,
                               device=cuda)
            wide[:, K - 1:] = syn
            for short, form in ((True, "short-row"), (False, "look-back")):
                forced(short)
                check_dt(f"corner {qs}x{ls} ({form} form)", syn, tls)
                check_dt(f"corner {qs}x{ls} ({form} form), rows at offset "
                         f"{K - 1} of a {ls + K - 1} stride", wide[:, K - 1:],
                         tls)
    finally:
        forced(None)
    del syn, wide
    # a look-back race would show only in some runs: 20 back-to-back calls
    # on the map's real MS row, the true length as a tensor and as an int
    before = derandomize_translate.launches
    reps = [derandomize_translate(ms_row, K, threshold,
                                  map_tl if run % 2 == 0 else n)
            for run in range(20)]
    torch.cuda.synchronize()
    if derandomize_translate.launches != before + 20:
        raise SystemExit("FAIL derandomize_translate: not one launch a call")
    for run, got in enumerate(reps):
        if not torch.equal(got, map_chars):
            raise SystemExit(f"FAIL derandomize_translate repeat run {run} "
                             f"of 20 (L={Lm}) differs")
    print(f"kernel derandomize_translate: 20 repeat calls at L={Lm}, "
          f"true_len {n} as a tensor and as an int, each bit-equal to the "
          f"checked call, one launch each", flush=True)
    del map_chars, reps

    counters = {"merge_path": merge_path, "clamp_scan": clamp_scan,
                "derandomize_translate": derandomize_translate,
                "bitonic_merge": bitonic_merge, "bitonic_sort": bitonic_sort,
                "ext_walk": ext_walk}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    # launches of each call, read around that call alone
    launches = {}
    ONE_JOIN = {"merge_path": 1, "clamp_scan": 2, "derandomize_translate": 1,
                "bitonic_merge": 0, "bitonic_sort": 0, "ext_walk": 0}

    def read_counts(path, want=ONE_JOIN):
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        if got != want:
            raise SystemExit(f"FAIL launches on the {path} path: {got}, "
                             f"expected {want}")
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

    # the joins with merge="bitonic" (kbo_tpu's KBO_TPU_MERGE_PATH=0 choice)
    # give what merge="path" gives: find-core's MS at full length, the rows
    # join's MS / uniq / rows at the map shape; the padded layout runs
    # through the scans and the back-to-order steps drop the pads
    only_bitonic = {**ONE_JOIN, "merge_path": 0, "derandomize_translate": 0,
                    "bitonic_merge": 1}
    reset_counts()
    ms_bit = ms2_core(dev.keys2, dev.cap2, buf, K, merge="bitonic")
    launches["ms2_core merge=bitonic"] = read_counts(
        "ms2_core merge=bitonic", only_bitonic)
    if not torch.equal(ms_bit, ms_gpu):
        raise SystemExit("FAIL ms2_core merge=bitonic differs from merge=path")
    reset_counts()
    rows_bit = ms3_rows_core(dev.keys3, dev.rows_packed, mbuf, K,
                             merge="bitonic")
    launches["ms3_rows_core merge=bitonic"] = read_counts(
        "ms3_rows_core merge=bitonic", only_bitonic)
    rows_path = ms3_rows_core(dev.keys3, dev.rows_packed, mbuf, K)
    if not all(torch.equal(x, y) for x, y in zip(rows_bit, rows_path)):
        raise SystemExit("FAIL ms3_rows_core merge=bitonic differs from "
                         "merge=path")
    reset_counts()
    bitonic_sort(sort_in, 4)
    launches["bitonic_sort"] = read_counts(
        "bitonic_sort", {**only_bitonic, "clamp_scan": 0, "bitonic_merge": 0,
                         "bitonic_sort": 1})
    print(f"merge=bitonic: ms2_core over {T} slots and ms3_rows_core over "
          f"{mbuf.shape[0]} slots equal merge=path", flush=True)
    del ms_bit, rows_bit, rows_path

    # ---- 5. the map slice at full size; launch counts around each call
    def mopts(fmt):
        return MapOpts(fill_gaps=False, call_variants=False, format=fmt)

    # the default MapOpts(): the sweep's join, the variant join reusing the
    # sweep's sorted query table (single shot: one table), one fused
    # derandomize+translate; the 8-contig batch joins against its own
    # tagged table (W=7)
    TWO_JOINS = {**ONE_JOIN, "merge_path": 2, "clamp_scan": 4}
    t0 = time.perf_counter()
    dmap_gpu, dstats = {}, {}
    for fmt in (True, False):
        reset_counts()
        reset_stats()
        dmap_gpu[fmt] = api.map_(ref, index, dopts(fmt), device=cuda)
        launches[f"map_ MapOpts() format={fmt}"] = read_counts(
            f"map_ MapOpts() format={fmt}", TWO_JOINS)
        dstats[fmt] = get_stats().as_dict()
    reset_counts()
    reset_stats()
    dbatch_gpu = api.map_batch(contigs_of(ref), index, dopts(True), device=cuda)
    launches["map_batch MapOpts()"] = read_counts("map_batch MapOpts()",
                                                  TWO_JOINS)
    dstats["batch"] = get_stats().as_dict()
    print(f"default map path on the card: {time.perf_counter() - t0:.2f}s, "
          f"launches per call {json.dumps(launches)}", flush=True)
    t0 = time.perf_counter()
    for fmt in (True, False):
        reset_stats()
        if dmap_gpu[fmt] != api.map_(ref, index, dopts(fmt), device="cpu"):
            raise SystemExit(f"FAIL map_ MapOpts() format={fmt} differs from "
                             "the CPU run")
        if get_stats().as_dict().get("variants_called") != \
                dstats[fmt]["variants_called"]:
            raise SystemExit("FAIL map_ MapOpts() counters differ from the "
                             "CPU run")
    if dbatch_gpu != api.map_batch(contigs_of(ref), index, dopts(True),
                                   device="cpu"):
        raise SystemExit("FAIL map_batch MapOpts() differs from the CPU run")
    dt, df = dmap_gpu[True], dmap_gpu[False]
    if len(dt) != n or len(df) != n or set(dt) - set(b"ACGTN-") \
            or set(df) - set(b"MX-RACGTNID"):
        raise SystemExit("FAIL map_ MapOpts() output has the wrong length or "
                         "alphabet")
    st = dstats[True]
    print(f"CPU run of the default map calls: {time.perf_counter() - t0:.1f}s; "
          f"map_ MapOpts(): {n} bases, format true and false and the 8-contig "
          f"map_batch equal the CPU run; counters: variants resolved "
          f"{st['variants_called']}, gaps seen {st['gaps_seen']}, filled "
          f"{st['gaps_filled']}, unfilled bases {st['gap_bases_unfilled']}, "
          f"host-fallback gaps {st['gaps_to_host']}; "
          f"{n - int((np.frombuffer(dt, np.uint8) == np.frombuffer(ref, np.uint8)).sum())}"
          f" bases differ from the reference", flush=True)
    sb = dstats["batch"]
    print(f"map_batch MapOpts() counters: variants resolved "
          f"{sb['variants_called']}, gaps seen {sb['gaps_seen']}, filled "
          f"{sb['gaps_filled']}, host-fallback gaps {sb['gaps_to_host']}",
          flush=True)
    if st["variants_called"] == 0 or st["gaps_filled"] == 0:
        raise SystemExit("FAIL the default map_ resolved no variant or "
                         "filled no gap")

    contigs = contigs_of(ref)
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
    # the chunked sweep's own upload (pack, ship, decode and sweep chunk by
    # chunk) against the one-shot upload and the single-shot sweep
    ref_mat = np.zeros((1, Lm), dtype=np.uint8)
    ref_mat[0, :n] = np.frombuffer(ref, dtype=np.uint8)
    seq_lens = np.asarray([n], dtype=np.int32)
    piped = mapsweep.upload_sweep_chunked_pipelined(
        dev.keys3, dev.rows_packed, ref_mat, seq_lens, K, 1_000_000)
    if piped is None or not (
            torch.equal(piped[0].cpu(), torch.from_numpy(ref_mat))
            and torch.equal(piped[1], mcodes)
            and torch.equal(piped[2], single[0]) and torch.equal(piped[3], uq)
            and torch.equal(piped[4][uq], single[2][uq])):
        raise SystemExit("FAIL upload_sweep_chunked_pipelined (1 Mbase "
                         "chunks) differs from the one-shot upload and sweep")
    print("map upload: chunk-by-chunk pack + upload + sweep equals the "
          "one-shot upload and the single-shot sweep", flush=True)
    del piped

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

    # ---- 5b. the 2-bit map path: k >= 128, and batches past the rows
    # join's slot budget; launch counts around each call alone
    def capture(fn, names):
        """Run fn with the named functions (module, attribute) recording
        their arguments; returns (fn's result, {attribute: [args, ...]})."""
        got = {attr: [] for _, attr in names}
        real = {attr: getattr(mod, attr) for mod, attr in names}

        def rec(attr):
            def f(*a, **kw):
                got[attr].append(a)
                return real[attr](*a, **kw)
            return f

        for mod, attr in names:
            setattr(mod, attr, rec(attr))
        try:
            return fn(), got
        finally:
            for mod, attr in names:
                setattr(mod, attr, real[attr])

    def first(args, pred):
        return next(a for a in args if pred(a))

    K151, n1m = 151, min(n, 1_000_000)
    bo151 = BuildOpts(k=K151, build_select=True)

    def opts151(fmt):
        return MapOpts(format=fmt, sbwt_build_opts=bo151)

    def opts254(fmt):
        return MapOpts(format=fmt, sbwt_build_opts=BuildOpts(
            k=K254, build_select=True))

    t0 = time.perf_counter()
    idx151 = api.build([query], bo151)
    t_build151 = time.perf_counter() - t0
    print(f"index k={K151}: {n} bases, {idx151.n_rows} rows, built on the "
          f"host in {t_build151:.1f}s", flush=True)
    # the sweep's join, the interval probe's joins (one per prefetch that
    # misses), the 2-bit k-mer batch; two scans each for the sweep and the
    # k-mer batch, two for the vs-sequence join; one derandomize_translate
    classic_names = [(ms_mod, "merge_path"), (ms_mod, "clamp_scan"),
                     (mapsweep, "derandomize_translate")]

    def classic_counts(path, contigs_called=1):
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        want = {**ONE_JOIN, "merge_path": got["merge_path"],
                "clamp_scan": 2 + 4 * contigs_called}
        if got != want or got["merge_path"] < 1 + 2 * contigs_called:
            raise SystemExit(f"FAIL launches on the {path} path: {got}, "
                             f"expected {want} with a merge for the sweep "
                             f"and two or more for each contig")
        launches[path] = got
        return got

    t0 = time.perf_counter()
    cmap_gpu, cargs, cstats = {}, {}, {}
    for fmt in (True, False):
        reset_counts()
        reset_stats()
        cmap_gpu[fmt], cargs[fmt] = capture(
            lambda: api.map_(ref, idx151, opts151(fmt), device=cuda),
            classic_names)
        classic_counts(f"map_ k={K151} format={fmt}")
        cstats[fmt] = get_stats().as_dict()
    reset_counts()
    cbatch_gpu = api.map_batch(contigs_of(ref), idx151, opts151(True),
                               device=cuda)
    classic_counts(f"map_batch k={K151}", len(contigs))
    print(f"k={K151} map path on the card: {time.perf_counter() - t0:.2f}s "
          f"(first runs), launches per call "
          f"{json.dumps(launches[f'map_ k={K151} format=True'])}",
          flush=True)
    st = cstats[True]
    ct, cf = cmap_gpu[True], cmap_gpu[False]
    if len(ct) != n or len(cf) != n or set(ct) - set(b"ACGTN-") \
            or set(cf) - set(b"MX-RACGTNID") \
            or [len(b) for b in cbatch_gpu] != [len(c) for c in contigs]:
        raise SystemExit(f"FAIL map_ k={K151} output has the wrong length "
                         "or alphabet")
    if st["variants_called"] == 0 or st["gaps_filled"] == 0:
        raise SystemExit(f"FAIL map_ k={K151} resolved no variant or filled "
                         "no gap")
    print(f"map_ k={K151} at full width: {n} bases, variants resolved "
          f"{st['variants_called']}, gaps seen {st['gaps_seen']}, filled "
          f"{st['gaps_filled']}, unfilled bases {st['gap_bases_unfilled']}; "
          f"{n - int((np.frombuffer(ct, np.uint8) == np.frombuffer(ref, np.uint8)).sum())}"
          f" bases differ from the reference", flush=True)
    # the CPU runs of the full width take minutes: a 1 Mbase slice (its
    # own k=151 index) both ways, format true and false and 8 contigs
    t0 = time.perf_counter()
    idx151s = api.build([query[:n1m]], bo151)
    ref1m = ref[:n1m]
    for fmt in (True, False):
        if api.map_(ref1m, idx151s, opts151(fmt), device=cuda) != api.map_(
                ref1m, idx151s, opts151(fmt), device="cpu"):
            raise SystemExit(f"FAIL map_ k={K151} format={fmt} on {n1m} "
                             "bases differs from the CPU run")
    if api.map_batch(contigs_of(ref1m), idx151s, opts151(True),
                     device=cuda) != api.map_batch(
            contigs_of(ref1m), idx151s, opts151(True), device="cpu"):
        raise SystemExit(f"FAIL map_batch k={K151} on {n1m} bases differs "
                         "from the CPU run")
    del idx151s
    print(f"map_ k={K151} on a {n1m}-base slice (index and reference), "
          f"format true and false, and its 8-contig map_batch equal the CPU "
          f"run ({time.perf_counter() - t0:.1f}s, index build included)",
          flush=True)

    # k = 254 on phase 3's 400 kbase index: 17 rows through the sweep's
    # merge, 16 words through its scans, 27 rows through the interval merge
    t0 = time.perf_counter()
    map254, args254 = {}, {}
    for fmt in (True, False):
        reset_counts()
        map254[fmt], args254[fmt] = capture(
            lambda: api.map_(ref[:n254], idx254, opts254(fmt), device=cuda),
            classic_names)
        classic_counts(f"map_ k={K254} format={fmt}")
        if map254[fmt] != api.map_(ref[:n254], idx254, opts254(fmt),
                                   device="cpu"):
            raise SystemExit(f"FAIL map_ k={K254} format={fmt} differs from "
                             "the CPU run")
    b254 = contigs_of(ref[:n254])
    if api.map_batch(b254, idx254, opts254(True), device=cuda) != \
            api.map_batch(b254, idx254, opts254(True), device="cpu"):
        raise SystemExit(f"FAIL map_batch k={K254} differs from the CPU run")
    print(f"map_ k={K254} on {n254} bases, format true and false, and its "
          f"8-contig map_batch equal the CPU run "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)

    # the 2-bit flow at k = 51, where the default route takes the rows
    # join: the same bytes as phase 5's default map_
    for fmt in (True, False):
        if api._map_classic([ref], index, dopts(fmt), cuda)[0] != \
                dmap_gpu[fmt]:
            raise SystemExit(f"FAIL the 2-bit map flow at k={K} format={fmt} "
                             "differs from the default map_")
    print(f"map_ k={K}: the 2-bit flow equals the default route (the rows "
          f"join) byte for byte, format true and false", flush=True)

    # the sweep alone at an over-budget many-contig shape: contigs of 256
    # bases (L = 1024 a row), too many for the rows join even chunked, and
    # past 2^24 slots with the index (_neighbor_best's unpacked branch: no
    # merge). The CPU run of all of it takes minutes: the first OB_CPU
    # contigs, also past 2^24 slots, against their CPU twin; every contig
    # against the card's packed branch in sub-batches under 2^24 slots
    OB_Q, OB_CPU, OB_SUB = 60_000, 12_000, 10_000
    rc_all = encode_ascii(ref)
    ob_codes = np.full((OB_Q, 1024), 255, dtype=np.uint8)
    ob_start = (np.arange(OB_Q) * 7919) % (n - 256)
    ob_codes[:, :256] = rc_all[ob_start[:, None] + np.arange(256)[None, :]]
    ob_len = np.full(OB_Q, 256, dtype=np.int32)
    T3 = int(dev.keys3.shape[1])
    if api.map_route(K, OB_Q, 1024, T3) != ("classic", 0) or \
            OB_CPU * (1024 + K - 1) + dev.keys2.shape[1] < 2**24 - 1 or \
            OB_SUB * (1024 + K - 1) + dev.keys2.shape[1] >= 2**24 - 1:
        raise SystemExit("FAIL the over-budget shape does not take the "
                         "2-bit route and the unpacked join")
    ob_dev = (torch.from_numpy(ob_codes).to(cuda),
              torch.from_numpy(ob_len).to(cuda))

    def ob_sweep(keys2, cap2, codes_t, len_t):
        return mapsweep.map_sweep_compact_core(keys2, cap2, codes_t, len_t,
                                               K, threshold)

    reset_counts()
    ob_gpu, ob_args = capture(lambda: ob_sweep(dev.keys2, dev.cap2, *ob_dev),
                              classic_names)
    launches["over-budget sweep"] = read_counts(
        "over-budget sweep", {**ONE_JOIN, "merge_path": 0})

    def rows_equal(a, b, lo, hi):
        """The sweep's outputs of contigs lo to hi of a against b: chars and
        MS inside the 256 bases, counts and compacted arrays whole."""
        return all(torch.equal(x[lo:hi, :256].cpu(), y[:, :256].cpu())
                   for x, y in zip(a[:2], b[:2])) and all(
            torch.equal(x[lo:hi].cpu(), y.cpu()) for x, y in zip(a[2:], b[2:]))

    t0 = time.perf_counter()
    ob_cpu = ob_sweep(cpu_dev.keys2, cpu_dev.cap2,
                      torch.from_numpy(ob_codes[:OB_CPU]),
                      torch.from_numpy(ob_len[:OB_CPU]))
    t_ob_cpu = time.perf_counter() - t0
    if not rows_equal(ob_gpu, ob_cpu, 0, OB_CPU):
        raise SystemExit(f"FAIL the over-budget sweep's first {OB_CPU} "
                         "contigs differ from the CPU run")
    del ob_cpu
    for lo in range(0, OB_Q, OB_SUB):
        sub = ob_sweep(dev.keys2, dev.cap2, ob_dev[0][lo : lo + OB_SUB],
                       ob_dev[1][lo : lo + OB_SUB])
        if not rows_equal(ob_gpu, sub, lo, lo + OB_SUB):
            raise SystemExit(f"FAIL the over-budget sweep differs from the "
                             f"packed join on contigs {lo} to {lo + OB_SUB}")
    del sub
    ob_counts = ob_gpu[2].sum(dim=0).tolist()
    print(f"over-budget sweep: {OB_Q} contigs of 256 bases "
          f"({OB_Q * (1024 + K - 1)} slots with the {dev.keys2.shape[1]}-row "
          f"table; route {api.map_route(K, OB_Q, 1024, T3)[0]}): the first "
          f"{OB_CPU} equal the CPU run ({t_ob_cpu:.1f}s), all equal the "
          f"packed join in sub-batches of {OB_SUB}; drops {ob_counts[0]}, "
          f"gap runs {ob_counts[1]}", flush=True)
    del ob_gpu

    # the kernels at the shapes these calls gave them, against their plain
    # versions, bit for bit
    map2_shapes = {
        f"map2 k={K151}": first(cargs[True]["merge_path"],
                                lambda a: a[0].shape[0] == 10),
        f"interval k={K151}": first(cargs[True]["merge_path"],
                                    lambda a: a[0].shape[0] == 17),
        f"map2 k={K254}": first(args254[True]["merge_path"],
                                lambda a: a[0].shape[0] == 16),
    }
    for label, ops in map2_shapes.items():
        check("merge_path", f"{label} W={ops[0].shape[0]} "
              f"na={ops[0].shape[1]} nb={ops[2].shape[1]}",
              merge_path(*ops), merge_path_plain(*ops))
    map2_scans = {
        f"map2 k={K151}": cargs[True]["clamp_scan"][0],
        f"vs-seq k={K151}": first(cargs[True]["clamp_scan"],
                                  lambda a: a[2] == 3),
        f"map2 k={K254}": args254[True]["clamp_scan"][0],
        "over-budget": ob_args["clamp_scan"][0],
    }
    for label, (sw, cp, bits) in map2_scans.items():
        for rev in (False, True):
            check("clamp_scan", f"{label} bits={bits} W={sw.shape[0]} "
                  f"reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cp, bits, rev)],
                  [clamp_scan_plain(sw, cp, bits, rev)])
    map2_dt = {
        f"map2 k={K151}": cargs[True]["derandomize_translate"][0],
        "over-budget": ob_args["derandomize_translate"][0],
    }
    for label, (dms, dk, dthr, dtl) in map2_dt.items():
        got = derandomize_translate(dms, dk, dthr, dtl)
        want = derandomize_translate_plain(dms, dk, dthr, dtl)
        in_len = torch.arange(dms.shape[1], device=cuda)[None, :] < \
            dtl.reshape(-1, 1)
        if got[~in_len].any() or not torch.equal(
                torch.where(in_len, got, 0), torch.where(in_len, want, 0)):
            raise SystemExit(f"FAIL derandomize_translate {label} differs "
                             "from plain")
        print(f"kernel derandomize_translate {label} "
              f"{dms.shape[0]}x{dms.shape[1]} (strided rows, k={dk}): "
              f"bit-equal to plain", flush=True)
    del cargs, args254

    # ---- 6. the call slice and the device-built sequence index
    def tuples(variants):
        return [(v.query_pos, v.query_chars, v.ref_chars) for v in variants]

    def copts(k=K, rc=False):
        return CallOpts(sbwt_build_opts=BuildOpts(
            k=k, build_select=True, add_revcomp=rc))

    call_names = [(ms_mod, "merge_path"), (ms_mod, "clamp_scan"),
                  (ms_mod, "intervals3_windows_core"),
                  (engine_mod, "compute_ms_values_vs_seq_device")]
    t0 = time.perf_counter()
    reset_counts()
    reset_stats()
    call_gpu, call_args = capture(
        lambda: api.call(index, ref, copts(), device=cuda), call_names)
    rounds = get_stats().as_dict()["call_anchor_rounds"]
    # the row's join, one interval join per anchor round, the 2-bit k-mer
    # batch; two scans each for the row's join, the k-mer batch and the
    # vs-sequence join
    CALL = {**ONE_JOIN, "merge_path": 2 + rounds, "clamp_scan": 6,
            "derandomize_translate": 0}
    launches["call"] = read_counts("call", CALL)
    reset_counts()
    call_rc_gpu = api.call(index, ref, copts(rc=True), device=cuda)
    read_counts("call add_revcomp", CALL)
    print(f"call on the card: {time.perf_counter() - t0:.2f}s (first runs), "
          f"{rounds} anchor rounds, launches per call "
          f"{json.dumps(launches['call'])}", flush=True)
    t0 = time.perf_counter()
    for label, got, rc in (("", call_gpu, False),
                           (" add_revcomp", call_rc_gpu, True)):
        want = api.call(index, ref, copts(rc=rc), device="cpu")
        if tuples(got) != tuples(want):
            raise SystemExit(f"FAIL call{label} differs from the CPU run")
    if not call_gpu:
        raise SystemExit("FAIL call found no variant")
    # the planted sites in the streamed side's coordinates: SNPs that
    # changed a base, and 3-base deletions of the indexed side (3-base
    # insertions here), each shifted by the deletions before it
    rng = np.random.default_rng(42)
    rng.integers(0, 4, n)
    snps = {p for p in range(500, n - 500, 1000)
            if b"ACGT"[rng.integers(0, 4)] != ref[p]}
    dels = [p + 3 * j for j, p in
            enumerate(range(n // 50, n - n // 50, n // 10))]
    hit_snp = sum(v.query_pos in snps and len(v.query_chars) == 1
                  == len(v.ref_chars) for v in call_gpu)
    hit_del = sum(any(abs(v.query_pos - p) <= K and len(v.query_chars) == 3
                      and not v.ref_chars for v in call_gpu) for p in dels)
    print(f"call: {n} bases, {len(call_gpu)} variants ({len(call_rc_gpu)} "
          f"with add_revcomp), both equal the CPU run "
          f"({time.perf_counter() - t0:.1f}s); planted sites recovered: "
          f"{hit_snp} of {len(snps)} SNPs, {hit_del} of {len(dels)} 3-base "
          f"deletions", flush=True)

    # the short-reference branch (host build of the reference's index):
    # the reference's call doctest (src/lib.rs:518-545)
    doc_ref = (b"TCGTGGATCGATACACGCTAGCAGGCTGACTCGATGGGATACTATGTGTTATAGCAATT"
               b"CGGATCGATCGA")
    doc_q = (b"TCGTGGATCGATACACGCTAGCCTGACTCGATGGGATACCATGTGTTATAGCAATTCCGG"
             b"ATCGATCGA")
    doc_opts = CallOpts(max_error_prob=0.001,
                        sbwt_build_opts=BuildOpts(k=20, build_select=True))
    doc = tuples(api.call(api.build([doc_q], doc_opts.sbwt_build_opts),
                          doc_ref, doc_opts, device=cuda))
    if doc != [(22, b"AGG", b""), (42, b"T", b"C"), (60, b"", b"C")]:
        raise SystemExit(f"FAIL call doctest on the card: {doc}")
    print("call doctest (72-base reference, host-built index) gives the "
          "reference's three variants on the card", flush=True)

    # k = 254: 27 key rows through the interval merge (its half-length
    # tiles), 26 words through the vs-sequence scans
    reset_counts()
    reset_stats()
    call254_gpu, call254_args = capture(
        lambda: api.call(idx254, ref[:n254], copts(K254), device=cuda),
        call_names)
    rounds254 = get_stats().as_dict()["call_anchor_rounds"]
    launches["call k=254"] = read_counts(
        "call k=254", {**CALL, "merge_path": 2 + rounds254})
    if tuples(call254_gpu) != tuples(api.call(idx254, ref[:n254],
                                              copts(K254), device="cpu")):
        raise SystemExit("FAIL call at k=254 differs from the CPU run")
    if not call254_gpu:
        raise SystemExit("FAIL call at k=254 found no variant")
    print(f"call at k=254 on {n254} bases: {len(call254_gpu)} variants, "
          f"{rounds254} anchor rounds, equal to the CPU run", flush=True)

    # build_device + find_batch: phase 4's batch against the indexed side's
    # own sorted window keys
    t0 = time.perf_counter()
    seq_index = api.build_device([query], BuildOpts(k=K), device=cuda)
    torch.cuda.synchronize()
    t_build_dev = (time.perf_counter() - t0) * 1e3
    reset_counts()
    seq_names = [(ms_mod, "merge_path"), (ms_mod, "clamp_scan"),
                 (pipeline_mod, "derandomize_translate")]
    rle_seq_gpu, seq_args = capture(
        lambda: api.find_batch(q_list, seq_index, FindOpts()), seq_names)
    launches["find_batch DeviceSeqIndex"] = read_counts(
        "find_batch DeviceSeqIndex")
    seq_cpu = api.build_device([query], BuildOpts(k=K), device="cpu")
    if seq_cpu.n_kmers != seq_index.n_kmers or \
            api.find_batch(q_list, seq_cpu, FindOpts()) != rle_seq_gpu:
        raise SystemExit("FAIL find_batch against build_device's index "
                         "differs from the CPU run")
    del seq_cpu
    print(f"build_device + find_batch[{QN}x{QL}]: {seq_index.n_kmers} "
          f"distinct k-mers, {sum(len(r) for r in rle_seq_gpu)} segments, "
          f"RLE lists equal the CPU run", flush=True)

    # the slice's kernels at their new shapes against their plain versions
    new_shapes = {
        "interval k=51": first(call_args["merge_path"],
                               lambda a: a[0].shape[0] == 7),
        "interval k=254": first(call254_args["merge_path"],
                                lambda a: a[0].shape[0] == 27),
        "seq-index": seq_args["merge_path"][0],
    }
    for label, ops in new_shapes.items():
        check("merge_path", f"{label} W={ops[0].shape[0]} "
              f"na={ops[0].shape[1]} nb={ops[2].shape[1]}",
              merge_path(*ops), merge_path_plain(*ops))
    # (words, cap, bits) of the first scan of each join (the direction is
    # a keyword argument)
    scan_shapes = {
        "vs-seq": first(call_args["clamp_scan"], lambda a: a[2] == 3),
        "vs-seq k=254": first(call254_args["clamp_scan"], lambda a: a[2] == 3),
        "seq-index": seq_args["clamp_scan"][0],
    }
    for label, (sw, cp, bits) in scan_shapes.items():
        for rev in (False, True):
            check("clamp_scan", f"{label} bits={bits} W={sw.shape[0]} "
                  f"reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cp, bits, rev)],
                  [clamp_scan_plain(sw, cp, bits, rev)])
    seq_ms, _k, _thr, seq_tl = seq_args["derandomize_translate"][0]
    check_dt(f"seq-index batch {seq_ms.shape[0]}x{seq_ms.shape[1]} "
             f"(strided rows)", seq_ms, seq_tl)
    # merge="bitonic" in the interval probe (W + 2 = 8 operand rows)
    iv_in = call_args["intervals3_windows_core"][0]
    reset_counts()
    iv_bit = ms_mod.intervals3_windows_core(*iv_in, merge="bitonic")
    launches["intervals merge=bitonic"] = read_counts(
        "intervals merge=bitonic",
        {**only_bitonic, "clamp_scan": 0})
    iv_path = ms_mod.intervals3_windows_core(*iv_in)
    if not all(torch.equal(x, y) for x, y in zip(iv_bit, iv_path)):
        raise SystemExit("FAIL the interval probe with merge=bitonic differs "
                         "from merge=path")
    ak, ap, bk, bp = new_shapes["interval k=51"]
    bitonic_in["interval k=51"] = (
        torch.cat([ak, ap[None]]), torch.cat([bk, bp[None]]), ak.shape[0])
    got = bitonic_merge(*bitonic_in["interval k=51"])
    check("bitonic_merge", f"interval k=51 W={ak.shape[0]} M={got.shape[1]}",
          [got], [bitonic_merge_plain(*bitonic_in["interval k=51"])])
    print(f"merge=bitonic: the interval probe over {iv_in[1].shape[0]} "
          f"windows equals merge=path ({ak.shape[0] + 1} operand rows, "
          f"{passes_of(got.shape[1], ak.shape[0] + 1, False)})", flush=True)
    del got, iv_bit, iv_path
    vs_seq_in = call_args["compute_ms_values_vs_seq_device"][0]

    # ---- 6b. the native pack, the device-built full index, the interval
    # gap path and the command line
    t0 = time.perf_counter()
    pk_native = mapsweep.pack_ascii_host(ref_mat, seq_lens)
    t_pk_native = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pk_plain = mapsweep.pack_ascii_plain(ref_mat, seq_lens)
    t_pk_plain = (time.perf_counter() - t0) * 1e3
    if pk_native is None or not all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(pk_native, pk_plain)):
        raise SystemExit("FAIL the native pack differs from the numpy pack")
    print(f"native pack: {n} bases, packed bases and the exception list "
          f"({int((pk_native[1] < Lm).sum())} exceptions, padded to "
          f"{pk_native[1].size}) equal the numpy pack; first calls: native "
          f"{t_pk_native:.3f} ms, numpy {t_pk_plain:.3f} ms (host clock)",
          flush=True)
    del pk_native, pk_plain

    # build_device(full=True) over the indexed side: its tables against
    # the host build, then find_batch / map_ / call against it, each equal
    # to the same call against the host-built index
    t0 = time.perf_counter()
    full = api.build_device([query], BuildOpts(k=K, build_select=True),
                            full=True, device=cuda)
    torch.cuda.synchronize()
    t_build_full = (time.perf_counter() - t0) * 1e3
    k3 = full.keys3.cpu().numpy().view(np.uint32)
    nr = full.n_rows
    if (nr, full.n_kmers) != (index.n_rows, index.n_kmers) \
            or not np.array_equal(full.C, index.C) \
            or not np.array_equal(k3[:, :nr], np.asarray(index.keys3)) \
            or not (k3[:, nr:] == _U32).all() \
            or not bool((full.row_pos[nr:] == -1).all()):
        raise SystemExit("FAIL build_device(full=True) tables differ from the "
                         "host build")
    del k3
    rows_p = np.random.default_rng(5).integers(0, nr, 4096)
    if not np.array_equal(full.access_kmers_codes(rows_p),
                          index.access_kmers_codes(rows_p)):
        raise SystemExit("FAIL DeviceFullIndex.access_kmers_codes differs "
                         "from the host index")
    print(f"build_device(full=True): {nr} rows ({full.keys3.shape[1] - nr} "
          f"sentinel rows after them), {full.n_kmers} k-mers, C "
          f"{full.C.tolist()}: keys3[:, :n_rows], n_rows, n_kmers, C and "
          f"4096 rows' k-mers equal the host build; {t_build_full:.1f} ms "
          f"(first call, host clock)", flush=True)

    full_names = [(ms_mod, "merge_path"), (ms_mod, "clamp_scan"),
                  (pipeline_mod, "derandomize_translate")]
    reset_counts()
    rle_full, fb_args = capture(
        lambda: api.find_batch(q_list, full, FindOpts()), full_names)
    launches["find_batch DeviceFullIndex"] = read_counts(
        "find_batch DeviceFullIndex")
    if rle_full != rle_gpu:
        raise SystemExit("FAIL find_batch against the device-built full index "
                         "differs from the host index's")
    reset_counts()
    reset_stats()
    dmap_full, fm_args = capture(lambda: api.map_(ref, full, dopts(True)),
                                 full_names[:2])
    launches["map_ DeviceFullIndex"] = read_counts("map_ DeviceFullIndex",
                                                   TWO_JOINS)
    if dmap_full != dmap_gpu[True]:
        raise SystemExit("FAIL map_ MapOpts() against the device-built full "
                         "index differs from the host index's")
    reset_counts()
    reset_stats()
    call_full = api.call(full, ref, copts())
    rounds_full = get_stats().as_dict()["call_anchor_rounds"]
    launches["call DeviceFullIndex"] = read_counts(
        "call DeviceFullIndex", {**CALL, "merge_path": 2 + rounds_full})
    if tuples(call_full) != tuples(call_gpu):
        raise SystemExit("FAIL call against the device-built full index "
                         "differs from the host index's")
    print(f"against build_device(full=True): find_batch[{QN}x{QL}], map_ "
          f"MapOpts() and call (CallOpts(k={K}), {len(call_full)} variants) "
          f"equal the host-built index's; launches per call "
          f"{json.dumps({p: launches[p] for p in ('find_batch DeviceFullIndex', 'map_ DeviceFullIndex', 'call DeviceFullIndex')})}",
          flush=True)

    # the host gap pass on the device-built full index: an unrelated
    # 200-base stretch in the streamed side makes a gap wider than k, which
    # the device scorer flags for the host evaluator; its left extension
    # walks the chain links (kernels/refine.py ext_walk), one launch and no
    # join, bit-equal to the plain version on the operands the call gave
    # it; the map equals the host index's, whose evaluator takes the rounds
    ref_gap = bytearray(ref)
    g0 = n // 2 + 600
    ref_gap[g0 : g0 + 200] = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(7).integers(0, 4, 200)].tobytes()
    ref_gap = bytes(ref_gap)
    reset_counts()
    reset_stats()
    dmap_gap, walk_args = capture(lambda: api.map_(ref_gap, full, dopts(True)),
                                  [(gap_filling, "ext_walk")])
    gstats = get_stats().as_dict()
    launches["map_ DeviceFullIndex host gap"] = read_counts(
        "map_ DeviceFullIndex host gap", {**TWO_JOINS, "ext_walk": 1})
    if not gstats.get("gaps_to_host") or not gstats.get(
            "host_ext_walk_lanes") or "host_ext_rounds" in gstats:
        raise SystemExit(f"FAIL map_ with a host gap on the device full index: "
                         f"gaps_to_host {gstats.get('gaps_to_host')}, lanes "
                         f"walked {gstats.get('host_ext_walk_lanes')}, rounds "
                         f"{gstats.get('host_ext_rounds')}")
    reset_stats()
    if dmap_gap != api.map_(ref_gap, index, dopts(True), device=cuda):
        raise SystemExit("FAIL map_ with a host gap on the device full index "
                         "differs from the host index's")
    hstats = get_stats().as_dict()
    if not hstats.get("host_ext_rounds") or hstats.get(
            "gaps_to_host") != gstats["gaps_to_host"]:
        raise SystemExit(f"FAIL map_ with a host gap on the host index: "
                         f"gaps_to_host {hstats.get('gaps_to_host')}, rounds "
                         f"{hstats.get('host_ext_rounds')}")
    walk_ops = walk_args["ext_walk"][0]
    w_link, w_rows, w_bud, w_width = walk_ops
    check("ext_walk", f"host gap lanes E={w_rows.shape[0]} width={w_width} "
          f"budgets {int(w_bud.min())}-{int(w_bud.max())} "
          f"n={w_link.shape[0]}", ext_walk(*walk_ops),
          ext_walk_plain(*walk_ops))
    print(f"host gap pass on build_device(full=True): {gstats['gaps_to_host']} "
          f"gaps to the host, {gstats['host_ext_walk_lanes']} lanes in one "
          f"walk (launches {json.dumps(launches['map_ DeviceFullIndex host gap'])}"
          f"), the map equal to the host index's ({hstats['host_ext_rounds']} "
          f"rounds there)", flush=True)
    del dmap_gap, walk_args

    # the membership probe on the card against the host index's binary
    # search (the CPU's answer): rows' k-mers and one-base mutants
    gm = np.random.default_rng(6)
    probes = full.access_kmers_codes(gm.integers(0, nr, 2048))
    mutants = probes.copy()
    mutants[np.arange(2048), gm.integers(0, K, 2048)] = gm.integers(1, 5, 2048)
    probes = np.concatenate([probes, mutants])
    reset_counts()
    widths, mw_args = capture(lambda: full.member_widths(probes),
                              [(ms_mod, "merge_path")])
    MEMBER = {**ONE_JOIN, "clamp_scan": 0, "derandomize_translate": 0}
    launches["member_widths"] = read_counts("member_widths", MEMBER)
    no_dollar = ~(probes == 0).any(axis=1)
    if set(np.unique(widths).tolist()) - {0, 1} or not np.array_equal(
            (widths == 1) & no_dollar, gap_filling._member_rows(index, probes)):
        raise SystemExit("FAIL member_widths on the card differs from the host "
                         "index's membership")
    print(f"member_widths: {probes.shape[0]} probes on the card equal the host "
          f"index's binary search ({int(widths.sum())} members)", flush=True)

    # the kernels at the full index's shapes (sentinel-tailed tables: cap 0
    # in the 2-bit join, all-ones keys in the rows join and the probe)
    full_shapes = {
        "full-index batch": fb_args["merge_path"][0],
        "full-index map": fm_args["merge_path"][0],
        "full-index member": mw_args["merge_path"][0],
    }
    for label, ops in full_shapes.items():
        check("merge_path", f"{label} W={ops[0].shape[0]} "
              f"na={ops[0].shape[1]} nb={ops[2].shape[1]}",
              merge_path(*ops), merge_path_plain(*ops))
    full_scans = {
        "full-index batch": fb_args["clamp_scan"][0],
        "full-index map": fm_args["clamp_scan"][0],
    }
    for label, (sw, cp, bits) in full_scans.items():
        for rev in (False, True):
            check("clamp_scan", f"{label} bits={bits} W={sw.shape[0]} "
                  f"reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cp, bits, rev)],
                  [clamp_scan_plain(sw, cp, bits, rev)])
    full_ms, _k, _thr_full, full_tl = fb_args["derandomize_translate"][0]
    check_dt(f"full-index batch {full_ms.shape[0]}x{full_ms.shape[1]} "
             f"(strided rows)", full_ms, full_tl)

    # the interval gap path on a 400 kbase slice: fill_gaps over
    # SparseIntervals of the card-resident MS row, against the CPU run; the
    # same refinement as map_ with gap filling alone
    idx_s = api.build([query[:n254]], BuildOpts(k=K, build_select=True))
    ref_s, codes_s = ref[:n254], encode_ascii(ref[:n254])
    t_s = random_match_threshold(K, idx_s.n_kmers, 4, 1e-7)
    off = MapOpts(fill_gaps=False, call_variants=False, format=False)
    fill_only = MapOpts(call_variants=False, format=False,
                        sbwt_build_opts=BuildOpts(k=K, build_select=True))
    gap_out = {}
    for where, device in (("card", cuda), ("cpu", "cpu")):
        tr = list(api.map_(ref_s, idx_s, off, device=device).decode())
        row = ms_mod.query_ms_row_device(device_index(idx_s, device), codes_s)
        reset_stats()
        got = gap_filling.fill_gaps(
            tr, None, engine_mod.SparseIntervals(idx_s, codes_s, ms=row),
            ref_s, idx_s, t_s, 1e-7)
        gap_out[where] = (got, get_stats().as_dict().get("gaps_filled"))
    if gap_out["card"] != gap_out["cpu"]:
        raise SystemExit("FAIL fill_gaps over SparseIntervals on the card "
                         "differs from the CPU run")
    if "".join(gap_out["card"][0]).encode() != api.map_(ref_s, idx_s,
                                                        fill_only):
        raise SystemExit("FAIL fill_gaps over intervals differs from map_ "
                         "with gap filling")
    if not gap_out["card"][1]:
        raise SystemExit("FAIL fill_gaps on the slice filled no gap")
    print(f"interval gap path: fill_gaps on {n254} bases over SparseIntervals "
          f"on the card equals the CPU run and map_ with gap filling alone "
          f"({gap_out['card'][1]} gaps filled)", flush=True)
    del gap_out, tr

    # the command line in-process on the pair written as FASTA: each verb's
    # output equals the rows formatted from the API results held above
    rle_rc = api.find_batch([revcomp_ascii(q) for q in q_list], index,
                            FindOpts(), device=cuda)
    rle_seq_rc = api.find_batch([revcomp_ascii(q) for q in q_list], seq_index,
                                FindOpts())

    def tsv(ref_file, target, ref_len, plus, minus):
        """find's TSV rows for the batch file (kbo_tpu_torch.cli.cmd_find's
        columns) from two RLE lists per query."""
        lines = []
        for qi in range(QN):
            for strand, rles in (("+", plus[qi]), ("-", minus[qi])):
                for rle, start, end in cli_mod._find_rows(rles, strand, QL):
                    length = rle.end - rle.start
                    ident = 100.0 * rle.matches / length if length else 0.0
                    cov = (100.0 * (rle.matches + rle.mismatches) / ref_len
                           if ref_len else 0.0)
                    lines.append(
                        f"batch.fa\t{ref_file}\t{start}\t{end}\t{strand}"
                        f"\t{length}\t{rle.mismatches}\t{rle.gap_bases}"
                        f"\t{rle.gap_opens}\t{ident:.2f}\t{cov:.2f}\tb{qi}"
                        f"\t{target}")
        return lines

    cli_ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        fa = {name: os.path.join(tmp, name)
              for name in ("ref.fa", "query.fa", "batch.fa")}
        with open(fa["ref.fa"], "wb") as fh:
            fh.write(b">ref\n" + ref + b"\n")
        with open(fa["query.fa"], "wb") as fh:
            fh.write(b">query\n" + query + b"\n")
        with open(fa["batch.fa"], "wb") as fh:
            fh.write(b"".join(b">b%d\n%s\n" % (i, q)
                              for i, q in enumerate(q_list)))
        prefix = os.path.join(tmp, "idx")

        def run_cli(label, argv):
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                cli_mod.main(argv, device=cuda)
            torch.cuda.synchronize()
            cli_ms[label] = (time.perf_counter() - t) * 1e3
            return out.getvalue()

        vcf = run_cli("call", ["call", "-k", str(K), "-r", fa["ref.fa"],
                               fa["query.fa"]]).splitlines()
        if vcf[0] != "##fileformat=VCFv4.4" or [
                line for line in vcf if not line.startswith("#")] != [
                cli_mod._vcf_row("ref", ref, v) for v in call_gpu]:
            raise SystemExit("FAIL cli call differs from the API's variants")
        header = run_cli("find", [
            "find", "-k", str(K), "-r", fa["query.fa"], fa["batch.fa"]
        ]).splitlines()
        if header[1:] != tsv("query.fa", "query.fa", len(query), rle_gpu,
                             rle_rc):
            raise SystemExit("FAIL cli find differs from the API's segments")
        got = run_cli("find --device-index", [
            "find", "-k", str(K), "--device-index", "-r", fa["query.fa"],
            fa["batch.fa"]]).splitlines()
        if got[1:] != tsv("query.fa", "query.fa", len(query), rle_seq_gpu,
                          rle_seq_rc):
            raise SystemExit("FAIL cli find --device-index differs from the "
                             "API's segments")
        got = run_cli("map", ["map", "-k", str(K), "-r", fa["ref.fa"],
                              fa["query.fa"]])
        if got != ">query.fa\n" + dmap_gpu[True].decode() + "\n":
            raise SystemExit("FAIL cli map differs from the API's map_")
        run_cli("build", ["build", "-k", str(K), "-o", prefix, fa["query.fa"]])
        got = run_cli("find -i", ["find", "-i", prefix, fa["batch.fa"]])
        if got.splitlines()[1:] != tsv("idx", "idx", None, rle_gpu, rle_rc):
            raise SystemExit("FAIL cli find -i on the built index differs "
                             "from the API's segments")
    print(f"cli: call ({len(call_gpu)} VCF rows), find, find --device-index, "
          f"map, build -o then find -i ({len(header) - 1} TSV rows) equal the "
          f"rows formatted from the API's results", flush=True)

    # ---- 6c. the mesh on the card: four shards on the one card (and every
    # card when there are two or more), each call against its single-device
    # twin above, byte for byte; launch counts and the route around each
    # call on the four-shard mesh, and the kernels at its per-shard shapes
    nsh = 4
    meshes = {"4 shards on cuda:0": pmesh.make_mesh(nsh, device="cuda:0")}
    if torch.cuda.device_count() >= 2:
        meshes[f"{torch.cuda.device_count()} cards"] = pmesh.make_mesh()
    print(f"mesh: {', '.join(meshes)} ({torch.cuda.device_count()} card(s) "
          f"visible)", flush=True)
    mesh_names = [(ms_mod, "merge_path"), (ms_mod, "clamp_scan"),
                  (pipeline_mod, "derandomize_translate"),
                  (mapsweep, "derandomize_translate")]
    mesh_args, mesh_routes, mesh_first_ms = {}, {}, {}

    def per_shard(m):
        return {**ONE_JOIN, "merge_path": m.devices.size,
                "clamp_scan": 2 * m.devices.size,
                "derandomize_translate": m.devices.size}

    def mesh_run(path, fn, want, m):
        """One call over mesh m: its output, with the launches held to
        want (a dict, or a function of the launches and the run's stats
        that says what is wrong) and the route its stats name, on the
        four-shard mesh."""
        reset_counts()
        reset_stats()
        t = time.perf_counter()
        out, args = capture(fn, mesh_names)
        torch.cuda.synchronize()
        ms_first = (time.perf_counter() - t) * 1e3
        got = {name: f.launches for name, f in counters.items()}
        stats = get_stats().as_dict()
        route = [key for key in stats if key.startswith("mesh_")]
        if m is meshes["4 shards on cuda:0"]:
            bad = want(got, stats) if callable(want) else (
                None if got == want else f"expected {want}")
            if bad:
                raise SystemExit(f"FAIL launches on the {path} path: {got}, "
                                 f"{bad}")
            launches[path], mesh_args[path] = got, args
            mesh_routes[path], mesh_first_ms[path] = route, ms_first
        return out, stats

    t6c = time.perf_counter()
    fo5 = FindOpts(max_gap_len=5)
    rle_gap_gpu = api.find_batch(q_list, index, fo5, device=cuda)
    long_chars, long_ms = pipeline_mod.matches_ms_batch(index, [codes],
                                                        threshold, cuda)
    if not np.array_equal(long_ms[0], ms_gpu[K - 1 : K - 1 + n].cpu().numpy()):
        raise SystemExit("FAIL the single-device pipeline's MS differs from "
                         "find-core's")
    for mname, m in meshes.items():
        nd = m.devices.size
        got, _ = mesh_run("find_batch mesh", lambda: api.find_batch(
            q_list, index, FindOpts(), mesh=m), per_shard(m), m)
        if got != rle_gpu:
            raise SystemExit(f"FAIL find_batch over the mesh ({mname}) differs "
                             "from the single-device call")
        got, _ = mesh_run("find_batch mesh max_gap_len=5", lambda: api.find_batch(
            q_list, index, fo5, mesh=m), per_shard(m), m)
        if got != rle_gap_gpu:
            raise SystemExit(f"FAIL find_batch max_gap_len=5 over the mesh "
                             f"({mname}) differs from the single-device call")
        (ch, msl), _ = mesh_run("matches_long_sharded", lambda: pmesh.
                                matches_long_sharded(index, codes, threshold, m),
                                per_shard(m), m)
        if not (np.array_equal(msl, long_ms[0])
                and np.array_equal(ch, long_chars[0])):
            raise SystemExit(f"FAIL matches_long_sharded ({mname}) differs "
                             "from the single-device pipeline and find-core's "
                             "MS")

        def call_counts(got, st):
            # the row's join, one interval join per anchor round, the k-mer
            # batch on every shard; two scans each for the row's join and
            # the k-mer batches, two for the vs-sequence join
            rounds = st["call_anchor_rounds"]
            want = {**ONE_JOIN, "merge_path": 1 + rounds + nsh,
                    "clamp_scan": 4 + 2 * nsh, "derandomize_translate": 0}
            return None if got == want else f"expected {want}"

        got, _ = mesh_run("call mesh", lambda: api.call(
            index, ref, copts(), mesh=m), call_counts, m)
        if tuples(got) != tuples(call_gpu):
            raise SystemExit(f"FAIL call over the mesh ({mname}) differs from "
                             "the single-device call")
        # the sequence-sharded map: stage 1 and the variant join's table on
        # every shard, the postprocess once
        seq_want = {**ONE_JOIN, "merge_path": 2 * nd, "clamp_scan": 4 * nd}
        for fmt in (True, False):
            got, st = mesh_run(f"map_batch mesh format={fmt}",
                               lambda: api.map_batch([ref], index, dopts(fmt),
                                                     mesh=m), seq_want, m)
            if got != [dmap_gpu[fmt]]:
                raise SystemExit(f"FAIL map_batch([genome]) over the mesh "
                                 f"({mname}) format={fmt} differs from map_")
            if st["variants_called"] != dstats[fmt]["variants_called"] or \
                    st["gaps_filled"] != dstats[fmt]["gaps_filled"]:
                raise SystemExit("FAIL map_batch over the mesh: counters "
                                 "differ from map_'s")

        def batch_counts(got, st):
            # the contig-sharded route: a sweep, a postprocess and a variant
            # join per shard; the classic one after a degrade: more
            if "mesh_route_data" in st:
                want = {**ONE_JOIN, "merge_path": 2 * nsh,
                        "clamp_scan": 4 * nsh, "derandomize_translate": nsh}
                return None if got == want else f"expected {want}"
            return None if got["merge_path"] >= 2 * nsh else "too few merges"

        got, _ = mesh_run("map_batch mesh 8 contigs", lambda: api.map_batch(
            contigs_of(ref), index, dopts(True), mesh=m), batch_counts, m)
        if got != dbatch_gpu:
            raise SystemExit(f"FAIL the 8-contig map_batch over the mesh "
                             f"({mname}) differs from the single-device call")
    print(f"mesh: find_batch[{QN}x{QL}] (max_gap_len 0 and 5), "
          f"matches_long_sharded over {n} bases, call, map_batch([genome]) "
          f"format true and false and the 8-contig map_batch equal their "
          f"single-device twins on {', '.join(meshes)}; routes "
          f"{json.dumps(mesh_routes)}; launches "
          f"{json.dumps({p: launches[p] for p in mesh_routes})}", flush=True)

    # the classic mesh route once (k = 151: the host refinement, about 3 s)
    def classic_mesh_counts(got, st):
        # the sweep on every shard, then per contig the interval probe's
        # join(s) and call's k-mer batch on every shard, its vs-sequence join
        c = len(contigs)
        want_scans = 2 * nsh + c * (2 * nsh + 2)
        if got["clamp_scan"] != want_scans or \
                got["derandomize_translate"] != nsh or \
                got["merge_path"] < nsh + c * (1 + nsh):
            return f"expected {want_scans} scans, {nsh} derandomize_" \
                   f"translate, {nsh + c * (1 + nsh)} or more merges"
        return None

    m4 = meshes["4 shards on cuda:0"]
    got, _ = mesh_run(f"map_batch mesh k={K151}", lambda: api.map_batch(
        contigs, idx151, opts151(True), mesh=m4), classic_mesh_counts, m4)
    if got != cbatch_gpu:
        raise SystemExit(f"FAIL the 8-contig map_batch at k={K151} over the "
                         "mesh differs from the single-device call")
    print(f"mesh: map_batch[8x{len(contigs[0])}] k={K151} over 4 shards "
          f"(route {mesh_routes[f'map_batch mesh k={K151}']}) equals the "
          f"single-device call; {mesh_first_ms[f'map_batch mesh k={K151}']:.1f}"
          f" ms (one run, host clock)", flush=True)

    # the kernels at the four-shard mesh's shapes, against their plain
    # versions: a shard of the find batch, a chunk of the sequence-sharded
    # map's stage 1 and its per-shard variant join, a shard of the contig-
    # sharded batch
    ma = mesh_args
    mesh_shapes = {
        "mesh batch shard": ma["find_batch mesh"]["merge_path"][0],
        "mesh seq chunk": ma["map_batch mesh format=True"]["merge_path"][0],
        "mesh seq variant join":
            ma["map_batch mesh format=True"]["merge_path"][nsh],
        "mesh 8-contig shard":
            ma["map_batch mesh 8 contigs"]["merge_path"][0],
    }
    mesh_scans = {
        "mesh batch shard": ma["find_batch mesh"]["clamp_scan"][0],
        "mesh seq chunk": ma["map_batch mesh format=True"]["clamp_scan"][0],
        "mesh seq variant join":
            ma["map_batch mesh format=True"]["clamp_scan"][2 * nsh],
        "mesh 8-contig shard":
            ma["map_batch mesh 8 contigs"]["clamp_scan"][0],
    }
    mesh_dt = {"mesh batch shard":
               ma["find_batch mesh"]["derandomize_translate"][0]}
    if ma["map_batch mesh 8 contigs"]["derandomize_translate"]:
        mesh_dt["mesh 8-contig shard"] = \
            ma["map_batch mesh 8 contigs"]["derandomize_translate"][0]
    for label, ops in mesh_shapes.items():
        check("merge_path", f"{label} W={ops[0].shape[0]} "
              f"na={ops[0].shape[1]} nb={ops[2].shape[1]}",
              merge_path(*ops), merge_path_plain(*ops))
    for label, (sw, cp, bits) in mesh_scans.items():
        for rev in (False, True):
            check("clamp_scan", f"{label} bits={bits} W={sw.shape[0]} "
                  f"reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cp, bits, rev)],
                  [clamp_scan_plain(sw, cp, bits, rev)])
    for label, (dms, _k, _t, dtl) in mesh_dt.items():
        check_dt(f"{label} {dms.shape[0]}x{dms.shape[1]} (strided rows)", dms,
                 dtl)
    del ma

    # two processes on the one card, joined by a gloo group: each brings a
    # 2-shard mesh on cuda:0, matches_batch_sharded runs over the 4-shard
    # global mesh, and map_batch's per-process halves merge with one
    # process_allgather; both must write the single process's digests.
    # Then the full-width calls over meshes that span both processes
    # (_two_process_calls, phase 5's index saved once for both), each equal
    # to its one-process twin in both processes, their routes agreeing
    t = time.perf_counter()
    want_digests = _mesh_digests(pmesh.make_mesh(4, device="cuda:0"), None)
    want_calls = {
        "map_batch([genome])": _out_digest([dmap_gpu[True]]),
        "map_batch 8 contigs": _out_digest(dbatch_gpu),
        "call": _out_digest(call_gpu),
        "map_batch_index_sharded": _out_digest([dmap_gpu[True]]),
        "map_batch_2d_sharded 4 x 2": _out_digest(dbatch_gpu),
    }
    with tempfile.TemporaryDirectory() as tmp:
        t_save = time.perf_counter()
        index_path = serialize.save_index(os.path.join(tmp, "index"), index)
        t_save = time.perf_counter() - t_save
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        outs = [os.path.join(tmp, f"worker_{r}.json") for r in range(2)]
        here = os.path.dirname(os.path.abspath(__file__))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             outs[r], "--mesh-index", index_path, "--genome", str(n)],
            env=dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                     LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     PYTHONPATH=here + os.pathsep
                     + os.environ.get("PYTHONPATH", "")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ) for r in range(2)]
        try:
            for r, proc in enumerate(procs):
                out, err = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    raise SystemExit(f"FAIL mesh worker {r} exited "
                                     f"{proc.returncode}: {err[-2000:]}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        two_proc = []
        for o in outs:
            with open(o) as fh:
                two_proc.append(json.load(fh))
    got_digests = [w["digests"] for w in two_proc]
    if got_digests[0] != got_digests[1] or got_digests[0] != want_digests:
        raise SystemExit(f"FAIL the two-process mesh run's digests "
                         f"{got_digests} differ from one process's "
                         f"{want_digests}")

    def two_proc_want(name, row):
        """One process's launches in the two-process run: its own 2 shards'
        joins, and the stages each process runs once (the sequence-sharded
        postprocess, call's row join and anchor rounds, the index-sharded
        map's finish), or per local data row."""
        if name == "map_batch([genome])":
            return {"merge_path": 4, "clamp_scan": 8,
                    "derandomize_translate": 1}
        if name == "map_batch 8 contigs":
            return {"merge_path": 4, "clamp_scan": 8,
                    "derandomize_translate": 2}
        if name == "call":
            return {"merge_path": 3 + row["stats"]["call_anchor_rounds"],
                    "clamp_scan": 8, "derandomize_translate": 0}
        rows = 1 if name == "map_batch_index_sharded" else 2
        tries = row["launches"]["derandomize_translate"]
        if not rows <= tries <= 3 * rows:
            return f"{rows} to {3 * rows} finishes"
        return {"merge_path": 2 * rows + tries,
                "clamp_scan": 4 * rows + 2 * tries,
                "derandomize_translate": tries}

    for name, (twin, _) in TWO_PROC_CALLS.items():
        rows = [w["calls"][name] for w in two_proc]
        for r, row in enumerate(rows):
            if row["digest"] != want_calls[name]:
                raise SystemExit(f"FAIL two processes: {name} in process {r} "
                                 f"differs from {twin}")
            want = two_proc_want(name, row)
            if row["launches"] != want:
                raise SystemExit(f"FAIL two processes: {name}'s launches in "
                                 f"process {r} {row['launches']}, expected "
                                 f"{want}")
        routes = [sorted(k for k in row["stats"] if k.startswith("mesh_"))
                  for row in rows]
        if routes[0] != routes[1] or (name in ("map_batch([genome])",
                                               "map_batch 8 contigs", "call")
                                      and routes[0] != sorted(mesh_routes[
                                          TWO_PROC_CALLS[name][1]])):
            raise SystemExit(f"FAIL two processes: {name}'s routes {routes} "
                             f"differ from each other or one process's")
        st = rows[0]["stats"]
        print(f"mesh: two processes (cuda:0 each, 4 shards"
              + (", a 4 x 2 grid" if "2d" in name else "") + f"): {name} "
              f"equals {twin} in both; route "
              f"{routes[0] or 'none (no routing)'}; launches per process "
              f"{rows[0]['launches']} / {rows[1]['launches']}; dist_bytes "
              f"{st.get('dist_bytes', 0)} in {st.get('dist_calls', 0)} calls "
              f"({st.get('dist_s', 0) * 1e3:.3f} ms)"
              + (f"; left extension {st.get('left_ext_rounds', 0)} rounds "
                 f"over {st.get('left_ext_lanes', 0)} lanes (process 1: "
                 f"{rows[1]['stats'].get('left_ext_rounds', 0)} over "
                 f"{rows[1]['stats'].get('left_ext_lanes', 0)})"
                 if "sharded" in name else "")
              + f"; peak memory {rows[0]['peak_bytes'] / 2**30:.3f} / "
              f"{rows[1]['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    print(f"mesh: two processes on the one card (gloo, 2 x 2 shards): "
          f"matches_batch_sharded and the per-process map merge equal one "
          f"process's digests, and the five full-width calls their twins "
          f"(index saved in {t_save:.1f}s, loaded in "
          f"{two_proc[0]['load_s']:.1f} / {two_proc[1]['load_s']:.1f}s; "
          f"peak memory per process "
          f"{max(c['peak_bytes'] for c in two_proc[0]['calls'].values()) / 2**30:.3f}"
          f" / {max(c['peak_bytes'] for c in two_proc[1]['calls'].values()) / 2**30:.3f}"
          f" GiB; {time.perf_counter() - t:.1f}s with the children's start); "
          f"phase 6c {time.perf_counter() - t6c:.1f}s", flush=True)

    # ---- 6d. the single-core engine as the oracle at bench size: the
    # native map (native.map_e2e, one CPU core, the host index above)
    # against phase 5's default map_ byte for byte; the native streaming MS
    # and intervals against the card's query_ms_device (the 3-bit join and
    # the interval probe, about 14 M merged slots) at every position; native
    # derandomize + translate against the card's derandomize_translate on
    # the same row
    t6d = time.perf_counter()
    t = time.perf_counter()
    nat_out, nat_var = native.map_e2e(index, ref, threshold, 1e-7)
    t_native = (time.perf_counter() - t) * 1e3
    dmap = dmap_gpu[True]
    if len(nat_out) != len(dmap):
        raise SystemExit(f"FAIL native map_e2e gives {len(nat_out)} bytes, "
                         f"the card's map_ {len(dmap)}")
    mismatches = int((np.frombuffer(nat_out, np.uint8)
                      != np.frombuffer(dmap, np.uint8)).sum())
    print(f"{tag} native map_e2e over {n} bases (one CPU core, host clock, "
          f"one run): {t_native:.3f} ms ({n / t_native * 1e3 / 1e6:.2f} "
          f"Mbases/s), {nat_var} variants called (the card's map_: "
          f"{dstats[True]['variants_called']} resolved); byte mismatches "
          f"against the card's default map_: {mismatches}", flush=True)
    if mismatches:
        raise SystemExit(f"FAIL native map_e2e and the card's map_ differ at "
                         f"{mismatches} bytes")
    t = time.perf_counter()
    nat_ms, nat_iv = native.ms_stream(index, codes)
    t_stream = (time.perf_counter() - t) * 1e3
    reset_counts()
    (qms, qiv), qargs = capture(lambda: ms_mod.query_ms_device(dev, codes),
                                [(ms_mod, "merge_path"),
                                 (ms_mod, "clamp_scan")])
    launches["query_ms_device"] = read_counts(
        "query_ms_device",
        {**ONE_JOIN, "merge_path": 2, "derandomize_translate": 0})
    if not (np.array_equal(qms, nat_ms) and np.array_equal(qiv, nat_iv)):
        bad = int(((qms != nat_ms) | (qiv != nat_iv).any(axis=1)).sum())
        raise SystemExit(f"FAIL query_ms_device differs from native ms_stream "
                         f"at {bad} positions")
    t = time.perf_counter()
    nat_chars = native.translate(native.derandomize(nat_ms, K, threshold), K,
                                 threshold)
    t_nat_dt = (time.perf_counter() - t) * 1e3
    ms_row = torch.from_numpy(nat_ms.astype(np.int32)).to(cuda)
    card_chars = derandomize_translate(ms_row, K, threshold).cpu().numpy()
    if not np.array_equal(card_chars, nat_chars):
        raise SystemExit(f"FAIL derandomize_translate differs from native "
                         f"derandomize + translate at "
                         f"{int((card_chars != nat_chars).sum())} positions")
    ref_shapes = {"reference ms3": qargs["merge_path"][0],
                  "reference intervals": qargs["merge_path"][1]}
    ref_scans = {"reference ms3": qargs["clamp_scan"][0]}
    for label, ops in ref_shapes.items():
        check("merge_path", f"{label} W={ops[0].shape[0]} "
              f"na={ops[0].shape[1]} nb={ops[2].shape[1]}",
              merge_path(*ops), merge_path_plain(*ops))
    for label, (sw, cp, bits) in ref_scans.items():
        for rev in (False, True):
            check("clamp_scan", f"{label} bits={bits} W={sw.shape[0]} "
                  f"reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cp, bits, rev)],
                  [clamp_scan_plain(sw, cp, bits, rev)])
    print(f"native: ms_stream over {n} bases ({t_stream:.3f} ms, host clock) "
          f"equals the card's query_ms_device, MS and intervals at every "
          f"position (launches {json.dumps(launches['query_ms_device'])}); "
          f"native derandomize + translate ({t_nat_dt:.3f} ms) equals the "
          f"card's derandomize_translate on the same row; phase 6d "
          f"{time.perf_counter() - t6d:.1f}s", flush=True)
    del qms, qiv, nat_ms, nat_iv, ms_row, card_chars, nat_chars

    # ---- 6e. the model axis: the key table split over four shards on the
    # one card (Sharded3Index, no shard holding the whole table), the
    # index-sharded rows sweep over the streamed side against the
    # single-device ms3_rows_sweep, the index-sharded matches over phase
    # 4's batch against the single-device matches_batch, with launch counts;
    # then the kernels at the per-shard shapes against their plain versions
    t6e = time.perf_counter()
    mm = pmesh.make_mesh(4, axis="model", device="cuda:0")
    t = time.perf_counter()
    sidx = pmesh.Sharded3Index(index, mm)
    torch.cuda.synchronize()
    t_sidx = (time.perf_counter() - t) * 1e3
    whole = index.keys3.nbytes + 2 * index.n_rows
    for i in range(mm.devices.size):
        lo = i * sidx.shard_cols
        real = max(0, min(sidx.shard_cols, index.n_rows - lo))
        print(f"model shard {i} on {mm.devices[i]}: keys3 columns [{lo}, "
              f"{lo + sidx.shard_cols}) ({real} rows, "
              f"{sidx.shard_cols - real} pad), {sidx.shard_bytes} B of the "
              f"whole table's {whole} B", flush=True)
    model_names = [(ms_mod, "merge_path"), (ms_mod, "clamp_scan"),
                   (pmesh, "derandomize_translate")]
    PER_MODEL = {**ONE_JOIN, "merge_path": 4, "clamp_scan": 8}
    reset_counts()
    rows_sh, margs_rows = capture(
        lambda: pmesh.ms3_rows_sweep_index_sharded(sidx, mcodes, mm),
        model_names)
    launches["ms3_rows_sweep_index_sharded"] = read_counts(
        "ms3_rows_sweep_index_sharded",
        {**PER_MODEL, "derandomize_translate": 0})
    uq = single[1]
    if not (torch.equal(rows_sh[0], single[0]) and torch.equal(rows_sh[1], uq)
            and torch.equal(rows_sh[2][uq], single[2][uq])):
        raise SystemExit("FAIL ms3_rows_sweep_index_sharded differs from the "
                         "single-device ms3_rows_sweep")
    bcode_list = [encode_ascii(q) for q in q_list]
    match_single = pipeline_mod.matches_batch(index, bcode_list, threshold,
                                              cuda)
    reset_counts()
    match_sh, margs_match = capture(
        lambda: pmesh.matches_batch_index_sharded(index, bcode_list,
                                                  threshold, mm),
        model_names)
    launches["matches_batch_index_sharded"] = read_counts(
        "matches_batch_index_sharded", PER_MODEL)
    if len(match_sh) != QN or not all(
            np.array_equal(a, b) for a, b in zip(match_sh, match_single)):
        raise SystemExit("FAIL matches_batch_index_sharded differs from the "
                         "single-device matches_batch")
    model_shapes = {"model rows shard": margs_rows["merge_path"][0],
                    "model matches shard": margs_match["merge_path"][0]}
    model_scans = {"model rows shard": margs_rows["clamp_scan"][0],
                   "model matches shard": margs_match["clamp_scan"][0]}
    model_dt = {"model matches shard":
                margs_match["derandomize_translate"][0]}
    for label, ops in model_shapes.items():
        check("merge_path", f"{label} W={ops[0].shape[0]} "
              f"na={ops[0].shape[1]} nb={ops[2].shape[1]}",
              merge_path(*ops), merge_path_plain(*ops))
    for label, (sw, cp, bits) in model_scans.items():
        for rev in (False, True):
            check("clamp_scan", f"{label} bits={bits} W={sw.shape[0]} "
                  f"reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cp, bits, rev)],
                  [clamp_scan_plain(sw, cp, bits, rev)])
    for label, (dms, _k, _t, dtl) in model_dt.items():
        check_dt(f"{label} {dms.shape[0]}x{dms.shape[1]}", dms, dtl)
    print(f"model: Sharded3Index over 4 shards on cuda:0 built in "
          f"{t_sidx:.3f} ms (host clock, one run); "
          f"ms3_rows_sweep_index_sharded over {Lm} positions "
          f"({int(uq.sum())} unique) equals ms3_rows_sweep; "
          f"matches_batch_index_sharded[{QN}x{QL}] equals matches_batch; "
          f"launches {json.dumps({p: launches[p] for p in ('ms3_rows_sweep_index_sharded', 'matches_batch_index_sharded')})}"
          f"; phase 6e {time.perf_counter() - t6e:.1f}s", flush=True)
    del rows_sh, match_sh

    # the map over the sharded table: map_batch_index_sharded over the four
    # model shards against phase 5's default map_ byte for byte (which
    # phase 6d holds to native.map_e2e), then map_batch_2d_sharded over a
    # 2 x 4 (data, model) mesh on the card against the single-device
    # map_batch of the 8 contigs; launches (4 partial joins, then one
    # variant join and one derandomize_translate per finish, per data row
    # on the 2-D mesh), the search loop's rounds and lanes and the gaps sent
    # to the host (run stats); then the kernels at these calls' shapes
    t6e2 = time.perf_counter()
    sharded_names = model_names + [
        (mapsweep, "derandomize_translate"),
        (pmesh, "sharded_score_gaps"), (pmesh, "sharded_resolve_variants"),
        (refine_mod, "left_extend_device")]

    def sharded_run(path, fn, rows, model=4):
        """One sharded map: its output, stats and captured arguments, the
        launches held to `rows` model groups each running `model` partial
        joins and, per finish, 1 derandomize_translate and 1 variant
        join."""
        reset_counts()
        reset_stats()
        out, args = capture(fn, sharded_names)
        torch.cuda.synchronize()
        got = {name: f.launches for name, f in counters.items()}
        tries = got["derandomize_translate"]
        want = {**ONE_JOIN, "merge_path": model * rows + tries,
                "clamp_scan": 2 * model * rows + 2 * tries,
                "derandomize_translate": tries}
        if got != want or not rows <= tries <= 3 * rows:
            raise SystemExit(f"FAIL launches on the {path} path: {got}, "
                             f"expected {want} with {rows} to {3 * rows} "
                             f"finishes")
        launches[path] = got
        return out, get_stats().as_dict(), args

    ish_out, ish_stats, ish_args = sharded_run(
        "map_batch_index_sharded", lambda: pmesh.map_batch_index_sharded(
            [ref], index, dopts(True), mm), 1)
    if ish_out != [dmap_gpu[True]]:
        raise SystemExit("FAIL map_batch_index_sharded over 4 model shards "
                         "differs from the default map_")
    mesh2d = pmesh.make_mesh((2, 4), axis=("data", "model"), device="cuda:0")
    sidx2d = pmesh.Sharded3Index(index, mesh2d)
    if sidx2d.group(0) is not sidx2d.group(1) or len({
            id(t) for r in (0, 1) for t in sidx2d.tables(r)}) != 4:
        raise SystemExit("FAIL the 2 x 4 mesh on one card holds other than "
                         "four key shards")
    del sidx2d
    d2_opts, d2_twin = dopts(True), dbatch_gpu
    d2_out, d2_stats, d2_args = sharded_run(
        "map_batch_2d_sharded", lambda: pmesh.map_batch_2d_sharded(
            contigs, index, d2_opts, mesh2d), 2)
    d2_host = 0
    if d2_out is None:
        # a gap needs the exact host evaluator: kbo_tpu's returns None too;
        # without gap filling no gap goes to the host
        d2_host, d2_none = d2_stats.get("gaps_to_host", 0), d2_stats
        if not d2_host:
            raise SystemExit("FAIL map_batch_2d_sharded returned None with "
                             "no gap for the host evaluator")
        d2_opts = MapOpts(fill_gaps=False, sbwt_build_opts=BuildOpts(
            k=K, build_select=True))
        d2_twin = api.map_batch(contigs, index, d2_opts, device=cuda)
        d2_out, d2_stats, d2_args = sharded_run(
            "map_batch_2d_sharded", lambda: pmesh.map_batch_2d_sharded(
                contigs, index, d2_opts, mesh2d), 2)
    if d2_out != d2_twin:
        raise SystemExit("FAIL map_batch_2d_sharded over 2 x 4 differs from "
                         "the single-device map_batch")
    # the 2-D map's own refinement at full size: over 4 x 2 a data row holds
    # 2 of the 8 contigs, whose left extension fits cap_ext, so no gap goes
    # to the host and MapOpts() maps them all, equal to the single-device
    # map_batch
    mesh42 = pmesh.make_mesh((4, 2), axis=("data", "model"), device="cuda:0")
    d42_out, d42_stats, d42_args = sharded_run(
        "map_batch_2d_sharded 4 x 2", lambda: pmesh.map_batch_2d_sharded(
            contigs, index, dopts(True), mesh42), 4, 2)
    if d42_out is None:
        raise SystemExit(f"FAIL map_batch_2d_sharded over 4 x 2 returned "
                         f"None ({d42_stats.get('gaps_to_host', 0)} gaps "
                         f"for the host evaluator)")
    if d42_out != dbatch_gpu:
        raise SystemExit("FAIL map_batch_2d_sharded over 4 x 2 differs from "
                         "the single-device map_batch")
    if not d42_stats.get("gaps_filled") or not d42_stats.get(
            "left_ext_rounds"):
        raise SystemExit(f"FAIL map_batch_2d_sharded over 4 x 2 filled no "
                         f"gap through the search loop: {d42_stats}")
    # the kernels at the new per-shard shapes: a 2-D stage-1 shard (a data
    # row's contigs against a quarter of the table, over 4 x 2 against
    # half), the index-sharded and the 2-D variant joins,
    # derandomize_translate over a data row's block; the 4 x 2 grid's are
    # also the two-process run's (phase 6c: the same grid over two
    # processes)
    ia, da, d42 = ish_args, d2_args, d42_args
    shard_shapes = {
        "model map variant join": ia["merge_path"][4],
        "2-D stage-1 shard": da["merge_path"][0],
        "2-D variant join": da["merge_path"][8],
        "4 x 2 stage-1 shard": d42["merge_path"][0],
        "4 x 2 variant join": d42["merge_path"][8],
    }
    shard_scans = {
        "model map variant join": ia["clamp_scan"][8],
        "2-D stage-1 shard": da["clamp_scan"][0],
        "2-D variant join": da["clamp_scan"][16],
        "4 x 2 stage-1 shard": d42["clamp_scan"][0],
        "4 x 2 variant join": d42["clamp_scan"][16],
    }
    shard_dt = {"model map postprocess": ia["derandomize_translate"][0],
                "2-D data row": da["derandomize_translate"][0],
                "4 x 2 data row": d42["derandomize_translate"][0]}
    for label, ops in shard_shapes.items():
        check("merge_path", f"{label} W={ops[0].shape[0]} "
              f"na={ops[0].shape[1]} nb={ops[2].shape[1]}",
              merge_path(*ops), merge_path_plain(*ops))
    for label, (sw, cp, bits) in shard_scans.items():
        for rev in (False, True):
            check("clamp_scan", f"{label} bits={bits} W={sw.shape[0]} "
                  f"reverse={rev} M={sw.shape[1]}",
                  [clamp_scan(sw, cp, bits, rev)],
                  [clamp_scan_plain(sw, cp, bits, rev)])
    for label, (dms, _k, _t, dtl) in shard_dt.items():
        check_dt(f"{label} {dms.shape[0]}x{dms.shape[1]}", dms, dtl)
    # the sharded refinement's stages and the search loop, timed in phase 7
    # on the first finish's arguments
    sg_args = ish_args["sharded_score_gaps"][0]
    sv_args = ish_args["sharded_resolve_variants"][0]
    le_args = ish_args["left_extend_device"][0]
    print(f"model map: map_batch_index_sharded over {n} bases on 4 model "
          f"shards equals the default map_ (launches "
          f"{json.dumps(launches['map_batch_index_sharded'])}; left "
          f"extension {ish_stats.get('left_ext_rounds', 0)} rounds over "
          f"{ish_stats.get('left_ext_lanes', 0)} lanes; gaps to the host "
          f"{ish_stats.get('gaps_to_host', 0)}; variants "
          f"{ish_stats.get('variants_called')}, gaps filled "
          f"{ish_stats.get('gaps_filled')}); map_batch_2d_sharded over 2 x 4 "
          f"on cuda:0 "
          + (f"returned None (gaps for the host evaluator: {d2_host}; its "
             f"left extension {d2_none.get('left_ext_rounds', 0)} rounds over "
             f"{d2_none.get('left_ext_lanes', 0)} lanes), and with "
             f"fill_gaps=False " if d2_host else "")
          + f"equals the single-device map_batch of the {len(contigs)} "
          f"contigs (launches {json.dumps(launches['map_batch_2d_sharded'])}"
          f"; left extension {d2_stats.get('left_ext_rounds', 0)} rounds "
          f"over {d2_stats.get('left_ext_lanes', 0)} lanes); over 4 x 2 "
          f"with MapOpts() it equals the single-device map_batch (launches "
          f"{json.dumps(launches['map_batch_2d_sharded 4 x 2'])}; left "
          f"extension {d42_stats.get('left_ext_rounds', 0)} rounds over "
          f"{d42_stats.get('left_ext_lanes', 0)} lanes; gaps to the host "
          f"{d42_stats.get('gaps_to_host', 0)}; variants "
          f"{d42_stats.get('variants_called')}, gaps filled "
          f"{d42_stats.get('gaps_filled')}); "
          f"{time.perf_counter() - t6e2:.1f}s", flush=True)
    del ish_out, d2_out, d42_out

    # ---- 7. times on the card
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

    def run_ms(fn, n=10):
        """Per-call time in runs of n back-to-back calls: the host's work
        in the wrapper overlaps the card's, so this is the kernel's own."""
        def run():
            for _ in range(n):
                fn()
        return dev_ms(run) / n

    def host_ms(fn, reps=REPS):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
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

    t_maps = {}
    for label, opts_of in (("MapOpts()", dopts), ("refinements off", mopts)):
        for fmt in (True, False):
            t_map = t_maps[label, fmt] = host_ms(
                lambda: api.map_(ref, index, opts_of(fmt), device=cuda))
            print(f"{tag} map_ {label} format={fmt}: {t_map:.3f} ms "
                  f"({n / t_map * 1e3 / 1e6:.2f} Mbases/s) over {n} bases, "
                  f"host clock around the call", flush=True)
        t_mb = t_maps[label, "batch"] = host_ms(
            lambda: api.map_batch(contigs, index, opts_of(True), device=cuda))
        print(f"{tag} map_batch[8x{len(contigs[0])}] {label}: {t_mb:.3f} ms "
              f"({8 * len(contigs[0]) / t_mb * 1e3 / 1e6:.2f} Mbases/s)",
              flush=True)

    # map_ by stage, as api.map_batch runs them for this one contig
    cap_d, cap_g = _pow2_cap(Lm // 1024), _pow2_cap(Lm // 1536)
    w_grid = max(K - threshold + 1, 1)

    def upload():
        packed_up = mapsweep.pack_ascii_host(ref_mat, seq_lens)
        return mapsweep.decode_packed4_encode_device(
            *(torch.from_numpy(a).to(cuda) for a in packed_up), map_tl
        )

    def upload_plain():
        packed_up = mapsweep.pack_ascii_plain(ref_mat, seq_lens)
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

    def finish(opts=mopts(True), tables=None):
        return map_devref_finish(
            dev, codes_dev, map_tl, single[0], chars_dev, pieces, _packed,
            [ref], index, opts, threshold, cap_d, cap_g,
            total_gap_slack=cap_g * 2 + 64, ref_mat=ref_mat,
            ref_mat_dev=ref_mat_dev, seq_tables=tables,
        )

    if finish()[0] != out_t:
        raise SystemExit("FAIL staged map run differs from api.map_")
    # the default map_'s refinement stages on the same candidate tables:
    # the sweep with its sorted query table, gap scoring (with the
    # per-index extension table, built once per index), variant resolution
    # (its join against the sweep's table), then the whole finish
    qtab = mapsweep.ms3_rows_sweep(dev.keys3, dev.rows_packed, codes_dev, K,
                                   want_qtable=True)[3]
    cap_ext = _pow2_cap(max(4 * cap_g, 32), lo=256)

    def gaps():
        return score_gaps_core(
            dev.keys3, ref_mat_dev, map_tl, pieces["gap_start"],
            pieces["gap_end_at"], pieces["grid"], threshold, K, cap_g,
            cap_ext, get_ext_table(dev), prob_bound(1e-7))

    def variants():
        return resolve_variants_core(
            dev.keys3, None, codes_dev, ref_mat_dev, single[0], map_tl,
            pieces["drop_pos"], pieces["apos"], pieces["arow"], threshold, K,
            cap_d, d_lo=threshold - 1, seq_tables=qtab)

    if finish(dopts(True), qtab)[0] != dmap_gpu[True]:
        raise SystemExit("FAIL staged default map run differs from api.map_")
    # the variant join with merge="bitonic" gives the same patches
    want_v = variants()
    reset_counts()
    got_v = resolve_variants_core(
        dev.keys3, None, codes_dev, ref_mat_dev, single[0], map_tl,
        pieces["drop_pos"], pieces["apos"], pieces["arow"], threshold, K,
        cap_d, d_lo=threshold - 1, seq_tables=qtab, merge="bitonic")
    launches["resolve_variants_core merge=bitonic"] = read_counts(
        "resolve_variants_core merge=bitonic", only_bitonic)
    if not all(torch.equal(x, y) for x, y in zip(got_v, want_v)):
        raise SystemExit("FAIL resolve_variants_core merge=bitonic differs "
                         "from merge=path")
    print(f"merge=bitonic: resolve_variants_core over {cap_d} drop slots "
          f"equals merge=path ({int(want_v[2])} variants)", flush=True)
    del got_v, want_v
    # gap filling at full width: every gap run of the sweep's table through
    # the host evaluator, from the device grid and from colex intervals
    # (SparseIntervals over the card-resident MS row), patch for patch
    block = _packed.cpu().numpy()[0]
    ng = int(block[1])
    gp = block[2:]
    runs_dev = [(int(a), int(b)) for a, b in zip(
        gp[cap_d : cap_d + ng], gp[cap_d + cap_g : cap_d + cap_g + ng])]
    goff = 3 * cap_d + 2 * cap_g
    grid_all = gp[goff : goff + cap_g * w_grid].reshape(cap_g, w_grid)[:ng]
    translation = list(out_f.decode())
    if runs_dev != gap_filling._gap_runs(translation, threshold):
        raise SystemExit("FAIL the sweep's gap runs differ from the host's")
    ms_row_gap = ms_mod.query_ms_row_device(dev, codes)

    def gaps_grid():
        return gap_filling.fill_gaps_patches(
            runs_dev, None, ref, index, threshold, 1e-7, grid=grid_all)

    def gaps_intervals():
        iv = engine_mod.SparseIntervals(index, codes, ms=ms_row_gap)
        return gap_filling.fill_gaps_patches(
            runs_dev, iv, ref, index, threshold, 1e-7)

    def gaps_fill():
        iv = engine_mod.SparseIntervals(index, codes, ms=ms_row_gap)
        return gap_filling.fill_gaps(translation, None, iv, ref, index,
                                     threshold, 1e-7)

    patches_grid, patches_iv = gaps_grid(), gaps_intervals()
    if patches_iv != patches_grid:
        raise SystemExit("FAIL gap patches from intervals differ from the "
                         "grid's")
    # host numpy of about half a second a call: medians of 3
    print(f"{tag} gap filling at full width over {ng} gap runs: "
          f"{len(patches_iv)} patches from intervals, {len(patches_grid)} "
          f"from the device grid (equal); fill_gaps_patches from intervals "
          f"{host_ms(gaps_intervals, 3):.3f} ms, from the grid "
          f"{host_ms(gaps_grid, 3):.3f} ms; fill_gaps over the {n}-base "
          f"translation {host_ms(gaps_fill, 3):.3f} ms (host clock, medians "
          f"of 3)", flush=True)
    del translation, ms_row_gap, grid_all

    # device stages by CUDA events; the stages that begin or end on the
    # host (the pack before the upload, paint after the fetch) by the host
    # clock around a synchronise
    for name, fn, clock in (
        ("upload+decode (native pack included, host clock)", upload, host_ms),
        ("upload+decode with the numpy pack (not on the path, host clock)",
         upload_plain, host_ms),
        ("pack alone, native (host clock)",
         lambda: mapsweep.pack_ascii_host(ref_mat, seq_lens), host_ms),
        ("pack alone, numpy (not on the path, host clock)",
         lambda: mapsweep.pack_ascii_plain(ref_mat, seq_lens), host_ms),
        ("ms3_rows_sweep", sweep, dev_ms),
        ("ms3_rows_sweep want_qtable (MapOpts())", lambda: mapsweep.ms3_rows_sweep(
            dev.keys3, dev.rows_packed, codes_dev, K, want_qtable=True), dev_ms),
        ("map_postprocess3_core", post, dev_ms),
        ("score_gaps_core (MapOpts())", gaps, dev_ms),
        ("resolve_variants_core with its join (MapOpts())", variants, dev_ms),
        ("assemble + fetch + paint (host clock)", finish, host_ms),
        ("refine + assemble + fetch + paint (MapOpts(), host clock)",
         lambda: finish(dopts(True), qtab), host_ms),
        ("build_ext_table_core (once per index, not per call)",
         lambda: build_ext_table_core(dev.keys3, K), dev_ms),
        (f"ext_walk, the host gap pass's {w_rows.shape[0]} lanes to width "
         f"{w_width}", lambda: ext_walk(*walk_ops), dev_ms),
        ("ext_walk_plain, the same lanes (not on the path)",
         lambda: ext_walk_plain(*walk_ops), dev_ms),
    ):
        print(f"{tag} map_ stage {name}: {clock(fn):.3f} ms", flush=True)
    del _packed
    for label, opts in (("MapOpts()", dopts(True)),
                        ("refinements off", mopts(True))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        api.map_(ref, index, opts, device=cuda)
        torch.cuda.synchronize()
        print(f"{tag} map_ {label} peak device memory: "
              f"{(torch.cuda.max_memory_allocated() - base_mem) / 2**20:.1f} "
              f"MiB above the {base_mem / 2**20:.1f} MiB the script holds",
              flush=True)

    # the 2-bit map path at k = 151: host clock around the call (medians of
    # 3, each call about a second), its host steps from the run's stats,
    # and its device stages alone (CUDA events; the fetches by the host
    # clock around a synchronise)
    c_stats = []

    def one_map151():
        reset_stats()
        api.map_(ref, idx151, opts151(True), device=cuda)
        c_stats.append(get_stats().as_dict())

    t_map151 = host_ms(one_map151, 3)
    c_stats = c_stats[1:]
    print(f"{tag} map_ k={K151} MapOpts() format=True (2-bit path): "
          f"{t_map151:.3f} ms ({n / t_map151 * 1e3 / 1e6:.2f} Mbases/s) over "
          f"{n} bases, host clock, median of 3", flush=True)
    for label, fn in (
        (f"map_batch[8x{len(contigs[0])}] k={K151}",
         lambda: api.map_batch(contigs, idx151, opts151(True), device=cuda)),
        (f"map_ k={K254} on {n254} bases",
         lambda: api.map_(ref[:n254], idx254, opts254(True), device=cuda)),
        (f"map_ k={K} through the 2-bit flow (the default route: "
         f"{t_maps['MapOpts()', True]:.3f} ms)",
         lambda: api._map_classic([ref], index, dopts(True), cuda)),
    ):
        t_maps[label] = host_ms(fn, 3)
        print(f"{tag} {label}: {t_maps[label]:.3f} ms (host clock, median "
              f"of 3)", flush=True)
    for st_name in ("map_sweep", "map_intervals", "map_gap_fill", "map_call",
                    "map_assemble", "map_paint"):
        med = statistics.median(c[f"{st_name}_s"] for c in c_stats) * 1e3
        print(f"{tag} map_ k={K151} step {st_name}: {med:.3f} ms (host "
              f"clock, run stats, median of 3)", flush=True)
    dev151 = device_index(idx151, cuda)
    thr151 = random_match_threshold(K151, idx151.n_kmers, 4, 1e-7)

    def sweep151():
        return mapsweep.map_sweep_compact_core(
            dev151.keys2, dev151.cap2, codes_dev, map_tl, K151, thr151)

    out151 = sweep151()
    cand151 = mapsweep.fetch_candidates(*out151[2:], cap_d, cap_g).cpu()
    nd151 = int(cand151[0, 0])
    if nd151 > cap_d:
        raise SystemExit("FAIL k=151 drops overflow the timed capacity")
    # one patch per drop site, about what the refinement writes
    pp151 = cand151[0, 2 : 2 + nd151].to(cuda)
    pv151 = torch.full_like(pp151, ord("A"), dtype=torch.uint8)

    def assemble151():
        return mapsweep.assemble_map_core(out151[0], ref_mat_dev, map_tl,
                                          pp151, pv151, True)

    asm151 = assemble151()
    cap_r151 = _pow2_cap(nd151 + int(cand151[0, 1]) + 256)
    for name, fn, clock in (
        ("map_sweep_compact_core", sweep151, dev_ms),
        ("fetch_candidates + fetch (host clock)", lambda: mapsweep.
         fetch_candidates(*out151[2:], cap_d, cap_g).cpu(), host_ms),
        (f"assemble_map_core ({nd151} patches)", assemble151, dev_ms),
        ("fetch_delta_runs + fetch (host clock)", lambda: mapsweep.
         fetch_delta_runs(*asm151, cap_r151).cpu(), host_ms),
    ):
        print(f"{tag} map_ k={K151} stage {name}: {clock(fn):.3f} ms",
              flush=True)
    del out151, asm151
    t_ob = dev_ms(lambda: ob_sweep(dev.keys2, dev.cap2, *ob_dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ob_sweep(dev.keys2, dev.cap2, *ob_dev)
    torch.cuda.synchronize()
    print(f"{tag} over-budget sweep ({OB_Q} contigs of 256 bases, "
          f"map_sweep_compact_core): {t_ob:.3f} ms "
          f"({OB_Q * 256 / t_ob * 1e3 / 1e6:.2f} Mbases/s), peak device "
          f"memory {(torch.cuda.max_memory_allocated() - base_mem) / 2**30:.1f}"
          f" GiB above the {base_mem / 2**30:.1f} GiB the script holds",
          flush=True)

    # call: the host clock around the call (it returns host objects), and
    # its phases by the host clock of the run's stats (each of the first
    # three ends in a fetch), medians over the same 7 calls
    call_stats = []

    def one_call():
        reset_stats()
        api.call(index, ref, copts(), device=cuda)
        call_stats.append(get_stats().as_dict())

    t_call = host_ms(one_call)
    call_stats = call_stats[1:]
    print(f"{tag} call: {t_call:.3f} ms ({n / t_call * 1e3 / 1e6:.2f} "
          f"Mbases/s) over {n} bases, {len(call_gpu)} variants, host clock "
          f"around the call", flush=True)
    for st_name in ("call_drops", "call_anchors", "call_kmer_joins",
                    "call_resolve"):
        med = statistics.median(c[f"{st_name}_s"] for c in call_stats) * 1e3
        print(f"{tag} call stage {st_name}: {med:.3f} ms (host clock)",
              flush=True)
    t_call_rc = host_ms(lambda: api.call(index, ref, copts(rc=True),
                                         device=cuda))
    print(f"{tag} call add_revcomp: {t_call_rc:.3f} ms "
          f"({n / t_call_rc * 1e3 / 1e6:.2f} Mbases/s)", flush=True)
    # the device stages of the call alone (CUDA events): the MS row, the
    # drop scan on it, one interval join (the first anchor round's
    # probe), the two k-mer batches
    dq = device_index(index, cuda)
    ms_row_call = ms_mod.query_ms_row_device(dq, codes)
    d_call = random_match_threshold(K, index.n_kmers, 4, 1e-7)
    kmer_batch = call_args["compute_ms_values_vs_seq_device"][0][1]
    for name, fn in (
        ("MS row (query_ms_row_device)",
         lambda: ms_mod.query_ms_row_device(dq, codes)),
        ("drop scan (ms_drops_device, fetch included)",
         lambda: ms_mod.ms_drops_device(ms_row_call, d_call)),
        (f"interval join of the first round ({iv_in[1].shape[0]} windows)",
         lambda: ms_mod.intervals3_windows_core(*iv_in)),
        (f"2-bit k-mer batch ({len(kmer_batch)} k-mers)",
         lambda: compute_ms_values_many_device(index, kmer_batch, cuda)),
        (f"vs-sequence join ({len(kmer_batch)} k-mers against {n} "
         f"positions)",
         lambda: engine_mod.compute_ms_values_vs_seq_device(*vs_seq_in)),
    ):
        print(f"{tag} call stage {name}: {dev_ms(fn):.3f} ms", flush=True)
    t_seq = host_ms(lambda: api.find_batch(q_list, seq_index, FindOpts()))
    print(f"{tag} find_batch[{QN}x{QL}] against build_device's index: "
          f"{t_seq:.3f} ms ({QN / t_seq * 1e3:.1f} queries/s; the full "
          f"index {t_batch:.3f} ms); build_device {t_build_dev:.3f} ms "
          f"once (host clock, first call)", flush=True)
    # the device-built full index: its build, and each call beside its
    # host-index twin (host clock around the call)
    t_bf = host_ms(lambda: api.build_device(
        [query], BuildOpts(k=K, build_select=True), full=True, device=cuda))
    print(f"{tag} build_device(full=True) over {len(query)} bases: "
          f"{t_bf:.3f} ms (first call {t_build_full:.3f} ms)", flush=True)
    for what, t_full, t_host in (
        (f"find_batch[{QN}x{QL}]",
         host_ms(lambda: api.find_batch(q_list, full, FindOpts())), t_batch),
        ("map_ MapOpts() format=True",
         host_ms(lambda: api.map_(ref, full, dopts(True))),
         t_maps["MapOpts()", True]),
        (f"call CallOpts(k={K})",
         host_ms(lambda: api.call(full, ref, copts())), t_call),
    ):
        print(f"{tag} {what} against build_device(full=True)'s index: "
              f"{t_full:.3f} ms ({n / t_full * 1e3 / 1e6:.2f} Mbases/s over "
              f"the streamed side where it applies); the host-built index "
              f"{t_host:.3f} ms", flush=True)
    print(f"{tag} member_widths of {probes.shape[0]} probes: "
          f"{host_ms(lambda: full.member_widths(probes)):.3f} ms (host "
          f"clock)", flush=True)
    for label, t_cli in cli_ms.items():
        print(f"{tag} cli {label}: {t_cli:.1f} ms (one run, host clock, "
              f"in-process; reading the FASTA and the host index build "
              f"included)", flush=True)

    # the mesh: each call over four shards on the one card (and over every
    # card when there are two or more) beside its single-device twin, host
    # clock, medians of 7; the k = 151 batch once (phase 6c's run)
    t_gap5 = host_ms(lambda: api.find_batch(q_list, index, fo5, device=cuda))
    t_long = host_ms(lambda: pipeline_mod.matches_ms_batch(
        index, [codes], threshold, cuda))
    mesh_calls = (
        ("find_batch mesh", f"find_batch[{QN}x{QL}]",
         lambda m: api.find_batch(q_list, index, FindOpts(), mesh=m),
         t_batch),
        ("find_batch mesh max_gap_len=5", f"find_batch[{QN}x{QL}] "
         f"max_gap_len=5", lambda m: api.find_batch(q_list, index, fo5,
                                                   mesh=m), t_gap5),
        ("matches_long_sharded", f"matches_long_sharded over {n} bases "
         f"(twin: the single-device pipeline's matches_ms_batch)",
         lambda m: pmesh.matches_long_sharded(index, codes, threshold, m),
         t_long),
        ("call mesh", f"call CallOpts(k={K})",
         lambda m: api.call(index, ref, copts(), mesh=m), t_call),
        ("map_batch mesh format=True", "map_batch([genome]) MapOpts() "
         "format=True (twin: map_)",
         lambda m: api.map_batch([ref], index, dopts(True), mesh=m),
         t_maps["MapOpts()", True]),
        ("map_batch mesh format=False", "map_batch([genome]) MapOpts() "
         "format=False (twin: map_)",
         lambda m: api.map_batch([ref], index, dopts(False), mesh=m),
         t_maps["MapOpts()", False]),
        ("map_batch mesh 8 contigs", f"map_batch[8x{len(contigs[0])}] "
         f"MapOpts()", lambda m: api.map_batch(contigs, index, dopts(True),
                                               mesh=m),
         t_maps["MapOpts()", "batch"]),
    )
    mesh_ms = {}
    for mname, m in meshes.items():
        for path, label, fn, twin in mesh_calls:
            t_mesh = mesh_ms[mname, path] = host_ms(lambda: fn(m))
            print(f"{tag} mesh {label} over {mname}: {t_mesh:.3f} ms; "
                  f"single-device {twin:.3f} ms; route "
                  f"{mesh_routes[path] or 'none (no routing)'}; launches "
                  f"{json.dumps(launches[path])}", flush=True)
    path151 = f"map_batch mesh k={K151}"
    print(f"{tag} mesh map_batch[8x{len(contigs[0])}] k={K151} over 4 shards "
          f"on cuda:0: {mesh_first_ms[path151]:.3f} ms (one run); "
          f"single-device "
          f"{t_maps[f'map_batch[8x{len(contigs[0])}] k={K151}']:.3f} ms "
          f"(median of 3); route {mesh_routes[path151]}; launches "
          f"{json.dumps(launches[path151])}", flush=True)

    # the single-core engine beside the card (host clock), and the model
    # axis's two calls beside their single-device twins (host clock,
    # medians of 7)
    t_qms = host_ms(lambda: ms_mod.query_ms_device(dev, codes))
    t_stream = host_ms(lambda: native.ms_stream(index, codes), 3)
    print(f"{tag} native ms_stream over {n} bases (one CPU core): "
          f"{t_stream:.3f} ms (median of 3); the card's query_ms_device "
          f"{t_qms:.3f} ms (host clock, host in and out); native map_e2e "
          f"{t_native:.3f} ms (one run) against the card's default map_ "
          f"{t_maps['MapOpts()', True]:.3f} ms", flush=True)
    model_calls = (
        ("ms3_rows_sweep_index_sharded", f"ms3_rows_sweep over {Lm} "
         f"positions",
         lambda: pmesh.ms3_rows_sweep_index_sharded(sidx, mcodes, mm),
         lambda: mapsweep.ms3_rows_sweep(dev.keys3, dev.rows_packed, mcodes,
                                         K)),
        ("matches_batch_index_sharded", f"matches_batch[{QN}x{QL}]",
         lambda: pmesh.matches_batch_index_sharded(index, bcode_list,
                                                   threshold, mm),
         lambda: pipeline_mod.matches_batch(index, bcode_list, threshold,
                                            cuda)),
    )
    for path, label, fn, twin in model_calls:
        print(f"{tag} model {label} over 4 shards on cuda:0: "
              f"{host_ms(fn):.3f} ms; single-device {host_ms(twin):.3f} ms; "
              f"launches {json.dumps(launches[path])}", flush=True)
    # the sharded maps beside their single-device twins (phase 7's
    # medians above), then the index-sharded map's stages on the arguments
    # its finish gave them (phase 6e) beside the single table's forms: gap
    # scoring (the search loop over 4 shards against the chain table), the
    # search loop alone (4 shards, one bucketed table), variant resolution
    t_ish = host_ms(lambda: pmesh.map_batch_index_sharded(
        [ref], index, dopts(True), mm))
    t_2d = host_ms(lambda: pmesh.map_batch_2d_sharded(
        contigs, index, d2_opts, mesh2d))
    t_2d_twin = t_maps["MapOpts()", "batch"] if d2_host == 0 else host_ms(
        lambda: api.map_batch(contigs, index, d2_opts, device=cuda))
    t_42 = host_ms(lambda: pmesh.map_batch_2d_sharded(
        contigs, index, dopts(True), mesh42))
    print(f"{tag} map_batch_index_sharded over {n} bases, 4 model shards on "
          f"cuda:0: {t_ish:.3f} ms; the default map_ "
          f"{t_maps['MapOpts()', True]:.3f} ms; map_batch_2d_sharded over "
          f"2 x 4 on cuda:0, {len(contigs)} contigs"
          + (" with fill_gaps=False" if d2_host else "")
          + f": {t_2d:.3f} ms; the single-device map_batch {t_2d_twin:.3f} ms"
          f"; map_batch_2d_sharded over 4 x 2 with MapOpts(): {t_42:.3f} ms; "
          f"the single-device map_batch {t_maps['MapOpts()', 'batch']:.3f} ms "
          f"(host clock, medians of {REPS})", flush=True)
    # the two-process run's calls (phase 6c: each process's median of 3,
    # both processes on the one card at once) beside one process over the
    # same shards: merge_path and clamp_scan summed over the two processes
    # beside one process's (the stages each process runs once count twice)
    one_ms = {
        "map_batch([genome])":
            mesh_ms["4 shards on cuda:0", "map_batch mesh format=True"],
        "map_batch 8 contigs":
            mesh_ms["4 shards on cuda:0", "map_batch mesh 8 contigs"],
        "call": mesh_ms["4 shards on cuda:0", "call mesh"],
        "map_batch_index_sharded": t_ish,
        "map_batch_2d_sharded 4 x 2": t_42,
    }
    for name, (_, lkey) in TWO_PROC_CALLS.items():
        r0, r1 = (w["calls"][name] for w in two_proc)
        both = {k: r0["launches"][k] + r1["launches"][k]
                for k in ("merge_path", "clamp_scan")}
        one = {k: launches[lkey][k] for k in both}
        print(f"{tag} two processes on cuda:0, {name}: {r0['ms']:.3f} / "
              f"{r1['ms']:.3f} ms (processes 0 / 1, host clock, medians of "
              f"3); one process over the same shards {one_ms[name]:.3f} ms "
              f"(median of {REPS}); dist_bytes "
              f"{r0['stats'].get('dist_bytes', 0)} in "
              f"{r0['stats'].get('dist_calls', 0)} calls, "
              f"{r0['stats'].get('dist_s', 0) * 1e3:.3f} / "
              f"{r1['stats'].get('dist_s', 0) * 1e3:.3f} ms; merge_path + "
              f"clamp_scan over both processes {both}, one process {one}",
              flush=True)
    sg_rest = sg_args[1:]
    lk_keys, lk_rest = le_args[0], le_args[1:4]
    stage_times = {
        "Sharded3Index(4 shards)": host_ms(
            lambda: pmesh.Sharded3Index(index, mm)),
        "rows join (4 partial joins + pmax + finish)": host_ms(
            lambda: pmesh.ms3_rows_sweep_index_sharded(sidx, mcodes, mm)),
        "sharded_score_gaps": host_ms(
            lambda: pmesh.sharded_score_gaps(*sg_args)),
        "score_gaps_core, one table + chain table": host_ms(
            lambda: score_gaps_core(dev.keys3, *sg_rest[:6], *sg_rest[7:10],
                                    get_ext_table(dev), sg_rest[6])),
        "left_extend_device, 4 shards": host_ms(
            lambda: refine_mod.left_extend_device(lk_keys, *lk_rest)),
        "left_extend_device, one table (its bucket table built per call)":
            host_ms(
            lambda: refine_mod.left_extend_device(
                dev.keys3, *lk_rest, refine_mod.bucket_table(dev.keys3))),
        "sharded_resolve_variants": host_ms(
            lambda: pmesh.sharded_resolve_variants(*sv_args,
                                                   d_lo=threshold - 1)),
    }
    reset_stats()
    refine_mod.left_extend_device(lk_keys, *lk_rest)
    lstats = get_stats().as_dict()
    print(f"{tag} the index-sharded map's stages (host clock, medians of "
          f"{REPS}; the search loop {lstats.get('left_ext_rounds', 0)} rounds "
          f"over {lstats.get('left_ext_lanes', 0)} lanes of "
          f"{lk_rest[0].shape[0]}): "
          + "; ".join(f"{name} {t:.3f} ms" for name, t in stage_times.items()),
          flush=True)

    # each kernel alone at the find-core and map shapes, beside its plain
    # version, its byte bound and (where there is one) a library call: the
    # bare torch.sort passes of the radix sort over the same keys
    def lib_sort_of(words):
        keys = [k.contiguous() for k in _pack_key_words(words)]

        def run():
            for key in reversed(keys):
                torch.sort(key, stable=True)
        return run

    rows, runs = {}, {}
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
        runs[label] = (run_ms(lambda: merge_path(ak, ap, bk, bp)),
                       run_ms(lambda: clamp_scan(sw, cp, bits, False)))
        r["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, bits, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, bits, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
            f"M={M}, W={W}, bits={bits}, one direction",
        )
        del sw, sp, cp
        rows[label] = r
    # the call slice's shapes: the interval merges (W + 1 key rows), the
    # vs-sequence scans, the sequence index's join and batch
    for label, (ak, ap, bk, bp) in new_shapes.items():
        W = ak.shape[0]
        M = ak.shape[1] + bk.shape[1]
        rows.setdefault(label, {})["merge_path"] = (
            dev_ms(lambda: merge_path(ak, ap, bk, bp)),
            dev_ms(lambda: merge_path_plain(ak, ap, bk, bp)),
            2 * M * (W + 1) * 4 / hbm * 1e3,
            dev_ms(lib_sort_of(torch.cat([ak, bk], 1))),
            f"M={M}, W={W}",
        )
    for label, (sw, cp, bits) in scan_shapes.items():
        W, M = sw.shape
        rows.setdefault(label, {})["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, bits, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, bits, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
            f"M={M}, W={W}, bits={bits}, one direction",
        )
    for label, (ak, ap, bk, bp) in full_shapes.items():
        W = ak.shape[0]
        M = ak.shape[1] + bk.shape[1]
        rows.setdefault(label, {})["merge_path"] = (
            dev_ms(lambda: merge_path(ak, ap, bk, bp)),
            dev_ms(lambda: merge_path_plain(ak, ap, bk, bp)),
            2 * M * (W + 1) * 4 / hbm * 1e3,
            dev_ms(lib_sort_of(torch.cat([ak, bk], 1))),
            f"M={M}, W={W}",
        )
    for label, (sw, cp, bits) in full_scans.items():
        W, M = sw.shape
        rows.setdefault(label, {})["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, bits, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, bits, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
            f"M={M}, W={W}, bits={bits}, one direction",
        )
    # the 2-bit map path's shapes (captured in phase 5b)
    for label, (ak, ap, bk, bp) in map2_shapes.items():
        W = ak.shape[0]
        M = ak.shape[1] + bk.shape[1]
        rows.setdefault(label, {})["merge_path"] = (
            dev_ms(lambda: merge_path(ak, ap, bk, bp)),
            dev_ms(lambda: merge_path_plain(ak, ap, bk, bp)),
            2 * M * (W + 1) * 4 / hbm * 1e3,
            dev_ms(lib_sort_of(torch.cat([ak, bk], 1))),
            f"M={M}, W={W}",
        )
    for label, (sw, cp, bits) in map2_scans.items():
        W, M = sw.shape
        rows.setdefault(label, {})["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, bits, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, bits, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
            f"M={M}, W={W}, bits={bits}, one direction",
        )
    for label, (dms, dk, dthr, dtl) in map2_dt.items():
        Qd, Ld = dms.shape
        rows.setdefault(label, {})["derandomize_translate"] = (
            dev_ms(lambda: derandomize_translate(dms, dk, dthr, dtl)),
            dev_ms(lambda: derandomize_translate_plain(dms, dk, dthr, dtl)),
            (5 * Qd * Ld + 4 * Qd) / hbm * 1e3,
            None,
            f"Q={Qd}, L={Ld}, k={dk}",
        )
    Qf, Lf = full_ms.shape
    rows["full-index batch"]["derandomize_translate"] = (
        dev_ms(lambda: derandomize_translate(full_ms, K, _thr_full, full_tl)),
        dev_ms(lambda: derandomize_translate_plain(full_ms, K, _thr_full,
                                                   full_tl)),
        (5 * Qf * Lf + 4 * Qf) / hbm * 1e3,
        None,
        f"Q={Qf}, L={Lf}",
    )
    Qs, Ls = seq_ms.shape
    rows["seq-index"]["derandomize_translate"] = (
        dev_ms(lambda: derandomize_translate(seq_ms, K, _thr, seq_tl)),
        dev_ms(lambda: derandomize_translate_plain(seq_ms, K, _thr, seq_tl)),
        (5 * Qs * Ls + 4 * Qs) / hbm * 1e3,
        None,
        f"Q={Qs}, L={Ls}",
    )

    # the mesh's per-shard shapes (captured in phase 6c)
    for label, (ak, ap, bk, bp) in mesh_shapes.items():
        W = ak.shape[0]
        M = ak.shape[1] + bk.shape[1]
        rows.setdefault(label, {})["merge_path"] = (
            dev_ms(lambda: merge_path(ak, ap, bk, bp)),
            dev_ms(lambda: merge_path_plain(ak, ap, bk, bp)),
            2 * M * (W + 1) * 4 / hbm * 1e3,
            dev_ms(lib_sort_of(torch.cat([ak, bk], 1))),
            f"M={M}, W={W}",
        )
    for label, (sw, cp, bits) in mesh_scans.items():
        W, M = sw.shape
        rows.setdefault(label, {})["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, bits, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, bits, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
            f"M={M}, W={W}, bits={bits}, one direction",
        )
    for label, (dms, dk, dthr, dtl) in mesh_dt.items():
        Qd, Ld = dms.shape
        rows.setdefault(label, {})["derandomize_translate"] = (
            dev_ms(lambda: derandomize_translate(dms, dk, dthr, dtl)),
            dev_ms(lambda: derandomize_translate_plain(dms, dk, dthr, dtl)),
            (5 * Qd * Ld + 4 * Qd) / hbm * 1e3,
            None,
            f"Q={Qd}, L={Ld}, k={dk}",
        )

    # the reference helper's and the model axis's shapes (captured in
    # phases 6d and 6e)
    for label, (ak, ap, bk, bp) in {**ref_shapes, **model_shapes,
                                    **shard_shapes}.items():
        W = ak.shape[0]
        M = ak.shape[1] + bk.shape[1]
        rows.setdefault(label, {})["merge_path"] = (
            dev_ms(lambda: merge_path(ak, ap, bk, bp)),
            dev_ms(lambda: merge_path_plain(ak, ap, bk, bp)),
            2 * M * (W + 1) * 4 / hbm * 1e3,
            dev_ms(lib_sort_of(torch.cat([ak, bk], 1))),
            f"M={M}, W={W}",
        )
    for label, (sw, cp, bits) in {**ref_scans, **model_scans,
                                  **shard_scans}.items():
        W, M = sw.shape
        rows.setdefault(label, {})["clamp_scan"] = (
            dev_ms(lambda: clamp_scan(sw, cp, bits, False)),
            dev_ms(lambda: clamp_scan_plain(sw, cp, bits, False)),
            ((W + 1) * 4 + 4) * M / hbm * 1e3,
            None,
            f"M={M}, W={W}, bits={bits}, one direction",
        )
    for label, (dms, dk, dthr, dtl) in {**model_dt, **shard_dt}.items():
        Qd, Ld = dms.shape
        rows.setdefault(label, {})["derandomize_translate"] = (
            dev_ms(lambda: derandomize_translate(dms, dk, dthr, dtl)),
            dev_ms(lambda: derandomize_translate_plain(dms, dk, dthr, dtl)),
            (5 * Qd * Ld + 4 * Qd) / hbm * 1e3,
            None,
            f"Q={Qd}, L={Ld}, k={dk}",
        )

    # bitonic_merge: the same merge work as merge_path (bound and library
    # call as its row); bitonic_sort: one read and one write of the
    # operands, beside the radix sort's torch.sort passes on the same keys
    for label, (a_ops, b_ops, W) in bitonic_in.items():
        M = a_ops.shape[1] + b_ops.shape[1]
        rows[label]["bitonic_merge"] = (
            dev_ms(lambda: bitonic_merge(a_ops, b_ops, W)),
            dev_ms(lambda: bitonic_merge_plain(a_ops, b_ops, W)),
            2 * M * (W + 1) * 4 / hbm * 1e3,
            dev_ms(lib_sort_of(torch.cat([a_ops[:W], b_ops[:W]], 1))),
            f"M={M} (padded to {_bitonic_len(M)}), W={W}, "
            f"{passes_of(_bitonic_len(M), W + 1, False)}",
        )
    rows["query sort"] = {"bitonic_sort": (
        dev_ms(lambda: bitonic_sort(sort_in, 4)),
        dev_ms(lambda: bitonic_sort_plain(sort_in, 4)),
        2 * sort_in.numel() * 4 / hbm * 1e3,
        dev_ms(lib_sort_of(sort_in[:4])),
        f"n={sort_in.shape[1]}, W=4 + 1 payload, {passes_of(sort_M, 5, True)}",
    )}
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
    dt_runs = {label: run_ms(lambda: derandomize_translate(
        ms_in, K, threshold, tl_in)) for label, ms_in, tl_in in (
            ("find-core", ms_gpu, T), ("batch", ms_batch, batch_tl),
            ("map", single[0], map_tl))}
    # the two forms of derandomize_translate on the same Lipschitz rows,
    # forced in turn: device time of the kernel and the memset per call
    # (profiler), beside the form the wrapper picks (_short_rows)
    def device_ms(fn, n=5):
        return sum(e.self_device_time_total
                   for e in device_events(fn, n)) / n / 1e3

    try:
        for qs, ls in ((512, 4096), (512, 8192), (512, 16384), (512, 32768),
                       (64, 4096), (64, 8192), (64, 16384), (64, 32768),
                       (8, 16384), (8, 131072)):
            syn = lipschitz_rows(qs, ls)
            t_form = {}
            for short, form in ((True, "short-row"), (False, "look-back")):
                forced(short)
                t_form[form] = device_ms(
                    lambda: derandomize_translate(syn, K, threshold, ls))
            forced(None)
            pick = "short-row" if own_choice(
                qs, -(-ls // DT_TILE), cuda.index or 0) else "look-back"
            print(f"{tag} derandomize_translate forms at Q={qs}, L={ls} "
                  f"({-(-ls // DT_TILE)} tiles a row), device time a call: "
                  f"short-row {t_form['short-row']:.4f} ms, look-back "
                  f"{t_form['look-back']:.4f} ms (kernel + memset); the "
                  f"wrapper picks {pick}", flush=True)
    finally:
        forced(None)
    del syn
    # the sort's first pass alone: phases 1..log2(tile) in one tile pass,
    # reading the operands and the pads straight from sort_in
    first = _bitonic_passes(sort_M, 5, True)[0]
    scratch = torch.empty((5, sort_M), dtype=torch.int32, device=cuda)

    def block_sort():
        _build.check(_bitonic_lib().kbo_bitonic_tile(
            scratch.data_ptr(), 5, 4, sort_M, first.log_tile, first.k,
            first.k_end, first.j, sort_in.data_ptr(), sort_in.shape[1],
            sort_in.data_ptr(), 0, 1,
            torch.cuda.current_stream().cuda_stream), "block sort")

    print(f"{tag} bitonic_sort query sort: its first pass (phases 1.."
          f"{first.k_end} in tiles of {1 << first.log_tile}) alone "
          f"{dev_ms(block_sort):.3f} ms", flush=True)
    del scratch
    for label, (t_m, t_s) in runs.items():
        dt = f", derandomize_translate {dt_runs[label]:.3f} ms" \
            if label in dt_runs else ""
        print(f"{tag} {label} in runs of 10 back-to-back calls: merge_path "
              f"{t_m:.3f} ms, clamp_scan {t_s:.3f} ms{dt} per call",
              flush=True)
    for label, r in rows.items():
        for name, (t_k, t_p, t_b, t_l, shape) in r.items():
            lib = f", torch.sort passes {t_l:.3f} ms" if t_l is not None else ""
            if name == "bitonic_sort":
                lib = f", radix sort's torch.sort passes {t_l:.3f} ms"
            print(f"{tag} {name} {label} ({shape}): kernel {t_k:.3f} ms, "
                  f"plain {t_p:.3f} ms, bound {t_b:.3f} ms (bytes){lib}",
                  flush=True)

    # ---- where the device time goes: one profiled run of each workload

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
    breakdown("map_ refinements off format=True",
              lambda: api.map_(ref, index, mopts(True), device=cuda))
    breakdown("map_ MapOpts() format=True",
              lambda: api.map_(ref, index, dopts(True), device=cuda))
    # the bitonic calls by pass kind: regs_pass<n_ops> and tile_pass<n_ops>
    breakdown("bitonic_merge find-core",
              lambda: bitonic_merge(*bitonic_in["find-core"]))
    breakdown("bitonic_sort query sort", lambda: bitonic_sort(sort_in, 4))
    breakdown("call", lambda: api.call(index, ref, copts(), device=cuda))
    breakdown(f"find_batch[{QN}x{QL}] against build_device's index",
              lambda: api.find_batch(q_list, seq_index, FindOpts()))
    breakdown(f"find_batch[{QN}x{QL}] against build_device(full=True)",
              lambda: api.find_batch(q_list, full, FindOpts()))
    breakdown("map_ MapOpts() format=True against build_device(full=True)",
              lambda: api.map_(ref, full, dopts(True)))
    breakdown(f"map_ k={K151} MapOpts() format=True (2-bit path)",
              lambda: api.map_(ref, idx151, opts151(True), device=cuda))
    breakdown(f"over-budget sweep ({OB_Q} contigs)",
              lambda: ob_sweep(dev.keys2, dev.cap2, *ob_dev))
    breakdown("call against build_device(full=True)",
              lambda: api.call(full, ref, copts()))
    breakdown(f"find_batch[{QN}x{QL}] over 4 shards on cuda:0",
              lambda: api.find_batch(q_list, index, FindOpts(), mesh=m4))
    breakdown("map_batch([genome]) MapOpts() format=True over 4 shards on "
              "cuda:0 (sequence-sharded)",
              lambda: api.map_batch([ref], index, dopts(True), mesh=m4))
    breakdown(f"map_batch[8x{len(contigs[0])}] MapOpts() over 4 shards on "
              f"cuda:0 (contig-sharded)",
              lambda: api.map_batch(contigs, index, dopts(True), mesh=m4))
    breakdown(f"ms3_rows_sweep_index_sharded over {Lm} positions, 4 model "
              f"shards on cuda:0",
              lambda: pmesh.ms3_rows_sweep_index_sharded(sidx, mcodes, mm))
    breakdown(f"map_batch_index_sharded over {n} bases, 4 model shards on "
              f"cuda:0", lambda: pmesh.map_batch_index_sharded(
                  [ref], index, dopts(True), mm))

    src = "kbo_tpu_torch/kernels/csrc/"
    main = "map_ MapOpts() format=True"
    map151, map254 = f"map_ k={K151} format=True", f"map_ k={K254} format=True"
    # the mesh's per-shard shapes, each with the launches of one mesh call
    mesh_paths = [("mesh batch shard", "find_batch mesh"),
                  ("mesh seq chunk", "map_batch mesh format=True"),
                  ("mesh seq variant join", "map_batch mesh format=True"),
                  ("mesh 8-contig shard", "map_batch mesh 8 contigs")]
    # the reference helper's and the model axis's shapes, each with the
    # launches of its one call
    new_paths = [("reference ms3", "query_ms_device"),
                 ("model rows shard", "ms3_rows_sweep_index_sharded"),
                 ("model matches shard", "matches_batch_index_sharded"),
                 ("model map variant join", "map_batch_index_sharded"),
                 ("2-D stage-1 shard", "map_batch_2d_sharded"),
                 ("2-D variant join", "map_batch_2d_sharded"),
                 ("4 x 2 stage-1 shard", "map_batch_2d_sharded 4 x 2"),
                 ("4 x 2 variant join", "map_batch_2d_sharded 4 x 2")]
    # name: (source, TPU kernel, (shape, path whose launches it reports),
    #        other (shape, path) pairs)
    sources = {
        "merge_path": ("merge_path.cu", "kbo_tpu/kernels/pallas_sort.py:353",
                       ("map", main),
                       [("rk-vs-seq", main), ("find-core", "find-core"),
                        ("batch", "find_batch"), ("interval k=51", "call"),
                        ("interval k=254", "call k=254"),
                        ("seq-index", "find_batch DeviceSeqIndex"),
                        ("full-index batch", "find_batch DeviceFullIndex"),
                        ("full-index map", "map_ DeviceFullIndex"),
                        ("full-index member", "member_widths"),
                        (f"map2 k={K151}", map151),
                        (f"interval k={K151}", map151),
                        (f"map2 k={K254}", map254)] + mesh_paths
                       + [("reference intervals", "query_ms_device")]
                       + new_paths),
        "clamp_scan": ("clamp_scan.cu", "kbo_tpu/kernels/pallas_join.py:191",
                       ("map", main),
                       [("rk-vs-seq", main), ("find-core", "find-core"),
                        ("batch", "find_batch"), ("vs-seq", "call"),
                        ("vs-seq k=254", "call k=254"),
                        ("seq-index", "find_batch DeviceSeqIndex"),
                        ("full-index batch", "find_batch DeviceFullIndex"),
                        ("full-index map", "map_ DeviceFullIndex"),
                        (f"map2 k={K151}", map151),
                        (f"vs-seq k={K151}", map151),
                        (f"map2 k={K254}", map254),
                        ("over-budget", "over-budget sweep")]
                       + mesh_paths + new_paths),
        "derandomize_translate": (
            "derand_translate.cu", "attic/pallas_postprocess.py:258",
            ("map", main), [("find-core", "find-core"),
                            ("batch", "find_batch"),
                            ("seq-index", "find_batch DeviceSeqIndex"),
                            ("full-index batch",
                             "find_batch DeviceFullIndex"),
                            (f"map2 k={K151}", map151),
                            ("over-budget", "over-budget sweep")]
            + [(label, path) for label, path in mesh_paths
               if label in mesh_dt]
            + [("model matches shard", "matches_batch_index_sharded"),
               ("model map postprocess", "map_batch_index_sharded"),
               ("2-D data row", "map_batch_2d_sharded"),
               ("4 x 2 data row", "map_batch_2d_sharded 4 x 2")]),
        "bitonic_merge": ("bitonic.cu", "kbo_tpu/kernels/pallas_sort.py:178",
                          ("find-core", "ms2_core merge=bitonic"),
                          [("map", "ms3_rows_core merge=bitonic"),
                           ("rk-vs-seq",
                            "resolve_variants_core merge=bitonic"),
                           ("interval k=51", "intervals merge=bitonic")]),
        "bitonic_sort": ("bitonic.cu", "kbo_tpu/kernels/pallas_sort.py:558",
                         ("query sort", "bitonic_sort"), []),
    }
    out = []
    for name, (fname, replaces, top, others) in sources.items():
        def entry(label, path):
            t_k, t_p, t_b, t_l, shape = rows[label][name]
            return {"launches": launches[path][name], "ms": t_k,
                    "plain_ms": t_p, "bound_ms": t_b, "bound_by": "bytes",
                    "library_ms": t_l, "shape": f"{label}: {shape}",
                    "path": path}

        # the numbers at the shape of the path that runs the kernel (the
        # default map_ for the main path's kernels, the merge="bitonic"
        # joins and the standalone sort for the bitonic ones); the other
        # shapes beside them, each with the launches of its own one call
        out.append({
            "name": name, "route": "cuda", "source": src + fname,
            "replaces": replaces, "max_abs_err": errs[name],
            **entry(*top),
            "other_paths": [entry(*o) for o in others],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
