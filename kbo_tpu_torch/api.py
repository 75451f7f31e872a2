"""Top-level API of the port: build, build_device, matches, find,
find_batch, call, map_, map_batch (counterpart of kbo_tpu/api.py;
reference: src/lib.rs:501-506 build, :547-573 call, :612-628 matches,
:808-821 find, :720-761 map).

Every query runs on ``device`` -- the CUDA card when it is None; pass
``device="cpu"`` to run the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kbo_tpu_torch import engine, pipeline
from kbo_tpu_torch.index.build import build_sbwt_from_seqs
from kbo_tpu_torch.index.encode import encode_ascii, revcomp_ascii
from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.ops import derandomize, format as fmt, translate
from kbo_tpu_torch.kernels import mapsweep, ms as ms_kernels
from kbo_tpu_torch.kernels.ms import _bucket
from kbo_tpu_torch.opts import BuildOpts, CallOpts, FindOpts, MapOpts, MatchOpts
from kbo_tpu_torch.parallel import mesh as pmesh
from kbo_tpu_torch.refine import gap_filling, variant_calling
from kbo_tpu_torch.refine.device_map import (
    KeyTable,
    _canvas,
    _paint_runs,
    _pow2_cap,
    map_devref_finish,
    start_caps,
)
from kbo_tpu_torch.utils.stats import get_stats, stage


def build(seq_data, build_opts: BuildOpts | None = None) -> SbwtIndex:
    """Build an SBWT index (+ LCS) from sequences on the host
    (reference: src/lib.rs:501-506)."""
    return build_sbwt_from_seqs(seq_data, build_opts or BuildOpts())


def build_device(seq_data, build_opts: BuildOpts | None = None,
                 full: bool = False, device=None):
    """Device-built index (no host SBWT construction) on ``device``.

    Default: a find-only :class:`kbo_tpu_torch.kernels.ms.DeviceSeqIndex`
    (the sequences' own sorted 3-bit window keys), which serves
    :func:`find_batch`. ``full=True``: a :class:`kbo_tpu_torch.kernels.ms.
    DeviceFullIndex` -- three radix sorts on the device emit the complete
    join-table set, so every entry point (find, matches, map, call) runs
    against it; only six metadata scalars cross to the host.
    """
    opts = build_opts or BuildOpts()
    seqs = [s.encode() if isinstance(s, str) else bytes(s) for s in seq_data]
    if full:
        return ms_kernels.DeviceFullIndex(
            seqs, opts.k, add_revcomp=opts.add_revcomp, device=device
        )
    return ms_kernels.DeviceSeqIndex(
        seqs, opts.k, add_revcomp=opts.add_revcomp, device=device
    )


def matches(query_seq: bytes, sbwt: SbwtIndex,
            match_opts: MatchOpts | None = None, device=None) -> list[str]:
    """Translated alignment characters of a query against an index
    (reference: src/lib.rs:612-628): MS on the device, then the host
    derandomize/translate oracles."""
    opts = match_opts or MatchOpts()
    k = sbwt.k
    threshold = derandomize.random_match_threshold(
        k, sbwt.n_kmers, 4, opts.max_error_prob
    )
    with stage("matches", bases=len(query_seq)):
        noisy_ms = engine.compute_ms_values(
            sbwt, encode_ascii(bytes(query_seq)), device
        )
        derand_ms = derandomize.derandomize_ms_vec(noisy_ms, k, threshold)
        return translate.translate_ms_vec(derand_ms, k, threshold)


def find(query_seq: bytes, sbwt: SbwtIndex,
         find_opts: FindOpts | None = None, device=None) -> list[fmt.RLE]:
    """Local alignment segments of a query within the index
    (reference: src/lib.rs:808-821)."""
    opts = find_opts or FindOpts()
    aln = matches(
        query_seq, sbwt, MatchOpts(max_error_prob=opts.max_error_prob), device
    )
    if opts.max_gap_len > 0:
        return fmt.run_lengths_gapped(aln, opts.max_gap_len)
    return fmt.run_lengths(aln)


def find_batch(query_seqs: list[bytes], sbwt, find_opts: FindOpts | None = None,
               mesh=None, device=None) -> list[list[fmt.RLE]]:
    """Batched :func:`find`: all queries go through one device pipeline,
    with segments extracted on the device at ``max_gap_len == 0``.

    ``sbwt`` is an :class:`SbwtIndex`, or an index from
    :func:`build_device`: a :class:`kbo_tpu_torch.kernels.ms.DeviceSeqIndex`
    (the index-free path) or a :class:`kbo_tpu_torch.kernels.ms.
    DeviceFullIndex`, each on its own device.

    With a ``data`` ``mesh`` (:func:`kbo_tpu_torch.parallel.mesh.make_mesh`)
    the batch shards over its devices (the mesh names the devices: no
    ``device`` then); a sequence index serves its one device only."""
    opts = find_opts or FindOpts()
    seq_index = isinstance(sbwt, ms_kernels.DeviceSeqIndex)
    indexes = (SbwtIndex, ms_kernels.DeviceIndex, ms_kernels.DeviceSeqIndex)
    if not isinstance(sbwt, indexes):
        raise TypeError(
            f"find_batch needs an SbwtIndex or an index from build_device, "
            f"not {type(sbwt).__name__}"
        )
    if mesh is not None:
        pmesh.require_data_axis(mesh, "find_batch")
    if mesh is not None and (seq_index or device is not None):
        raise ValueError(
            "find_batch over a mesh takes no device= and no build_device "
            "sequence index"
        )
    if not query_seqs:
        return []
    threshold = derandomize.random_match_threshold(
        sbwt.k, sbwt.n_kmers, 4, opts.max_error_prob
    )
    with stage("find_batch", bases=sum(len(q) for q in query_seqs)):
        with stage("find_encode"):
            code_list = [encode_ascii(bytes(q)) for q in query_seqs]
        if seq_index and opts.max_gap_len == 0:
            return pipeline.find_rle_batch_seq(sbwt, code_list, threshold)
        if seq_index:
            chars_list = pipeline.matches_batch_seq(sbwt, code_list, threshold)
        elif mesh is not None and opts.max_gap_len == 0:
            return pmesh.find_rle_batch_sharded(sbwt, code_list, threshold,
                                                mesh)
        elif mesh is not None:
            chars_list = pmesh.matches_batch_sharded(sbwt, code_list,
                                                     threshold, mesh)
        elif opts.max_gap_len == 0:
            return pipeline.find_rle_batch(sbwt, code_list, threshold, device)
        else:
            chars_list = pipeline.matches_batch(sbwt, code_list, threshold,
                                                device)
    return [
        fmt.run_lengths_gapped([chr(c) for c in chars], opts.max_gap_len)
        for chars in chars_list
    ]


def call(sbwt_query: SbwtIndex, ref_seq: bytes,
         call_opts: CallOpts | None = None, noisy_ms=None, ivals=None,
         drops=None, anchors=None, anchor_rows=None, mesh=None,
         device=None) -> list[variant_calling.Variant]:
    """Call variants between a query index and a reference sequence
    (reference: src/lib.rs:547-573).

    Note the argument inversion mirrored from the reference: inside
    ``call_variants`` the roles swap -- the "reference index" slot receives
    the user's QUERY index and the streamed "query" is the user's REFERENCE
    sequence, so ``Variant.query_pos`` is a position in the user's
    reference, matching VCF POS semantics (reference: src/lib.rs:561-568).

    A reference of at least 1024 bases takes the index-free device path:
    the MS row of the streamed reference stays on the device, its drops
    are compacted there, the anchor search probes the drops' candidates
    in one gated interval probe (a slab of drops each) against that row
    and the resident code buffer, and the reference k-mers join against
    the reference's own window keys (with its reverse complement after a
    separator when ``add_revcomp``) instead of an index built here. A
    shorter one builds its index on the host, as the reference does.

    With a ``data`` ``mesh`` the k-mer re-runs against the index shard over
    it and the other phases run on its first local device (no ``device``
    then).
    """
    if mesh is not None:
        pmesh.require_data_axis(mesh, "call")
        if device is not None:
            raise ValueError("call over a mesh takes no device=")
        device = mesh.devices[mesh.local_shards[0]]
    opts = call_opts or CallOpts()
    ref_seq = bytes(ref_seq)
    resident = None
    with stage("call", bases=len(ref_seq)):
        if len(ref_seq) >= 1024:
            if opts.sbwt_build_opts.k != sbwt_query.k:
                raise ValueError(
                    f"call needs call_opts.sbwt_build_opts.k == the index's "
                    f"k ({opts.sbwt_build_opts.k} != {sbwt_query.k})"
                )
            ref_codes = encode_ascii(ref_seq)
            if noisy_ms is None and drops is None and ivals is None:
                # a standalone call: the drops are compacted on the device
                # and only their positions cross; the MS row and the code
                # buffer it was computed from stay there for the anchor
                # probe
                d = derandomize.random_match_threshold(
                    sbwt_query.k, sbwt_query.n_kmers, 4, opts.max_error_prob
                )
                with stage("call_drops"):
                    resident = ms_kernels.query_ms_row_and_buffer_device(
                        engine.device_index(sbwt_query, device), ref_codes
                    )
                    drops = ms_kernels.ms_drops_device(resident[0], d)
            if opts.sbwt_build_opts.add_revcomp:
                sep = np.array([ms_kernels.INVALID], dtype=np.uint8)
                ref_codes = np.concatenate(
                    [ref_codes, sep, encode_ascii(revcomp_ascii(ref_seq))]
                )
            inner = ref_codes
        else:
            inner = build([ref_seq], opts.sbwt_build_opts)
            assert inner.k == sbwt_query.k
        variants = variant_calling.call_variants(
            sbwt_query,  # -> call_variants' sbwt_ref slot
            inner,  # -> its sbwt_query slot (an index or raw codes)
            ref_seq,
            opts.max_error_prob,
            noisy_ms=noisy_ms,
            ivals=ivals,
            drops=drops,
            anchors=anchors,
            anchor_rows=anchor_rows,
            resident=resident,
            ms_many=None if mesh is None else functools.partial(
                pmesh.ms_values_many_sharded, mesh=mesh),
            device=device,
        )
    get_stats().add("variants_called", len(variants))
    return variants


def map_(ref_seq: bytes, query_sbwt: SbwtIndex,
         map_opts: MapOpts | None = None, device=None) -> bytes:
    """Map a query (as an index) onto reference coordinates
    (reference: src/lib.rs:720-761). Role inversion: the QUERY is indexed and
    the REFERENCE sequence is streamed through it. One-contig
    :func:`map_batch`, whatever the input's size and k."""
    return map_batch([bytes(ref_seq)], query_sbwt, map_opts, device=device)[0]


def map_route(k: int, Q: int, L: int, table_width: int) -> tuple[str, int]:
    """Which sweep serves a [Q, L] batch against an index whose key table
    is ``table_width`` columns wide (kbo_tpu's single-device gate,
    kbo_tpu/api.py ``_map_batch_sparse``): ``("rows", 0)`` the 3-bit rows
    sweep in one shot, ``("rows", chunk)`` the rows sweep in chunks of
    ``chunk`` positions, ``("classic", 0)`` the 2-bit sweep with the host
    refinement.

    The rows join packs the table and the probes into 2^24 slots with
    k < 128 (kernels.ms.ms3_rows_core); past the budget the sweep runs
    CHUNKED along the sequence with k-1 context (exact). Each chunk
    re-scans the key table, so the fewest equal chunks on the 1/8-octave
    bucket grid that fit the budget, and no chunk under 4k positions: a
    batch of too many contigs for that takes the 2-bit sweep, as does
    every k >= 128. (kbo_tpu also leaves the rows path past ``max_tag(k)``
    = 2^30 contigs; the int32 position space keeps Q below 2^21.)
    """
    if k >= 128:
        return "classic", 0
    slot_budget = ms_kernels._PACKED_SLOT_LIMIT - table_width
    if Q * (L + k - 1) < slot_budget:
        return "rows", 0
    # strictly under the budget, as the join asserts (n + T < limit)
    max_chunk = (slot_budget - 1) // Q - (k - 1)
    n_chunks = max(1, -(-L // max(max_chunk, 1)))
    chunk = min(_bucket(-(-L // n_chunks)), max_chunk)
    if 0 < chunk < L and chunk >= 4 * k:
        return "rows", chunk
    return "classic", 0


def map_batch(ref_seqs: list[bytes], query_sbwt: SbwtIndex,
              map_opts: MapOpts | None = None, mesh=None,
              device=None) -> list[bytes]:
    """Batched :func:`map_` over many reference contigs.

    Where the rows join fits (k < 128, chunked if need be; see
    :func:`map_route`), the 3-bit rows sweep + derandomize + translate for
    ALL contigs run on the device, which also compacts the refinement
    candidates (MS drops, gap runs); the dense chars/MS arrays never cross
    to the host. Gap filling and variant calling run on the device too
    (kernels/refine.py): the default ``MapOpts()`` pays one fetch, plus a
    host pass only for gaps whose left extensions exceed the device budgets
    (refine/gap_filling.py). The output is fetched as run-length deltas
    against the reference and painted on the host (kernels/mapsweep.py,
    refine/device_map.py). The host clock of each step goes to the run's
    stats: ``map_upload`` (the pipelined chunked sweep runs inside it, as
    ``map_sweep_chunked`` with its bases, ``map_chunk_pack`` a chunk and
    the counter ``map_sweep_chunks``), ``map_sweep`` (with its bases;
    absent on the pipelined route), then those of
    :func:`~kbo_tpu_torch.refine.device_map.map_devref_finish` (from
    ``map_postprocess`` on); ``map_overflow_retries`` counts the capacity
    retries.

    Every other batch (k >= 128, or too many contigs for the rows join)
    takes :func:`_map_classic`: the 2-bit sweep and the host refinement
    over sparse colex intervals. ``format`` true or false.

    A ``data`` ``mesh`` (:func:`kbo_tpu_torch.parallel.mesh.make_mesh`; no
    ``device`` then) takes one of three routes, see :func:`_map_batch_mesh`.
    """
    opts = map_opts or MapOpts()
    if mesh is not None:
        pmesh.require_data_axis(mesh, "map_batch")
    if mesh is not None and device is not None:
        raise ValueError("map_batch over a mesh takes no device=")
    if not ref_seqs:
        return []
    ref_seqs = [bytes(r) for r in ref_seqs]
    k = query_sbwt.k
    if opts.call_variants and k != opts.sbwt_build_opts.k:
        # the reference builds its inner sequence index with these options
        raise ValueError(
            f"call_variants needs map_opts.sbwt_build_opts.k == the index's "
            f"k ({opts.sbwt_build_opts.k} != {k})"
        )
    if mesh is not None:
        return _map_batch_mesh(ref_seqs, query_sbwt, opts, mesh)
    dev = engine.device_index(query_sbwt, device)

    # shapes come from the byte lengths alone (1 code per byte): the sweep
    # codes are derived on the device from the reference upload
    seq_lens = np.asarray([len(r) for r in ref_seqs], dtype=np.int32)
    Q = len(ref_seqs)
    L = _bucket(int(seq_lens.max()))
    # delta positions travel as int32 flat offsets (q * L + i)
    assert Q * L < 2**31, "padded batch exceeds the int32 position space"
    route, chunk = map_route(k, Q, L, int(dev.keys3.shape[1]))
    if route == "classic":
        return _map_classic(ref_seqs, query_sbwt, opts, device)
    threshold = derandomize.random_match_threshold(
        k, query_sbwt.n_kmers, 4, opts.max_error_prob
    )

    # single-contig maps reuse the sweep's sorted query window keys as
    # the variant join's table (kernels/refine.py resolve_variants_core
    # ``seq_tables``); revcomp inner indexes and Q > 1 sort their own
    want_qt = (
        opts.call_variants and Q == 1
        and not opts.sbwt_build_opts.add_revcomp
    )
    with stage("map_upload"):
        ref_mat = _ref_matrix(ref_seqs, L)
        lengths_dev = torch.from_numpy(seq_lens).to(dev.device)
        pipelined = None
        if chunk:
            # the chunked sweep packs and ships chunk by chunk, so the host
            # packs chunk c + 1 while the card sweeps chunk c: the sweep
            # runs inside this span
            pipelined = mapsweep.upload_sweep_chunked_pipelined(
                dev.keys3, dev.rows_packed, ref_mat, seq_lens, k, chunk,
                want_qtable=want_qt,
            )
        if pipelined is None:
            ref_mat_dev, codes_dev = _upload(ref_mat, seq_lens, lengths_dev)
    if pipelined is not None:
        (ref_mat_dev, codes_dev, ms_dev, uniq_dev, rows_dev,
         seq_tables) = pipelined
    else:
        # the join stage is cap-independent: a capacity-overflow retry
        # re-runs only the refinement
        with stage("map_sweep", bases=int(seq_lens.sum())):
            if chunk:
                out = mapsweep.ms3_rows_sweep_chunked(
                    dev.keys3, dev.rows_packed, codes_dev, k, chunk,
                    want_qtable=want_qt,
                )
            else:
                out = mapsweep.ms3_rows_sweep(
                    dev.keys3, dev.rows_packed, codes_dev, k,
                    want_qtable=want_qt,
                )
        ms_dev, uniq_dev, rows_dev = out[:3]
        seq_tables = out[3] if want_qt else None

    return map_devref_finish(
        KeyTable.of(dev), codes_dev, lengths_dev, (ms_dev, uniq_dev, rows_dev),
        ref_seqs, query_sbwt, opts, threshold, ref_mat, ref_mat_dev,
        seq_tables,
    )


def _map_batch_mesh(ref_seqs: list[bytes], query_sbwt, opts: MapOpts,
                    mesh) -> list[bytes]:
    """:func:`map_batch` over a ``data`` mesh, routed as kbo_tpu's
    ``_map_batch_sparse`` routes it (k < 128 and no variant calling against
    both strands for the first two):

    1. fewer contigs than shards, chunks of at least max(k, 256) positions
       and the rows join's slot budget per chunk: the sequence-sharded map
       (:func:`kbo_tpu_torch.parallel.mesh.map_seq_sharded`);
    2. the budget per shard's contigs: the contig-sharded map
       (:func:`kbo_tpu_torch.parallel.mesh.map_devref_data_sharded`),
       unless it returns None (a gap for the host evaluator);
    3. else the classic mesh sweep (:func:`_map_classic` with the mesh).

    The run's stats count the route: ``mesh_route_seq``,
    ``mesh_route_data``, ``mesh_route_classic`` (``mesh_data_degraded``
    when route 2 gave way to 3)."""
    nd = mesh.devices.size
    k = query_sbwt.k
    Q0 = len(ref_seqs)
    L = _bucket(max(len(r) for r in ref_seqs))
    if -(-Q0 // nd) * nd * L >= 2**31:
        raise ValueError("padded batch exceeds the int32 position space")
    stats = get_stats()
    if k < 128 and not (opts.call_variants
                        and opts.sbwt_build_opts.add_revcomp):
        dev = pmesh.index_replicas(query_sbwt, mesh)[mesh.local_shards[0]]
        budget = ms_kernels._PACKED_SLOT_LIMIT - int(dev.keys3.shape[1])
        code_list = [encode_ascii(r) for r in ref_seqs]
        chunk = -(-L // nd)
        if Q0 < nd and chunk >= max(k, 256) and \
                Q0 * (chunk + 2 * (k - 1)) < budget:
            stats.add("mesh_route_seq")
            return pmesh.map_seq_sharded(ref_seqs, query_sbwt, opts, mesh,
                                         code_list)
        if -(-Q0 // nd) * (L + k - 1) < budget:
            threshold = derandomize.random_match_threshold(
                k, query_sbwt.n_kmers, 4, opts.max_error_prob
            )
            with stage("map_sweep", bases=sum(len(r) for r in ref_seqs)):
                out = pmesh.map_devref_data_sharded(
                    ref_seqs, query_sbwt, code_list, opts, threshold, mesh)
            if out is not None:
                stats.add("mesh_route_data")
                return out
            stats.add("mesh_data_degraded")
    stats.add("mesh_route_classic")
    return _map_classic(ref_seqs, query_sbwt, opts, mesh=mesh)


def _ref_matrix(ref_seqs: list[bytes], L: int,
                Q: int | None = None) -> np.ndarray:
    """The contigs' raw bytes as a zero-padded [Q, L] uint8 matrix (Q: the
    contig count, or more with zero rows after them)."""
    ref_mat = np.zeros((Q or len(ref_seqs), L), dtype=np.uint8)
    for q, r in enumerate(ref_seqs):
        ref_mat[q, : len(r)] = np.frombuffer(r, dtype=np.uint8)
    return ref_mat


def _upload(ref_mat: np.ndarray, seq_lens: np.ndarray, lengths_dev):
    """ONE upload of the padded [Q, L] reference matrix, 2-bit packed: the
    assembly needs the raw reference bytes, so ship 4 bases/byte + an
    exception list for every byte that is not uppercase ACGT, rebuild the
    exact raw matrix on the device and derive the sweep codes from it.
    Dense exceptions (soft-masked genomes) upload the raw matrix instead.
    Returns (raw matrix, codes), both [Q, L] uint8 on the device of
    ``lengths_dev``."""
    device = lengths_dev.device
    packed_up = mapsweep.pack_ascii_host(ref_mat, seq_lens)
    if packed_up is not None:
        return mapsweep.decode_packed4_encode_device(
            *(torch.from_numpy(a).to(device) for a in packed_up), lengths_dev
        )
    ref_mat_dev = torch.from_numpy(ref_mat).to(device)
    return ref_mat_dev, mapsweep.encode_ascii_device(ref_mat_dev)


def _map_classic(ref_seqs: list[bytes], query_sbwt, opts: MapOpts,
                 device=None, mesh=None) -> list[bytes]:
    """The 2-bit map path (kbo_tpu/api.py ``_map_batch_sparse``, its
    classic single-device branch): every k, any number of contigs.
    :func:`map_batch` sends a batch here when :func:`map_route` says so;
    ``ref_seqs`` are bytes and ``opts`` already checked against the index.

    1. One packed upload; :func:`kernels.mapsweep.map_sweep_compact_core`
       (the 2-bit join, derandomize_translate, the candidates compacted on
       the device) and one :func:`kernels.mapsweep.fetch_candidates`, again
       with exact capacities when the optimistic ones overflow.
    2. Per contig on the host: an :class:`engine.SparseIntervals` over the
       device MS row with ONE prefetch of the gap probe positions and the
       anchor candidates together, then
       :func:`refine.gap_filling.fill_gaps_patches` from those intervals
       and :func:`call` with the intervals and the sweep's drops; gap
       fills first, variant patches over them (one dict: last write wins).
    3. :func:`kernels.mapsweep.assemble_map_core` lands the patches on the
       device, :func:`kernels.mapsweep.fetch_delta_runs` fetches the delta
       runs (again when they overflow), and the host paints them.

    The host clock of each step goes to the run's stats: ``map_sweep``
    (upload, sweep and candidate fetch), ``map_intervals`` (the
    prefetches), ``map_gap_fill``, ``map_call``, ``map_assemble`` (with the
    delta fetch), ``map_paint``.

    With a ``data`` ``mesh`` (kbo_tpu's classic mesh branch) the batch is
    padded to a multiple of the shard count and the sweep and the candidate
    compaction run per shard
    (:func:`kbo_tpu_torch.parallel.mesh.map_sweep_compact_sharded`); the
    candidates are fetched from every shard at once, the chars, MS and
    codes gathered onto the first local device (of every process), where
    the rest runs, and :func:`call` takes the mesh.
    """
    k = query_sbwt.k
    threshold = derandomize.random_match_threshold(
        k, query_sbwt.n_kmers, 4, opts.max_error_prob
    )
    L = _bucket(max(len(r) for r in ref_seqs))
    if mesh is None:
        dev = engine.device_index(query_sbwt, device)
        seq_lens = np.asarray([len(r) for r in ref_seqs], dtype=np.int32)
    else:
        dev = pmesh.index_replicas(query_sbwt, mesh)[mesh.local_shards[0]]
        codes, seq_lens = pmesh.pad_rows(
            *pipeline.pad_batch([encode_ascii(r) for r in ref_seqs], L),
            mesh.devices.size,
        )
    Q = seq_lens.size
    ref_mat = _ref_matrix(ref_seqs, L, Q)
    lengths_dev = torch.from_numpy(seq_lens).to(dev.device)
    total_bases = int(seq_lens.sum())
    stats = get_stats()
    with stage("map_sweep", bases=total_bases):
        if mesh is None:
            ref_mat_dev, codes_dev = _upload(ref_mat, seq_lens, lengths_dev)
            sweep = mapsweep.map_sweep_compact_core(
                dev.keys2, dev.cap2, codes_dev, lengths_dev, k, threshold
            )
            chars_dev, ms_dev = sweep[:2]

            def fetch(cap_d, cap_g):
                return mapsweep.fetch_candidates(*sweep[2:], cap_d,
                                                 cap_g).cpu().numpy()
        else:
            parts = pmesh.map_sweep_compact_sharded(
                query_sbwt, codes, seq_lens, threshold, mesh
            )
            codes_dev, chars_dev, ms_dev = (
                pmesh.all_gather(mesh, pmesh.pick(parts, j)) for j in range(3)
            )
            ref_mat_dev = torch.from_numpy(ref_mat).to(dev.device)

            def fetch(cap_d, cap_g):
                return pmesh.gather_to_host(mesh, pmesh.map_shards(
                    mesh,
                    lambda p: mapsweep.fetch_candidates(*p[3:], cap_d, cap_g),
                    parts,
                ))

        # the rows path's capacities, grown once to the exact need
        caps = start_caps(L, Q)
        packed = fetch(caps.d, caps.g)
        need_d, need_g = (int(n) for n in packed[:, :2].max(0))
        if need_d > caps.d or need_g > caps.g:
            caps = caps.grown(need_d, need_g)
            packed = fetch(caps.d, caps.g)
        counts = packed[:, :2]
        packed = packed[:, 2:]

    call_opts = CallOpts(max_error_prob=opts.max_error_prob,
                         sbwt_build_opts=opts.sbwt_build_opts)
    patch_pos: list[np.ndarray] = []
    patch_val: list[np.ndarray] = []
    unfilled_bases = 0
    total_gap_runs = 0
    for q, ref_seq in enumerate(ref_seqs):
        n_ref = len(ref_seq)
        nd, ng = int(counts[q, 0]), int(counts[q, 1])
        drops = packed[q, :nd].astype(np.int64)
        runs = list(zip(
            packed[q, caps.d : caps.d + ng].tolist(),
            packed[q, caps.d + caps.g : caps.d + caps.g + ng].tolist(),
        ))
        with stage("map_intervals"):
            ivals = engine.SparseIntervals(
                query_sbwt, encode_ascii(ref_seq), ms=ms_dev[q],
                dev_codes=codes_dev[q],
            )
            # one union prefetch: the gap evaluator and the anchor rounds
            # read from the provider's cache
            probe_parts = []
            if opts.fill_gaps and runs:
                probe_parts.append(gap_filling.gap_probe_positions(
                    runs, n_ref, k, threshold))
            if opts.call_variants and drops.size:
                # anchors need ms[j] >= threshold, which after a clean
                # variant first happens near offset=threshold -- prefetch
                # through threshold+16 so the 8-offset rounds hit cache
                hi_off = min(threshold + 16, k)
                cand = np.unique(
                    (drops[:, None] + np.arange(1, hi_off + 1)[None, :])
                    .reshape(-1)
                )
                probe_parts.append(cand[cand < n_ref])
            if probe_parts:
                ivals.prefetch(np.unique(np.concatenate(probe_parts)))
        patches: dict[int, int] = {}
        total_gap_runs += len(runs)
        clamped_gap_bases = sum(
            max(0, min(e, n_ref - threshold) - s) for s, e in runs
        )
        if opts.fill_gaps:
            with stage("map_gap_fill"):
                gp = gap_filling.fill_gaps_patches(
                    runs, ivals, ref_seq, query_sbwt, threshold,
                    opts.max_error_prob,
                )
            unfilled_bases += max(0, clamped_gap_bases - len(gp))
            patches.update(gp)
        else:
            unfilled_bases += clamped_gap_bases
        if opts.call_variants:
            with stage("map_call"):
                variants = call(query_sbwt, ref_seq, call_opts, ivals=ivals,
                                drops=drops, mesh=mesh,
                                device=dev.device if mesh is None else None)
            patches.update(translate.variant_patches(variants))
        if patches:
            pp = np.fromiter(patches.keys(), dtype=np.int64)
            patch_pos.append((pp + q * L).astype(np.int32))
            patch_val.append(
                np.fromiter(patches.values(), dtype=np.int64).astype(np.uint8)
            )

    with stage("map_assemble", bases=total_bases):
        n_p = sum(p.size for p in patch_pos)
        cap_p = _pow2_cap(max(n_p, 1))
        pp = np.full(cap_p, Q * L, dtype=np.int32)  # out of range = inert
        pv = np.zeros(cap_p, dtype=np.uint8)
        if n_p:
            pp[:n_p] = np.concatenate(patch_pos)
            pv[:n_p] = np.concatenate(patch_val)
        assembled = mapsweep.assemble_map_core(
            chars_dev, ref_mat_dev, lengths_dev,
            torch.from_numpy(pp).to(dev.device),
            torch.from_numpy(pv).to(dev.device), bool(opts.format),
        )
        stats.add("gap_bases_unfilled", unfilled_bases)
        # optimistic single fetch: deltas are run-encoded, so the count is
        # bounded by patches (worst case one run each) + gap runs + a small
        # margin for flank '-' stretches; a miss pays one refetch
        cap_r = _pow2_cap(n_p + total_gap_runs + 256)
        delta = mapsweep.fetch_delta_runs(*assembled, cap_r).cpu().numpy()
        n_runs = int(delta[3, 0])
        if n_runs > cap_r:
            cap_r = _pow2_cap(n_runs)
            delta = mapsweep.fetch_delta_runs(*assembled, cap_r).cpu().numpy()

    with stage("map_paint"):
        canvas, row_lens = _canvas(ref_seqs, Q, L, bool(opts.format), ref_mat)
        _paint_runs(canvas, delta[0, :n_runs], delta[1, :n_runs],
                    delta[2, :n_runs], L, row_lens)
        return [canvas[q * L : q * L + row_lens[q]].tobytes()
                for q in range(len(ref_seqs))]
