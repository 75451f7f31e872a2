"""Single-fetch map refinement and assembly (PyTorch; counterpart of
kbo_tpu/refine/device_map.py).

After the 3-bit sweep and the candidate compaction (kernels/mapsweep.py)
the refinement stays on the device: variant resolution and gap scoring
(kernels/refine.py), priority-ordered patch assembly and
``relative_to_ref``. The steady-state ``map_batch`` pays ONE device->host
fetch that carries the delta runs, the counters and the fallback indicators
together; the host paints the runs onto a copy of the reference. The host
touches candidate data only on the rare fallback paths:

- capacity overflow (more drops/gap runs than the optimistic slots): the
  caller re-runs the postprocess stage at exact capacities;
- ``needs_host`` gaps (extension lanes beyond the device budgets) and gap
  runs beyond the device scoring capacity: scored by the exact host
  evaluator (refine/gap_filling.py) from the device's candidate grid, then
  one re-assembly.

Over a ``data`` mesh (kbo_tpu_torch.parallel.mesh) the contig-sharded map
(:func:`map_devref_data_sharded`) runs the whole refinement per shard as
one function (:func:`devref_core`) and pays one gather of the per-shard
delta blocks (:func:`devref_sharded_finish`; the 2-D ``("data", "model")``
map shares it); the sequence-sharded map splits gap slots and the variant
join's sequence table inside :func:`map_devref_finish`, and the
index-sharded map reads its key table by shard there.

Reference semantics: map = src/lib.rs:720-761; variant calling =
src/variant_calling.rs:249-294; gap filling = src/gap_filling.rs:444-526.
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch.kernels import mapsweep
from kbo_tpu_torch.kernels.mapsweep import (
    assemble_map_prio_core,
    fetch_delta_runs_extras,
    map_postprocess3_core,
)
from kbo_tpu_torch.kernels.refine import (
    get_ext_table,
    prob_bound,
    resolve_variants_core,
    score_gaps_core,
    seq_keys3_tagged_core,
    seq_keys3_tagged_rc,
)
from kbo_tpu_torch.pipeline import pad_batch
from kbo_tpu_torch.refine import gap_filling
from kbo_tpu_torch.utils.stats import get_stats, stage


class DevRefOverflow(Exception):
    """Candidate counts exceeded the optimistic capacities: re-run the
    postprocess + refinement stages with ``cap_d``/``cap_g`` at least the
    carried values."""

    def __init__(self, need_d: int, need_g: int):
        self.need_d = need_d
        self.need_g = need_g
        super().__init__(f"devref capacity overflow: {need_d} drops, {need_g} gaps")


def _pow2_cap(n: int, lo: int = 256) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


def _paint_runs(out_flat, starts, ends, vals, L: int, row_lens):
    """Vectorized delta-run painting onto a padded [Q*L] byte canvas.

    Runs never cross row edges (the device assembler breaks at them); ends
    are additionally clipped to each row's true length."""
    if starts.size == 0:
        return
    q = starts.astype(np.int64) // L
    row_end = q * L + row_lens[q]
    e = np.minimum(ends.astype(np.int64), row_end)
    s = starts.astype(np.int64)
    ls = np.maximum(e - s, 0)
    tot = int(ls.sum())
    if tot == 0:
        return
    base = np.repeat(s, ls)
    offs = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(ls) - ls, ls)
    out_flat[base + offs] = np.repeat(vals.astype(np.uint8), ls)


def _canvas(ref_seqs, Q: int, L: int, fmt: bool, ref_mat):
    """Padded [Q*L] output canvas + per-row true lengths: rows start as the
    raw reference bytes (``format=True``: a copy of the padded [Q, L] host
    matrix ``ref_mat``) or 'M' fill."""
    row_lens = np.zeros(Q, dtype=np.int64)
    for q, r in enumerate(ref_seqs):
        row_lens[q] = len(r)
    if fmt:
        canvas = ref_mat.reshape(-1).copy()
    else:
        canvas = np.full(Q * L, ord("M"), dtype=np.uint8)
    return canvas, row_lens


def map_devref_finish(
    dev,
    codes_dev,
    lengths_dev,
    ms_dev,
    chars_dev,
    pieces,
    packed_dev,
    ref_seqs,
    query_sbwt,
    opts,
    threshold: int,
    cap_d: int,
    cap_g: int,
    total_gap_slack: int,
    ref_mat,
    ref_mat_dev,
    seq_tables=None,
):
    """Run the device refinement + assembly and reconstruct the output.

    ``dev`` is the index's :class:`~kbo_tpu_torch.kernels.ms.DeviceIndex`
    (or the sequence-sharded map's holder or a prefix-sharded
    ``Sharded3Index``, kbo_tpu_torch.parallel.mesh),
    ``codes_dev`` / ``ms_dev`` the sweep's [Q, L] codes and MS,
    ``chars_dev`` / ``packed_dev`` / ``pieces`` the postprocess outputs
    (kernels/mapsweep.map_postprocess3_core), ``ref_mat`` the padded [Q, L]
    raw reference matrix on the host and ``ref_mat_dev`` its copy on the
    device. ``seq_tables`` are the sweep's sorted query tables
    (single contig without revcomp; see kernels/refine.py
    resolve_variants_core), else the variant join sorts its own.

    Returns the list of output byte strings. Raises :class:`DevRefOverflow`
    when the candidate capacities were too small (the caller re-runs the
    postprocess stage).

    The host clock of each step goes to the run's stats: ``map_devref``
    (the refinement and assembly launches), ``map_fetch`` (the delta fetch,
    and the exact-size re-assembly with its re-fetch), ``map_host_gaps``
    (the host gap pass, its re-assembly and its re-fetch) and
    ``map_paint``.
    """
    k = dev.k
    Q, L = codes_dev.shape
    device = chars_dev.device
    fmt = bool(opts.format)

    with stage("map_devref"):
        pos_grids: list = []
        pv_grids: list = []
        n_var_dev = torch.zeros((), dtype=torch.int32, device=device)
        gap_counters_dev = torch.zeros(3, dtype=torch.int32, device=device)
        needs_host_dev = None
        cap_ge = cap_g  # device gap scoring covers every compacted slot
        # extension lanes scale with the TOTAL gap count across contigs:
        # about 2 lanes per gap on SNP-dense inputs (4x headroom here); an
        # overflow flags the owning gaps to the host evaluator, so
        # undersizing costs a host pass, not correctness
        cap_ext = _pow2_cap(max(4 * cap_g, 32 * Q), lo=256)
        # a sequence-sharded holder (parallel.mesh._SeqShardedDev) splits
        # the gap slots and the variant join's sequence table over its mesh;
        # a prefix-sharded index (parallel.mesh.Sharded3Index) reads its
        # table by shard (the unpacks, and the search loop for the left
        # extension)
        seq_mesh = getattr(dev, "seq_mesh", None)
        model_mesh = getattr(dev, "model_mesh", None)
        if seq_mesh is not None or model_mesh is not None:
            from kbo_tpu_torch.parallel import mesh as pmesh
        if opts.fill_gaps:
            gap_args = (
                ref_mat_dev, lengths_dev, pieces["gap_start"],
                pieces["gap_end_at"], pieces["grid"], threshold,
            )
            bound = prob_bound(opts.max_error_prob)
            if seq_mesh is not None:
                gpos, gpv, needs_host_dev, gap_counters_dev = \
                    pmesh.seqsh_score_gaps(dev, *gap_args, bound, k, cap_ge,
                                           cap_ext)
            elif model_mesh is not None:
                gpos, gpv, needs_host_dev, gap_counters_dev = \
                    pmesh.sharded_score_gaps(dev, *gap_args, bound, k, cap_ge,
                                             cap_ext)
            else:
                gpos, gpv, needs_host_dev, gap_counters_dev = score_gaps_core(
                    dev.keys3, *gap_args, k, cap_ge, cap_ext,
                    get_ext_table(dev), bound,
                )
            pos_grids.append(gpos)
            pv_grids.append(gpv)
        if opts.call_variants and seq_mesh is not None:
            vpos, vpv, n_var_dev = pmesh.seqsh_resolve_variants(
                dev, codes_dev, ref_mat_dev, ms_dev, lengths_dev,
                pieces["drop_pos"], pieces["apos"], pieces["arow"], threshold,
                k, cap_d, d_lo=max(int(threshold) - 1, 0),
            )
            pos_grids.append(vpos)
            pv_grids.append(vpv)
        elif opts.call_variants and model_mesh is not None:
            vpos, vpv, n_var_dev = pmesh.sharded_resolve_variants(
                dev, seq_keys3_tagged_core(codes_dev, k), codes_dev,
                ref_mat_dev, ms_dev, lengths_dev, pieces["drop_pos"],
                pieces["apos"], pieces["arow"], threshold, k, cap_d,
                d_lo=max(int(threshold) - 1, 0),
            )
            pos_grids.append(vpos)
            pv_grids.append(vpv)
        elif opts.call_variants:
            seq_words = None
            if seq_tables is None:
                # the reference's inner sequence index reuses the BuildOpts
                # (src/lib.rs:553): with add_revcomp it holds both strands
                if opts.sbwt_build_opts.add_revcomp:
                    seq_words = seq_keys3_tagged_rc(codes_dev, k)
                else:
                    seq_words = seq_keys3_tagged_core(codes_dev, k)
            vpos, vpv, n_var_dev = resolve_variants_core(
                dev.keys3, seq_words, codes_dev, ref_mat_dev, ms_dev,
                lengths_dev, pieces["drop_pos"], pieces["apos"],
                pieces["arow"], threshold, k, cap_d,
                d_lo=max(int(threshold) - 1, 0), seq_tables=seq_tables,
            )
            pos_grids.append(vpos)
            pv_grids.append(vpv)

        # Optimistic run budget: ~1 delta run per variant site (L/1024
        # slots) + a quarter of the gap slack + flanks; an underestimate
        # pays one exactly-sized re-assembly below.
        cap_r = _pow2_cap(int(L // 1024 + total_gap_slack // 4 + 256))
        assembled = assemble_map_prio_core(
            chars_dev, ref_mat_dev, lengths_dev, pos_grids, pv_grids, fmt,
            cap_r,
        )
        counts = pieces["counts"]
        zero = torch.zeros(1, dtype=torch.int32, device=device)
        extras_dev = torch.cat(
            [
                counts[:, 0].max()[None],  # 0: max drops per contig
                counts[:, 1].max()[None],  # 1: max gap runs per contig
                # 2: gaps needing the host evaluator
                zero if needs_host_dev is None
                else needs_host_dev.sum(dtype=torch.int32)[None],
                # 3, 4, 5: gaps_seen, gaps_filled, unfilled
                gap_counters_dev,
                n_var_dev[None],  # 6: variants resolved
                pieces["clamped_gap"].sum(dtype=torch.int32)[None],  # 7
            ]
        )

    # ONE fetch: delta runs + counters + fallback indicators together.
    with stage("map_fetch"):
        delta = fetch_delta_runs_extras(
            *assembled, extras_dev, cap_r
        ).cpu().numpy()
    n_runs = int(delta[3, 0])
    extras = delta[3, 2:10]
    max_d, max_g, n_need_host = int(extras[0]), int(extras[1]), int(extras[2])
    if max_d > cap_d or max_g > cap_g:
        raise DevRefOverflow(max_d, max_g)

    stats = get_stats()
    if opts.fill_gaps:
        stats.add("gaps_to_host", n_need_host)
        stats.add("gaps_seen", int(extras[3]))
        stats.add("gaps_filled", int(extras[4]))
        stats.add("gap_bases_unfilled", int(extras[5]))
    else:
        stats.add("gap_bases_unfilled", int(extras[7]))
    if opts.call_variants:
        stats.add("variants_called", int(extras[6]))

    if opts.fill_gaps and (n_need_host > 0 or max_g > cap_ge):
        # rare path: some gaps exceeded the device extension budgets. Fetch
        # the packed candidate block + flags, score those gaps on the host
        # FROM THE DEVICE GRID (the host extension walks the host index's
        # own keys), re-assemble with the extra patches, re-fetch.
        with stage("map_host_gaps"):
            extra_pos, extra_pv, extra_unfilled = _host_gap_patches(
                needs_host_dev, packed_dev, pieces, ref_seqs, query_sbwt, opts,
                threshold, cap_d, cap_g, cap_ge, L, n_need_host,
            )
            stats.add("gap_bases_unfilled", extra_unfilled)
            if extra_pos:
                ep = np.concatenate(extra_pos)
                ev = np.concatenate(extra_pv)
                cap_p = _pow2_cap(ep.size, lo=64)
                ep_pad = np.full(cap_p, Q * L, dtype=np.int32)
                ev_pad = np.zeros(cap_p, dtype=np.int32)
                ep_pad[: ep.size] = ep
                ev_pad[: ev.size] = ev
                pos_grids.append(torch.from_numpy(ep_pad).to(device))
                pv_grids.append(torch.from_numpy(ev_pad).to(device))
                assembled = assemble_map_prio_core(
                    chars_dev, ref_mat_dev, lengths_dev, pos_grids, pv_grids,
                    fmt, cap_r,
                )
                delta = (
                    fetch_delta_runs_extras(*assembled, extras_dev, cap_r)
                    .cpu().numpy()
                )
                n_runs = int(delta[3, 0])

    if n_runs > cap_r:
        # run arrays are emitted capped, so an undersized budget re-runs
        # the (cheap) assembly at the exact size before refetching
        cap_r = _pow2_cap(n_runs)
        with stage("map_fetch"):
            assembled = assemble_map_prio_core(
                chars_dev, ref_mat_dev, lengths_dev, pos_grids, pv_grids, fmt,
                cap_r,
            )
            delta = (
                fetch_delta_runs_extras(*assembled, extras_dev, cap_r)
                .cpu().numpy()
            )
        n_runs = int(delta[3, 0])

    with stage("map_paint"):
        canvas, row_lens = _canvas(ref_seqs, Q, L, fmt, ref_mat)
        _paint_runs(
            canvas, delta[0, :n_runs], delta[1, :n_runs], delta[2, :n_runs],
            L, row_lens,
        )
        return [
            canvas[q * L : q * L + row_lens[q]].tobytes()
            for q in range(len(ref_seqs))
        ]


def _host_gap_patches(needs_host_dev, packed_dev, pieces, ref_seqs,
                      query_sbwt, opts, threshold: int, cap_d: int,
                      cap_g: int, cap_ge: int, L: int, n_need_host: int):
    """Gap patches from the exact host evaluator for the gaps the device
    flagged (and any beyond its scoring capacity): (flat positions, packed
    gap-priority values, unfilled bases) per contig."""
    Q = len(ref_seqs)
    need = (
        needs_host_dev.reshape(-1, cap_ge).cpu().numpy()
        if n_need_host
        else np.zeros((Q, cap_ge), dtype=bool)
    )
    w_grid = int(pieces["grid"].shape[-1])
    block = packed_dev.cpu().numpy()
    bcounts = block[:, :2]
    packed = block[:, 2:]
    grid_off = 3 * cap_d + 2 * cap_g
    extra_pos: list[np.ndarray] = []
    extra_pv: list[np.ndarray] = []
    extra_unfilled = 0
    for q, ref_seq in enumerate(ref_seqs):
        ng = int(bcounts[q, 1])
        sel = [j for j in range(ng) if j >= cap_ge or need[q, j]]
        if not sel:
            continue
        ref_seq = bytes(ref_seq)
        starts = packed[q, cap_d : cap_d + ng]
        ends = packed[q, cap_d + cap_g : cap_d + cap_g + ng]
        runs = [(int(starts[j]), int(ends[j])) for j in sel]
        grid_all = packed[q, grid_off : grid_off + cap_g * w_grid]
        grid_sel = grid_all.reshape(cap_g, w_grid)[sel]
        gp = gap_filling.fill_gaps_patches(
            runs, None, ref_seq, query_sbwt, threshold, opts.max_error_prob,
            grid=grid_sel,
        )
        clamped = sum(
            max(0, min(e, len(ref_seq) - threshold) - s) for s, e in runs
        )
        extra_unfilled += max(0, clamped - len(gp))
        if gp:
            pp = np.fromiter((p for p, _ in gp), dtype=np.int64)
            vv = np.fromiter((v for _, v in gp), dtype=np.int64)
            extra_pos.append((pp + q * L).astype(np.int32))
            extra_pv.append(((1 << 8) | vv).astype(np.int32))  # gap priority
    return extra_pos, extra_pv, extra_unfilled


# ---------------------------------------- data-parallel (contig-sharded)


def devref_core(keys3, codes, ref_mat, lengths, ms, uniq, rows,
                threshold: int, k: int, cap_d: int, cap_g: int, cap_ext: int,
                cap_r: int, do_gaps: bool, do_vars: bool, fmt: bool,
                d_lo: int = 0, w_grid: int | None = None, ext_tab=None,
                bound: float | None = None):
    """The whole post-sweep refinement of a [Q, L] contig block as one
    function: postprocess, variant resolution, gap scoring, priority
    assembly and the packed delta block. Every stage is contig-local, so
    it runs per shard of a contig-sharded batch. ``keys3`` may be a
    kernels.refine.ShardedKeys3 (the 2-D mesh's model group; ``ext_tab``
    None then: the left extension takes the search loop).

    Returns (delta4 int32 [4, cap_r] -- :func:`fetch_delta_runs_extras`'s
    layout, row 3 the run count, checksum and the counters that
    :func:`map_devref_finish` fetches -- and needs_host bool [Q * cap_g]).
    """
    chars, _packed, pieces = map_postprocess3_core(
        ms, uniq, rows, lengths, k, threshold, cap_d, cap_g, w_grid
    )
    Q = codes.shape[0]
    device = codes.device
    pos_grids, pv_grids = [], []
    n_var = torch.zeros((), dtype=torch.int32, device=device)
    gap_counters = torch.zeros(3, dtype=torch.int32, device=device)
    needs_host = torch.zeros(Q * cap_g, dtype=torch.bool, device=device)
    if do_gaps:
        gpos, gpv, needs_host, gap_counters = score_gaps_core(
            keys3, ref_mat, lengths, pieces["gap_start"], pieces["gap_end_at"],
            pieces["grid"], threshold, k, cap_g, cap_ext, ext_tab, bound,
        )
        pos_grids.append(gpos)
        pv_grids.append(gpv)
    if do_vars:
        vpos, vpv, n_var = resolve_variants_core(
            keys3, seq_keys3_tagged_core(codes, k), codes, ref_mat, ms,
            lengths, pieces["drop_pos"], pieces["apos"], pieces["arow"],
            threshold, k, cap_d, d_lo=d_lo,
        )
        pos_grids.append(vpos)
        pv_grids.append(vpv)
    assembled = assemble_map_prio_core(chars, ref_mat, lengths, pos_grids,
                                       pv_grids, fmt, cap_r)
    counts = pieces["counts"]
    extras = torch.cat([
        counts[:, 0].max()[None],
        counts[:, 1].max()[None],
        needs_host.sum(dtype=torch.int32)[None],
        gap_counters,
        n_var[None],
        pieces["clamped_gap"].sum(dtype=torch.int32)[None],
    ])
    return fetch_delta_runs_extras(*assembled, extras, cap_r), needs_host


def map_devref_data_sharded(ref_seqs, query_sbwt, code_list, opts,
                            threshold: int, mesh):
    """Contig-sharded single-fetch map over a ``data`` mesh: the 3-bit
    sweep AND the refinement (:func:`devref_core`) run per shard on its
    replica of the index; the host pays one gather of the per-shard
    [4, cap_r] delta blocks, again at larger capacities when candidates or
    runs overflowed (at most three tries). Returns None when a gap needs
    the exact host evaluator or the tries run out: the caller takes the
    classic mesh sweep (kbo_tpu_torch.api._map_classic), so correctness
    never rests on this path."""
    from kbo_tpu_torch.parallel import mesh as pmesh

    k = query_sbwt.k
    nd = mesh.devices.size
    codes, lengths = pmesh.pad_rows(*pad_batch(code_list, bucket=True), nd)
    Q, L = codes.shape
    ref_mat = pmesh.ref_matrix(ref_seqs, Q, L)
    reps = pmesh.index_replicas(query_sbwt, mesh)
    codes_p = pmesh.shard_rows(mesh, codes)
    ref_p = pmesh.shard_rows(mesh, ref_mat)
    len_p = pmesh.shard_rows(mesh, lengths)
    sweep_p = pmesh.map_shards(
        mesh,
        lambda dv, co: mapsweep.ms3_rows_sweep(dv.keys3, dv.rows_packed, co, k),
        reps, codes_p,
    )

    bound = prob_bound(opts.max_error_prob)

    def run(cap_d, cap_g, cap_ext, cap_r):
        def shard(dv, co, rm, le, sw):
            return devref_core(
                dv.keys3, co, rm, le, *sw, threshold, k, cap_d, cap_g,
                cap_ext, cap_r, bool(opts.fill_gaps),
                bool(opts.call_variants), bool(opts.format),
                d_lo=max(int(threshold) - 1, 0),
                w_grid=max(k - int(threshold) + 1, 1),
                ext_tab=get_ext_table(dv) if opts.fill_gaps else None,
                bound=bound,
            )[0][None]

        return pmesh.gather_to_host(mesh, pmesh.map_shards(
            mesh, shard, reps, codes_p, ref_p, len_p, sweep_p))

    return devref_sharded_finish(ref_seqs, ref_mat, nd, opts, run)


def devref_sharded_finish(ref_seqs, ref_mat, n_shards: int, opts, run):
    """The host side of a contig-sharded single-fetch map over n_shards
    blocks of q_per contigs (the padded [Q, L] ``ref_mat`` split by rows):
    ``run(cap_d, cap_g, cap_ext, cap_r)`` runs :func:`devref_core` on every
    block and returns their delta blocks on the host, [n_shards, 4, cap_r];
    they run again at larger capacities when candidates or runs overflowed
    (at most three tries), and the runs are painted onto the canvas.
    Returns None when a gap needs the exact host evaluator (their count to
    the run's stats, ``gaps_to_host``) or the tries run out."""
    Q, L = ref_mat.shape
    q_per = Q // n_shards
    # the single-device path's optimistic capacities
    cap_d = _pow2_cap(L // 1024)
    cap_g = _pow2_cap(L // 1536, lo=256)
    cap_r_floor = 0
    for _attempt in range(3):
        cap_ext = _pow2_cap(max(4 * cap_g, 32 * q_per), lo=256)
        cap_r = max(_pow2_cap(int(q_per * (L // 1024) + cap_g // 2 + 256)),
                    cap_r_floor)
        blocks = run(cap_d, cap_g, cap_ext, cap_r)
        max_d = int(blocks[:, 3, 2].max())
        max_g = int(blocks[:, 3, 3].max())
        if max_d > cap_d or max_g > cap_g:
            cap_d = max(cap_d, _pow2_cap(max_d))
            cap_g = max(cap_g, _pow2_cap(max_g))
            continue
        n_host = int(blocks[:, 3, 4].sum())
        if n_host:
            get_stats().add("gaps_to_host", n_host)
            return None  # a gap for the host evaluator
        max_runs = int(blocks[:, 3, 0].max())
        if max_runs > cap_r:
            cap_r_floor = _pow2_cap(max_runs)
            continue
        break
    else:
        return None

    stats = get_stats()
    if opts.fill_gaps:
        stats.add("gaps_seen", int(blocks[:, 3, 5].sum()))
        stats.add("gaps_filled", int(blocks[:, 3, 6].sum()))
        stats.add("gap_bases_unfilled", int(blocks[:, 3, 7].sum()))
    else:
        stats.add("gap_bases_unfilled", int(blocks[:, 3, 9].sum()))
    if opts.call_variants:
        stats.add("variants_called", int(blocks[:, 3, 8].sum()))

    canvas, row_lens = _canvas(ref_seqs, Q, L, bool(opts.format), ref_mat)
    for s, block in enumerate(blocks):
        # shard s's flat positions are local to its q_per rows; runs never
        # cross rows and padding rows have length 0, so painting clips them
        n_runs = int(block[3, 0])
        base = s * q_per * L
        _paint_runs(canvas, block[0, :n_runs] + base, block[1, :n_runs] + base,
                    block[2, :n_runs], L, row_lens)
    return [canvas[q * L : q * L + row_lens[q]].tobytes()
            for q in range(len(ref_seqs))]
