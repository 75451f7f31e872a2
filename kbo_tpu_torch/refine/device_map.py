"""Single-fetch map refinement and assembly (PyTorch; counterpart of
kbo_tpu/refine/device_map.py).

After the 3-bit sweep the refinement stays on the device: the candidate
compaction (kernels/mapsweep.py), gap scoring and variant resolution
(kernels/refine.py), priority-ordered patch assembly and
``relative_to_ref``. The steady-state ``map_batch`` pays ONE device->host
fetch that carries the delta runs, the counters and the fallback indicators
together; the host paints the runs onto a copy of the reference. The host
touches candidate data only on the rare fallback paths:

- capacity overflow (more drops/gap runs than the optimistic slots): the
  attempt runs again at the exact capacities (:func:`with_capacities`);
- ``needs_host`` gaps (extension lanes beyond the device budgets): scored
  by the exact host evaluator (refine/gap_filling.py) from the device's
  candidate grid, then one re-assembly.

Every map route that takes the rows join refines here, with one device body
(:func:`devref_core`) and one capacity policy (:class:`Caps`). The body
reads the key table through a value with two operations, ``score_gaps``
and ``resolve_variants``: a :class:`KeyTable` (one device's table, or a
model group's kernels.refine.ShardedKeys3 with no chain table), or the
sequence-sharded map's holder (kbo_tpu_torch.parallel.mesh). The single
card, the sequence-sharded and the index-sharded map finish through
:func:`map_devref_finish`; the contig-sharded and the 2-D map run the body
per block of contigs and finish through :func:`devref_sharded_finish`.

Reference semantics: map = src/lib.rs:720-761; variant calling =
src/variant_calling.rs:249-294; gap filling = src/gap_filling.rs:444-526.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

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
from kbo_tpu_torch.refine import gap_filling
from kbo_tpu_torch.utils.stats import get_stats, stage


class DevRefOverflow(Exception):
    """Candidate or run counts exceeded the capacities of an attempt: run it
    again with ``d`` / ``g`` / ``r`` at least the carried needs."""

    def __init__(self, need_d: int, need_g: int, need_r: int = 0):
        self.need_d = need_d
        self.need_g = need_g
        self.need_r = need_r
        super().__init__(f"devref capacity overflow: {need_d} drops, "
                         f"{need_g} gaps, {need_r} runs")


def _pow2_cap(n: int, lo: int = 256) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


# ------------------------------------------------------ capacity policy


def _run_budget(L: int, q: int, g: int) -> int:
    # ~1 delta run per variant site (L/1024 slots a contig) + a quarter of
    # the gap slack (2 g + 64) + flanks; an underestimate pays one
    # exactly-sized re-assembly (or, per block, one more attempt)
    return _pow2_cap(q * (L // 1024) + (2 * g + 64) // 4 + 256)


@dataclass(frozen=True)
class Caps:
    """The refinement's capacities for blocks of ``q`` contigs padded to
    ``L`` positions: ``d`` MS drops and ``g`` gap runs per contig, ``r``
    delta runs per block, and :attr:`ext` left-extension lanes."""

    L: int
    q: int
    d: int
    g: int
    r: int

    @property
    def ext(self) -> int:
        # extension lanes scale with the TOTAL gap count across contigs:
        # about 2 lanes per gap on SNP-dense inputs (4x headroom here); an
        # overflow flags the owning gaps to the host evaluator, so
        # undersizing costs a host pass, not correctness
        return _pow2_cap(max(4 * self.g, 32 * self.q), lo=256)

    def grown(self, need_d: int, need_g: int, need_r: int = 0) -> Caps:
        """Grown to at least the needs (never shrunk)."""
        g = max(self.g, _pow2_cap(need_g))
        return replace(self, d=max(self.d, _pow2_cap(need_d)), g=g,
                       r=max(self.r, _run_budget(self.L, self.q, g),
                             _pow2_cap(need_r)))


def start_caps(L: int, q: int) -> Caps:
    """The optimistic first capacities: only a denser-than-expected input
    pays a second pass. Drops (SNP sites) run ~1/kb on same-species pairs;
    gap runs are rarer and cost more per slot in the refinement."""
    g = _pow2_cap(L // 1536, lo=256)
    return Caps(L, q, _pow2_cap(L // 1024), g, _run_budget(L, q, g))


def with_capacities(L: int, q: int, attempt):
    """``attempt(caps)`` at :func:`start_caps`, and again at grown
    capacities after each :class:`DevRefOverflow` (counted in the run's
    ``map_overflow_retries``). The needs are exact counts that do not
    depend on the capacities, so a third attempt at most always fits."""
    caps = start_caps(L, q)
    while True:
        try:
            return attempt(caps)
        except DevRefOverflow as o:
            get_stats().add("map_overflow_retries")
            caps = caps.grown(o.need_d, o.need_g, o.need_r)


# --------------------------------------------------------- the key table


class KeyTable(NamedTuple):
    """The refinement's view of one key table: ``keys3`` (a device's table,
    or a model group's kernels.refine.ShardedKeys3) and ``chains``, the
    DeviceIndex whose chain table (kernels.refine.get_ext_table: built at
    its first gap scoring, cached on the index) gives the gaps' left
    extensions; None: the search loop."""

    keys3: object
    chains: object = None

    @classmethod
    def of(cls, dev) -> KeyTable:
        """A DeviceIndex's own table and chain table."""
        return cls(dev.keys3, dev)

    def score_gaps(self, ref_mat, lengths, gap_start, gap_end_at, grid,
                   threshold: int, k: int, cap_g: int, cap_ext: int,
                   bound: float):
        ext_tab = None if self.chains is None else get_ext_table(self.chains)
        return score_gaps_core(self.keys3, ref_mat, lengths, gap_start,
                               gap_end_at, grid, threshold, k, cap_g, cap_ext,
                               ext_tab, bound)

    def resolve_variants(self, codes, ref_mat, ms, lengths, drop_pos, apos,
                         arow, d: int, k: int, cap_d: int, d_lo: int,
                         seq_tables=None, revcomp: bool = False):
        """The variant join against the sweep's own tables (one contig) or
        the contigs' tagged window keys, both strands with ``revcomp`` (the
        reference's inner sequence index reuses the BuildOpts,
        src/lib.rs:553)."""
        seq_words = None
        if seq_tables is None:
            tag = seq_keys3_tagged_rc if revcomp else seq_keys3_tagged_core
            seq_words = tag(codes, k)
        return resolve_variants_core(
            self.keys3, seq_words, codes, ref_mat, ms, lengths, drop_pos,
            apos, arow, d, k, cap_d, d_lo=d_lo, seq_tables=seq_tables)


# ------------------------------------------------------------ the body

# the counter row that rides the delta fetch (row 3 of
# fetch_delta_runs_extras's block, after the run count and checksum)
_COUNTERS = ("max_drops", "max_gap_runs", "gaps_to_host", "gaps_seen",
             "gaps_filled", "gap_bases_unfilled", "variants_called",
             "clamped_gap_bases")


class Refined(NamedTuple):
    """One block's refinement on the device: the assembled delta runs and
    the counter row, and what a re-assembly or the host gap pass reads."""

    assembled: tuple
    extras: torch.Tensor
    chars: torch.Tensor
    packed: torch.Tensor
    pieces: dict
    pos_grids: list
    pv_grids: list
    needs_host: torch.Tensor | None

    def delta(self, cap_r: int) -> torch.Tensor:
        """The fetch-ready int32 [4, cap_r] block: the delta runs, then the
        run count, checksum and counter row."""
        return fetch_delta_runs_extras(*self.assembled, self.extras, cap_r)


def devref_core(table, k: int, codes, ref_mat, lengths, sweep,
                threshold: int, caps: Caps, opts,
                seq_tables=None) -> Refined:
    """The whole post-sweep refinement of a [Q, L] contig block on its
    device: the postprocess (``map_postprocess``), then gap scoring,
    variant resolution, priority assembly at ``caps.r`` runs and the
    counter row (``map_devref``). ``sweep`` is the rows join's (ms, uniq,
    rows), ``table`` a :class:`KeyTable` or the sequence-sharded holder.
    Every stage is contig-local, so it runs per shard of a contig-sharded
    batch."""
    ms = sweep[0]
    device = codes.device
    with stage("map_postprocess"):
        # the gap-candidate window never exceeds k - threshold + 1
        # positions (mapsweep.map_postprocess3_core docstring)
        chars, packed, pieces = map_postprocess3_core(
            *sweep, lengths, k, threshold, caps.d, caps.g,
            max(k - threshold + 1, 1),
        )
    with stage("map_devref"):
        pos_grids: list = []
        pv_grids: list = []
        n_var = torch.zeros((), dtype=torch.int32, device=device)
        gap_counters = torch.zeros(3, dtype=torch.int32, device=device)
        needs_host = None
        if opts.fill_gaps:
            gpos, gpv, needs_host, gap_counters = table.score_gaps(
                ref_mat, lengths, pieces["gap_start"], pieces["gap_end_at"],
                pieces["grid"], threshold, k, caps.g, caps.ext,
                prob_bound(opts.max_error_prob),
            )
            pos_grids.append(gpos)
            pv_grids.append(gpv)
        if opts.call_variants:
            vpos, vpv, n_var = table.resolve_variants(
                codes, ref_mat, ms, lengths, pieces["drop_pos"],
                pieces["apos"], pieces["arow"], threshold, k, caps.d,
                max(int(threshold) - 1, 0), seq_tables,
                opts.sbwt_build_opts.add_revcomp,
            )
            pos_grids.append(vpos)
            pv_grids.append(vpv)
        assembled = assemble_map_prio_core(
            chars, ref_mat, lengths, pos_grids, pv_grids, bool(opts.format),
            caps.r,
        )
        counts = pieces["counts"]
        extras = torch.cat([  # in _COUNTERS order
            counts[:, 0].max()[None],
            counts[:, 1].max()[None],
            torch.zeros(1, dtype=torch.int32, device=device)
            if needs_host is None
            else needs_host.sum(dtype=torch.int32)[None],
            gap_counters,
            n_var[None],
            pieces["clamped_gap"].sum(dtype=torch.int32)[None],
        ])
    return Refined(assembled, extras, chars, packed, pieces, pos_grids,
                   pv_grids, needs_host)


def _counters(blocks: np.ndarray, caps: Caps) -> dict:
    """The counters of fetched delta blocks [n, 4, cap_r] (maxima of the
    per-contig candidate counts, sums of the rest, ``runs`` the most runs
    of a block). Raises :class:`DevRefOverflow` when the candidates did
    not fit ``caps``."""
    rows = blocks[:, 3, 2 : 2 + len(_COUNTERS)].astype(np.int64)
    c = dict(zip(_COUNTERS, (int(v) for v in rows.sum(0))))
    c["max_drops"], c["max_gap_runs"] = (int(v) for v in rows[:, :2].max(0))
    c["runs"] = int(blocks[:, 3, 0].max())
    if c["max_drops"] > caps.d or c["max_gap_runs"] > caps.g:
        raise DevRefOverflow(c["max_drops"], c["max_gap_runs"])
    return c


def _record(c: dict, opts) -> None:
    """The refinement's counters into the run's stats."""
    stats = get_stats()
    if opts.fill_gaps:
        for key in ("gaps_to_host", "gaps_seen", "gaps_filled",
                    "gap_bases_unfilled"):
            stats.add(key, c[key])
    else:
        stats.add("gap_bases_unfilled", c["clamped_gap_bases"])
    if opts.call_variants:
        stats.add("variants_called", c["variants_called"])


# ------------------------------------------------------------ painting


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


def _paint(ref_seqs, ref_mat, fmt: bool, blocks) -> list[bytes]:
    """The output bytes: each delta block's runs (block s holds the flat
    positions of its own Q / n rows) painted onto the reference."""
    Q, L = ref_mat.shape
    q_per = Q // len(blocks)
    with stage("map_paint"):
        canvas, row_lens = _canvas(ref_seqs, Q, L, fmt, ref_mat)
        for s, block in enumerate(blocks):
            # runs never cross rows and padding rows have length 0, so
            # painting clips them
            n_runs = int(block[3, 0])
            base = s * q_per * L
            _paint_runs(canvas, block[0, :n_runs] + base,
                        block[1, :n_runs] + base, block[2, :n_runs], L,
                        row_lens)
        return [canvas[q * L : q * L + row_lens[q]].tobytes()
                for q in range(len(ref_seqs))]


# ------------------------------------------------- the single-fetch finish


def map_devref_finish(table, codes, lengths, sweep, ref_seqs, query_sbwt,
                      opts, threshold: int, ref_mat, ref_mat_dev,
                      seq_tables=None) -> list[bytes]:
    """Refine a swept [Q, L] batch on its device in one fetch and
    reconstruct the output (the single card, the sequence-sharded and the
    index-sharded map).

    ``table`` is the key table's view (:class:`KeyTable`, or the
    sequence-sharded holder of kbo_tpu_torch.parallel.mesh), ``codes`` the
    [Q, L] sweep codes, ``sweep`` the rows join's (ms, uniq, rows),
    ``ref_mat`` the padded [Q, L] raw reference matrix on the host and
    ``ref_mat_dev`` its copy on the device. ``seq_tables`` are the sweep's
    sorted query tables (single contig without revcomp; see
    kernels/refine.py resolve_variants_core), else the variant join sorts
    its own. Runs at :func:`with_capacities`.

    The host clock of each step goes to the run's stats:
    ``map_postprocess`` and ``map_devref`` (:func:`devref_core`),
    ``map_fetch`` (the delta fetch, and the exact-size re-assembly with its
    re-fetch), ``map_host_gaps`` (the host gap pass, its re-assembly and
    its re-fetch) and ``map_paint``.
    """
    Q, L = codes.shape
    device = codes.device
    fmt = bool(opts.format)

    def attempt(caps: Caps) -> list[bytes]:
        rf = devref_core(table, query_sbwt.k, codes, ref_mat_dev, lengths,
                         sweep, threshold, caps, opts, seq_tables)

        def assemble_fetch(cap_r: int) -> np.ndarray:
            assembled = assemble_map_prio_core(
                rf.chars, ref_mat_dev, lengths, rf.pos_grids, rf.pv_grids,
                fmt, cap_r,
            )
            return fetch_delta_runs_extras(
                *assembled, rf.extras, cap_r).cpu().numpy()

        # ONE fetch: delta runs + counters + fallback indicators together.
        with stage("map_fetch"):
            delta = rf.delta(caps.r).cpu().numpy()
        c = _counters(delta[None], caps)
        _record(c, opts)
        if opts.fill_gaps and c["gaps_to_host"]:
            # rare path: some gaps exceeded the device extension budgets.
            # Fetch the packed candidate block + flags, score those gaps on
            # the host FROM THE DEVICE GRID (the host extension walks the
            # host index's own keys), re-assemble with the extra patches,
            # re-fetch.
            with stage("map_host_gaps"):
                extra_pos, extra_pv, extra_unfilled = _host_gap_patches(
                    rf, ref_seqs, query_sbwt, opts, threshold, caps)
                get_stats().add("gap_bases_unfilled", extra_unfilled)
                if extra_pos:
                    ep = np.concatenate(extra_pos)
                    ev = np.concatenate(extra_pv)
                    cap_p = _pow2_cap(ep.size, lo=64)
                    ep_pad = np.full(cap_p, Q * L, dtype=np.int32)
                    ev_pad = np.zeros(cap_p, dtype=np.int32)
                    ep_pad[: ep.size] = ep
                    ev_pad[: ev.size] = ev
                    rf.pos_grids.append(torch.from_numpy(ep_pad).to(device))
                    rf.pv_grids.append(torch.from_numpy(ev_pad).to(device))
                    delta = assemble_fetch(caps.r)
        n_runs = int(delta[3, 0])
        if n_runs > caps.r:
            # run arrays are emitted capped, so an undersized budget re-runs
            # the (cheap) assembly at the exact size before refetching
            with stage("map_fetch"):
                delta = assemble_fetch(_pow2_cap(n_runs))
        return _paint(ref_seqs, ref_mat, fmt, delta[None])

    return with_capacities(L, Q, attempt)


def _host_gap_patches(rf: Refined, ref_seqs, query_sbwt, opts,
                      threshold: int, caps: Caps):
    """Gap patches from the exact host evaluator for the gaps the device
    flagged: (flat positions, packed gap-priority values, unfilled bases)
    per contig."""
    cap_d, cap_g = caps.d, caps.g
    L = rf.chars.shape[1]
    need = rf.needs_host.reshape(-1, cap_g).cpu().numpy()
    w_grid = int(rf.pieces["grid"].shape[-1])
    block = rf.packed.cpu().numpy()
    bcounts = block[:, :2]
    packed = block[:, 2:]
    grid_off = 3 * cap_d + 2 * cap_g
    extra_pos: list[np.ndarray] = []
    extra_pv: list[np.ndarray] = []
    extra_unfilled = 0
    for q, ref_seq in enumerate(ref_seqs):
        ng = int(bcounts[q, 1])
        sel = np.flatnonzero(need[q, :ng])
        if not sel.size:
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


# --------------------------------------- the contig-sharded finish


def devref_sharded_finish(ref_seqs, ref_mat, n_shards: int, opts, run):
    """The host side of a contig-sharded single-fetch map over n_shards
    blocks of contigs (the padded [Q, L] ``ref_mat`` split by rows):
    ``run(caps)`` runs :func:`devref_core` on every block and returns their
    fetched delta blocks, [n_shards, 4, caps.r], at
    :func:`with_capacities`; the runs are painted onto the canvas. Returns
    None when a gap needs the exact host evaluator (their count to the
    run's stats, ``gaps_to_host``): the caller takes another route."""
    Q, L = ref_mat.shape

    def attempt(caps: Caps):
        blocks = run(caps)
        c = _counters(blocks, caps)
        if c["gaps_to_host"]:
            get_stats().add("gaps_to_host", c["gaps_to_host"])
            return None
        if c["runs"] > caps.r:
            raise DevRefOverflow(0, 0, c["runs"])
        _record(c, opts)
        return _paint(ref_seqs, ref_mat, bool(opts.format), blocks)

    return with_capacities(L, Q // n_shards, attempt)
