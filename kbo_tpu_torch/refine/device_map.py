"""Single-fetch map assembly (PyTorch; counterpart of
kbo_tpu/refine/device_map.py, single-device branch).

After the 3-bit sweep and the candidate compaction
(kernels/mapsweep.py) the translation stays on the device: patches land by
priority, ``relative_to_ref`` is applied there, and the steady-state
``map_batch`` pays ONE device->host fetch that carries the delta runs, the
counters and the overflow indicators together. The host paints the runs
onto a copy of the reference.

This slice covers ``MapOpts(fill_gaps=False, call_variants=False)``: the
patch grids are empty. The device refinement (kbo_tpu/kernels/refine.py:
gap scoring and variant resolution) is the next slice of the port and reads
the candidate tables ``pieces`` that this path already computes.

Reference semantics: map = src/lib.rs:720-761.
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch.kernels.mapsweep import (
    assemble_map_prio_core,
    fetch_delta_runs_extras,
)
from kbo_tpu_torch.utils.stats import get_stats


class DevRefOverflow(Exception):
    """Candidate counts exceeded the optimistic capacities: re-run the
    postprocess stage with ``cap_d``/``cap_g`` at least the carried
    values."""

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
    chars_dev,
    lengths_dev,
    pieces,
    ref_seqs,
    opts,
    cap_d: int,
    cap_g: int,
    total_gap_slack: int,
    ref_mat,
    ref_mat_dev,
):
    """Run the device assembly and reconstruct the output. ``ref_mat`` is
    the padded [Q, L] raw reference matrix on the host, ``ref_mat_dev`` its
    copy on the device.

    Returns the list of output byte strings. Raises :class:`DevRefOverflow`
    when the candidate capacities were too small (the caller re-runs the
    postprocess stage): the refinement that reads those tables must see all
    of them, so the check stands with the refinement switched off too.
    """
    if opts.fill_gaps:
        raise NotImplementedError(
            "map_ with fill_gaps=True: the device gap scoring "
            "(kernels/refine.py score_gaps) is ROADMAP Queue 1 item 4b"
        )
    if opts.call_variants:
        raise NotImplementedError(
            "map_ with call_variants=True: the device variant resolution "
            "(kernels/refine.py resolve_variants) is ROADMAP Queue 1 item 4b"
        )
    Q, L = chars_dev.shape
    device = chars_dev.device
    fmt = bool(opts.format)

    # both refinements are off: no patches to land
    pos_grids: list = []
    pv_grids: list = []

    # Optimistic run budget: ~1 delta run per variant site (L/1024 slots)
    # + a quarter of the gap slack + flanks; an underestimate pays one
    # exactly-sized re-assembly below.
    cap_r = _pow2_cap(int(L // 1024 + total_gap_slack // 4 + 256))
    assembled = assemble_map_prio_core(
        chars_dev, ref_mat_dev, lengths_dev, pos_grids, pv_grids, fmt, cap_r
    )
    counts = pieces["counts"]
    zeros = torch.zeros(5, dtype=torch.int32, device=device)
    extras_dev = torch.cat(
        [
            counts[:, 0].max()[None],  # 0: max drops per contig
            counts[:, 1].max()[None],  # 1: max gap runs per contig
            # 2: gaps needing the host evaluator; 3,4,5: gaps_seen,
            # gaps_filled, unfilled; 6: variants resolved -- all counters
            # of the refinement, which is off
            zeros,
            pieces["clamped_gap"].sum(dtype=torch.int32)[None],  # 7
        ]
    )

    # ONE fetch: delta runs + counters + overflow indicators together.
    delta = fetch_delta_runs_extras(*assembled, extras_dev, cap_r).cpu().numpy()
    n_runs = int(delta[3, 0])
    extras = delta[3, 2:10]
    max_d, max_g = int(extras[0]), int(extras[1])
    if max_d > cap_d or max_g > cap_g:
        raise DevRefOverflow(max_d, max_g)

    get_stats().add("gap_bases_unfilled", int(extras[7]))

    if n_runs > cap_r:
        # run arrays are emitted capped, so an undersized budget re-runs
        # the (cheap) assembly at the exact size before refetching
        cap_r = _pow2_cap(n_runs)
        assembled = assemble_map_prio_core(
            chars_dev, ref_mat_dev, lengths_dev, pos_grids, pv_grids, fmt, cap_r
        )
        delta = (
            fetch_delta_runs_extras(*assembled, extras_dev, cap_r).cpu().numpy()
        )
        n_runs = int(delta[3, 0])

    canvas, row_lens = _canvas(ref_seqs, Q, L, fmt, ref_mat)
    _paint_runs(
        canvas, delta[0, :n_runs], delta[1, :n_runs], delta[2, :n_runs],
        L, row_lens,
    )
    return [
        canvas[q * L : q * L + row_lens[q]].tobytes()
        for q in range(len(ref_seqs))
    ]
