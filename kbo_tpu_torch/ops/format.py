"""Alignment formatting: run-length encodings.

Mirrors the reference module (reference: src/format.rs):

- :class:`RLE`                (src/format.rs:18-33)
- :func:`run_lengths`         (src/format.rs:98-102)
- :func:`run_lengths_gapped`  (src/format.rs:143-193)

Note the reference RLE doc comment claims 1-based positions but the code emits
0-based start with half-open end (src/format.rs:93-94); the CLI layer adds +1.
We mirror the struct exactly (0-based) -- parity hazard flagged in SURVEY §2.1.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RLE:
    """Run length encoding for an alignment segment (0-based, half-open)."""

    start: int = 0
    end: int = 0
    matches: int = 0
    mismatches: int = 0
    jumps: int = 0
    gap_bases: int = 0
    gap_opens: int = 0


def _as_chars(aln) -> list[str]:
    if isinstance(aln, np.ndarray):
        if aln.dtype == np.uint8:
            return [chr(c) for c in aln]
        return [str(c) for c in aln]
    if isinstance(aln, (bytes, bytearray)):
        return [chr(c) for c in aln]
    return list(aln)


def run_lengths(aln) -> list[RLE]:
    """RLE segments with no gap tolerance (reference: src/format.rs:98-102)."""
    return run_lengths_gapped(aln, 0)


def run_lengths_gapped(aln, max_gap_len: int) -> list[RLE]:
    """RLE segments allowing dash runs up to ``max_gap_len`` bases.

    Semantics pinned against the reference (src/format.rs:143-193) by the
    doctest + 512-char fixtures: a segment opens at the first character
    that is neither ``-`` nor blank and accumulates until a blank, a dash
    run longer than ``max_gap_len``, or the end of input.  A segment that
    terminates *inside* a dash run (overflow, or input ending on a gap
    character) backs that run's open and dash count out of its totals --
    the run belongs to no segment.
    """
    chars = _as_chars(aln)
    n = len(chars)
    segments: list[RLE] = []
    pos = 0
    while pos < n:
        if chars[pos] == "-" or chars[pos] == " ":
            pos += 1
            continue

        seg = RLE(start=pos)
        in_dash_run = False
        # Dashes in the current run.  Deliberately NOT reset when a run
        # closes -- the reference clears it only when a new run opens
        # (src/format.rs:161-165), so the end-of-input back-out below can
        # subtract the PREVIOUS run's dashes when the input ends on 'D'.
        # Quirky, but it is the pinned parity behavior.
        run_dashes = 0
        while pos < n and chars[pos] != " ":
            c = chars[pos]
            if c == "-":
                if not in_dash_run:
                    in_dash_run = True
                    seg.gap_opens += 1
                    run_dashes = 0
                run_dashes += 1
            else:
                in_dash_run = False
            aligned = c in ("M", "R", "I")
            gap = c == "-" or c == "D"
            if aligned:
                seg.matches += 1
            elif gap:
                seg.gap_bases += 1
            else:
                seg.mismatches += 1
            if not gap:
                seg.end = pos + 1
            if c == "R" and pos > 0 and chars[pos - 1] == "R":
                seg.jumps += 1
            pos += 1
            ends_in_gap = gap and pos == n and seg.gap_opens > 0
            if run_dashes > max_gap_len or ends_in_gap:
                # the terminating run is not part of the segment
                seg.gap_opens -= 1
                seg.gap_bases -= run_dashes
                break
        segments.append(seg)
    return segments
