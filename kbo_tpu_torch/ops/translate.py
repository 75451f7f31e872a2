"""Translating derandomized matching statistics into alignment characters.

Mirrors the reference module (reference: src/translate.rs):

- :func:`translate_ms_val` (src/translate.rs:180-216)
- :func:`translate_ms_vec` (src/translate.rs:263-293)
- :func:`add_variants`     (src/translate.rs:350-386)

Character vocabulary: 'M' match, 'X' mismatch/1-char insert, '-' multi-char
insert, 'R','R' discontinuity, plus 'I'/'D'/nucleotides after add_variants.

This is the sequential reference; the vectorized stencil with the RR-run
parity rule lives in ``kbo_tpu_torch.kernels.postprocess``.
"""

from __future__ import annotations

import numpy as np


def translate_ms_val(
    ms_curr: int, ms_next: int, ms_prev: int, threshold: int
) -> tuple[str, str]:
    """Translate one derandomized MS value from its 3-point neighborhood."""
    assert threshold > 1
    aln_next = " "
    if ms_curr > threshold and 0 < ms_next < threshold:
        # jump to another k-mer / deletion of unknown length in the query
        aln_curr = "R"
        aln_next = "R"
    elif ms_curr <= 0:
        if ms_next == 1 and ms_prev > 0:
            aln_curr = "X"  # mismatch or 1-char insertion
        else:
            aln_curr = "-"  # insertion of more than 1 character
    else:
        aln_curr = "M"
    return aln_curr, aln_next


def translate_ms_vec(derand_ms, k: int, threshold: int) -> list[str]:
    """Translate a derandomized MS vector into alignment characters."""
    ms = np.asarray(derand_ms, dtype=np.int64)
    assert k > 0
    assert threshold > 1
    assert ms.size > 2

    n = ms.size
    res = [" "] * n
    for pos in range(n):
        prev = int(ms[pos - 1]) if pos > 1 else k
        curr = int(ms[pos])
        nxt = int(ms[pos + 1]) if pos < n - 1 else int(ms[pos])

        # two consecutive 'R's mean this pos was set by the previous iteration
        if not (pos > 1 and res[pos - 1] == "R" and res[pos] == "R"):
            aln_curr, aln_next = translate_ms_val(curr, nxt, prev, threshold)
            res[pos] = aln_curr
            if pos + 1 < n - 1 and aln_next != " ":
                res[pos + 1] = aln_next
    return res


def add_variants(translation, variants) -> list[str]:
    """Merge called variants into a translated alignment.

    Mirrors add_variants (reference: src/translate.rs:350-386): substitutions
    write the reference characters; insertions into the reference replace the
    two 'R's with 'I's; deletions mark 'D's; unequal multi-base substitutions
    fill with the uniform ref char or 'N'. The oracle form of
    :func:`variant_patches`.
    """
    refined = list(translation)
    for pos, ch in variant_patches(variants):
        refined[pos] = chr(ch)
    return refined


def variant_patches(variants) -> list[tuple[int, int]]:
    """add_variants as (position, ascii) writes (same order, last wins), so
    the map path lands variant edits in the device-resident translation
    (kernels/mapsweep.py assemble_map_core) instead of building the
    characters on the host."""
    patches: list[tuple[int, int]] = []
    for var in variants:
        q = var.query_chars
        r = var.ref_chars
        if len(q) == len(r):
            for i, nt in enumerate(r):
                patches.append((var.query_pos + i, nt))
        elif len(q) == 0:
            # the reference indexes refined[query_pos - 1] (translate.rs:
            # 366-368), which panics for an insertion at position 0;
            # Python's -1 would silently wrap to the LAST character
            assert var.query_pos > 0, "insertion variant at position 0"
            patches.append((var.query_pos - 1, ord("I")))
            patches.append((var.query_pos, ord("I")))
        elif len(r) == 0:
            for i in range(len(q)):
                patches.append((var.query_pos + i, ord("D")))
        else:
            fill = r[0] if len(set(r)) == 1 else ord("N")
            for i in range(len(q)):
                patches.append((var.query_pos + i, fill))
    return patches
