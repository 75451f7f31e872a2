"""Translating derandomized matching statistics into alignment characters.

Mirrors the reference module (reference: src/translate.rs):

- :func:`translate_ms_val` (src/translate.rs:180-216)
- :func:`translate_ms_vec` (src/translate.rs:263-293)

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
