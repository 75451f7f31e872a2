"""k-bounded matching statistics: the scalar SBWT walk (host numpy;
counterpart of kbo_tpu/ops/ms.py).

MS[i] = length (capped at k) of the longest suffix of query[..=i] that occurs
in the index (i.e. is the suffix of some SBWT row), together with its colex
interval. Mirrors ``query_sbwt`` / ``StreamingIndex::matching_statistics``
(reference: src/index.rs:243-256; golden vector src/index.rs:224-241).

MS[i] depends only on the k-window ending at i, so each position
binary-searches its longest matching suffix length with fresh interval
searches. The batched device form is kernels/ms.py; this walk is the
tests' oracle, and no entry point of the port calls it.
"""

from __future__ import annotations

import numpy as np

from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.index.sbwt import SbwtIndex


def _suffix_interval(index: SbwtIndex, codes: np.ndarray, end: int, length: int):
    """Interval of codes[end-length+1 ..= end] as a row suffix, or None."""
    l, r = 0, index.n_rows
    for j in range(end - length + 1, end + 1):
        l, r = index.extend(l, r, int(codes[j]))
        if l >= r:
            return None
    return (l, r)


def query_ms_codes(index: SbwtIndex, codes: np.ndarray):
    """MS values + colex intervals for an encoded query.

    Returns (ms [n] int64, intervals [n, 2] int64). For MS value 0 the
    interval is the full row range [0, n_rows) (the empty-string interval).
    """
    n = codes.size
    k = index.k
    ms = np.zeros(n, dtype=np.int64)
    ivals = np.zeros((n, 2), dtype=np.int64)
    ivals[:, 1] = index.n_rows
    for i in range(n):
        lo, hi = 0, min(k, i + 1)
        best = (0, index.n_rows)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            res = _suffix_interval(index, codes, i, mid)
            if res is not None:
                lo = mid
                best = res
            else:
                hi = mid - 1
        ms[i] = lo
        if lo > 0:
            ivals[i] = best
    return ms, ivals


def query_ms(index: SbwtIndex, query: bytes):
    """MS values + intervals for an ASCII query (mirrors query_sbwt)."""
    return query_ms_codes(index, encode_ascii(query))
