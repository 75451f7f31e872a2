"""Derandomizing noisy k-bounded matching statistics.

Mirrors the reference module (reference: src/derandomize.rs):

- :func:`log_rm_max_cdf`        (src/derandomize.rs:91-100)
- :func:`random_match_threshold` (src/derandomize.rs:127-145)
- :func:`derandomize_ms_val`    (src/derandomize.rs:221-247)
- :func:`derandomize_ms_vec`    (src/derandomize.rs:269-288)

The threshold is integer-valued from a float64 CDF; it is always computed on
the host in float64 to match the reference bit-for-bit. The vector pass is
the sequential reference; the parallel (anchor/parity) reformulation for
device execution lives in ``kbo_tpu_torch.kernels.postprocess``.
"""

from __future__ import annotations

import math

import numpy as np


def log_rm_max_cdf(t: int, alphabet_size: int, n_kmers: int) -> float:
    """Log-CDF of the max random match length: n * log(1 - (1/sigma)^(t+1))."""
    assert n_kmers > 0
    assert alphabet_size > 0
    q = math.exp(math.log(1.0) - math.log(float(alphabet_size)))
    return n_kmers * math.log1p(-(q ** (t + 1)))


def random_match_threshold(
    k: int, n_kmers: int, alphabet_size: int, max_error_prob: float
) -> int:
    """Smallest t in 1..k with cdf > log(1 - p); k if none passes."""
    assert k > 0
    assert n_kmers > 0
    assert alphabet_size > 0
    assert 0.0 < max_error_prob <= 1.0
    bound = math.log1p(-max_error_prob)
    for i in range(1, k):
        if log_rm_max_cdf(i, alphabet_size, n_kmers) > bound:
            return i
    return k


def derandomize_ms_val(
    curr_noisy_ms: int, next_derand_ms: int, threshold: int, k: int
) -> int:
    """Derandomize one MS value given the derandomized right neighbor."""
    assert k > 0
    assert threshold > 1
    assert curr_noisy_ms <= k
    assert next_derand_ms <= k

    run = next_derand_ms - 1
    if curr_noisy_ms == k:
        # beginning of a full k-mer match
        run = k
    if curr_noisy_ms > threshold and next_derand_ms < curr_noisy_ms:
        # beginning of a partial k-mer match
        run = curr_noisy_ms
    return run


def derandomize_ms_vec(noisy_ms, k: int, threshold: int) -> np.ndarray:
    """Sequential right-to-left derandomization (reference semantics)."""
    noisy = np.asarray(noisy_ms, dtype=np.int64)
    assert k > 0
    assert threshold > 1
    assert noisy.size > 2

    n = noisy.size
    out = np.zeros(n, dtype=np.int64)
    out[n - 1] = noisy[n - 1] if noisy[n - 1] > threshold else 0
    for i in range(n - 2, -1, -1):
        out[i] = derandomize_ms_val(int(noisy[i]), int(out[i + 1]), threshold, k)
    return out
