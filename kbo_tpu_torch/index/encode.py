"""Nucleotide encoding helpers (host side, numpy).

Character codes used throughout the package:

- ``$`` (dummy/pad)  -> 0
- ``A``/``a``        -> 1
- ``C``/``c``        -> 2
- ``G``/``g``        -> 3
- ``T``/``t``        -> 4
- anything else      -> INVALID (255)

Colexicographic order with ``$`` smallest matches the reference index's row
order (reference: sbwt crate consumed via src/index.rs:22-25; behavior pinned
by the MS golden vector at src/index.rs:224-241).
"""

from __future__ import annotations

import numpy as np

DOLLAR = 0
INVALID = 255

# ASCII -> code lookup table.
_LUT = np.full(256, INVALID, dtype=np.uint8)
for _i, _chars in enumerate((b"$", b"Aa", b"Cc", b"Gg", b"Tt")):
    for _ch in _chars:
        _LUT[_ch] = _i

# code -> ASCII (index 0 is '$')
CODE_TO_ASCII = np.frombuffer(b"$ACGT", dtype=np.uint8).copy()

# ASCII complement table for reverse complements (A<->T, C<->G); other
# characters map to 'N' so they stay invalid.
_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[_a] = _b


def encode_ascii(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII bytes -> uint8 codes (0=$, 1..4=ACGT, 255=invalid)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return _LUT[arr]


def decode_codes(codes: np.ndarray) -> bytes:
    """uint8 codes -> ASCII bytes ('$' for 0)."""
    return CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes()


def revcomp_ascii(seq: bytes) -> bytes:
    """Reverse complement of an ASCII sequence."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _COMP[arr][::-1].tobytes()


def split_segments(codes: np.ndarray) -> list[np.ndarray]:
    """Split a code sequence into maximal runs of valid (ACGT) codes.

    The reference index treats non-ACGT characters as sequence breaks: k-mers
    never span them, and each run restarts with its own dummy ($-padded)
    prefixes (behavior pinned by the golden MS vector for a reference
    containing '-', src/index.rs:229-240).
    """
    valid = codes != INVALID
    # also treat any literal '$' in the input as invalid
    valid &= codes != DOLLAR
    if not valid.any():
        return []
    boundaries = np.flatnonzero(np.diff(valid.astype(np.int8)) != 0) + 1
    pieces = np.split(codes, boundaries)
    out = []
    pos = 0
    for piece in pieces:
        if piece.size and valid[pos]:
            out.append(piece)
        pos += piece.size
    return out
