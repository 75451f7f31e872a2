"""The SBWT index data structure (subset-matrix representation).

Layout is designed for TPU rank queries: per base, the bitvector is stored as
32-bit words interleaved with an exclusive popcount prefix so that a single
8-byte gather answers one rank query. The same arrays serve the host (numpy)
reference path and the device (JAX) batched path.

Semantics mirror the sbwt crate as consumed by the reference
(reference: src/index.rs:22-25, src/variant_calling.rs:4):

- Rows are the distinct length-k windows of ``$^k + segment`` for every
  maximal ACGT run of every input sequence, colex-sorted with ``$`` smallest.
- Row i's subset contains base c iff row i is the colex-smallest row with its
  (k-1)-suffix and ``suffix + c`` is also a row; every non-root row therefore
  has exactly one incoming edge.
- ``C[c]`` = number of rows whose last character sorts before c
  (row 0 is the all-$ root, the only row ending in '$').
- Pattern search extends right: interval [l, r) for P becomes
  ``[C[c] + rank_c(l), C[c] + rank_c(r))`` for P + c.
- ``lcs[i]`` = longest common suffix of rows i-1 and i (lcs[0] = 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from kbo_tpu_torch.index.encode import DOLLAR, decode_codes

N_BASES = 4  # A, C, G, T (codes 1..4; bitvector index = code - 1)


@dataclasses.dataclass
class SbwtIndex:
    """Subset-matrix SBWT with rank support and LCS array."""

    k: int
    n_rows: int
    n_kmers: int
    #: uint32 [4, n_words]; bit j of word w covers row w*32+j (base order ACGT)
    bits: np.ndarray
    #: int32 [4, n_words]; exclusive popcount prefix per word
    cum: np.ndarray
    #: int32 [4]; rows ending with a character < base
    C: np.ndarray
    #: uint8 [n_rows]; longest common suffix with previous row
    lcs: np.ndarray
    #: uint32 [W2, n_rows]; 2-bit keys of ALL rows ('$' packs as chunk 3),
    #: sorted by 2-bit key, for the sort-join MS engine (kbo_tpu_torch.kernels.ms)
    keys2: Optional[np.ndarray] = None
    #: int32 [n_rows]; per-row match cap aligned with keys2: k for real
    #: k-mer rows, the real-suffix length v for '$'-padded dummy rows
    cap2: Optional[np.ndarray] = None
    #: uint32 [W3, n_rows]; colex-packed 3-bit keys of all rows ('$'=0)
    keys3: Optional[np.ndarray] = None
    #: int64 [n_rows]; text position of each colex row's window END (keys3
    #: order). Any one occurrence; rows are distinct strings so the k-mer
    #: text read from any occurrence is identical.
    row_pos: Optional[np.ndarray] = None
    #: uint8 [T]; usually the packed construction buffer: k '$' (0) codes
    #: before each maximal ACGT segment, then the segment's codes (1..4).
    #: Rows are exactly the distinct k-windows of this buffer, so k-mer
    #: extraction is a slice -- the TPU-native replacement for the
    #: reference's select-walk ``access_kmer`` (src/variant_calling.rs:276).
    #: For indexes reconstructed from a ``.sbwt`` file it is instead the
    #: per-row access chunks (row i's window ends at i*k + k - 1) and
    #: ``text_is_access`` is True.
    text: Optional[np.ndarray] = None
    #: True when ``text`` holds per-row access chunks rather than a
    #: construction buffer (a device rebuild from access chunks would
    #: produce garbage join tables -- kernels/ms.py checks this flag)
    text_is_access: bool = False

    # ------------------------------------------------------------------ meta
    @property
    def n_words(self) -> int:
        return self.bits.shape[1]

    def alphabet(self) -> bytes:
        return b"ACGT"

    # ------------------------------------------------------------- rank/sel
    def rank(self, base: int, pos: int) -> int:
        """Set bits of bitvector `base` (0..3) in rows [0, pos)."""
        w, b = divmod(int(pos), 32)
        if w >= self.n_words:
            return int(self.cum[base, -1]) + int(
                bin(int(self.bits[base, -1])).count("1")
            )
        word = int(self.bits[base, w])
        return int(self.cum[base, w]) + bin(word & ((1 << b) - 1)).count("1")

    def select(self, base: int, t: int) -> int:
        """Row index of the t-th (0-based) set bit of bitvector `base`."""
        w = int(np.searchsorted(self.cum[base], t, side="right")) - 1
        word = int(self.bits[base, w])
        rem = t - int(self.cum[base, w])
        for b in range(32):
            if (word >> b) & 1:
                if rem == 0:
                    return w * 32 + b
                rem -= 1
        raise ValueError(f"select({base}, {t}) out of range")

    # ----------------------------------------------------------- search ops
    def extend(self, l: int, r: int, code: int) -> tuple[int, int]:
        """Append base `code` (1..4) to the pattern with interval [l, r)."""
        if not 1 <= code <= 4:
            return (0, 0)
        base = code - 1
        c0 = int(self.C[base])
        return (c0 + self.rank(base, l), c0 + self.rank(base, r))

    def search_codes(self, codes: np.ndarray) -> Optional[tuple[int, int]]:
        """Colex interval of rows having `codes` as a suffix, or None.

        Mirrors ``SbwtIndex::search`` (reference: src/gap_filling.rs:217,593).
        """
        l, r = 0, self.n_rows
        for code in codes:
            l, r = self.extend(l, r, int(code))
            if l >= r:
                return None
        return (l, r)

    def last_char_code(self, row: int) -> int:
        """Code (0=$, 1..4) of the last character of `row`."""
        # C[] boundaries partition rows by last char: [0, C[0]) end with '$',
        # [C[b], C[b+1]) end with base b.
        bounds = list(self.C) + [self.n_rows]
        if row < bounds[0]:
            return DOLLAR
        for b in range(N_BASES):
            if bounds[b] <= row < bounds[b + 1]:
                return b + 1
        raise ValueError(f"row {row} out of range")

    def access_kmer_codes(self, row: int) -> np.ndarray:
        """Reconstruct the k-length code string of a colex row.

        Text-slice fast path when the packed text is present (every row is
        a k-window of ``text``); otherwise k backward select-walk steps.
        Mirrors ``SbwtIndex::access_kmer`` / ``push_kmer_to_vec``
        (reference: src/variant_calling.rs:276, src/gap_filling.rs:144,594).
        """
        if self.text is not None:
            p = int(self.row_pos[int(row)])
            return np.asarray(self.text[p - self.k + 1 : p + 1])
        out = np.zeros(self.k, dtype=np.uint8)
        cur = int(row)
        for j in range(self.k - 1, -1, -1):
            code = self.last_char_code(cur)
            out[j] = code
            if code == DOLLAR:
                break  # rows to the left are all '$'
            cur = self.select(code - 1, cur - int(self.C[code - 1]))
        return out

    def access_kmer(self, row: int) -> bytes:
        """ASCII k-mer at a colex row ('$' for dummy positions)."""
        return decode_codes(self.access_kmer_codes(row))

    def access_kmers_codes(self, rows: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`access_kmer_codes` over a batch of rows.

        With text: one fancy-indexed slice. Without: k backward steps, each
        a vectorized (searchsorted + in-word binary select) over all lanes.
        Used by the batched variant caller and gap filler (SURVEY §7.3).
        """
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        if self.text is not None:
            p = np.asarray(self.row_pos, dtype=np.int64)[rows]
            offs = np.arange(-self.k + 1, 1, dtype=np.int64)
            return np.asarray(self.text)[p[:, None] + offs[None, :]]
        n = rows.size
        out = np.zeros((n, self.k), dtype=np.uint8)
        cur = rows.copy()
        alive = np.ones(n, dtype=bool)
        bounds = np.asarray(self.C, dtype=np.int64)
        pop = np.bitwise_count
        for j in range(self.k - 1, -1, -1):
            code = np.searchsorted(bounds, cur, side="right").astype(np.uint8)
            code[~alive] = 0
            out[:, j] = code
            alive &= code != 0
            nxt = cur.copy()
            for b in range(4):
                m = alive & (code == b + 1)
                if not m.any():
                    continue
                t = cur[m] - bounds[b]
                w = np.searchsorted(self.cum[b], t, side="right") - 1
                rem = (t - self.cum[b][w]).astype(np.uint32)
                word = self.bits[b][w]
                pos = np.zeros(m.sum(), dtype=np.uint32)
                for width in (16, 8, 4, 2, 1):
                    seg = np.uint32((1 << width) - 1) << pos
                    cnt = pop(word & seg).astype(np.uint32)
                    right = rem >= cnt
                    rem = np.where(right, rem - cnt, rem)
                    pos = np.where(right, pos + width, pos)
                nxt[m] = w * 32 + pos
            cur = nxt
        return out


def index_from_arrays(fields: dict) -> SbwtIndex:
    """An :class:`SbwtIndex` from another build's fields, as plain numpy
    arrays and ints -- e.g. ``dataclasses.asdict`` of a kbo_tpu index --
    so an index built elsewhere serves the port without a rebuild."""
    kw = {}
    for f in dataclasses.fields(SbwtIndex):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name in ("k", "n_rows", "n_kmers"):
            v = int(v)
        elif f.name == "text_is_access":
            v = bool(v)
        elif v is not None:
            v = np.asarray(v)
        kw[f.name] = v
    return SbwtIndex(**kw)
