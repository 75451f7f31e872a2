"""kbo-compatible ``.sbwt`` / ``.lcs`` byte-format reader and writer (host
numpy; counterpart of kbo_tpu/index/sbwt_format.py, whose files it reads
and writes byte for byte).

The reference writes a u64-LE length prefix + ``"SubsetMatrix"`` followed by
the sbwt crate's ``SbwtIndex::serialize`` payload (reference:
src/index.rs:128-151, load :195-212). The crate source is not available in
this environment (no cargo, no network -- see BASELINE.md), so the payload
layout below is a DOCUMENTED reconstruction of sbwt v0.3.4 following the
simple-sds serialization conventions it builds on (u64-LE fields, length-
prefixed word vectors, optional support structures). Every field lives in
this module only; if a genuine kbo-built fixture ever disagrees, the fix is
local. The reader is defensive: unknown optional support payloads are
skipped by their word counts, and structural invariants (popcounts,
monotone C, row-walk closure) are verified after parsing.

Payload layout (all integers u64-LE):

``<prefix>.sbwt``::

    u64  12                      -- variant name length
    12B  "SubsetMatrix"
    -- SubsetMatrix subset rank structure --
    u64  4                       -- number of character bitvectors (ACGT)
    4 x BitVector:
        u64  len                 -- bits (= number of SBWT rows)
        u64  ones                -- set bits
        u64  W = ceil(len/64); W x u64 data words
             (bit i = word[i//64] >> (i%64) & 1)
        3 x optional support (rank / select / select0):
            u64 word count (0 = absent), that many u64 words skipped
    -- SbwtIndex fields --
    u64  n_kmers
    u64  k
    -- prefix lookup table --
    u64  prefix_length p
    u64  2^(2p)                  -- entry count
    2^(2p) x (u64 start, u64 end)  -- colex interval per p-mer, lexicographic
                                     A=0 C=1 G=2 T=3 order of the REVERSED
                                     prefix (colex packing)

``<prefix>.lcs``  (simple-sds IntVector)::

    u64  len                     -- elements (= number of SBWT rows)
    u64  width                   -- bits per element
    u64  W = ceil(len*width/64); W x u64 words, LSB-first packing

Loading reconstructs the full :class:`SbwtIndex` (join keys, caps, row
texts) from the bitvectors alone: every row has exactly one incoming edge,
so k rounds of vectorized predecessor propagation (one ``flatnonzero`` per
base = select-all) recover each row's k-mer text in O(n k) numpy work.
"""

from __future__ import annotations

import struct

import numpy as np

from kbo_tpu_torch.index.build import _popcount32, join_tables_from_packed
from kbo_tpu_torch.index.sbwt import N_BASES, SbwtIndex

_VARIANT = b"SubsetMatrix"


# ------------------------------------------------------------------ writing
def _pack_bits_u64(bools: np.ndarray) -> np.ndarray:
    """bool [n] -> u64 words, bit i at word i//64 position i%64."""
    n = bools.size
    W = (n + 63) // 64
    padded = np.zeros(W * 64, dtype=bool)
    padded[:n] = bools
    b = np.packbits(padded.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)
    return b.view(np.uint64) if b.size else np.zeros(0, dtype=np.uint64)


def _unpack_bits_u64(words: np.ndarray, n: int) -> np.ndarray:
    b = np.frombuffer(
        np.ascontiguousarray(words, dtype=np.uint64).tobytes(), dtype=np.uint8
    )
    bools = np.unpackbits(b, bitorder="little")
    return bools[:n].astype(bool)


def _expand_rows(index: SbwtIndex, base: int) -> np.ndarray:
    """Bool [n_rows] bitvector for one base from the packed 32-bit words."""
    n = index.n_rows
    w = np.asarray(index.bits[base], dtype=np.uint32)
    b = np.frombuffer(w.tobytes(), dtype=np.uint8)
    return np.unpackbits(b, bitorder="little")[:n].astype(bool)


def _prefix_lookup(index: SbwtIndex, p: int) -> np.ndarray:
    """[4^p, 2] colex interval per p-mer: rows whose last p characters
    equal the p-mer. Computed by binary search on the packed colex keys
    (top p 3-bit chunks of keys3 word 0; requires p <= 10)."""
    assert p <= 10
    top = (np.asarray(index.keys3[0], dtype=np.uint64) >> np.uint64(30 - 3 * p))
    pm = np.arange(4 ** p, dtype=np.uint64)
    # 2-bit p-mer id -> packed 3-bit chunks (code = base + 1), colex: the
    # table is indexed by the p-mer read left-to-right; chunk 0 (most
    # significant) is the LAST character
    key = np.zeros(4 ** p, dtype=np.uint64)
    for j in range(p):
        base2 = (pm >> np.uint64(2 * (p - 1 - j))) & np.uint64(3)
        key |= (base2 + np.uint64(1)) << np.uint64(3 * (p - 1 - j))
    lo = np.searchsorted(top, key, side="left")
    hi = np.searchsorted(top, key, side="right")
    return np.stack([lo, hi], axis=1).astype(np.uint64)


def write_kbo_sbwt(
    prefix: str, index: SbwtIndex, precalc_length: int = 8
) -> tuple[str, str]:
    """Write ``<prefix>.sbwt`` + ``<prefix>.lcs`` in the documented
    kbo/sbwt-crate byte layout; returns both paths."""
    sbwt_path, lcs_path = f"{prefix}.sbwt", f"{prefix}.lcs"
    n = index.n_rows
    with open(sbwt_path, "wb") as fh:
        fh.write(struct.pack("<Q", len(_VARIANT)))
        fh.write(_VARIANT)
        fh.write(struct.pack("<Q", N_BASES))
        for b in range(N_BASES):
            bools = _expand_rows(index, b)
            words = _pack_bits_u64(bools)
            fh.write(struct.pack("<QQ", n, int(bools.sum())))
            fh.write(struct.pack("<Q", words.size))
            fh.write(words.tobytes())
            fh.write(struct.pack("<QQQ", 0, 0, 0))  # supports absent
        fh.write(struct.pack("<QQ", index.n_kmers, index.k))
        # the table keys are length-p prefixes: p must not exceed k (a
        # longer "prefix" can never match any row) nor one packed word
        p = min(precalc_length, 10, index.k)
        lut = _prefix_lookup(index, p)
        fh.write(struct.pack("<QQ", p, lut.shape[0]))
        fh.write(np.ascontiguousarray(lut).tobytes())
    with open(lcs_path, "wb") as fh:
        lcs = np.asarray(index.lcs, dtype=np.uint64)
        width = max(1, int(index.k - 1).bit_length())
        # LSB-first element packing: element i occupies bits
        # [i*width, (i+1)*width)
        flat = np.zeros(n * width, dtype=bool)
        for j in range(width):
            flat[j::width] = ((lcs >> np.uint64(j)) & np.uint64(1)).astype(bool)
        words = _pack_bits_u64(flat)
        fh.write(struct.pack("<QQQ", n, width, words.size))
        fh.write(words.tobytes())
    return sbwt_path, lcs_path


# ------------------------------------------------------------------ reading
class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.off)
        self.off += 8
        return v

    def words(self, count: int) -> np.ndarray:
        out = np.frombuffer(
            self.data, dtype="<u8", count=count, offset=self.off
        )
        self.off += 8 * count
        return out

    def raw(self, nbytes: int) -> bytes:
        out = self.data[self.off : self.off + nbytes]
        self.off += nbytes
        return out


def _read_bitvector(r: _Reader) -> np.ndarray:
    n = r.u64()
    ones = r.u64()
    W = r.u64()
    if W != (n + 63) // 64:
        raise ValueError(f"bitvector word count {W} != ceil({n}/64)")
    bools = _unpack_bits_u64(r.words(W), n)
    if int(bools.sum()) != ones:
        raise ValueError("bitvector popcount mismatch")
    for _ in range(3):  # optional rank/select/select0 supports
        cnt = r.u64()
        if cnt:
            r.words(cnt)
    return bools


def _rebuild_from_bitvectors(
    rows: list[np.ndarray], n_kmers: int, k: int, lcs: np.ndarray
) -> SbwtIndex:
    """Reconstruct the full index from the 4 subset-matrix bitvectors.

    Every non-root row has exactly one incoming edge labeled with its last
    character; k-1 rounds of predecessor gathers recover all row texts
    (codes matrix), from which the packed join keys, caps, and the
    access-text derive. Runs in O(n k) vectorized numpy.
    """
    n = rows[0].size
    # C array + last characters from the edge counts: rows [C[b], C[b+1])
    # end with base b+1; row 0 is the all-'$' root
    ones = [int(r.sum()) for r in rows]
    C = np.cumsum([1] + ones[:-1]).astype(np.int32)
    if 1 + sum(ones) != n:
        raise ValueError("edge count != n_rows - 1 + root")
    last = np.zeros(n, dtype=np.uint8)
    bounds = np.concatenate([C.astype(np.int64), [n]])
    for b in range(N_BASES):
        last[bounds[b] : bounds[b + 1]] = b + 1
    pred = np.zeros(n, dtype=np.int64)
    for b in range(N_BASES):
        pred[bounds[b] : bounds[b + 1]] = np.flatnonzero(rows[b])
    codes = np.zeros((n, k), dtype=np.uint8)
    cur = np.arange(n, dtype=np.int64)
    for j in range(k - 1, -1, -1):
        codes[:, j] = last[cur]
        cur = pred[cur]

    # packed keys from the codes matrix (same chunk layout as index.build)
    W3, W2 = (k + 9) // 10, (k + 15) // 16
    w3 = []
    for w in range(W3):
        acc = np.zeros(n, dtype=np.uint32)
        for j in range(10):
            t = w * 10 + j
            if t >= k:
                break
            acc |= codes[:, k - 1 - t].astype(np.uint32) << np.uint32(
                27 - 3 * j
            )
        w3.append(acc)
    c2 = (codes.astype(np.uint32) - 1) & 3
    c2[codes == 0] = 3  # '$' packs as chunk 3 in 2-bit space
    w2 = []
    for w in range(W2):
        acc = np.zeros(n, dtype=np.uint32)
        for j in range(16):
            t = w * 16 + j
            if t >= k:
                break
            acc |= c2[:, k - 1 - t] << np.uint32(30 - 2 * j)
        w2.append(acc)
    # rows must already be colex-sorted; verify on the packed keys
    if n > 1:
        gt = np.zeros(n - 1, dtype=bool)
        decided = np.zeros(n - 1, dtype=bool)
        for w in range(W3):
            a, b2 = w3[w][:-1], w3[w][1:]
            gt |= ~decided & (a > b2)
            decided |= a != b2
        if gt.any():
            raise ValueError("rows not in colex order")

    v = (codes != 0).astype(np.int32)[:, ::-1].cumprod(axis=1).sum(axis=1)
    v = np.minimum(v, k).astype(np.int32)
    keys2, cap2 = join_tables_from_packed(w2, v, k)

    n_words = n // 32 + 1
    bits = np.zeros((N_BASES, n_words), dtype=np.uint32)
    for b in range(N_BASES):
        s = np.flatnonzero(rows[b])
        np.bitwise_or.at(
            bits[b], s >> 5, (np.uint32(1) << (s & 31).astype(np.uint32))
        )
    pc = _popcount32(bits).astype(np.int64)
    cum = np.zeros((N_BASES, n_words), dtype=np.int64)
    cum[:, 1:] = np.cumsum(pc, axis=1)[:, :-1]

    # access text: per-row k-mer chunks; row i's window ends at i*k + k-1
    text = codes.reshape(-1)
    row_pos = (np.arange(n, dtype=np.int64) * k) + (k - 1)
    index = SbwtIndex(
        k=k,
        n_rows=n,
        n_kmers=n_kmers,
        bits=bits,
        cum=cum.astype(np.int32),
        C=C,
        lcs=np.asarray(lcs, dtype=np.uint8),
        keys2=keys2,
        cap2=cap2.astype(np.int32),
        keys3=np.stack(w3),
        row_pos=row_pos,
        text=text,
        # the text above is per-row ACCESS chunks, not a construction
        # buffer: a device rebuild from it would be garbage (and k-times
        # oversized)
        text_is_access=True,
    )
    return index


def read_kbo_sbwt(prefix: str) -> SbwtIndex:
    """Load a ``.sbwt``/``.lcs`` file pair in the kbo byte layout and
    reconstruct the full index."""
    with open(f"{prefix}.sbwt", "rb") as fh:
        r = _Reader(fh.read())
    name_len = r.u64()
    variant = r.raw(name_len)
    if variant != _VARIANT:
        raise ValueError(
            f"unsupported SBWT variant {variant!r} (expected {_VARIANT!r})"
        )
    n_sets = r.u64()
    if n_sets != N_BASES:
        raise ValueError(f"expected 4 bitvectors, found {n_sets}")
    rows = [_read_bitvector(r) for _ in range(N_BASES)]
    n_kmers = r.u64()
    k = r.u64()
    if not 1 < k < 256:
        raise ValueError(f"implausible k = {k}")
    # prefix lookup table: parsed and discarded (the sort-join engine does
    # not use interval precalc; documented at opts.py prefix_precalc)
    p = r.u64()
    cnt = r.u64()
    if cnt != 4 ** p:
        raise ValueError(f"prefix table count {cnt} != 4^{p}")
    r.words(2 * cnt)

    with open(f"{prefix}.lcs", "rb") as fh:
        r2 = _Reader(fh.read())
    n_elem = r2.u64()
    width = r2.u64()
    W = r2.u64()
    if W != (n_elem * width + 63) // 64:
        raise ValueError(".lcs bit-packing word count mismatch")
    flat = _unpack_bits_u64(r2.words(W), n_elem * width)
    lcs = np.zeros(n_elem, dtype=np.uint64)
    for j in range(width):
        lcs |= flat[j::width].astype(np.uint64) << np.uint64(j)

    index = _rebuild_from_bitvectors(rows, n_kmers, int(k), lcs)
    if index.n_rows != n_elem:
        raise ValueError(".lcs length != row count")
    return index
