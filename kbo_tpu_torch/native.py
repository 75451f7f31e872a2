"""The port's native host library, in C++ (``native_src/``): the map
upload's 2-bit pack, the device index builds' construction buffers and the
FASTA/FASTQ scanner (``pack.cpp``, ``fastx.cpp``), and the single-core
engine (``kbo_cpu.cpp``, ``kbo_refine.cpp``): streaming matching
statistics over the SBWT's rank arrays, derandomize and translate, the
index build, gap filling and variant calling, which together run one ``kbo
map`` end to end on one CPU core (:func:`map_e2e`), the oracle that the
device path is held against at full size.

The four sources compile with ``g++`` into one shared library with a plain C
interface under ``kbo_tpu_torch/_build/`` at first use, and load through
``ctypes``. The library is named by a hash of its sources and flags, so an
edited source rebuilds and an unchanged one loads from disk; a build writes
a temporary name and renames it into place, so processes that build at
once (parallel test workers) never load a half-written file. A missing
``g++`` or a failed build raises: nothing falls back to numpy or Python.
Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "native_src"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("pack.cpp", "fastx.cpp", "kbo_cpu.cpp", "kbo_refine.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libkbo_host-{h.hexdigest()[:12]}.so"


def build() -> float:
    """Compile the library if it has not been built yet. Returns the
    seconds spent (0 when it was on disk)."""
    out = _lib_path()
    if out.exists():
        return 0.0
    t0 = time.perf_counter()
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library builds "
                           "from kbo_tpu_torch/native_src at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            "g++ failed for the native host library:\n"
            + proc.stdout.decode(errors="replace")
            + proc.stderr.decode(errors="replace")
        )
    os.replace(tmp, out)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded library, built if needed, with its entry points typed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_lib_path()))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            lib.kbo_ms_stream.argtypes = [
                u32p, i32p, i32p, u8p, i64, i64, i32,
                u8p, i64, i32p, i64p, i64p,
            ]
            lib.kbo_ms_stream.restype = None
            lib.kbo_derandomize.argtypes = [i32p, i64, i32, i32, i64p]
            lib.kbo_derandomize.restype = None
            lib.kbo_translate.argtypes = [i64p, i64, i32, i32, u8p]
            lib.kbo_translate.restype = None
            lib.kbo_build.argtypes = [u8p, i64, i32]
            lib.kbo_build.restype = i64
            lib.kbo_build_export.argtypes = [u32p, i32p, i32p, u8p, i64p]
            lib.kbo_build_export.restype = None
            lib.kbo_fill_gaps.argtypes = [
                u8p, i64, i64p, i64p, u8p, u8p, i64p,
                u32p, i32p, i32p, i64, i64, i32, i32, ctypes.c_double,
            ]
            lib.kbo_fill_gaps.restype = None
            lib.kbo_call_variants.argtypes = [
                i32p, i64p, i64p, u8p, i64,
                u8p, i64p, u32p, i32p, i32p, u8p, i64, i64,
                u32p, i32p, i32p, u8p, i64, i64, i32, i32,
                i64p, i32p, i32p, u8p, u8p, i64,
            ]
            lib.kbo_call_variants.restype = i64
            lib.kbo_pack_ascii.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, i32p,
                u8p, i64p, u8p, ctypes.c_int64,
            ]
            lib.kbo_pack_ascii.restype = ctypes.c_int64
            lib.kbo_index_text.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), i64p, i64, i32, i32, i32,
                ctypes.c_void_p, i64,
            ]
            lib.kbo_index_text.restype = i64
            for name in ("fastx_scan_fasta", "fastx_scan_fastq"):
                fn = getattr(lib, name)
                fn.argtypes = [
                    u8p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ]
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def pack_ascii(ref_mat: np.ndarray, lengths):
    """The native 2-bit pack of a [Q, L] raw ASCII matrix (0-padded rows):
    (packed4 uint8 [Q, L//4], exc_pos int32, exc_byte uint8) with the
    exception list padded to a power of two (at least 64) with position
    Q*L, or None when L % 4 != 0 or the exceptions exceed max(64, Q*L/16)
    -- the contract of kernels.mapsweep.pack_ascii_plain, byte for byte."""
    ref_mat = np.ascontiguousarray(ref_mat, dtype=np.uint8)
    Q, L = ref_mat.shape
    if L % 4:
        return None
    lens = np.ascontiguousarray(np.asarray(lengths)[:Q], dtype=np.int32)
    max_e = max(64, Q * L // 16)
    packed4 = np.empty((Q, L // 4), dtype=np.uint8)
    exc_pos = np.empty(max_e, dtype=np.int64)
    exc_byte = np.empty(max_e, dtype=np.uint8)
    n_exc = int(lib().kbo_pack_ascii(
        ref_mat.reshape(-1), Q, L, lens, packed4.reshape(-1),
        exc_pos, exc_byte, max_e,
    ))
    if n_exc > max_e:
        return None
    cap_e = 64
    while cap_e < n_exc:
        cap_e <<= 1
    pos_pad = np.full(cap_e, Q * L, dtype=np.int32)
    byte_pad = np.zeros(cap_e, dtype=np.uint8)
    pos_pad[:n_exc] = exc_pos[:n_exc]
    byte_pad[:n_exc] = exc_byte[:n_exc]
    return packed4, pos_pad, byte_pad


def index_text(seqs, k: int, add_revcomp: bool, full: bool, bucket):
    """A device index's construction buffer, sized, then written from the
    contigs' raw bytes in one pass: (buf uint8, text size). The sequence layout
    (``full`` false) is ``k - 1`` INVALID, then ``text`` codes, INVALID to
    ``k - 1 + bucket(text)``; the full layout is ``text`` codes, INVALID to
    ``bucket(text)``. The layouts and their numpy forms are in
    ``kernels/ms.py`` (``seq_index_buffer_plain``,
    ``full_index_buffer_plain``)."""
    seqs = list(map(bytes, seqs))  # bytes(b) is b: no copy
    n = len(seqs)
    ptrs = (ctypes.c_char_p * n)(*seqs)
    lens = np.fromiter(map(len, seqs), dtype=np.int64, count=n)
    fn = lib().kbo_index_text
    text = int(fn(ptrs, lens, n, k, int(add_revcomp), int(full), None, 0))
    buf = np.empty(bucket(text) + (0 if full else k - 1), dtype=np.uint8)
    got = fn(ptrs, lens, n, k, int(add_revcomp), int(full),
             buf.ctypes.data_as(ctypes.c_void_p), buf.size)
    assert got == text
    return buf, text


def scan_fastx(data: bytes, fastq: bool) -> list[tuple[str, bytes]]:
    """Records of a plain (already inflated) FASTA or FASTQ buffer:
    [(name, sequence bytes)]. Raises ValueError on a malformed record."""
    fn = lib().fastx_scan_fastq if fastq else lib().fastx_scan_fasta
    buf = np.frombuffer(data, dtype=np.uint8)
    n = int(fn(buf, buf.size, None, None, 0))
    if n < 0:
        raise ValueError("malformed FASTA/FASTQ record")
    out = np.empty(buf.size, dtype=np.uint8)
    recs = np.empty(4 * max(n, 1), dtype=np.int64)
    n2 = int(fn(buf, buf.size, out.ctypes.data_as(ctypes.c_void_p),
                recs.ctypes.data_as(ctypes.c_void_p), n))
    assert n2 == n
    return [
        (data[r[0] : r[0] + r[1]].decode(errors="replace"),
         out[r[2] : r[2] + r[3]].tobytes())
        for r in recs[: 4 * n].reshape(n, 4)
    ]


# ------------------------------------------------- the single-core engine
#
# The index arrays go in as the host SbwtIndex holds them (bits uint32,
# cum / C int32, lcs / text uint8, row_pos int64): ctypes checks each dtype
# against the argument types and raises ArgumentError on a mismatch rather
# than converting.


def _rank_arrays(index):
    return (np.ascontiguousarray(index.bits.reshape(-1)),
            np.ascontiguousarray(index.cum.reshape(-1)),
            np.ascontiguousarray(index.C))


def _stream(index, codes: np.ndarray):
    """kbo_ms_stream over one encoded query: (ms int32, lo, hi int64)."""
    L = codes.size
    ms = np.empty(L, dtype=np.int32)
    lo = np.empty(L, dtype=np.int64)
    hi = np.empty(L, dtype=np.int64)
    lib().kbo_ms_stream(
        *_rank_arrays(index), np.ascontiguousarray(index.lcs),
        index.n_rows, index.n_words, index.k, codes, L, ms, lo, hi,
    )
    return ms, lo, hi


def ms_stream(index, codes: np.ndarray):
    """Single-core streaming MS (the reference's algorithm, with LCS
    contraction) of one encoded query against a host index. Returns
    (ms int64 [L], intervals int64 [L, 2])."""
    ms, lo, hi = _stream(index, np.ascontiguousarray(codes, dtype=np.uint8))
    return ms.astype(np.int64), np.stack([lo, hi], axis=1)


def derandomize(noisy_ms: np.ndarray, k: int, threshold: int) -> np.ndarray:
    """Sequential right-to-left derandomization: int64 [L]."""
    noisy = np.ascontiguousarray(noisy_ms, dtype=np.int32)
    out = np.empty(noisy.size, dtype=np.int64)
    lib().kbo_derandomize(noisy, noisy.size, k, threshold, out)
    return out


def translate(derand_ms: np.ndarray, k: int, threshold: int) -> np.ndarray:
    """Sequential translation: uint8 alignment chars [L]."""
    d = np.ascontiguousarray(derand_ms, dtype=np.int64)
    out = np.zeros(d.size, dtype=np.uint8)  # zero-init: translate reads ahead
    lib().kbo_translate(d, d.size, k, threshold, out)
    return out


def build_arrays(codes: np.ndarray, k: int):
    """Single-core C++ SBWT construction (sorted 3-bit colex keys, k <= 63)
    of one encoded sequence.

    Returns a dict of (bits, cum, C, lcs, row_pos, text, n_rows, n_words):
    the rank arrays kbo_ms_stream reads, bits / cum flat [4 * n_words]. The
    reference builds the streamed sequence's index inside the call
    (src/lib.rs:553); :func:`map_e2e` does the same.
    """
    from kbo_tpu_torch.index.encode import split_segments

    parts = []
    for seg in split_segments(np.asarray(codes, dtype=np.uint8)):
        parts.append(np.zeros(k, dtype=np.uint8))
        parts.append(seg)
    if not parts:
        raise ValueError("cannot build an index from empty input")
    buf = np.ascontiguousarray(np.concatenate(parts))
    n_rows = int(lib().kbo_build(buf, buf.size, k))
    if n_rows <= 0:
        raise ValueError(f"the native build takes 2 <= k <= 63, not {k}")
    n_words = n_rows // 32 + 1
    bits = np.zeros(4 * n_words, dtype=np.uint32)
    cum = np.zeros(4 * n_words, dtype=np.int32)
    C = np.zeros(4, dtype=np.int32)
    lcs = np.zeros(n_rows, dtype=np.uint8)
    row_pos = np.zeros(n_rows, dtype=np.int64)
    lib().kbo_build_export(bits, cum, C, lcs, row_pos)
    return {
        "bits": bits, "cum": cum, "C": C, "lcs": lcs, "row_pos": row_pos,
        "text": buf, "n_rows": n_rows, "n_words": n_words,
    }


def _variant_cap(n: int) -> int:
    """The first variant buffer's capacity for a sequence of n bases."""
    return max(1024, n // 64)


def map_e2e(index, ref_seq: bytes, threshold: int, max_error_prob: float):
    """Single-core end-to-end ``kbo map``: streaming MS -> derandomize ->
    translate -> gap fill -> variant call (with the streamed reference's
    own index built here, reference: src/lib.rs:553) -> add_variants ->
    relative_to_ref, all sequential native code plus numpy glue.

    ``index`` is a host SbwtIndex built with ``BuildOpts(build_select=True)``
    (its ``text`` and ``row_pos`` serve the k-mer reads). Returns (output
    bytes, n_variants): the bytes of ``map_`` with the default
    ``MapOpts()`` and the index's BuildOpts, format true.
    """
    import math

    from kbo_tpu_torch.index.encode import encode_ascii
    from kbo_tpu_torch.ops.format import relative_to_ref
    from kbo_tpu_torch.ops.translate import add_variants
    from kbo_tpu_torch.refine.variant_calling import Variant

    k = index.k
    codes = np.ascontiguousarray(encode_ascii(bytes(ref_seq)))
    n = codes.size
    ms32, lo, hi = _stream(index, codes)
    derand = np.empty(n, dtype=np.int64)
    lib().kbo_derandomize(ms32, n, k, threshold, derand)
    chars = np.zeros(n, dtype=np.uint8)
    lib().kbo_translate(derand, n, k, threshold, chars)

    bits, cum, C = _rank_arrays(index)
    text = np.ascontiguousarray(index.text)
    row_pos = np.ascontiguousarray(index.row_pos)
    lcs = np.ascontiguousarray(index.lcs)
    lib().kbo_fill_gaps(
        chars, n, lo, hi, codes, text, row_pos,
        bits, cum, C, index.n_rows, index.n_words, k, threshold,
        math.log1p(-max_error_prob),
    )

    inner = build_arrays(codes, k)
    cap = _variant_cap(n)
    while True:
        pos = np.zeros(cap, dtype=np.int64)
        qlen = np.zeros(cap, dtype=np.int32)
        rlen = np.zeros(cap, dtype=np.int32)
        qch = np.zeros(cap * k, dtype=np.uint8)
        rch = np.zeros(cap * k, dtype=np.uint8)
        cnt = int(lib().kbo_call_variants(
            ms32, lo, hi, codes, n,
            text, row_pos, bits, cum, C, lcs, index.n_rows, index.n_words,
            inner["bits"], inner["cum"], inner["C"], inner["lcs"],
            inner["n_rows"], inner["n_words"], k, threshold,
            pos, qlen, rlen, qch, rch, cap,
        ))
        if cnt < cap:
            break
        # a full buffer is indistinguishable from exactly-cap variants:
        # retry with more room rather than truncate
        cap *= 4
    variants = [
        Variant(
            query_pos=int(pos[t]),
            query_chars=qch[t * k : t * k + qlen[t]].tobytes(),
            ref_chars=rch[t * k : t * k + rlen[t]].tobytes(),
        )
        for t in range(cnt)
    ]
    refined = add_variants([chr(c) for c in chars], variants)
    return relative_to_ref(ref_seq, refined), cnt
