"""The port's native host library: the map upload's 2-bit pack and the
FASTA/FASTQ scanner, in C++ (``native_src/pack.cpp``, ``native_src/fastx.cpp``).

Both sources compile with ``g++`` into one shared library with a plain C
interface under ``kbo_tpu_torch/_build/`` at first use, and load through
``ctypes``. The library is named by a hash of its sources and flags, so an
edited source rebuilds and an unchanged one loads from disk; a build writes
a temporary name and renames it into place, so processes that build at
once (parallel test workers) never load a half-written file. A failed
build raises: nothing falls back to the numpy pack or the Python reader.
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
SOURCES = ("pack.cpp", "fastx.cpp")
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
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            lib.kbo_pack_ascii.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, i32p,
                u8p, i64p, u8p, ctypes.c_int64,
            ]
            lib.kbo_pack_ascii.restype = ctypes.c_int64
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
