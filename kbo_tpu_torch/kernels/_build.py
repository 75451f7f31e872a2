"""Build and load the port's CUDA kernels at first use.

Each ``kernels/csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface under ``kbo_tpu_torch/_build/`` and loads
through ``ctypes``. The sources include no PyTorch header, so a build takes
seconds rather than the minutes a ``torch.utils.cpp_extension`` build that
includes ``torch/extension.h`` takes; the wrappers pass raw device pointers
and PyTorch's current stream. A library is named by a hash of its source and
flags, so an edited source rebuilds and an unchanged one loads from disk.
Nothing builds at import time: the CPU tests import every module.
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

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            "source at first use"
        )
    return found


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: list[str]) -> float:
    """Compile the named sources that have no library yet, one ``nvcc``
    per source, all started together. Returns the seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        procs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
