"""Clamped-LCP propagation scan of the sort-join (PyTorch, hand-written CUDA).

After the merge, every query slot needs the best match against the
reference rows around it: ``max over sources s of min(lcp(q, s), cap[s])``.
By the LCP lemma the best over one side is an inclusive scan of clamp
transforms ``x -> max(min(x, ell_i), cap_i)`` (``cap_i = -1`` at non-source
slots, ``ell_i`` the common chunk prefix entering slot i from the scan side),
and two transforms compose as ``(a1, b1) then (a2, b2) = (min(a1, a2),
max(min(b1, a2), b2))``.

:func:`clamp_scan` is the counterpart of the TPU kernel
``kbo_tpu/kernels/pallas_join.py::clamp_scan``: a CUDA kernel on CUDA tensors
(``csrc/clamp_scan.cu``), and on CPU tensors its plain version, the
log-depth doubling scan of ``kbo_tpu/kernels/ms.py::_clamp_scan_jnp``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kbo_tpu_torch.kernels import _build
from kbo_tpu_torch.kernels.sort import u32

_IDA = 2**31 - 1  # identity clamp component: min(x, +inf)
_IDB = -(2**31 - 1)  # identity clamp component: max(x, -inf)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64 (shift/compare ladder)."""
    n = torch.zeros_like(x)
    for width in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - width))
        n = torch.where(small, n + width, n)
        x = torch.where(small, x << width, x)
    return torch.where(x == 0, 32, n)


def _common_chunks(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Common chunk-prefix length between ``[W, M]`` word tables.

    bits = 2: 16 chunks per word; bits = 3: 10 chunks per word after 2 lead
    bits. ``(clz - lead) // bits`` is FLOOR division, as in kbo_tpu: with
    bits = 3 an all-ones pad against a real key (clz 0) gives -1.
    """
    per_word, lead = (16, 0) if bits == 2 else (10, 2)
    total = torch.zeros(a.shape[1], dtype=torch.int64, device=a.device)
    alive = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
    for w in range(a.shape[0]):
        x = u32(a[w] ^ b[w])
        nz = x != 0
        cw = torch.where(
            nz,
            torch.div(_clz32(x) - lead, bits, rounding_mode="floor"),
            per_word,
        )
        total = total + torch.where(alive, cw, 0)
        alive = alive & ~nz
    return total.to(torch.int32)


def _edge_lcp(sw: torch.Tensor, bits: int, reverse: bool) -> torch.Tensor:
    """Adjacent-slot common prefix entering each slot from the scan side
    (the first slot meets its own complement)."""
    if reverse:
        nb = torch.cat([sw[:, 1:], ~sw[:, -1:]], dim=1)
    else:
        nb = torch.cat([~sw[:, :1], sw[:, :-1]], dim=1)
    return _common_chunks(sw, nb, bits)


def _clamp_scan_plain(ell: torch.Tensor, cap: torch.Tensor, reverse: bool):
    """Inclusive compose scan of clamp transforms by log-depth doubling
    (kbo_tpu/kernels/ms.py::_clamp_scan_jnp). With seed -1 the output is
    the composed B component."""
    M = ell.shape[0]
    A, B = ell, cap
    s = 1
    while s < M:
        ida = torch.full((s,), _IDA, dtype=torch.int32, device=A.device)
        idb = torch.full((s,), _IDB, dtype=torch.int32, device=A.device)
        if reverse:
            Ao, Bo = torch.cat([A[s:], ida]), torch.cat([B[s:], idb])
        else:
            Ao, Bo = torch.cat([ida, A[:-s]]), torch.cat([idb, B[:-s]])
        A, B = torch.minimum(Ao, A), torch.maximum(torch.minimum(Bo, A), B)
        s <<= 1
    return B


def clamp_scan_plain(words, cap, bits: int, reverse: bool):
    """Plain version of :func:`clamp_scan`."""
    return _clamp_scan_plain(_edge_lcp(words, bits, reverse), cap, reverse)


@functools.cache
def _lib():
    lib = _build.load("clamp_scan")
    lib.kbo_clamp_scan_blocks.argtypes = [ctypes.c_longlong]
    lib.kbo_clamp_scan_blocks.restype = ctypes.c_longlong
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kbo_clamp_scan.argtypes = [
        p, p, ctypes.c_longlong, i, i, i, p, p, p, p
    ]
    lib.kbo_clamp_scan.restype = ctypes.c_int
    return lib


def clamp_scan(words: torch.Tensor, cap: torch.Tensor, bits: int,
               reverse: bool) -> torch.Tensor:
    """best[i] = max over source slots s at-or-before i (at-or-after when
    reverse) of min(lcp(slot_i, slot_s), cap[s]); -1 if none.

    words: int32 ``[W, M]`` colex-sorted key words (uint32 bit patterns);
    cap: int32 ``[M]``, -1 at non-source slots; bits 2 or 3. CUDA tensors
    launch ``csrc/clamp_scan.cu``; CPU tensors take :func:`clamp_scan_plain`.
    """
    if bits not in (2, 3):
        raise ValueError("bits must be 2 or 3")
    device = words.device
    if device.type == "cpu":
        return clamp_scan_plain(words, cap, bits, reverse)
    if cap.device != device:
        raise ValueError("clamp_scan operands must be on one device")
    if words.dtype != torch.int32 or cap.dtype != torch.int32:
        raise TypeError("clamp_scan operands must be int32")
    if words.dim() != 2 or cap.shape != words.shape[1:]:
        raise ValueError("clamp_scan wants words [W, M] and cap [M]")
    if not (words.is_contiguous() and cap.is_contiguous()):
        raise ValueError("clamp_scan operands must be contiguous")
    W, M = words.shape
    lib = _lib()
    nblk = lib.kbo_clamp_scan_blocks(M)
    tot = torch.empty(2 * nblk, dtype=torch.int32, device=device)
    carry = torch.empty(2 * nblk, dtype=torch.int32, device=device)
    out = torch.empty(M, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.kbo_clamp_scan(
            words.data_ptr(), cap.data_ptr(), M, W, bits, int(reverse),
            tot.data_ptr(), carry.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "clamp_scan")
    clamp_scan.launches += 1
    return out


clamp_scan.launches = 0
