"""Sorting and merging of multi-word uint32 keys (PyTorch, hand-written CUDA).

Key words are uint32 bit patterns carried in int32 tensors of shape
``[W, n]``, most significant word first. Torch lacks unsigned comparison and
sorting on the CPU, so the plain code widens words to int64 with
``& 0xFFFFFFFF``; the CUDA kernels compare them as ``uint32_t``.

:func:`merge_path` is the counterpart of the TPU kernel
``kbo_tpu/kernels/pallas_sort.py::merge_path``: a CUDA kernel on CUDA
tensors (``csrc/merge_path.cu``), its plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kbo_tpu_torch.kernels import _build

_U32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return x.to(torch.int64) & _U32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors holding the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _pack_key_words(words: torch.Tensor) -> list[torch.Tensor]:
    """[W, n] words -> int64 sort keys, most significant first.

    Adjacent word pairs pack into one key ``(hi - 2**31) * 2**32 + lo``,
    which keeps unsigned order in signed int64 without overflow (the
    counterpart of kbo_tpu's uint64 pair keys under x64); an odd last word
    is its own key.
    """
    keys = []
    W = words.shape[0]
    for i in range(0, W, 2):
        if i + 1 < W:
            keys.append((u32(words[i]) - 2**31) * 2**32 + u32(words[i + 1]))
        else:
            keys.append(u32(words[i]))
    return keys


def _radix_sort(words: torch.Tensor, payloads=()):
    """Stable LSD radix sort of ``[W, n]`` key words and parallel payloads.

    Each pass is one stable ``torch.sort`` on an int64 key; only the key
    rides each pass, and the composed permutation gathers the words and
    payloads once at the end. Returns (words, [payloads]).
    """
    perm = None
    for key in reversed(_pack_key_words(words)):
        if perm is not None:
            key = key[perm]
        _, order = torch.sort(key, stable=True)
        perm = order if perm is None else perm[order]
    if perm is None:
        return words, list(payloads)
    return words[:, perm], [p[perm] for p in payloads]


def merge_path_plain(a_keys, a_pay, b_keys, b_pay):
    """Plain version of :func:`merge_path`: concatenate A then B and sort
    stably, so equal keys keep A before B and each side's order."""
    keys, (pay,) = _radix_sort(
        torch.cat([a_keys, b_keys], dim=1), [torch.cat([a_pay, b_pay])]
    )
    return keys, pay


@functools.cache
def _lib():
    lib = _build.load("merge_path")
    lib.kbo_merge_path_tiles.argtypes = [ctypes.c_longlong] * 2
    lib.kbo_merge_path_tiles.restype = ctypes.c_longlong
    p, n = ctypes.c_void_p, ctypes.c_longlong
    lib.kbo_merge_path.argtypes = [
        p, p, n, p, p, n, ctypes.c_int, p, p, p, p
    ]
    lib.kbo_merge_path.restype = ctypes.c_int
    return lib


def _check_operands(keys, pay, W, device):
    if keys.device != device or pay.device != device:
        raise ValueError("merge_path operands must be on one device")
    if keys.dtype != torch.int32 or pay.dtype != torch.int32:
        raise TypeError("merge_path operands must be int32 bit patterns")
    if keys.dim() != 2 or keys.shape[0] != W or pay.shape != keys.shape[1:]:
        raise ValueError("merge_path wants keys [W, n] and payload [n]")
    if not (keys.is_contiguous() and pay.is_contiguous()):
        raise ValueError("merge_path operands must be contiguous")


def merge_path(a_keys, a_pay, b_keys, b_pay):
    """Stable merge of two sorted tables (A wins ties), exactly na+nb long.

    a_keys/b_keys: int32 ``[W, n]`` key words sorted lexicographically;
    a_pay/b_pay: int32 ``[n]`` payloads. Returns (keys ``[W, na+nb]``,
    payload ``[na+nb]``). CUDA tensors launch ``csrc/merge_path.cu``; CPU
    tensors take :func:`merge_path_plain`. Unlike kbo_tpu's operand-list
    form, the output carries no tile pads.
    """
    device = a_keys.device
    if device.type == "cpu":
        return merge_path_plain(a_keys, a_pay, b_keys, b_pay)
    W = a_keys.shape[0]
    _check_operands(a_keys, a_pay, W, device)
    _check_operands(b_keys, b_pay, W, device)
    na, nb = a_keys.shape[1], b_keys.shape[1]
    lib = _lib()
    out_keys = torch.empty((W, na + nb), dtype=torch.int32, device=device)
    out_pay = torch.empty(na + nb, dtype=torch.int32, device=device)
    a_off = torch.empty(
        lib.kbo_merge_path_tiles(na, nb) + 1, dtype=torch.int64, device=device
    )
    with torch.cuda.device(device):
        err = lib.kbo_merge_path(
            a_keys.data_ptr(), a_pay.data_ptr(), na,
            b_keys.data_ptr(), b_pay.data_ptr(), nb, W,
            a_off.data_ptr(), out_keys.data_ptr(), out_pay.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, "merge_path")
    merge_path.launches += 1
    return out_keys, out_pay


merge_path.launches = 0
