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
from typing import NamedTuple

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
    p, n = ctypes.c_void_p, ctypes.c_longlong
    lib.kbo_merge_path_tiles.argtypes = [n, n, ctypes.c_int]
    lib.kbo_merge_path_tiles.restype = n
    lib.kbo_merge_path_max_w.restype = ctypes.c_int
    lib.kbo_merge_path_smem.argtypes = [ctypes.c_int]
    lib.kbo_merge_path_smem.restype = n
    lib.kbo_merge_path.argtypes = [
        p, p, n, p, p, n, ctypes.c_int, p, p, p, p
    ]
    lib.kbo_merge_path.restype = ctypes.c_int
    lib.max_w = lib.kbo_merge_path_max_w()
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
    payload ``[na+nb]``). CUDA tensors launch ``csrc/merge_path.cu`` (at
    most 27 key rows: the rows of a tile share one CTA's shared memory,
    and above 26 the tiles are half as long);
    CPU tensors take :func:`merge_path_plain`. Unlike kbo_tpu's
    operand-list form, the output carries no tile pads.
    """
    device = a_keys.device
    if device.type == "cpu":
        return merge_path_plain(a_keys, a_pay, b_keys, b_pay)
    W = a_keys.shape[0]
    _check_operands(a_keys, a_pay, W, device)
    _check_operands(b_keys, b_pay, W, device)
    na, nb = a_keys.shape[1], b_keys.shape[1]
    lib = _lib()
    if W > lib.max_w:
        raise ValueError(
            f"merge_path takes at most {lib.max_w} key rows on the card, "
            f"got {W}"
        )
    out_keys = torch.empty((W, na + nb), dtype=torch.int32, device=device)
    out_pay = torch.empty(na + nb, dtype=torch.int32, device=device)
    a_off = torch.empty(
        lib.kbo_merge_path_tiles(na, nb, W) + 1, dtype=torch.int64,
        device=device,
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


# ------------------------------------------------------------ bitonic network

# kbo_tpu's tile: every bitonic layout is a power of two of at least this
BITONIC_MIN = 1 << 16


def _bitonic_len(total: int) -> int:
    M = BITONIC_MIN
    while M < total:
        M <<= 1
    return M


def _lex_gt(a, b, n_comps: int):
    """Lexicographic a > b over the first n_comps rows (signed int32 rows:
    callers flip the sign bit of uint32 patterns first)."""
    gt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for c in range(n_comps):
        gt = gt | (eq & (a[c] > b[c]))
        eq = eq & (a[c] == b[c])
    return gt


def _bitonic_stages(x, n_comps: int, stages):
    """Run compare-exchange stages over ``x`` int32 [n_ops, M] in place.
    ``stages`` yields (s, k): distance s, direction bit k of the lower
    index (None = ascending). Key rows are compared as uint32 by flipping
    their sign bit for the duration."""
    x[:n_comps] ^= -(2**31)
    n_ops, M = x.shape
    for s, k in stages:
        v = x.view(n_ops, M // (2 * s), 2, s)
        lo, hi = v[:, :, 0], v[:, :, 1]
        if k is None:
            swap = _lex_gt(lo, hi, n_comps)
        else:
            # bit k of i = g * 2s + t (t < s <= 2^(k-1)) is bit k-j-1 of g
            g = torch.arange(M // (2 * s), device=x.device)
            desc = ((g >> (k - s.bit_length())) & 1).bool()[:, None]
            swap = torch.where(
                desc, _lex_gt(hi, lo, n_comps), _lex_gt(lo, hi, n_comps)
            )
        new_lo = torch.where(swap, hi, lo)
        new_hi = torch.where(swap, lo, hi)
        v[:, :, 0] = new_lo
        v[:, :, 1] = new_hi
    x[:n_comps] ^= -(2**31)
    return x


def _merge_layout(a_ops, b_ops):
    """kbo_tpu's bitonic merge input: A ++ all-ones pads ++ reverse(B),
    padded to a power of two of at least 65 536."""
    n_ops, na = a_ops.shape
    nb = b_ops.shape[1]
    M = _bitonic_len(na + nb)
    x = torch.full((n_ops, M), -1, dtype=torch.int32, device=a_ops.device)
    x[:, :na] = a_ops
    x[:, M - nb :] = b_ops.flip(1)
    return x


def bitonic_merge_plain(a_ops, b_ops, n_comps: int):
    """Plain version of :func:`bitonic_merge`: the half-cleaner stages as
    whole-tensor ops."""
    x = _merge_layout(a_ops, b_ops)
    M = x.shape[1]
    return _bitonic_stages(
        x, n_comps, ((M >> (j + 1), None) for j in range(M.bit_length() - 1))
    )


def _sort_stages(M: int):
    lm = M.bit_length() - 1
    for k in range(1, lm + 1):
        for j in range(k - 1, -1, -1):
            yield 1 << j, k


def _sort_layout(ops):
    n_ops, n = ops.shape
    x = torch.full((n_ops, _bitonic_len(n)), -1, dtype=torch.int32,
                   device=ops.device)
    x[:, :n] = ops
    return x


def bitonic_sort_plain(ops, n_comps: int):
    """Plain version of :func:`bitonic_sort`: every stage of the network as
    whole-tensor ops."""
    n = ops.shape[1]
    x = _sort_layout(ops)
    return _bitonic_stages(x, n_comps, _sort_stages(x.shape[1]))[:, :n]


# the schedule of the CUDA network: passes over device memory, each running
# several stages (csrc/bitonic.cu)
_SMEM_BYTES = 232_448  # dynamic shared memory a Hopper block may ask for
_MAX_TILE = 1 << 14
# the most operand rows a caller passes: the 2-bit join's W2 <= 16 key words
# (k < 255) plus its payload; the 3-bit joins run only for k < 128, at most
# 13 key words, a tag word and the payload
_MAX_OPS = 17


class RegsPass(NamedTuple):
    """Stages at distances 2^j .. 2^(j-r+1) of phase k (None: the merge's
    one ascending phase) in registers."""

    k: int | None
    j: int
    r: int


class TilePass(NamedTuple):
    """Phase k from distance 2^j down, then phases k+1..k_end whole, in
    shared-memory tiles of 2^log_tile elements."""

    k: int | None
    k_end: int | None
    j: int
    log_tile: int


def _bitonic_r(n_ops: int) -> int:
    """Stages per register pass: 2^r * n_ops words stay in registers."""
    if not 1 <= n_ops <= _MAX_OPS:
        raise ValueError(f"the bitonic kernels take 1..{_MAX_OPS} operand "
                         f"rows, not {n_ops}")
    return 4 if n_ops <= 5 else 3 if n_ops <= 10 else 2


def _bitonic_tile_log(n_ops: int, M: int) -> int:
    """log2 of the largest power of two <= 16384 (and <= M) whose n_ops
    rows of uint32 fit a block's shared memory."""
    t = _MAX_TILE
    while t > 1 and t * n_ops * 4 > _SMEM_BYTES:
        t >>= 1
    return min(t, M).bit_length() - 1


def _bitonic_passes(M: int, n_ops: int, sort: bool):
    """The passes of the sort (phases 1..log2 M) or the merge (its one
    phase) over M elements of n_ops rows, in launch order.

    The sort's first pass runs phases 1..log2(tile) in one tile pass. Each
    later phase then runs register passes of r stages from its top
    distance down until what is left fits one tile (the last register pass
    may reach below the largest tile), then one tile pass of the smallest
    tile that holds the rest.
    """
    lm = M.bit_length() - 1
    lt = _bitonic_tile_log(n_ops, M)
    r = _bitonic_r(n_ops)
    assert lt >= r
    passes = []
    if sort:
        passes.append(TilePass(1, lt, 0, lt))
        phases = [(k, k - 1) for k in range(lt + 1, lm + 1)]
    else:
        phases = [(None, lm - 1)]
    for k, j in phases:
        while j >= lt:
            passes.append(RegsPass(k, j, r))
            j -= r
        if j >= 0:
            passes.append(TilePass(k, k, j, j + 1))
    return passes


@functools.cache
def _bitonic_lib():
    lib = _build.load("bitonic")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kbo_bitonic_regs.argtypes = [p, i, i, n, i, i, i, p, n, p, n, i, p]
    lib.kbo_bitonic_tile.argtypes = [p, i, i, n, i, i, i, i, p, n, p, n, i, p]
    lib.kbo_bitonic_regs.restype = lib.kbo_bitonic_tile.restype = ctypes.c_int
    return lib


def _check_ops(ops, what):
    if ops.dtype != torch.int32 or ops.dim() != 2:
        raise TypeError(f"{what} wants int32 operand rows [n_ops, n]")


def _run_bitonic(a, b, M: int, n_comps: int, sort: bool, what: str):
    """Launch the passes of the network on the layout A ++ all-ones pads
    ++ reverse(B) (B empty for the sort) into a new [n_ops, M] tensor."""
    n_ops = a.shape[0]
    if not 0 <= n_comps <= n_ops:
        raise ValueError(f"{what}: n_comps must be in 0..{n_ops}")
    a, b = a.contiguous(), b.contiguous()
    x = torch.empty((n_ops, M), dtype=torch.int32, device=a.device)
    lib = _bitonic_lib()
    lm = M.bit_length() - 1
    src = (a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for n, ps in enumerate(_bitonic_passes(M, n_ops, sort)):
            k = lm if ps.k is None else ps.k
            args = (x.data_ptr(), n_ops, n_comps, M)
            if isinstance(ps, RegsPass):
                err = lib.kbo_bitonic_regs(*args, ps.j, ps.r, k, *src,
                                           n == 0, stream)
            else:
                k_end = lm if ps.k_end is None else ps.k_end
                err = lib.kbo_bitonic_tile(*args, ps.log_tile, k, k_end, ps.j,
                                           *src, n == 0, stream)
            _build.check(err, what)
    return x


def bitonic_merge(a_ops, b_ops, n_comps: int):
    """Merge two operand tables sorted by their first ``n_comps`` rows, as
    kbo_tpu's ``bitonic_merge(..., slice_output=False)``.

    a_ops/b_ops: int32 ``[n_ops, n]`` rows of uint32 patterns (key words,
    then payloads), n_ops <= 17 on the card. Returns ``[n_ops, M]``,
    M = pow2 >= max(65536, na+nb): the merge followed by all-ones pads
    (payload 0xFFFFFFFF), equal keys in the network's (not a stable) order.
    CUDA tensors launch ``csrc/bitonic.cu``, whose first pass reads the
    layout straight from the operands; CPU tensors take
    :func:`bitonic_merge_plain`.
    """
    if a_ops.device.type == "cpu":
        return bitonic_merge_plain(a_ops, b_ops, n_comps)
    _check_ops(a_ops, "bitonic_merge")
    _check_ops(b_ops, "bitonic_merge")
    if b_ops.device != a_ops.device or b_ops.shape[0] != a_ops.shape[0]:
        raise ValueError("bitonic_merge operands must match in rows and device")
    M = _bitonic_len(a_ops.shape[1] + b_ops.shape[1])
    x = _run_bitonic(a_ops, b_ops, M, n_comps, False, "bitonic_merge")
    bitonic_merge.launches += 1
    return x


bitonic_merge.launches = 0


def bitonic_sort(ops, n_comps: int):
    """Sort operand rows by their first ``n_comps`` rows, as kbo_tpu's
    ``bitonic_sort``: all-ones pads to a power of two >= 65536, the full
    network, the first n columns back. Not stable. CUDA tensors launch
    ``csrc/bitonic.cu`` (n_ops <= 17); CPU tensors take
    :func:`bitonic_sort_plain`."""
    if ops.device.type == "cpu":
        return bitonic_sort_plain(ops, n_comps)
    _check_ops(ops, "bitonic_sort")
    n = ops.shape[1]
    x = _run_bitonic(ops, ops[:, :0], _bitonic_len(n), n_comps, True,
                     "bitonic_sort")
    bitonic_sort.launches += 1
    return x[:, :n]


bitonic_sort.launches = 0
