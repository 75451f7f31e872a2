"""Device derandomize + translate + RLE segments on ``[Q, L]`` batches
(PyTorch; counterpart of kbo_tpu/kernels/postprocess.py).

kbo_tpu writes these cores for one row and maps them over a batch with
``jax.vmap``; here every function takes the batch dimension explicitly and
works row by row along the last axis (a 1-D input is one row). The
algorithms are the same:

Derandomize (reference: src/derandomize.rs:269-288) is a right-to-left
recurrence that, in phi-space (phi = d[i] - i), becomes a composition of
identity / constant / point functions, closed under composition -- a
parallel suffix scan (:func:`_suffix_scan`). The equivalence with the host
oracle holds for +1-Lipschitz inputs, which true MS vectors are.

Translate (reference: src/translate.rs:263-293) is a 3-point stencil plus
the rule that a position already written as the second 'R' of a pair is
skipped: skip alternates inside maximal runs, found with one cummax.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from kbo_tpu_torch.kernels import _build
from kbo_tpu_torch.kernels.ms import _doubling_cummax, resolve_device

# alignment characters encoded as ASCII uint8
_M, _X, _DASH, _R = ord("M"), ord("X"), ord("-"), ord("R")


def _as_rows(x: torch.Tensor, true_len, L: int):
    """(x as [Q, L], true lengths as int32 [Q, 1], whether x was 1-D)."""
    one = x.dim() == 1
    if one:
        x = x[None]
    if true_len is None:
        true_len = L
    tl = torch.as_tensor(true_len, dtype=torch.int32, device=x.device)
    return x, tl.reshape(-1, 1).expand(x.shape[0], 1), one


def _compose(f, g):
    """Composition f o g of (is_id, is_const, q, v, r) function descriptors.

    Descriptor semantics: identity if is_id; else constant v if is_const;
    else point function (x == q ? v : r).
    """
    f_id, f_c, f_q, f_v, f_r = f
    g_id, g_c, g_q, g_v, g_r = g

    def apply_f(x):
        return torch.where(
            f_id, x, torch.where(f_c, f_v, torch.where(x == f_q, f_v, f_r))
        )

    h_v = apply_f(g_v)
    h_r = apply_f(g_r)
    out_id = f_id & g_id
    out_c = ~out_id & (g_c | (g_id & f_c))
    out_q = torch.where(g_id, f_q, g_q)
    out_v = torch.where(g_id, f_v, h_v)
    out_r = torch.where(g_id, f_r, h_r)
    return (out_id, out_c, out_q, out_v, out_r)


_IDENT = (True, False, 0, 0, 0)


def _shift_up(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x[..., i] <- x[..., i + s] along the last axis (tail filled)."""
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def _suffix_scan_flat(elems):
    """Inclusive right-to-left composition scan along the last axis by
    Hillis-Steele doubling: out[i] = f_i o f_{i+1} o ... o f_{L-1}."""
    L = elems[0].shape[-1]
    x = elems
    s = 1
    while s < L:
        shifted = tuple(_shift_up(a, s, f) for a, f in zip(x, _IDENT))
        x = _compose(x, shifted)
        s <<= 1
    return x


_SCAN_BLOCK = 1024


def _suffix_scan(elems):
    """Two-level suffix scan (within-block doubling, a block-total scan and
    one combine) for rows longer than 4 blocks; the same block structure as
    kbo_tpu, so outputs agree bit for bit everywhere, padding included."""
    L = elems[0].shape[-1]
    if L <= 4 * _SCAN_BLOCK:
        return _suffix_scan_flat(elems)
    S = _SCAN_BLOCK
    B = -(-L // S)
    pad = B * S - L
    lead = elems[0].shape[:-1]
    x = tuple(
        torch.cat(
            [a, torch.full(lead + (pad,), f, dtype=a.dtype, device=a.device)],
            dim=-1,
        ).reshape(lead + (B, S))
        for a, f in zip(elems, _IDENT)
    )
    x = _suffix_scan_flat(x)
    # block totals = within[..., 0]; exclusive suffix over blocks
    tot_x = tuple(_shift_up(a[..., 0], 1, f) for a, f in zip(x, _IDENT))
    tot_x = _suffix_scan_flat(tot_x)
    out = _compose(x, tuple(a[..., None] for a in tot_x))
    return tuple(a.reshape(lead + (B * S,))[..., :L] for a in out)


def derandomize_core(noisy: torch.Tensor, k: int, threshold: int,
                     true_len=None) -> torch.Tensor:
    """Parallel derandomization of (+1-Lipschitz) noisy MS rows [Q, L].

    ``true_len`` ([Q] or scalar) supports padded rows: positions past a
    row's true length must carry noisy == 0 and their outputs are garbage.
    As in kbo_tpu, a row of true length 0 reads its last value with a
    wrapped index (``jnp.take(noisy, -1)``).
    """
    L = noisy.shape[-1]
    noisy, tl, one = _as_rows(noisy.to(torch.int32), true_len, L)
    idx = torch.arange(L, dtype=torch.int32, device=noisy.device)
    a = noisy - idx
    is_k = noisy == k
    is_soft = (noisy > threshold) & ~is_k
    # final element: constant vlast - (true_len-1)
    nlast = torch.gather(noisy, 1, ((tl - 1) % L).to(torch.int64))
    vlast = torch.where(nlast > threshold, nlast, 0) - (tl - 1)

    is_id = ~is_k & ~is_soft
    is_const = is_k
    q = a - 1  # soft: x == a-1 ? a-1 : a
    v = torch.where(is_k, a, a - 1)
    r = a
    last = idx == tl - 1
    is_id = is_id & ~last
    is_const = is_const | last
    v = torch.where(last, vlast, v)

    _, c_c, _, c_v, c_r = _suffix_scan((is_id, is_const, q, v, r))
    # f_{L-1} is a constant, so every suffix composition is a constant
    out = torch.where(c_c, c_v, c_r) + idx
    return out[0] if one else out


def translate_core(derand: torch.Tensor, k: int, threshold: int,
                   true_len=None) -> torch.Tensor:
    """Parallel translation of derandomized MS rows [Q, L] -> uint8 chars.
    The rolls roll within a row."""
    L = derand.shape[-1]
    d, tl, one = _as_rows(derand.to(torch.int32), true_len, L)
    idx = torch.arange(L, dtype=torch.int32, device=d.device)
    t = threshold

    prev = torch.where(idx > 1, torch.roll(d, 1, dims=-1), k)
    nxt = torch.where(idx < tl - 1, torch.roll(d, -1, dims=-1), d)

    rr = (d > t) & (nxt > 0) & (nxt < t)
    rr_prev = torch.roll(rr, 1, dims=-1)
    rr_prev[:, 0] = False
    A = (idx > 1) & (idx < tl - 1) & rr_prev
    # skip[p] = A[p] & ~skip[p-1]  => parity within maximal runs of A
    last_false = _doubling_cummax(torch.where(A, -1, idx))
    skip = A & (((idx - last_false) & 1) == 1)

    x_char = (nxt == 1) & (prev > 0)
    base = torch.where(
        rr, _R, torch.where(d <= 0, torch.where(x_char, _X, _DASH), _M)
    ).to(torch.uint8)
    out = torch.where(skip, _R, base).to(torch.uint8)
    return out[0] if one else out


def derandomize_translate_plain(ms: torch.Tensor, k: int, threshold: int,
                                true_len=None) -> torch.Tensor:
    """Plain version of :func:`derandomize_translate`: the two cores as they
    stand (positions past a row's true length hold garbage, not 0)."""
    return translate_core(
        derandomize_core(ms, k, threshold, true_len), k, threshold, true_len
    )


def derandomize_ms_device(noisy_ms: np.ndarray, k: int, threshold: int,
                          device=None) -> np.ndarray:
    """Derandomize one noisy MS row with host numpy I/O: int64 [L], through
    :func:`derandomize_core` on ``device`` (the card unless named), as
    kbo_tpu's helper runs its XLA core."""
    noisy = torch.from_numpy(np.asarray(noisy_ms).astype(np.int32))
    out = derandomize_core(noisy.to(resolve_device(device)), k, threshold)
    return out.cpu().numpy().astype(np.int64)


def translate_ms_device(derand_ms: np.ndarray, k: int, threshold: int,
                        device=None) -> list[str]:
    """Translate one derandomized MS row with host numpy I/O: the alignment
    chars as a list of str, through :func:`translate_core` on ``device``."""
    derand = torch.from_numpy(np.asarray(derand_ms).astype(np.int32))
    out = translate_core(derand.to(resolve_device(device)), k, threshold)
    return [chr(c) for c in out.cpu().numpy()]


@functools.cache
def _lib():
    lib = _build.load("derand_translate")
    n, p, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.kbo_derand_translate_tile.argtypes = []
    lib.kbo_derand_translate_tile.restype = i
    lib.kbo_derand_translate_ctas_per_sm.argtypes = []
    lib.kbo_derand_translate_ctas_per_sm.restype = i
    lib.kbo_derand_translate_tiles.argtypes = [n]
    lib.kbo_derand_translate_tiles.restype = n
    lib.kbo_derand_translate.argtypes = [p, n, p, n, n, n, n, i, i, i, p, p, p]
    lib.kbo_derand_translate.restype = ctypes.c_int
    return lib


@functools.cache
def _resident_ctas(index: int) -> int:
    """CTAs of the kernel the whole card holds at once."""
    return (torch.cuda.get_device_properties(index).multi_processor_count
            * _lib().kbo_derand_translate_ctas_per_sm())


def _short_rows(Q: int, n_tiles: int, index: int) -> bool:
    """Whether to run the kernel's short-row form (one CTA per row walking
    its tiles: no look-back, no memset) rather than its look-back form (one
    CTA per tile): when it takes no more waves of resident CTAs. Measured
    on an H100 by device time (chip_smoke.py; PERF.md): the short-row form
    is faster at 512 rows of 1-4 tiles and at 64 rows of one tile, the
    look-back form at 64 rows of 2-8 tiles and at 8 rows of 4-32 tiles; at
    512 rows of 8 tiles, as many waves either way, the two are within a
    twentieth of each other."""
    r = _resident_ctas(index)
    return n_tiles * -(-Q // r) <= -(-Q * n_tiles // r)


def _true_len_arg(true_len, Q: int, L: int, device):
    """(int32 device tensor or None, its row stride, the scalar length) as
    the kernel takes the true lengths. A Python or numpy int stays a kernel
    argument: no host-to-device copy. A contiguous int32 tensor on the
    device goes as it is (the common case, and the cheap one on the host)."""
    if true_len is None:
        return None, 0, L
    if isinstance(true_len, (int, np.integer)):
        return None, 0, int(true_len)
    tl = true_len
    if not (isinstance(tl, torch.Tensor) and tl.dtype == torch.int32
            and tl.device == device and tl.is_contiguous()):
        tl = torch.as_tensor(tl, device=device).to(torch.int32).contiguous()
    if tl.numel() not in (1, Q):
        raise ValueError(f"derandomize_translate wants {Q} true lengths or "
                         f"one, not {tl.numel()}")
    return tl, int(tl.numel() > 1), 0


def _on(device):
    """The device's context, entered only when it is not already current
    (``torch.cuda.device`` alone costs microseconds of host time a call)."""
    if device.index == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def derandomize_translate(ms: torch.Tensor, k: int, threshold: int,
                          true_len=None) -> torch.Tensor:
    """Alignment chars uint8 [Q, L] of noisy MS rows int32 [Q, L]:
    ``translate_core(derandomize_core(ms, ...), ...)`` in one pass, equal to
    it at every position below each row's ``true_len`` ([Q] or scalar; L
    when None). A 1-D input is one row.

    CUDA tensors launch ``csrc/derand_translate.cu``, the counterpart of the
    TPU kernel ``attic/pallas_postprocess.py::fused_postprocess_core``, once
    per call (after one memset of its scratch in the look-back form, see
    :func:`_short_rows`); it reads ``ms`` once and writes 0 at and past
    ``true_len``. CPU tensors take :func:`derandomize_translate_plain`.
    Rows may be strided views (a row stride, unit stride inside a row).
    """
    if ms.device.type == "cpu":
        return derandomize_translate_plain(ms, k, threshold, true_len)
    one = ms.dim() == 1
    rows = ms[None] if one else ms
    if rows.dtype != torch.int32:
        raise TypeError("derandomize_translate wants int32 ms")
    if rows.dim() != 2:
        raise ValueError("derandomize_translate wants ms [Q, L] or [L]")
    Q, L = rows.shape
    if L > 1 and rows.stride(1) != 1:
        raise ValueError("derandomize_translate wants unit stride in a row")
    device = ms.device
    tl, tl_stride, tl_scalar = _true_len_arg(true_len, Q, L, device)
    lib = _lib()
    n_tiles = lib.kbo_derand_translate_tiles(L)
    short = _short_rows(Q, n_tiles, device.index)
    scratch = None if short else torch.empty(
        Q * n_tiles + 1, dtype=torch.int64, device=device)
    out = torch.empty((Q, L), dtype=torch.uint8, device=device)
    with _on(device):
        # the current stream's handle, as torch's own compiled code reads it
        # (torch.cuda.current_stream(...).cuda_stream builds a Stream object)
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        err = lib.kbo_derand_translate(
            rows.data_ptr(), rows.stride(0) if Q > 1 else L,
            None if tl is None else tl.data_ptr(), tl_stride, tl_scalar,
            Q, L, k, int(threshold), int(short),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            stream,
        )
    _build.check(err, "derandomize_translate")
    derandomize_translate.launches += 1
    return out[0] if one else out


derandomize_translate.launches = 0


# ------------------------------------------------------- device RLE (find)


def rle_segments_core(chars: torch.Tensor, lengths: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """Per-row RLE segment tables for ``max_gap_len == 0``: int32
    [Q, 1 + 5 * min(cap, L)], per row the segment count, then ``cap``
    columns (at most L) each of start, end (half-open), matches,
    mismatches and jumps, sentinel 0x7FFFFFFF starts past the count.

    At zero gap tolerance a segment is a maximal run of non-gap characters
    (reference: src/format.rs:143-193), so its stats are prefix-sum
    differences at the run's ends. :func:`rle_segments_global_core` shares
    one table among the rows instead, which is what the find paths fetch.
    """
    Q, L = chars.shape
    dev = chars.device
    big = 0x7FFFFFFF
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_len = idx < lengths.to(torch.int32)[:, None]
    mask = in_len & (chars != ord("-")) & (chars != ord(" "))
    false_col = torch.zeros((Q, 1), dtype=torch.bool, device=dev)
    seg_start = mask & ~torch.cat([false_col, mask[:, :-1]], dim=1)
    seg_end = mask & ~torch.cat([mask[:, 1:], false_col], dim=1)
    aligned = (chars == ord("M")) | (chars == ord("R")) | (chars == ord("I"))
    prev_r = torch.cat([false_col, chars[:, :-1] == ord("R")], dim=1)
    jump = mask & (chars == ord("R")) & prev_r
    cm = torch.cumsum((mask & aligned).to(torch.int32), dim=1, dtype=torch.int32)
    cx = torch.cumsum((mask & ~aligned).to(torch.int32), dim=1, dtype=torch.int32)
    cj = torch.cumsum(jump.to(torch.int32), dim=1, dtype=torch.int32)
    count = seg_start.sum(dim=1, dtype=torch.int32)

    def compact(m):
        """Ascending positions where m holds, sentinel-padded, cap wide."""
        return torch.sort(torch.where(m, idx, big), dim=1).values[:, :cap]

    starts, ends = compact(seg_start), compact(seg_end)
    sp = torch.clamp(starts, 0, L - 1).to(torch.int64)
    ep = torch.clamp(ends, 0, L - 1).to(torch.int64)
    at_prev = torch.clamp(sp - 1, min=0)

    def span(c):
        base = torch.where(sp > 0, torch.gather(c, 1, at_prev), 0)
        return torch.gather(c, 1, ep) - base

    return torch.cat(
        [count[:, None], starts, torch.where(ends < big, ep + 1, ends),
         span(cm), span(cx), span(cj)],
        dim=1,
    ).to(torch.int32)


def _compact_capped_flat(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """First ``cap`` set positions of a flat mask, ascending, padded with
    0x7FFFFFFF: cumsum + cap-many binary searches."""
    big = 0x7FFFFFFF
    cs = torch.cumsum(mask.to(torch.int64), dim=0)
    j = torch.arange(cap, dtype=torch.int64, device=mask.device)
    pos = torch.searchsorted(cs, j + 1, side="left")
    valid = j < cs[-1]
    return torch.where(
        valid, torch.clamp(pos, max=mask.shape[0] - 1), big
    ).to(torch.int32)


def rle_segments_global_core(chars: torch.Tensor, lengths: torch.Tensor,
                             cap_total: int) -> torch.Tensor:
    """Batch-GLOBAL RLE segment extraction for ``max_gap_len == 0``: per-row
    segment counts plus ONE dense segment table shared by all rows.

    Returns one flat int32 vector: [total, counts[Q],
    start/end/matches/mismatches/jumps x cap_total] with starts/ends
    row-local and half-open (reference: src/format.rs:143-193 at zero gap
    tolerance). ``total`` > cap_total signals overflow (the caller retries
    bigger).
    """
    Q, L = chars.shape
    dev = chars.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_len = idx < lengths.to(torch.int32)[:, None]
    is_gap = (chars == ord("-")) | (chars == ord(" "))
    mask = in_len & ~is_gap
    false_col = torch.zeros((Q, 1), dtype=torch.bool, device=dev)
    prev_mask = torch.cat([false_col, mask[:, :-1]], dim=1)
    next_mask = torch.cat([mask[:, 1:], false_col], dim=1)
    seg_start = mask & ~prev_mask
    seg_end = mask & ~next_mask
    aligned = (chars == ord("M")) | (chars == ord("R")) | (chars == ord("I"))
    prev_r = torch.cat([false_col, chars[:, :-1] == ord("R")], dim=1)
    jump = mask & (chars == ord("R")) & prev_r
    cm = torch.cumsum((mask & aligned).to(torch.int32), dim=1, dtype=torch.int32)
    cx = torch.cumsum((mask & ~aligned).to(torch.int32), dim=1, dtype=torch.int32)
    cj = torch.cumsum(jump.to(torch.int32), dim=1, dtype=torch.int32)
    counts = seg_start.sum(dim=1, dtype=torch.int32)
    total = counts.sum(dtype=torch.int32)

    fs = _compact_capped_flat(seg_start.reshape(-1), cap_total)
    fe = _compact_capped_flat(seg_end.reshape(-1), cap_total)
    big = 0x7FFFFFFF
    valid = fs < big
    fs_c = torch.where(valid, fs, 0).to(torch.int64)
    fe_c = torch.where(valid, fe, 0).to(torch.int64)
    # starts and ends pair 1:1 in flat order (within a row they strictly
    # interleave start <= end < next start; rows concatenate in order)
    q = fs_c // L
    sl = (fs_c - q * L).to(torch.int32)
    el = (fe_c - q * L).to(torch.int32)
    cmf, cxf, cjf = cm.reshape(-1), cx.reshape(-1), cj.reshape(-1)
    base_ok = sl > 0
    at_prev = torch.clamp(fs_c - 1, min=0)
    bm = torch.where(base_ok, cmf[at_prev], 0)
    bx = torch.where(base_ok, cxf[at_prev], 0)
    bj = torch.where(base_ok, cjf[at_prev], 0)
    rows = [
        torch.where(valid, sl, big),
        torch.where(valid, el + 1, big),
        torch.where(valid, cmf[fe_c] - bm, 0),
        torch.where(valid, cxf[fe_c] - bx, 0),
        torch.where(valid, cjf[fe_c] - bj, 0),
    ]
    return torch.cat([total[None], counts] + [r.to(torch.int32) for r in rows])
