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

import torch

from kbo_tpu_torch.kernels.ms import _doubling_cummax

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


# ------------------------------------------------------- device RLE (find)


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
