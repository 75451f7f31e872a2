"""Map pipeline on the device: the 3-bit rows sweep, candidate tables and
delta-encoded output assembly (PyTorch; counterpart of
kbo_tpu/kernels/mapsweep.py).

The map path (reference: src/lib.rs:720-761) streams the reference sequence
through the query's index. Nothing full-length ever goes back to the host:

1. :func:`ms3_rows_sweep` computes MS, per-position interval uniqueness and
   matched colex rows from one 3-bit sort-join
   (kernels.ms.ms3_rows_core); :func:`map_postprocess3_core` derandomizes and
   translates, compacts the refinement candidates on the device -- MS drop
   sites (variant calling, reference: src/variant_calling.rs:268-269) and gap
   runs of the translation (gap filling, src/gap_filling.rs:466-475) -- and
   resolves the variant anchors and gap unique-context grids as gathers from
   the dense join outputs.
2. Refinement produces (position, char) patches (kernels/refine.py on the
   device, refine/gap_filling.py on the host for the gaps over budget).
3. :func:`assemble_map_prio_core` lands the patches in the device-resident
   translation, applies ``relative_to_ref`` (reference:
   src/format.rs:266-287) and emits the output as *delta runs against the
   reference* (map output is ~99.9% equal to the reference sequence); the
   host paints them onto a copy of the reference.

Batches the rows join cannot take (k >= 128, or too many contigs even
chunked) run the 2-bit path instead: :func:`map_sweep_compact_core` (the
2-bit join, derandomize/translate and the compacted candidates), one
:func:`fetch_candidates`, the host refinement over sparse colex intervals
(kbo_tpu_torch.api._map_classic), :func:`assemble_map_core` and one
:func:`fetch_delta_runs`.

kbo_tpu writes the per-contig parts for one row and maps them with
``jax.vmap``; here the batch dimension is written out.
"""

from __future__ import annotations

import numpy as np
import torch

from kbo_tpu_torch import native
from kbo_tpu_torch.kernels.ms import INVALID, ms2_core, ms3_rows_core
from kbo_tpu_torch.kernels.postprocess import derandomize_translate
from kbo_tpu_torch.utils.stats import get_stats, stage

_BIG32 = 2**31 - 1
_M, _X, _DASH = ord("M"), ord("X"), ord("-")


# ------------------------------------------------------- packed upload


def pack_ascii_host(ref_mat: np.ndarray, lengths):
    """Host side of the packed reference upload: [Q, L] raw ASCII (0-padded
    rows) -> (packed4 uint8 [Q, L//4], exc_pos int32, exc_byte uint8).
    :func:`decode_packed4_device` reconstructs the exact raw matrix: 2 bits
    per base (A/a C/c G/g T/t -> 0..3) plus a flat-position exception list
    for every in-length byte that is not uppercase ACGT (N runs,
    soft-masking, '$', ...), padded to a power of two with position Q*L.
    Returns None when L % 4 != 0 or the exceptions exceed L//16 (soft-masked
    genomes: the packed form would not pay for itself) -- the caller uploads
    the raw matrix instead. The loop runs in the native host library
    (native_src/pack.cpp); :func:`pack_ascii_plain` is its numpy form."""
    return native.pack_ascii(ref_mat, lengths)


def pack_ascii_plain(ref_mat: np.ndarray, lengths):
    """The numpy form of :func:`pack_ascii_host`, same outputs byte for
    byte: the plain version the tests hold the native loop against."""
    Q, L = ref_mat.shape
    if L % 4:
        return None
    # one fused LUT pass: low 2 bits = base code, bit 7 = "not uppercase
    # ACGT" (a byte that must ride the exception list if in-length)
    lut = np.full(256, 0x80, dtype=np.uint8)
    for c2, chars in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
        for ch in chars:
            lut[ch] = c2 | (0x80 if ch >= ord("a") else 0)
    lc = np.ascontiguousarray(lut[ref_mat])
    # word-parallel pack: a little-endian uint32 view holds 4 base codes in
    # its bytes; OR-ing the word with itself shifted by 6/12/18 lands code i
    # at bits 2i..2i+1 with no cross-terms, so the low byte is the packed
    # quad. Bad positions are filtered against row lengths after the
    # flatnonzero, since tails and exceptions are both sparse
    v = lc.reshape(Q, L // 4, 4).view(np.uint32)[..., 0] & np.uint32(0x03030303)
    packed4 = ((v | (v >> 6) | (v >> 12) | (v >> 18)) & 0xFF).astype(np.uint8)
    bad_pos = np.flatnonzero(lc & 0x80)
    if bad_pos.size:
        lens = np.asarray(lengths)[:Q].astype(np.int64)
        q = bad_pos // L
        exc_pos = bad_pos[(bad_pos - q * L) < lens[q]]
    else:
        exc_pos = bad_pos
    if exc_pos.size > max(64, Q * L // 16):
        return None
    cap_e = 64
    while cap_e < exc_pos.size:
        cap_e <<= 1
    pos_pad = np.full(cap_e, Q * L, dtype=np.int32)
    byte_pad = np.zeros(cap_e, dtype=np.uint8)
    pos_pad[: exc_pos.size] = exc_pos
    byte_pad[: exc_pos.size] = ref_mat.reshape(-1)[exc_pos]
    return packed4, pos_pad, byte_pad


def decode_packed4_device(packed4, exc_pos, exc_byte, lengths):
    """Device side of the packed reference upload: exact raw ASCII [Q, L]
    from 2-bit packed bases + the exception list (see
    :func:`pack_ascii_host`). Padding beyond each row's length decodes to 0,
    matching the host matrix layout byte for byte."""
    Q, Lp = packed4.shape
    L = Lp * 4
    dev = packed4.device
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=dev)
    u2 = ((packed4[..., None] >> shifts) & 3).reshape(Q, L)
    out = torch.full((Q, L), ord("A"), dtype=torch.uint8, device=dev)
    for c2, ch in enumerate(b"CGT"):
        out = torch.where(u2 == c2 + 1, ch, out)
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    out = torch.where(idx < lengths[:, None], out, 0).to(torch.uint8)
    # exception pads carry position Q*L: they land in a spare last entry
    flat = torch.cat([out.reshape(-1), out.new_zeros(1)])
    flat.scatter_(0, exc_pos.to(torch.int64), exc_byte)
    return flat[: Q * L].reshape(Q, L)


def encode_ascii_device(ascii_mat):
    """Device twin of index.encode.encode_ascii: raw ASCII bytes -> codes
    (0='$', 1..4=ACGT/acgt, else INVALID). Zero padding encodes to INVALID,
    matching pipeline.pad_batch."""
    lower = ascii_mat | 0x20
    code = torch.full_like(ascii_mat, INVALID)
    code = torch.where(ascii_mat == ord("$"), 0, code)
    for b, ch in enumerate(b"acgt"):
        code = torch.where(lower == ch, b + 1, code)
    return code.to(torch.uint8)


def decode_packed4_encode_device(packed4, exc_pos, exc_byte, lengths):
    """The packed upload's tail: exact raw ASCII [Q, L] and its sweep codes."""
    rm = decode_packed4_device(packed4, exc_pos, exc_byte, lengths)
    return rm, encode_ascii_device(rm)


# ---------------------------------------------------------- compaction


def _compact_row(mask):
    """Ascending positions where a flat mask is set, padded with BIG (full
    length): where(mask, idx, BIG) sorted."""
    idx = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    return torch.sort(torch.where(mask, idx, _BIG32)).values


def _compact_mask_capped(mask, cap: int):
    """First ``cap`` set positions of each row of ``mask`` ([..., L]) in
    ascending order, padded with BIG: one cumsum + ``cap`` binary searches
    (slot j holds the position of the (j+1)-th set bit = the first index
    whose inclusive cumsum reaches j+1). Candidates are sparse (~1/kb) while
    the mask is genome-wide, so cap * log2(L) gather steps beat anything that
    touches all L slots again."""
    cs = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    j = torch.arange(cap, dtype=torch.int32, device=mask.device)
    j = j.expand(mask.shape[:-1] + (cap,)).contiguous()
    pos = torch.searchsorted(cs, j + 1, side="left")
    valid = j < cs[..., -1:]
    return torch.where(valid, pos, _BIG32).to(torch.int32)


def _next_nondash(is_dash, length):
    """nnd[..., i] = smallest j > i with NOT is_dash[..., j], clamped to
    ``length`` (a scalar, or [Q, 1] against [Q, L] rows).

    Log-depth reverse doubling min-scan (positions >= length count as
    non-dash, so runs always terminate at the true length).
    """
    L = is_dash.shape[-1]
    idx = torch.arange(L, dtype=torch.int32, device=is_dash.device)
    x = torch.where(is_dash, _BIG32, idx)

    def shifted(x, s):
        pad = torch.full(x.shape[:-1] + (s,), _BIG32, dtype=torch.int32,
                         device=x.device)
        return torch.cat([x[..., s:], pad], dim=-1)

    # exclusive-from-right scan: shift by one, then doubling cummin
    x = shifted(x, 1)
    s = 1
    while s < L:
        x = torch.minimum(x, shifted(x, s))
        s <<= 1
    return torch.clamp(x, max=length)


def _pad_slots(arr, cap: int):
    """Slice a compacted slot array ([..., n]) to ``cap``, padding with BIG
    when the source is shorter (tiny inputs)."""
    out = arr[..., :cap]
    if out.shape[-1] < cap:
        pad = torch.full(out.shape[:-1] + (cap - out.shape[-1],), _BIG32,
                         dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad], dim=-1)
    return out


# --------------------------------------------------------------- sweep


def _ms3_rows_chunk(keys3, ref_packed, ctx_codes, k: int,
                    want_qtable: bool = False):
    """The rows join over ``ctx_codes`` = [Q, (k-1) + W] (k-1 context codes
    + W positions per row); returns (ms, uniq, rows) for the W positions only
    (the qtable, when requested, covers ALL buffer positions -- context
    windows stay)."""
    Q, width = ctx_codes.shape
    out = ms3_rows_core(
        keys3, ref_packed, ctx_codes.reshape(-1), k, want_qtable
    )
    ms, uniq, rows = (x.reshape(Q, width)[:, k - 1 :] for x in out[:3])
    if want_qtable:
        return ms, uniq, rows, out[3]
    return ms, uniq, rows


def ms3_rows_sweep(keys3, ref_packed, codes, k: int, want_qtable: bool = False):
    """Stage 1 of the map sweep: the 3-bit join over a [Q, L] batch,
    emitting device-resident per-position (ms, uniq, row). ``ref_packed``
    is the index's ``rows_packed`` (kernels.ms.rows_ref_packed).

    ``want_qtable`` additionally returns ``[(words, limits)]``: the
    sweep-sorted query window keys (kernels.ms.ms3_rows_core), reusable as
    the rk-vs-seq join table for single-contig batches."""
    Q = codes.shape[0]
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8, device=codes.device)
    out = _ms3_rows_chunk(
        keys3, ref_packed, torch.cat([pad, codes], dim=1), k, want_qtable
    )
    if want_qtable:
        return out[0], out[1], out[2], [out[3]]
    return out


def ms3_rows_sweep_chunked(keys3, ref_packed, codes, k: int, chunk: int,
                           want_qtable: bool = False):
    """Sequence-chunked stage 1: the same (ms, uniq, row) outputs from
    sub-joins of ``chunk`` positions each.

    Window position p depends only on codes[p-k+1 .. p], so feeding each
    chunk the previous chunk's last k-1 codes as context makes the split
    EXACT (the first chunk's context is INVALID pad, exactly the unchunked
    buffer head). It keeps the packed join under its 2^24-slot budget for
    arbitrarily long references. Each sub-join re-scans the n-row key
    table, so chunks should stay as large as the slot budget allows.

    ``want_qtable`` additionally returns the per-chunk sorted query-key
    tables ``[(words, limits), ...]``: every true window of the sequence
    appears with full k-1 context in exactly one chunk's buffer, and a
    context-region duplicate can only carry a truncated (<=) key/limit, so a
    max over per-chunk joins against these tables is exact.

    Run stats: the chunk loop is the span ``map_sweep_chunked`` and
    ``map_sweep_chunks`` counts its chunks (the caller's ``map_sweep`` span
    counts the bases).
    """
    Q, L = codes.shape
    n_chunks = (L + chunk - 1) // chunk
    Lp = n_chunks * chunk
    dev = codes.device
    if Lp != L:
        tail = torch.full((Q, Lp - L), INVALID, dtype=torch.uint8, device=dev)
        codes = torch.cat([codes, tail], dim=1)
    parts = []
    with stage("map_sweep_chunked"):
        for c in range(n_chunks):
            lo = c * chunk
            if c == 0:
                ctx = torch.full((Q, k - 1), INVALID, dtype=torch.uint8,
                                 device=dev)
            else:
                ctx = codes[:, lo - (k - 1) : lo]
            parts.append(
                _ms3_rows_chunk(
                    keys3, ref_packed,
                    torch.cat([ctx, codes[:, lo : lo + chunk]], dim=1),
                    k, want_qtable,
                )
            )
    get_stats().add("map_sweep_chunks", n_chunks)
    ms, uniq, rows = (
        torch.cat([p[i] for p in parts], dim=1)[:, :L] for i in range(3)
    )
    if want_qtable:
        return ms, uniq, rows, [p[3] for p in parts]
    return ms, uniq, rows


def upload_sweep_chunked_pipelined(keys3, ref_packed, ref_mat, lengths,
                                   k: int, chunk: int,
                                   want_qtable: bool = False):
    """The chunked stage 1 with the upload chunked too: pack and ship chunk
    c + 1 while the device sweeps chunk c.

    Each chunk of the raw [Q, L] matrix packs on the host
    (:func:`pack_ascii_host`), crosses, decodes to raw ASCII and codes on
    the device and sweeps with the previous chunk's last k - 1 device codes
    as context; the launches are asynchronous, so the host packs the next
    chunk while the card works. In-chunk lengths clip the row lengths into
    the slice, so beyond-length positions decode to 0 and encode INVALID:
    the outputs equal the one-shot upload followed by
    :func:`ms3_rows_sweep_chunked`, byte for byte.

    Returns (ref_mat_dev [Q, L], codes_dev [Q, L], ms, uniq, rows,
    qtables or None), or None when the packed upload does not apply (the
    caller takes the one-shot upload).

    Run stats: the chunk loop is the span ``map_sweep_chunked`` with the
    rows' bases, each chunk's host pack the span ``map_chunk_pack``, and
    ``map_sweep_chunks`` counts the chunks of a sweep that completed."""
    Q, L = ref_mat.shape
    if L % 4 or chunk % 4:
        return None
    dev = keys3.device
    n_chunks = (L + chunk - 1) // chunk
    lens = np.asarray(lengths)
    ref_parts, code_parts, sweeps = [], [], []
    with stage("map_sweep_chunked", bases=int(lens.sum())):
        for c in range(n_chunks):
            lo = c * chunk
            hi = min(lo + chunk, L)
            sl = ref_mat[:, lo:hi]
            if hi - lo < chunk:
                sl = np.pad(sl, ((0, 0), (0, chunk - (hi - lo))))
            in_chunk_lens = np.clip(lens - lo, 0, chunk).astype(np.int32)
            with stage("map_chunk_pack"):
                packed_up = pack_ascii_host(np.ascontiguousarray(sl),
                                            in_chunk_lens)
            if packed_up is None:
                return None  # dense exceptions: the one-shot raw upload
            r_dev, c_dev = decode_packed4_encode_device(
                *(torch.from_numpy(a).to(dev)
                  for a in packed_up + (in_chunk_lens,))
            )
            if c == 0:
                ctx = torch.full((Q, k - 1), INVALID, dtype=torch.uint8,
                                 device=dev)
            else:
                ctx = code_parts[-1][:, -(k - 1):]
            ref_parts.append(r_dev)
            code_parts.append(c_dev)
            sweeps.append(_ms3_rows_chunk(
                keys3, ref_packed, torch.cat([ctx, c_dev], dim=1), k,
                want_qtable,
            ))
    get_stats().add("map_sweep_chunks", n_chunks)
    ref_mat_dev = torch.cat(ref_parts, dim=1)[:, :L]
    codes_dev = torch.cat(code_parts, dim=1)[:, :L]
    ms, uniq, rows = (
        torch.cat([p[i] for p in sweeps], dim=1)[:, :L] for i in range(3)
    )
    qtables = [p[3] for p in sweeps] if want_qtable else None
    return ref_mat_dev, codes_dev, ms, uniq, rows, qtables


def _candidates(ms, chars, lengths, t: int, cap_d: int, cap_g: int):
    """The refinement candidates of a sweep's [Q, L] MS and chars,
    compacted on the device: MS drop sites (variant calling) and gap runs
    of the translation (gap filling).

    Returns (counts int32 [Q, 2] = (n_drops, n_gaps), drop_pos [Q, cap_d],
    gap_start [Q, cap_g] ascending and padded with BIG, gap_end_at
    [Q, cap_g] the run end aligned with each start, start_mask [Q, L] and
    nnd [Q, L] (:func:`_next_nondash` of the translation's dashes)).
    """
    Q, L = ms.shape
    dev = ms.device
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    n_q = lengths.to(torch.int32)[:, None]
    in_len = idx < n_q
    false_col = torch.zeros((Q, 1), dtype=torch.bool, device=dev)

    # MS drops (reference: src/variant_calling.rs:268-269): i >= 1 with
    # ms[i] < ms[i-1], ms[i-1] >= t, ms[i] < t. The variant caller's
    # threshold equals the sweep threshold (same index, same error prob).
    prev_ms = torch.cat([ms[:, :1], ms[:, :-1]], dim=1)
    drop_mask = (idx >= 1) & in_len & (ms < prev_ms) & (prev_ms >= t) & (ms < t)
    drop_pos = _compact_mask_capped(drop_mask, cap_d)

    # gap runs (reference: src/gap_filling.rs:466-475): maximal
    # ['-'|'X'] + '-'* blocks with start in [t, n - t - 1). An 'X' always
    # starts a run (a run's dash-continuation stops at any non-dash); a
    # dash p0 > lo starts one iff it is not covered by the continuation of
    # the run through p0-1.
    is_dash = (chars == _DASH) & in_len
    is_x = (chars == _X) & in_len
    is_gapc = is_dash | is_x
    prev_gapc = torch.cat([false_col, is_gapc[:, :-1]], dim=1)
    start_mask = (
        is_gapc & (idx >= t) & (idx < n_q - t - 1)
        & (is_x | (idx == t) | ~prev_gapc)
    )
    gap_start = _compact_mask_capped(start_mask, cap_g)
    nnd = _next_nondash(is_dash, n_q)
    gap_end_at = torch.gather(
        nnd, 1, torch.clamp(gap_start, max=L - 1).to(torch.int64)
    )

    counts = torch.stack(
        [
            drop_mask.sum(dim=1, dtype=torch.int32),
            start_mask.sum(dim=1, dtype=torch.int32),
        ],
        dim=1,
    )
    return counts, drop_pos, gap_start, gap_end_at, start_mask, nnd


def map_sweep_compact_core(keys2, cap2, codes, lengths, k: int,
                           threshold: int):
    """The 2-bit map sweep with the candidates compacted on the device: the
    sweep of every k (the rows join needs k < 128) and of batches past the
    rows join's slot budget.

    codes: uint8 [Q, L] tail-padded with INVALID; lengths: int32 [Q] on the
    same device. :func:`kbo_tpu_torch.kernels.ms.ms2_core` over the
    sentinel-padded [Q, L + k - 1] buffer, then one
    :func:`derandomize_translate` (kbo_tpu's derandomize_core +
    translate_core), then the drop and gap-run masks, compacted and counted.

    Returns (chars uint8 [Q, L], ms int32 [Q, L], counts int32 [Q, 2] =
    (n_drops, n_gaps), drop_pos int32 [Q, L], gap_start int32 [Q, L],
    gap_end_at int32 [Q, L]): positions ascending and padded with BIG,
    ``gap_end_at[q, j]`` the end of the run starting at ``gap_start[q, j]``.
    Everything stays on the device; :func:`fetch_candidates` fetches
    count-sized slices. ``chars`` is 0 past each row's length.
    """
    Q, L = codes.shape
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8,
                     device=codes.device)
    buf = torch.cat([pad, codes], dim=1).reshape(-1)
    ms = ms2_core(keys2, cap2, buf, k).reshape(Q, L + k - 1)[:, k - 1 :]
    chars = derandomize_translate(ms, k, threshold, lengths)
    counts, drop_pos, gap_start, gap_end_at, _, _ = _candidates(
        ms, chars, lengths, int(threshold), L, L
    )
    return chars, ms, counts, drop_pos, gap_start, gap_end_at


def fetch_candidates(counts, drop_pos, gap_start, gap_end_at, cap_d: int,
                     cap_g: int):
    """The compacted candidate arrays of :func:`map_sweep_compact_core`
    sliced to the capacities and packed with the counts: int32
    [Q, 2 + cap_d + 2 * cap_g] = (n_drops, n_gaps, drop positions, gap
    starts, gap ends), one fetch. The caller checks the counts against the
    capacities and fetches again with larger ones when they overflow. A
    row shorter than a capacity (a reference under the slot floor) pads
    with BIG, so the caller's fixed offsets stay aligned."""
    return torch.cat(
        [
            counts,
            _pad_slots(drop_pos, cap_d),
            _pad_slots(gap_start, cap_g),
            _pad_slots(gap_end_at, cap_g),
        ],
        dim=1,
    )


def map_postprocess3_core(ms, uniq, rows, lengths, k: int, threshold: int,
                          cap_d: int, cap_g: int, w_grid: int | None = None):
    """Stage 2 of the map sweep: derandomize/translate, candidate
    compaction, device-side variant anchors and gap unique-context grids
    from the dense stage-1 outputs.

    Returns (chars uint8 [Q, L] -- device-resident;
    packed int32 [Q, 2 + cap_d + 2*cap_g + 2*cap_d + cap_g*w_grid];
    pieces): per row of ``packed``: n_drops, n_gaps, drop positions, gap
    starts, gap ends, anchor positions (-1 = none; reference anchor rule,
    src/variant_calling.rs:271-272), anchor colex rows, then the gap
    unique-context grid (colex row at search_lo_g + c when unique, else -1;
    src/gap_filling.rs:127-151, :466-478). ``pieces`` holds the same
    candidate tables as separate device tensors, for the on-device
    refinement.

    ``w_grid`` is the candidate-window width: the reference's search window
    is [end+t, min(end+radius, n-1)] with radius <= k, so its width never
    exceeds k - threshold + 1; callers that know the integer threshold pass
    that (the k+1 default is the thresholdless upper bound). Positions
    beyond the true window are -1 either way.
    """
    Q, L = ms.shape
    assert k < 128, "packed probe word carries ms in 7 bits"
    if w_grid is None:
        w_grid = k + 1
    dev = ms.device
    t = int(threshold)
    chars = derandomize_translate(ms, k, t, lengths)

    counts, drop_pos, gap_start, gap_end_at, start_mask, nnd = _candidates(
        ms, chars, lengths, t, cap_d, cap_g
    )
    idx = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    n_q = lengths.to(torch.int32)[:, None]
    # per-contig clamped gap bases over ALL runs (incl. any beyond the slot
    # capacities): sum of max(0, min(run_end, n - t) - start) -- feeds the
    # unfilled-bases stat when gap filling is off
    clamped_gap = torch.where(
        start_mask, torch.clamp(torch.minimum(nnd, n_q - t) - idx, min=0), 0
    ).sum(dim=1, dtype=torch.int32)

    # one packed word per position -- (row 24b | ms 7b | uniq 1b) -- so the
    # anchor and grid probes below pay ONE gather per position
    packed_pos = (
        (torch.clamp(rows, min=0).to(torch.int64) << 8)
        | (torch.clamp(ms, 0, 127) << 1)
        | uniq
    )

    def probe(pos):
        """packed_pos at [Q, S, W] positions (clipped into the row)."""
        at = torch.gather(
            packed_pos, 1,
            torch.clamp(pos, 0, L - 1).reshape(Q, -1).to(torch.int64),
        )
        return at.reshape(pos.shape)

    n_q3 = n_q[:, :, None]
    # variant anchors: first j in (i, i+k] with ms[j] >= t and a unique
    # interval -- gathers from the dense join outputs
    dp = _pad_slots(drop_pos, cap_d)
    offs_a = torch.arange(1, k + 1, dtype=torch.int32, device=dev)
    pos_a = torch.clamp(dp, max=2**30)[:, :, None] + offs_a
    at = probe(pos_a)
    ok = (
        (((at >> 1) & 0x7F) >= t) & ((at & 1) == 1)
        & (dp < _BIG32)[:, :, None] & (pos_a < n_q3)
    )
    first = torch.where(ok, offs_a, k + 1).min(dim=2)
    has = first.values <= k
    apos = torch.where(has, torch.clamp(dp, max=2**30) + first.values, -1)
    arow = torch.where(
        has, torch.gather(at >> 8, 2, first.indices[:, :, None])[:, :, 0], -1
    )

    # gap unique-context grid over each run's search window
    gstart = _pad_slots(gap_start, cap_g)
    gend = _pad_slots(gap_end_at, cap_g)
    gs = torch.clamp(gstart, max=2**30)
    end = torch.minimum(gend, n_q - t)
    fits = (end - gs) + 2 * t <= k
    radius = k - torch.where(fits, t, 0)
    lo = end + t
    hi = torch.minimum(end + radius, n_q - 1)
    offs_g = torch.arange(w_grid, dtype=torch.int32, device=dev)
    pos_g = lo[:, :, None] + offs_g
    valid_g = (
        (gstart < _BIG32)[:, :, None] & (pos_g <= hi[:, :, None]) & (pos_g >= 0)
    )
    gt = probe(pos_g)
    grid = torch.where(valid_g & ((gt & 1) == 1), gt >> 8, -1).to(torch.int32)

    pieces = {
        "drop_pos": dp,
        "gap_start": gstart,
        "gap_end_at": gend,
        "apos": apos.to(torch.int32),
        "arow": arow.to(torch.int32),
        "grid": grid,
        "counts": counts,
        "clamped_gap": clamped_gap,
    }
    packed = torch.cat(
        [
            counts, dp, gstart, gend, pieces["apos"], pieces["arow"],
            grid.reshape(Q, cap_g * w_grid),
        ],
        dim=1,
    )
    return chars, packed, pieces


# ------------------------------------------------------------ assembly


def _emit_deltas(flat, ref_ascii, lengths, fmt: bool, cap: int | None = None):
    """relative_to_ref + delta runs of a flat [Q*L] translation.

    With ``fmt`` the output is ``relative_to_ref`` (reference:
    src/format.rs:266-287) and deltas are vs the reference bytes; without,
    the output is the translation itself and deltas are vs 'M'. Deltas are
    run-length encoded (maximal runs of one differing value), so both the
    common shapes -- isolated SNP edits and long uncovered '-' stretches --
    fetch in O(#runs), never O(n). Returns (counts int32 [2] = (n_runs,
    checksum), run_start int32 global flat positions ascending and padded
    with BIG, run_end int32 aligned, run_val uint8 aligned).

    With ``cap`` the run arrays come back ``cap`` wide via the
    cumsum + search compaction (no full-length sort and no full-length
    end/value gathers), otherwise Q*L wide; the true run count rides
    ``counts`` either way, so an undersized cap is detected and the caller
    re-assembles."""
    Q, L = ref_ascii.shape
    dev = flat.device
    ref_flat = ref_ascii.reshape(-1)
    if fmt:
        take_ref = (flat == _M) | (flat == ord("R")) | (flat == ord("I"))
        dash = (flat == _X) | (flat == ord("D")) | (flat == _DASH)
        out = torch.where(take_ref, ref_flat, torch.where(dash, _DASH, flat))
        out = out.to(torch.uint8)
        base = ref_flat
    else:
        out = flat
        base = torch.full_like(flat, _M)

    col = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_len = (col < lengths.to(torch.int32)[:, None]).reshape(-1)
    row_head = (col == 0).expand(Q, L).reshape(-1)
    mask = in_len & (out != base)
    # a run continues while the delta value repeats, and never crosses a
    # contig row boundary
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    prev_mask = torch.cat([false1, mask[:-1]])
    prev_out = torch.cat([out[:1], out[:-1]])
    cont = mask & prev_mask & (out == prev_out) & ~row_head
    run_start_mask = mask & ~cont
    if cap is None:
        run_start = _compact_row(run_start_mask)
    else:
        run_start = _compact_mask_capped(run_start_mask, cap)
    ncont = _next_nondash(cont, Q * L)
    at = torch.clamp(run_start, max=Q * L - 1).to(torch.int64)
    run_end = ncont[at]
    run_val = out[at]
    n_runs = run_start_mask.sum(dtype=torch.int32)
    checksum = torch.where(in_len, out, 0).sum(dtype=torch.int32)
    return torch.stack([n_runs, checksum]), run_start, run_end, run_val


def assemble_map_core(chars, ref_ascii, lengths, patch_pos, patch_val,
                      fmt: bool):
    """Patch the device-resident translation and emit the output as delta
    runs (:func:`_emit_deltas`, full width: the run arrays are Q*L long
    and :func:`fetch_delta_runs` slices them).

    patch_pos: int32 [P] global flat positions q*L+i, unique (a host dict's
    keys), out of [0, Q*L) = inert; patch_val: uint8 [P]. The patches land
    through :func:`assemble_map_prio_core` at one priority (a scatter-max,
    never an indexed store)."""
    pv = (1 << 8) | patch_val.to(torch.int32)
    return assemble_map_prio_core(chars, ref_ascii, lengths, [patch_pos],
                                  [pv], fmt)


def assemble_map_prio_core(chars, ref_ascii, lengths, pos_grids,
                           prio_val_grids, fmt: bool, cap: int | None = None):
    """Priority-ordered patch application + delta emission.

    ``pos_grids`` / ``prio_val_grids``: parallel lists of integer tensors
    (any shape; flattened) where positions are global flat q*L+i (out of
    [0, Q*L) = inert) and values pack (priority << 8) | ascii. Duplicate
    positions resolve by scatter-max on the packed value
    (``scatter_reduce`` with ``amax``: an indexed store with duplicate
    indices is unordered on CUDA), so priorities reproduce the host's dict
    ordering: gap fills carry priority 1, variant patches 2 + site order,
    host extras ride above.
    """
    Q, L = chars.shape
    flat = chars.reshape(-1)
    if pos_grids:
        # inert positions land in a spare last entry
        acc = torch.zeros(Q * L + 1, dtype=torch.int32, device=chars.device)
        for pos, pv in zip(pos_grids, prio_val_grids):
            pos = pos.reshape(-1).to(torch.int64)
            pos = torch.where((pos >= 0) & (pos < Q * L), pos, Q * L)
            acc.scatter_reduce_(
                0, pos, pv.reshape(-1).to(torch.int32), "amax", include_self=True
            )
        acc = acc[: Q * L]
        flat = torch.where(acc > 0, (acc & 0xFF).to(torch.uint8), flat)
    return _emit_deltas(flat, ref_ascii, lengths, fmt, cap)


def fetch_delta_runs_extras(counts, run_start, run_end, run_val, extras,
                            cap: int):
    """Slice the compacted delta runs to ``cap`` and pack them with the
    (n_runs, checksum) counts and extra int32 scalars as one int32 [4, cap]
    tensor (row 3 holds the counts, then the extras) -- refinement
    counters, overflow indicators and fallback flags ride the SAME single
    fetch as the output deltas."""
    crow = torch.zeros(cap, dtype=torch.int32, device=counts.device)
    crow[:2] = counts
    crow[2 : 2 + extras.shape[0]] = extras

    def fit(row):
        row = row[:cap].to(torch.int32)
        if row.shape[0] < cap:
            row = torch.cat([row, row.new_zeros(cap - row.shape[0])])
        return row

    return torch.stack([fit(run_start), fit(run_end), fit(run_val), crow])


def fetch_delta_runs(counts, run_start, run_end, run_val, cap: int):
    """Slice the delta runs to ``cap`` and pack them with the (n_runs,
    checksum) counts as one int32 [4, cap] tensor (row 3 holds the counts).
    The caller fetches again with a larger cap when n_runs exceeds it."""
    return fetch_delta_runs_extras(counts, run_start, run_end, run_val,
                                   counts.new_zeros(0), cap)
