"""Device-side map refinement: variant resolution and gap-fill scoring
(PyTorch; counterpart of kbo_tpu/kernels/refine.py).

- :func:`resolve_variants_core` -- the variant pipeline per anchored MS drop
  (reference: src/variant_calling.rs:249-294): reference k-mers unpacked
  from the resident colex key table, query k-mers gathered from the resident
  batch rows, the two per-k-mer MS re-runs (one as a min-identity against
  the sweep row, one as a sort-join of the reference k-mers against the
  sequence's own window keys, through the join engine's merge and scan
  kernels), the vectorized resolve_variant case analysis
  (src/variant_calling.rs:139-201) and add_variants patch emission
  (src/translate.rs:350-386).
- :func:`score_gaps_core` -- gap-fill candidate scoring, left extension
  from the per-index chain table (:func:`build_ext_table_core`) or by the
  search loop (:func:`left_extend_device`) and first-success commit
  (reference: src/gap_filling.rs:444-526); gaps whose extension lanes do
  not fit the static budgets are flagged for the exact host evaluator
  (refine/gap_filling.py).

Over a key table prefix-sharded on a model group (:class:`ShardedKeys3`)
only what reads the table runs per shard: the row unpack, the membership
probes and the left extension's searches; the rest runs once, on the
group's first device. A group may span processes: the shards of this
process meet first, then the group's reducer (a ``sum`` / ``max`` pair,
kbo_tpu_torch.parallel.mesh.ProcessReduce) combines the processes' parts;
this module calls the reducer and nothing more.
- :func:`seq_keys3_tagged_core` -- sorted, contig-tagged 3-bit window keys
  of the [Q, L] reference batch: the join table for the reference-k-mer
  re-runs (the reference's build-an-index-inside-call(), src/lib.rs:553,
  without the construction).

Multi-contig correctness rides a contig tag carried as a LEADING KEY WORD
(values in chunk bits 29..0): the sort groups windows by (contig, key), an
equal tag word adds exactly 10 chunks to a common prefix and a differing one
caps it at <= 9, so the caller adds 10 to the clamp caps and subtracts 10
from the scan result (``_TAG_PAD``). Patches carry an explicit priority in
bits 8.. of a packed (priority << 8 | ascii) int32 and land by scatter-max
(kernels/mapsweep.assemble_map_prio_core): gap patches priority 1, variant
patches 2 + flat site index.

Key words are uint32 bit patterns in int32 tensors ``[W, n]``; 3-bit words
keep their top two bits clear, so they are non-negative.
"""

from __future__ import annotations

import math

import torch

from kbo_tpu_torch.kernels.ms import (
    INVALID,
    _carry_nearest,
    _neighbor_best,
    device_scope,
    pack_windows_3bit,
    w3_for_k,
)
from kbo_tpu_torch.kernels.sort import _radix_sort, to_i32, u32
from kbo_tpu_torch.ops.derandomize import log_rm_max_cdf
from kbo_tpu_torch.utils.stats import get_stats

_BIG32 = 2**31 - 1
_OOB = 254  # never equals any reference byte
_MASK30 = 0x3FFFFFFF

# chunk value (0..7) -> ASCII; 0 is '$', 5/6/7 are never real row content
# and map to 0, which never equals a reference byte either
_CHUNK_ASCII = (ord("$"), ord("A"), ord("C"), ord("G"), ord("T"), 0, 0, 0)

# The contig tag's +10 chunks (see the module docstring)
_TAG_PAD = 10


def _chunk_ascii(x):
    """Chunk code (0..7) -> ASCII uint8, one table lookup."""
    lut = torch.tensor(_CHUNK_ASCII, dtype=torch.uint8, device=x.device)
    return lut[x.to(torch.int64)]


def max_tag(k: int) -> int:
    """Largest contig count the tagged join supports (a full tag word in
    chunk bits 29..0)."""
    return 1 << 30


def with_revcomp_rows(codes):
    """[Q, L] codes -> [Q, 2L+1] per-row [forward | INVALID | revcomp].

    The reference's ``call`` builds its inner sequence index with the same
    BuildOpts as the outer one (src/lib.rs:553), so an ``add_revcomp``
    configuration joins against both strands of the streamed sequence.
    Codes 1..4 complement as 5-c; INVALID (and the separator) pack as a pad
    chunk, so windows across the strand boundary join nothing."""
    Q = codes.shape[0]
    real = (codes >= 1) & (codes <= 4)
    rc = torch.where(real, 5 - codes, codes).flip(1)
    sep = torch.full((Q, 1), INVALID, dtype=torch.uint8, device=codes.device)
    return torch.cat([codes, sep, rc], dim=1)


def seq_keys3_tagged_core(codes, k: int):
    """Sorted contig-tagged 3-bit window keys of a [Q, L] code batch,
    int32 [W (+1 when Q > 1), Q * (L + k - 1)].

    Pad chunk 5: pads never match probe chars (1..4) nor probe pads (7).
    Windows that straddle a row's leading pad carry a 5 at distance 0 and
    join nothing. Q > 1 prepends the tag word (see ``_TAG_PAD``); Q == 1
    keeps the plain keys."""
    Q, L = codes.shape
    pad = torch.full((Q, k - 1), INVALID, dtype=torch.uint8, device=codes.device)
    buf = torch.cat([pad, codes], dim=1).reshape(-1)
    stride = L + k - 1
    words = pack_windows_3bit(buf, k, pad_chunk=5)
    if Q > 1:
        tag = torch.arange(Q, dtype=torch.int32, device=codes.device)
        words = torch.cat([tag.repeat_interleave(stride)[None], words])
    return _radix_sort(words)[0]


def seq_keys3_tagged_rc(codes, k: int):
    """:func:`seq_keys3_tagged_core` over both strands of each row."""
    return seq_keys3_tagged_core(with_revcomp_rows(codes), k)


class LocalReduce:
    """The reducer of a group that lies in one process: the identity."""

    @staticmethod
    def sum(x):
        return x

    max = sum


class ShardedKeys3:
    """A colex key table prefix-sharded over a model group (the placement of
    kbo_tpu_torch.parallel.mesh.Sharded3Index): ``shards[i]`` int32 [W, m] is
    columns [i*m, (i+1)*m) of the table on its own device, all-ones past the
    table's end, or None when another process holds it. The refinement
    functions below take it where they take ``keys3``: the row unpack, the
    membership probes and the left extension run per local shard on the
    shard's device and meet on the first local shard's device (a sum of
    the shards' disjoint contributions, or an OR), then over the processes
    through ``reduce`` (``sum`` / ``max``; :class:`LocalReduce` by
    default), where everything that does not read the table runs once.

    Each shard's bucket table (:func:`bucket_table`, 8 MiB) is built at the
    first search and kept with the shard."""

    def __init__(self, shards, m: int, reduce=None):
        self.shards = list(shards)
        self.local = [(i, s) for i, s in enumerate(self.shards)
                      if s is not None]
        self.m = int(m)
        self.device = self.local[0][1].device
        self.reduce = reduce or LocalReduce()
        self._tables = None

    def search_tables(self):
        """(bucket table, search steps) per local shard, on its device."""
        if self._tables is None:
            self._tables = []
            for _, s in self.local:
                with device_scope(s.device):
                    tbl = bucket_table(s)
                    self._tables.append((tbl, _bucket_steps(tbl, s.shape[1])))
        return self._tables


def _unpack(keys3, r, k: int):
    words = keys3[:, r]  # [W, S]
    t = torch.arange(k - 1, -1, -1, device=keys3.device)  # char i: t = k-1-i
    sel = words[t // 10]  # [k, S]
    shift = (27 - 3 * (t % 10)).to(torch.int32)[:, None]
    return ((sel >> shift) & 7).to(torch.uint8).T


def unpack_rows3(keys3, rows, k: int):
    """[S] colex rows -> uint8 [S, k] chunk codes (0='$', 1..4=ACGT).

    The colex key table IS the packed k-mer text (build pad chunk 0 == '$'):
    the char at distance t from the window end rides word t // 10 at bits
    27 - 3 (t % 10). Each key word is gathered once per row.

    Over a :class:`ShardedKeys3` the rows are GLOBAL: each shard gives its
    in-range rows and zeros elsewhere, and the sum lands on the first local
    device (then over the processes). A row < 0 is then all zeros (no shard
    owns it), where the single table gives row 0's k-mer; only what the
    callers compute from them agrees."""
    if not isinstance(keys3, ShardedKeys3):
        return _unpack(keys3, torch.clamp(rows, min=0).to(torch.int64), k)
    m = keys3.m
    out = None
    for i, shard in keys3.local:
        with device_scope(shard.device):
            local = rows.to(shard.device).to(torch.int64) - i * m
            part = _unpack(shard, torch.clamp(local, 0, m - 1), k)
            part = torch.where(((local >= 0) & (local < m))[:, None], part, 0)
        part = part.to(keys3.device)
        out = part if out is None else out + part
    return keys3.reduce.sum(out)


# ------------------------------------------------------------ the search loop
#
# Membership probes and the left extension over the colex key table (kbo_tpu
# runs them as XLA gathers and a while_loop, no Pallas kernel). Key words
# are int32 bit patterns whose pad and sentinel columns are all ones (-1):
# the lower bound compares them as unsigned (sign bit flipped), so those
# columns sort after every probe, and the bucket table widens word 0 before
# its shift.

_BUCKET_BITS = 21
_SIGN = -(2**31)


def _pack_codes_matrix(cm, k: int):
    """[N, k] chunk codes (0..7; char 0 first) -> int32 [W, N] words in the
    colex window-key layout (the char at distance t from the END rides word
    t // 10 at bits 27 - 3 (t % 10)), comparable with keys3 columns."""
    N = cm.shape[0]
    W = w3_for_k(k)
    t = torch.arange(k, device=cm.device)
    fields = cm[:, k - 1 - t].to(torch.int64) << (27 - 3 * (t % 10))
    fields = torch.cat([fields, fields.new_zeros((N, W * 10 - k))], dim=1)
    # the fields of one word are disjoint bits: their sum is their OR
    return fields.reshape(N, W, 10).sum(dim=2).T.to(torch.int32)


def bucket_table(keys3):
    """int32 [2^21] prefix-bucket starts over the colex rows: ``tbl[p]`` =
    the first row whose word-0 top 21 bits are >= p (n when none).

    Bucketing by the key's high bits is order-consistent, so the lower
    bound of a probe lies in [tbl[top], tbl[top + 1]]: the binary search
    starts about 2^21-fold narrower. One scatter-min over the rows, then a
    backward doubling min for the empty buckets."""
    n = keys3.shape[1]
    size = 1 << _BUCKET_BITS
    tops = u32(keys3[0]) >> (32 - _BUCKET_BITS)
    tbl = torch.full((size,), n, dtype=torch.int32, device=keys3.device)
    tbl.scatter_reduce_(0, tops,
                        torch.arange(n, dtype=torch.int32, device=keys3.device),
                        "amin")
    s = 1
    while s < size:
        tbl = torch.minimum(tbl, torch.cat([tbl[s:], tbl.new_full((s,), n)]))
        s <<= 1
    return tbl


def _bucket_steps(tbl, n: int) -> int:
    """Halvings that close the widest bucket of ``tbl`` (one host sync)."""
    ends = torch.cat([tbl[1:], tbl.new_full((1,), n)])
    return int((ends - tbl).max()).bit_length()


def _lower_bound_device(keys3, probe_words, tbl=None, steps=None):
    """Vectorized lower bound of packed probes (int32 [W, N]) in the colex
    rows of ``keys3`` (int32 [W, n]), compared as unsigned words; int32 [N].

    A fixed number of halvings, with no host sync: bit_length(n) over the
    whole table, or with a :func:`bucket_table` the halvings of its widest
    bucket (``steps``; computed here when not given). Converged lanes do not
    move, so the extra halvings change nothing."""
    n = keys3.shape[1]
    N = probe_words.shape[1]
    dev = keys3.device
    pw = probe_words ^ _SIGN
    if tbl is None:
        lo = torch.zeros(N, dtype=torch.int64, device=dev)
        hi = torch.full((N,), n, dtype=torch.int64, device=dev)
        steps = n.bit_length()
    else:
        size = 1 << _BUCKET_BITS
        top = u32(probe_words[0]) >> (32 - _BUCKET_BITS)
        lo = tbl[top].to(torch.int64)
        hi = torch.where(top + 1 < size, tbl[torch.clamp(top + 1, max=size - 1)],
                         n).to(torch.int64)
        if steps is None:
            steps = _bucket_steps(tbl, n)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        tw = keys3[:, torch.clamp(mid, max=n - 1)] ^ _SIGN  # [W, N]
        ne = tw != pw
        first = torch.argmax(ne.to(torch.int8), dim=0, keepdim=True)
        # the first differing word decides; an equal key is not less
        less = ne.any(dim=0) & (tw.gather(0, first) < pw.gather(0, first))[0]
        act = lo < hi
        lo = torch.where(act & less, mid + 1, lo)
        hi = torch.where(act & ~less, mid, hi)
    return lo.to(torch.int32)


def _searches(keys3, tbl):
    """((table, (bucket table, steps) or None) per local shard of ``keys3``,
    the reducer over the processes)."""
    if isinstance(keys3, ShardedKeys3):
        return ([(s, tab) for (_, s), tab in zip(keys3.local,
                                                  keys3.search_tables())],
                keys3.reduce)
    if tbl is None:
        return [(keys3, None)], LocalReduce()
    return [(keys3, (tbl, _bucket_steps(tbl, keys3.shape[1])))], LocalReduce()


def _or_shards(searches, probe_words, fn):
    """``fn(table, search table, probes)`` per local shard on its device,
    ORed on the probes' device (a row lives in at most one shard), then
    over the processes (a bool max)."""
    tables, reduce = searches
    out = None
    for keys, tab in tables:
        with device_scope(keys.device):
            part = fn(keys, tab, probe_words.to(keys.device))
        part = part.to(probe_words.device)
        out = part if out is None else out | part
    return reduce.max(out)


def _member(keys, tab, pw):
    n = keys.shape[1]
    lo = _lower_bound_device(keys, pw, *(tab or ()))
    at = torch.clamp(lo, max=n - 1).to(torch.int64)
    return (lo < n) & (keys[:, at] == pw).all(dim=0)


def _member_rows_device(keys3, probe_words, tbl=None):
    """Membership of full-length probes (int32 [W, N]) in the colex rows:
    rows are distinct length-k strings, so membership is equality at the
    lower bound. Over a :class:`ShardedKeys3` each shard searches its own
    range with its own bucket table and membership is the OR; bool [N]."""
    return _or_shards(_searches(keys3, tbl), probe_words, _member)


def _extend_members(searches, prefix, k: int):
    """Membership of the four prepend-variants b + prefix (b = A..T) with
    one lower bound per lane: colex order compares the shared (k-1)-suffix
    first, so the variants that exist are consecutive rows sorted by the
    prepended char, and the A-variant's lower bound plus the next three rows
    covers all four. Variant b's key differs from the A-variant's by
    (b - 1) << shift in one word. Over shards, a suffix range that spans a
    shard boundary continues at the next shard's own lower bound, and the
    OR recovers it. Returns bool [4, E]."""
    E = prefix.shape[0]
    cm1 = torch.cat([prefix.new_ones((E, 1)), prefix], dim=1)
    pw = _pack_codes_matrix(cm1, k)
    wb, jb = divmod(k - 1, 10)
    bump = torch.zeros((4, pw.shape[0], 1), dtype=torch.int32,
                       device=pw.device)
    bump[:, wb, 0] = torch.arange(4, dtype=torch.int32,
                                  device=pw.device) << (27 - 3 * jb)
    want = pw[None] + bump  # [4 (b), W, E]

    def members(keys, tab, want_s):
        n = keys.shape[1]
        lo = _lower_bound_device(keys, want_s[0], *(tab or ())).to(torch.int64)
        cand = lo[None] + torch.arange(4, device=keys.device)[:, None]  # [4, E]
        rows = keys[:, torch.clamp(cand, max=n - 1)]  # [W, 4 (j), E]
        eq = (rows[None] == want_s[:, :, None]).all(dim=1)  # [4 (b), 4 (j), E]
        return (eq & (cand < n)[None]).any(dim=1)

    return _or_shards(searches, want, members)


def _extend_members_device(keys3, prefix, k: int, tbl=None):
    """:func:`_extend_members` over ``keys3`` (a table, with or without a
    :func:`bucket_table`, or a :class:`ShardedKeys3`): bool [4, E]."""
    return _extend_members(_searches(keys3, tbl), prefix, k)


def left_extend_device(keys3, kmers, budgets, k: int, tbl=None):
    """Batched left extension (reference: src/gap_filling.rs:205-232): per
    round, prepend each of the four bases to the lane's current
    (k-1)-prefix and extend iff EXACTLY ONE base gives a row (full-length
    probes: nonempty == singleton == membership).

    kmers: uint8 [E, k] chunk codes; budgets: int32 [E] (<= k). Rounds run
    until no lane is active, one host sync each (at most k rounds), and
    search only the active lanes; the rounds and the lanes that start
    active go to the run's stats (``left_ext_rounds``, ``left_ext_lanes``).
    Over a group that spans processes every round's membership is reduced
    over them first, so every process sees the same active lanes.
    Returns (exts uint8 [E, 2k] chunk codes, LEFT-aligned: char i of the
    extended string; ext_len int32 [E] = k + n_ext)."""
    E = kmers.shape[0]
    dev = kmers.device
    searches = _searches(keys3, tbl)
    prefix = kmers[:, : k - 1].clone()
    pre = torch.zeros((E, k), dtype=torch.uint8, device=dev)
    n_ext = torch.zeros(E, dtype=torch.int32, device=dev)
    idx = (budgets > 0).nonzero()[:, 0]  # the active lanes
    stats = get_stats()
    stats.add("left_ext_lanes", idx.numel())
    while idx.numel():
        stats.add("left_ext_rounds")
        member = _extend_members(searches, prefix[idx], k)  # [4, A]
        ok = member.sum(dim=0) == 1
        newchar = (torch.argmax(member.to(torch.int8), dim=0) + 1).to(
            torch.uint8)
        slot = n_ext[idx].to(torch.int64)  # < k on an active lane
        pre[idx, slot] = torch.where(ok, newchar, pre[idx, slot])
        prefix[idx] = torch.where(
            ok[:, None], torch.cat([newchar[:, None], prefix[idx, :-1]], dim=1),
            prefix[idx])
        n_ext[idx] += ok.to(torch.int32)
        more = ok & (n_ext[idx] < budgets[idx]) & (n_ext[idx] < k)
        idx = idx[more.nonzero()[:, 0]]  # the round's one host sync
    # char i = pre[n_ext-1-i] for i < n_ext, else kmer[i - n_ext]
    i2k = torch.arange(2 * k, dtype=torch.int32, device=dev)[None, :]
    pre_idx = torch.clamp(n_ext[:, None] - 1 - i2k, 0, k - 1).to(torch.int64)
    km_idx = torch.clamp(i2k - n_ext[:, None], 0, k - 1).to(torch.int64)
    exts = torch.where(i2k < n_ext[:, None], torch.gather(pre, 1, pre_idx),
                       torch.gather(kmers, 1, km_idx))
    return exts, k + n_ext


def _leading_run(eq):
    """Per row: length of the leading True run (eq: [..., T] bool)."""
    return torch.cumprod(eq.to(torch.int32), dim=-1).sum(dim=-1,
                                                          dtype=torch.int32)


def _trailing_run(eq):
    return _leading_run(eq.flip(-1))


def _rightmost_peak(ms_mat, d: int):
    """Per row: rightmost i <= k-2 with ms[i] >= d and ms[i] > ms[i+1],
    else -1 (reference: src/variant_calling.rs:73-83)."""
    mask = (ms_mat[:, :-1] >= d) & (ms_mat[:, :-1] > ms_mat[:, 1:])
    w = mask.shape[1]
    last = w - 1 - torch.argmax(mask.flip(1).to(torch.int8), dim=1)
    return torch.where(mask.any(dim=1), last.to(torch.int32), -1)


# ------------------------------------------------------ variant resolution


def resolve_variants_core(
    keys3,
    seq_words,
    codes,
    ref_ascii,
    ms,
    lengths,
    drop_pos,
    apos,
    arow,
    d: int,
    k: int,
    cap_d: int,
    d_lo: int = 0,
    seq_tables=None,
    merge: str = "path",
    reduce=None,
):
    """Variant patches for every anchored MS drop, on the device.

    Inputs are the resident sweep outputs: ``ms`` [Q, L] from the 3-bit
    join, ``drop_pos``/``apos``/``arow`` [Q, cap_d] from the postprocess
    stage (kernels/mapsweep.py), ``seq_words`` from
    :func:`seq_keys3_tagged_core`, or a list of such tables, one per
    position chunk of the sequence and each on its own device (the
    sequence-sharded map, kbo_tpu_torch.parallel.mesh; this process's
    chunks, with ``reduce.max`` over the processes that hold the others).
    Returns (patch_pos int32 [S, k] flat q*L+i positions with Q*L = inert,
    patch_prio_val int32 [S, k], n_variants int32 scalar) with S = Q*cap_d.

    The query-k-mer MS re-run needs no join: the isolated k-mer's window at
    local offset i packs like the sweep's window at the underlying position,
    so ms_kmer[i] == min(ms_row[apos-k+1+i], i+1). Only the
    reference-k-mer-vs-sequence direction is a real join (``merge`` picks
    its merge kernel, see kernels.ms._merge_scan).

    ``seq_tables`` (single contig only) replaces ``seq_words`` with the
    sweep's own sorted query-key tables ``[(words, limits), ...]``
    (kernels.ms.ms3_rows_core ``want_qtable``): the join runs per chunk
    table with a max across chunks and per-window caps, and the
    genome-sized sort of :func:`seq_keys3_tagged_core` disappears. A capped
    LCP can only be inflated past a table window's real run length v by
    pad-7-vs-pad-7 matches, which need all v real chars to match first, so
    min(lcp, v) is exactly the pad-5 value; every true window lives in one
    chunk with full context, so the max over chunks is exact.

    ``d_lo`` (<= d-1) drops the first d_lo probe offsets: the re-run MS
    feeds only _rightmost_peak(msq, d) and msq[i] <= i+1 < d for i < d-1,
    so those probes can never make a peak nor flip a comparison.
    """
    Q, L = codes.shape
    S = Q * cap_d
    dev = codes.device

    drop = drop_pos[:, :cap_d].reshape(S)
    ap = apos[:, :cap_d].reshape(S)
    ar = arow[:, :cap_d].reshape(S)
    q_of = torch.arange(S, dtype=torch.int32, device=dev) // cap_d
    n_q = lengths.to(torch.int32)[q_of.to(torch.int64)]
    valid = (drop < _BIG32) & (ap >= 0)
    site = torch.where(valid, drop, 0)
    apc = torch.where(valid, ap, k - 1)

    # query k-mer (the streamed side's k bases ending at the anchor): the
    # ascii window, '$' where it runs past the contig start
    # (src/variant_calling.rs:46-58)
    i_t = torch.arange(k, dtype=torch.int32, device=dev)
    j = apc[:, None] + i_t[None, :] - (k - 1)  # [S, k]
    in_seq = j >= 0
    flat_j = (q_of[:, None] * L + torch.clamp(j, min=0)).to(torch.int64)
    qa = torch.where(in_seq, ref_ascii.reshape(-1)[flat_j], ord("$"))

    # ms of the query k-mer vs THE INDEX: min-identity against the sweep row
    msr = torch.where(
        in_seq, torch.minimum(ms.reshape(-1)[flat_j], i_t[None, :] + 1), 0
    ).to(torch.int32)

    # reference k-mer from the colex key table
    rk = unpack_rows3(keys3, ar, k)  # [S, k] chunks
    ra = _chunk_ascii(rk)

    # ms of the reference k-mer vs THE SEQUENCE. The probe buffer pads k-1
    # slots per row so every window has full context; the pad-straddling
    # windows and the first d_lo offsets are dropped before the join
    kp = k - d_lo
    assert 0 <= d_lo < k
    pad = torch.full((S, k - 1), INVALID, dtype=torch.uint8, device=dev)
    pbuf = torch.cat([pad, rk], dim=1).reshape(-1)
    p_all = pack_windows_3bit(pbuf, k, pad_chunk=7)
    W = p_all.shape[0]
    p_words = p_all.reshape(W, S, 2 * k - 1)[:, :, k - 1 + d_lo :].reshape(W, -1)
    meta = torch.arange(S * kp, dtype=torch.int32, device=dev)
    if seq_tables is not None:
        assert Q == 1, "sweep-table reuse is single-contig (no tag word)"
        c = None
        for tw, tlim in seq_tables:
            ct = _neighbor_best(tw, tlim.to(torch.int32), p_words, meta, 3,
                                merge=merge)
            c = ct if c is None else torch.maximum(c, ct)
    else:
        if Q > 1:
            # leading tag word: probes join only their own contig's windows
            p_tag = (meta // kp) // cap_d
            p_words = torch.cat([p_tag[None], p_words])
        cap = k + _TAG_PAD if Q > 1 else k
        c = None
        # a list holds one table per position chunk of the sequence, each on
        # its own device: the probes join each, and the max over the chunks
        # is exact (every true window lies in one chunk with its full
        # context; a context-region duplicate can only score lower)
        for sw in seq_words if isinstance(seq_words, list) else [seq_words]:
            with device_scope(sw.device):
                cap_seq = torch.full((sw.shape[1],), cap, dtype=torch.int32,
                                     device=sw.device)
                ct = _neighbor_best(sw, cap_seq, p_words.to(sw.device),
                                    meta.to(sw.device), 3, merge=merge)
            ct = ct.to(dev)
            c = ct if c is None else torch.maximum(c, ct)
        if reduce is not None:
            c = reduce.max(c)
    if Q > 1:
        c = torch.clamp(c - _TAG_PAD, min=0)
    msq = torch.clamp(c, max=k).reshape(S, kp)
    if d_lo:
        msq = torch.cat(
            [torch.zeros((S, d_lo), dtype=torch.int32, device=dev), msq], dim=1
        )

    # vectorized resolve_variant (src/variant_calling.rs:139-201)
    csl = _trailing_run(qa == ra)
    qpeak = _rightmost_peak(msr, d)
    rpeak = _rightmost_peak(msq, d)
    ok = valid & (csl > 0) & (qpeak >= 0) & (rpeak >= 0)
    sms = k - csl
    qgap = sms - qpeak - 1
    rgap = sms - rpeak - 1
    subst = ok & (qgap > 0) & (rgap > 0)
    indel = ok & ~subst & (qgap != rgap)
    is_del = indel & (qgap < rgap)  # query overlap larger -> deletion
    is_ins = indel & ~is_del
    vlen = torch.abs(qgap - rgap)

    # add_variants patch emission (src/translate.rs:350-386): an
    # equal-length substitution writes the reference k-mer's chars; unequal
    # writes uniform-char-or-N over the query-chars length; a deletion
    # writes 'I' at site-1/site; an insertion writes 'D' per char
    rc_idx = torch.clamp(rpeak[:, None] + 1 + i_t[None, :], 0, k - 1)
    rc_t = torch.gather(ra, 1, rc_idx.to(torch.int64))
    subst_eq = subst & (qgap == rgap)
    subst_ne = subst & (qgap != rgap)
    in_rc = i_t[None, :] < rgap[:, None]
    all_eq = (in_rc & (rc_t != rc_t[:, :1])).sum(dim=1) == 0
    fill = torch.where(all_eq, rc_t[:, 0], ord("N")).to(torch.uint8)

    npatch = torch.where(
        subst_eq,
        rgap,
        torch.where(
            subst_ne, qgap,
            torch.where(is_del, 2, torch.where(is_ins, vlen, 0)),
        ),
    )
    base = torch.where(is_del, site - 1, site)
    val = torch.where(
        subst_eq[:, None],
        rc_t,
        torch.where(
            subst_ne[:, None],
            fill[:, None],
            torch.where(is_del[:, None], ord("I"), ord("D")).to(torch.uint8),
        ),
    )
    pos_local = base[:, None] + i_t[None, :]
    emit = (
        (i_t[None, :] < npatch[:, None]) & (pos_local >= 0)
        & (pos_local < n_q[:, None])
    )
    pos = torch.where(emit, q_of[:, None] * L + pos_local, Q * L)
    # priority 2+s: ascending flat site order == the host's dict order
    prio = 2 + torch.arange(S, dtype=torch.int32, device=dev)
    prio_val = (prio[:, None] << 8) | val.to(torch.int32)
    n_variants = (subst | indel).sum(dtype=torch.int32)
    return pos.to(torch.int32), prio_val, n_variants


# ------------------------------------------- precomputed extension chains


def _shift_key_down(words):
    """(k-1)-key of r[:k-1]: chunk at distance t := r's chunk at distance
    t+1 (drop r's LAST char). Cross-word 3-bit funnel; incoming top chunks
    beyond the key are zero in real row words."""
    w64 = u32(words)
    out = (w64 << 3) & _MASK30
    out[:-1] |= (w64[1:] >> 27) & 7
    return to_i32(out)


def _shift_chain(src, e):
    """Shift a 3-bit chain-char stream right by ``e`` chunk slots (per lane):
    target word wt chunk j = src chunk 10*wt + j - e. Chunks pushed past the
    last word drop (reads are capped by length)."""
    W = src.shape[0]
    s64 = u32(src)
    q = e // 10
    r = (e % 10).to(torch.int64)
    down = s64 >> (3 * r)
    up = (s64 << (30 - 3 * r)) & _MASK30
    out = []
    for wt in range(W):
        v = torch.zeros_like(s64[0])
        for ws in range(W):
            if wt - ws >= 0:
                v = v | torch.where(q == wt - ws, down[ws], 0)
            if wt - ws - 1 >= 0:
                v = v | torch.where(q == wt - ws - 1, up[ws], 0)
        out.append(v)
    return to_i32(torch.stack(out))


def build_ext_table_core(keys3, k: int):
    """Canonical left-extension chain of EVERY colex row, precomputed.

    The extension rule (reference: src/gap_filling.rs:205-232) extends a row
    r by char b iff b + r[:k-1] is EXACTLY ONE row -- a function of r alone.
    So each row has one chain parent (the unique such row, -1 when 0 or >= 2
    exist), and a lane's extension is the first min(budget, k, chain length)
    chars of its row's chain. One sorted (k-1)-key join pairs every row's
    drop-last-char key with every row's drop-first-char key (one radix sort
    of 2n keys); pointer doubling then packs up to k chain chars per row.

    Returns (ext_words int32 [W, n] -- chain chars packed 3-bit in chain
    order, slot j at word j//10 bits 27-3*(j%10); ext_len int32 [n]).
    """
    W, n = keys3.shape
    dev = keys3.device
    wA, jA = divmod(k - 1, 10)
    shiftA = 27 - 3 * jA
    first = (keys3[wA] >> shiftA) & 7
    akeys = keys3.clone()
    akeys[wA] = akeys[wA] & ~(7 << shiftA)
    bkeys = _shift_key_down(keys3)

    rows_idx = torch.arange(n, dtype=torch.int64, device=dev)
    a_pay = to_i32((rows_idx << 8) | (first.to(torch.int64) << 1) | 1)
    b_pay = to_i32(rows_idx << 8)
    sw, (pay,) = _radix_sort(
        torch.cat([akeys, bkeys], dim=1), [torch.cat([a_pay, b_pay])]
    )

    M = 2 * n
    isA = (pay & 1) == 1
    chr3 = (pay >> 1) & 7
    row = (u32(pay) >> 8).to(torch.int32)
    boundary = torch.zeros(M, dtype=torch.bool, device=dev)
    boundary[0] = True
    boundary[1:] = (sw[:, 1:] != sw[:, :-1]).any(dim=0)
    idx = torch.arange(M, dtype=torch.int32, device=dev)
    start = _carry_nearest(torch.where(boundary, idx, -1), reverse=False)
    nb = torch.cat([boundary[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    last = _carry_nearest(torch.where(nb, idx, -1), reverse=True).to(torch.int64)

    # per group: count of A slots whose first char is a real base, and the
    # (row, char) of the max such slot (== THE slot when the count is 1)
    a01 = isA & (chr3 >= 1) & (chr3 <= 4)
    S = torch.cumsum(a01, dim=0, dtype=torch.int32)
    S_before = torch.where(
        start > 0, S[torch.clamp(start - 1, min=0).to(torch.int64)], 0
    )
    cnt = S[last] - S_before
    m1 = torch.where(a01, (row << 3) | chr3, -1)
    # the group max of m1 (kbo_tpu's segmented doubling max read at the
    # group's last slot): max is exact in any order
    gid = (torch.cumsum(boundary, dim=0) - 1).to(torch.int64)
    gmax_g = torch.full((M,), -1, dtype=torch.int32, device=dev)
    gmax_g.scatter_reduce_(0, gid, m1, "amax", include_self=True)
    gmax = gmax_g[gid]

    ok_b = ~isA & (cnt == 1) & (gmax >= 0)
    tgt = torch.where(ok_b, row, n).to(torch.int64)
    parent = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    parent.scatter_(0, tgt, gmax >> 3)
    parent = parent[:n]
    pchar = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    pchar.scatter_(0, tgt, gmax & 7)
    pchar = pchar[:n]

    # pointer doubling: accumulate up to k chain chars per row
    pv = parent >= 0
    ext_len = pv.to(torch.int32)
    ew = torch.zeros((W, n), dtype=torch.int32, device=dev)
    ew[0] = torch.where(pv, pchar << 27, 0)
    # rows with no parent contribute length 0 forever (hop = self)
    hop = torch.where(pv, parent, idx[:n]).to(torch.int64)
    for _ in range(max(1, (k - 1).bit_length())):
        g_len = ext_len[hop]
        ew = ew | _shift_chain(ew[:, hop], ext_len)
        ext_len = torch.clamp(ext_len + g_len, max=k)
        hop = hop[hop]
    return ew, ext_len


def get_ext_table(dev):
    """The per-index extension-chain table, built at the first call and
    cached on the :class:`~kbo_tpu_torch.kernels.ms.DeviceIndex`."""
    cached = getattr(dev, "_ext_table", None)
    if cached is None:
        cached = build_ext_table_core(dev.keys3, dev.k)
        dev._ext_table = cached
    return cached


def ext_from_table(ext_words, ext_len_tab, rows, kmers, budgets, k: int):
    """Table-backed left extension: the lane's extension is the first
    min(budget, chain length) chars of its row's canonical chain. Returns
    (exts uint8 [E, 2k] chunk codes, ext_len int32 [E])."""
    dev = kmers.device
    r = torch.clamp(rows, min=0).to(torch.int64)
    ce = ext_words[:, r]  # [W, E]
    n_ext = torch.minimum(torch.clamp(budgets, min=0), ext_len_tab[r])
    i2k = torch.arange(2 * k, dtype=torch.int32, device=dev)[None, :]
    # char i < n_ext: chain slot n_ext - 1 - i; else kmer[i - n_ext]
    slot = torch.clamp(n_ext[:, None] - 1 - i2k, min=0)
    sh = 27 - 3 * (slot % 10)
    chain = torch.gather(ce.T, 1, (slot // 10).to(torch.int64))
    chain_char = ((chain >> sh) & 7).to(torch.uint8)
    km_idx = torch.clamp(i2k - n_ext[:, None], 0, k - 1).to(torch.int64)
    exts = torch.where(
        i2k < n_ext[:, None], chain_char, torch.gather(kmers, 1, km_idx)
    )
    return exts, (k + n_ext).to(torch.int32)


# ------------------------------------------------------------ gap scoring


def _cdf_table(k: int, device):
    """float64 [k+1]: 0 then the per-run CDF addends for run lengths 1..k,
    from the host float64 formula the host evaluator uses."""
    return torch.tensor(
        [0.0] + [log_rm_max_cdf(r + 1, 4, 1) for r in range(1, k + 1)],
        dtype=torch.float64, device=device,
    )


def score_gaps_core(
    keys3,
    ref_ascii,
    lengths,
    gap_start,
    gap_end_at,
    grid,
    threshold: int,
    k: int,
    cap_ge: int,
    cap_ext: int,
    ext_tab=None,
    bound=None,
):
    """Gap-fill candidate scoring + first-success commit on the device.

    Follows refine/gap_filling._score_candidates phases C-E exactly, left
    extension (:func:`ext_from_table` over ``ext_tab``; without one, the
    search loop :func:`left_extend_device` over a :func:`bucket_table`, the
    one form a :class:`ShardedKeys3` takes) and the probabilistic
    acceptance for gaps a single k-mer cannot span (``bound`` =
    log1p(-max_error_prob); reference: src/gap_filling.rs:476-509)
    included; the first-success scan is position-descending across both
    candidate kinds (src/gap_filling.rs:444-526). ``needs_host`` flags only
    gaps whose extension lanes did not fit the static budgets (more than
    ``cap_ext`` lanes overall, or an extension budget beyond k chars) or
    whose width exceeds the [G, k] fill window: those go to the exact host
    evaluator.

    grid: [Q, cap_ge, w] colex row of candidate jpos = search_lo + c when
    unique, else -1 (kernels.mapsweep.map_postprocess3_core). Returns
    (patch_pos [G, k], patch_prio_val [G, k], needs_host [G] bool, counters
    int32 [3] = gaps_seen, gaps_filled, unfilled_bases), G = Q * cap_ge.
    """
    Q, L = ref_ascii.shape
    dev = ref_ascii.device
    G = Q * cap_ge
    w = int(grid.shape[-1])
    t = int(threshold)
    i32 = torch.int32
    ref_flat = ref_ascii.reshape(-1)

    def at(q_rows, p):
        """ref bytes at per-gap positions p [G, m] (clipped into the row)."""
        flat = q_rows[:, None] * L + torch.clamp(p, 0, L - 1)
        return ref_flat[flat.to(torch.int64)]

    gs_raw = gap_start[:, :cap_ge].reshape(G)
    ge_raw = gap_end_at[:, :cap_ge].reshape(G)
    q_of = torch.arange(G, dtype=i32, device=dev) // cap_ge
    n_q = lengths.to(i32)[q_of.to(torch.int64)]
    real = gs_raw < _BIG32
    gs = torch.where(real, gs_raw, 0)
    end = torch.minimum(torch.where(real, ge_raw, 0), n_q - t)
    gap_len = end - gs
    fits = gap_len + 2 * t <= k
    radius = k - torch.where(fits, t, 0)
    lo = end + t
    hi = torch.minimum(end + radius, n_q - 1)

    cgrid = grid.reshape(Q, -1, w)[:, :cap_ge].reshape(G, w)
    c_t = torch.arange(w, dtype=i32, device=dev)
    jpos = lo[:, None] + c_t[None, :]
    cand = real[:, None] & (cgrid >= 0) & (jpos <= hi[:, None])

    rows = torch.clamp(cgrid, min=0).reshape(-1)
    km = unpack_rows3(keys3, rows, k).reshape(G, w, k)  # chunks
    ka = _chunk_ascii(km)

    # phase C: overlap run lengths in RAW ASCII space. Candidate c's right
    # window is ref[jpos-k+1 .. jpos] with jpos = lo + c: the windows slide
    # by one char, so gather the union span once per gap
    off = torch.arange(k, dtype=i32, device=dev)
    span_pos = (lo - (k - 1))[:, None] + torch.arange(k - 1 + w, dtype=i32,
                                                      device=dev)[None, :]
    span_ok = (span_pos >= 0) & (span_pos < n_q[:, None])
    span = torch.where(span_ok, at(q_of, span_pos), _OOB).to(torch.uint8)
    right_win = span.unfold(1, k, 1)  # [G, w, k]
    rg = _trailing_run((ka == right_win)[:, :, 1:])
    want = jpos - end[:, None] + 1

    lreq = t
    rsp = torch.clamp(gs - lreq, min=0)
    # the left window starts at the gap's left flank whatever the candidate
    lw_pos = rsp[:, None] + off[None, :]
    left_win = torch.where(lw_pos < n_q[:, None], at(q_of, lw_pos), _OOB)
    lg = _leading_run(ka == left_win.to(torch.uint8)[:, None, :])

    right_ok = cand & (rg >= torch.clamp(want, max=k))
    case_a = right_ok & (lg >= lreq)
    should_extend = k < lreq + gap_len[:, None] + rg
    case_b = should_extend & right_ok & (lg < lreq)

    # phase D: left extension for the case_b lanes. Lanes are compacted
    # into a static budget; a gap owning a lane that does not fit (cap_ext
    # overflow, or an extension budget beyond k chars) goes to the exact
    # host evaluator instead of being guessed.
    GC = G * w
    bud = (lreq + gap_len[:, None] + rg - k).reshape(-1)  # > 0 wherever case_b
    flat_cb = case_b.reshape(-1)
    cb32 = flat_cb.to(i32)
    rank = torch.cumsum(cb32, dim=0, dtype=i32) - cb32
    evaluable = flat_cb & (rank < cap_ext) & (bud <= k)
    dropped = flat_cb & ~evaluable
    fcand = torch.where(evaluable, torch.arange(GC, dtype=i32, device=dev), GC)
    fc = torch.sort(fcand).values[:cap_ext]
    n_f = fc.shape[0]
    lane_valid = fc < GC
    fci = torch.clamp(fc, max=GC - 1).to(torch.int64)
    lane_g = fci // w
    lane_row = rows[fci]
    lane_km = unpack_rows3(keys3, lane_row, k)
    lane_bud = torch.where(lane_valid, bud[fci], 0)
    if ext_tab is not None:
        exts, ext_len = ext_from_table(ext_tab[0], ext_tab[1], lane_row,
                                       lane_km, lane_bud, k)
    else:
        tbl = None if isinstance(keys3, ShardedKeys3) else bucket_table(keys3)
        exts, ext_len = left_extend_device(keys3, lane_km, lane_bud, k, tbl)
    # leading match of the extended string vs the reference from the gap's
    # left flank; the reference window is gathered once per gap
    i2k = torch.arange(2 * k, dtype=i32, device=dev)
    gwin_pos = rsp[:, None] + i2k[None, :]
    gwin = torch.where(gwin_pos < n_q[:, None], at(q_of, gwin_pos), _OOB)
    ref_l = gwin.to(torch.uint8)[lane_g]
    avail = (i2k[None, :] < ext_len[:, None]) & (ref_l != _OOB)
    lane_lm = _leading_run(avail & (_chunk_ascii(exts) == ref_l))
    lane_ok = lane_valid & (lane_lm >= lreq)
    ext_ok = torch.zeros(GC + 1, dtype=torch.bool, device=dev)
    ext_ok.scatter_(0, fc.to(torch.int64), lane_ok)
    ext_ok = ext_ok[:GC].reshape(G, w)

    # phase E: first success in DESCENDING position order across BOTH
    # candidate kinds (the reference's scan order)
    success = case_a | ext_ok
    has_w = success.any(dim=1)
    cwin = (w - 1) - torch.argmax(success.flip(1).to(torch.int8), dim=1)
    cwin = torch.where(has_w, cwin.to(i32), -1)
    needs_host = real & dropped.reshape(G, w).any(dim=1)

    sel = torch.clamp(cwin, min=0).to(torch.int64)[:, None]
    win_is_a = has_w & torch.gather(case_a, 1, sel)[:, 0]

    # --- no-extension winner: fill = kmer[start:end]
    lg_w = torch.gather(lg, 1, sel)[:, 0]
    rg_w = torch.gather(rg, 1, sel)[:, 0]
    km_w = torch.gather(km, 1, sel[:, :, None].expand(G, 1, k))[:, 0]  # [G, k]
    start_a = lg_w - lreq
    end_a = k - (rg_w - t)
    len_a = end_a - start_a
    in_fill_a = (off[None, :] >= start_a[:, None]) & (off[None, :] < end_a[:, None])
    dollar_a = (in_fill_a & (km_w == 0)).any(dim=1)
    seg_idx = torch.clamp(start_a[:, None] + t + off[None, :], 0, k - 1)
    seg_a = _chunk_ascii(torch.gather(km_w, 1, seg_idx.to(torch.int64)))

    # --- extension winner: fill = ext[start:end] from the winning lane
    win_flat = torch.where(
        has_w, torch.arange(G, dtype=i32, device=dev) * w + sel[:, 0].to(i32), GC
    )
    # kbo_tpu clips to cap_ext - 1 and its gathers clamp to the last lane
    li = torch.clamp(torch.searchsorted(fc, win_flat), 0, min(cap_ext, n_f) - 1)
    lane_hit = (fc[li] == win_flat) & has_w & ~win_is_a
    ext_w = exts[li]  # [G, 2k] chunks
    start_b = lane_lm[li] - lreq
    end_b = ext_len[li] - (rg_w - t)
    len_b = end_b - start_b
    in_fill_b = (i2k[None, :] >= start_b[:, None]) & (i2k[None, :] < end_b[:, None])
    dollar_b = (in_fill_b & (ext_w == 0)).any(dim=1)
    seg_idx = torch.clamp(start_b[:, None] + t + off[None, :], 0, 2 * k - 1)
    seg_b = _chunk_ascii(torch.gather(ext_w, 1, seg_idx.to(torch.int64)))

    fill_len = torch.where(win_is_a, len_a, len_b)
    has_dollar = torch.where(win_is_a, dollar_a, dollar_b)
    seg_ascii = torch.where(win_is_a[:, None], seg_a, seg_b)

    ppos_local = gs[:, None] + off[None, :]
    ref_at = at(q_of, ppos_local)

    # acceptance beyond no-indel/no-dollar (reference src/gap_filling.rs:
    # 476-509): a k-mer spanning gap + both flanks is accepted outright
    # (``fits``); otherwise the consecutive-match run probability test
    # (fill_overlaps, :496-506) or the mismatch-flanked pattern
    # (fill_flanked, :507) must pass. The per-run CDF addends come from the
    # host float64 formula and are added in float64 in ascending run order,
    # one column at a time, so the sum -- and the > bound decision -- is
    # bit-identical to refine.gap_filling._run_log_prob. A gap wider than k
    # cannot show its match pattern in the [G, k] fill window and goes to
    # the exact host evaluator instead.
    in_gap = off[None, :] < gap_len[:, None]
    match = in_gap & (seg_ascii == ref_at)
    if bound is None:
        prob_ok = torch.ones(G, dtype=torch.bool, device=dev)
    else:
        cdf = _cdf_table(k, dev)
        pairs = match[:, :-1] & match[:, 1:]
        pairs = pairs & (off[None, :-1] < (gap_len[:, None] - 1))
        nxt = torch.cat([pairs[:, 1:], torch.zeros((G, 1), dtype=torch.bool,
                                                   device=dev)], dim=1)
        # a run reaching the final pair never flushes (:505 trailing run)
        take = pairs & ~nxt & (off[None, :-1] != (gap_len[:, None] - 2))
        # run length at each pair: distance to the last non-pair before it
        col = off[None, :-1].expand(G, k - 1)
        last_gap = torch.cummax(torch.where(pairs, -1, col), dim=1).values
        rl = torch.clamp(col - last_gap, max=k).to(torch.int64)
        addend = torch.where(take, cdf[rl], 0.0)
        acc = torch.zeros(G, dtype=torch.float64, device=dev)
        for jj in range(k - 1):
            acc = acc + addend[:, jj]
        fill_overlaps = acc > bound
        first_m = match[:, 0]
        last_idx = torch.clamp(gap_len - 1, 0, k - 1).to(torch.int64)[:, None]
        last_m = torch.gather(match, 1, last_idx)[:, 0]
        n_match = match.sum(dim=1, dtype=i32)
        flanked = (gap_len > 0) & ~first_m & ~last_m & (n_match + 2 == gap_len)
        prob_ok = fill_overlaps | flanked
    needs_host = needs_host | (real & (gap_len > k))

    accept = (
        real & has_w & (win_is_a | lane_hit) & ~needs_host
        & (fill_len == 2 * t + gap_len) & ~has_dollar & (fits | prob_ok)
    )

    # paint: 'M' where the filler agrees with the raw reference bytes, the
    # filler nucleotide where it does not (src/gap_filling.rs:511-519)
    emit = accept[:, None] & (off[None, :] < gap_len[:, None])
    pval = torch.where(seg_ascii == ref_at, ord("M"), seg_ascii.to(i32))
    pos = torch.where(emit, q_of[:, None] * L + ppos_local, Q * L).to(i32)
    prio_val = (1 << 8) | pval.to(i32)

    handled = real & ~needs_host
    clamped = torch.clamp(torch.where(handled, gap_len, 0), min=0)
    filled = torch.where(accept, gap_len, 0)
    counters = torch.stack([
        handled.sum(dtype=i32),
        accept.sum(dtype=i32),
        (clamped - filled).sum(dtype=i32),
    ])
    return pos, prio_val, needs_host, counters


def prob_bound(max_error_prob: float) -> float:
    """log1p(-p) in host float64 -- the acceptance bound the reference
    compares the per-run CDF sum against (src/gap_filling.rs:497)."""
    return math.log1p(-max_error_prob)
