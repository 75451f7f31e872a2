"""The port's map sweep, candidate tables and delta assembly
(kernels/mapsweep.py) against kbo_tpu's, on the CPU.

kbo_tpu runs its non-TPU branches here; the port runs its kernels' plain
versions. Exact equality throughout (integers and bytes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kbo_tpu_torch
from kbo_tpu.kernels import mapsweep as jmap
from kbo_tpu.kernels import ms as jms
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels import mapsweep as tmap
from kbo_tpu_torch.kernels import ms as tms
from kbo_tpu_torch.ops.derandomize import random_match_threshold
from kbo_tpu_torch.ops.format import relative_to_ref
from kbo_tpu_torch.refine.device_map import _canvas, _paint_runs

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
L = 1024


def _i32(table):
    return torch.from_numpy(np.ascontiguousarray(table).view(np.int32))


def _contigs(seed, k):
    """(reference contigs, the indexed query): SNPs, a deletion, an
    insertion, an N run, a contig shorter than k and an unrelated one."""
    rng = np.random.default_rng(500 + seed)
    query = bytearray(BASES[rng.integers(0, 4, 2400)].tobytes())
    ref = bytearray(query)
    for p in range(60, 2300, 170):
        ref[p] = BASES[(np.searchsorted(BASES, ref[p]) + 1) % 4]
    del ref[1200:1215]
    ref[1700:1700] = BASES[rng.integers(0, 4, 9)].tobytes()
    ref[400:407] = b"NNNNNNN"
    contigs = [
        bytes(ref[:900]),
        bytes(ref[900:1900]),
        bytes(ref[1900:1900 + max(k - 3, 1)]),
        BASES[rng.integers(0, 4, 300)].tobytes(),
        bytes(ref[1900:]),
    ]
    return contigs, bytes(query)


def _codes(contigs):
    codes = np.full((len(contigs), L), 255, np.uint8)
    for q, c in enumerate(contigs):
        codes[q, : len(c)] = encode_ascii(c)
    return codes, np.asarray([len(c) for c in contigs], np.int32)


def _sweep_both(k, seed):
    contigs, query = _contigs(seed, k)
    idx = kbo_tpu_torch.build([query], kbo_tpu_torch.BuildOpts(k=k))
    codes, lengths = _codes(contigs)
    keys3 = _i32(idx.keys3)
    lcs3 = tms.lcs3_from_keys3(keys3, k)
    got = tmap.ms3_rows_sweep(
        keys3, tms.rows_ref_packed(lcs3, k), torch.from_numpy(codes), k
    )
    jk = jnp.asarray(idx.keys3)
    want = jmap.ms3_rows_sweep(
        jk, jms.lcs3_from_keys3(jk, k), jnp.asarray(codes), k
    )
    t = random_match_threshold(k, idx.n_kmers, 4, 1e-7)
    return contigs, idx, codes, lengths, got, want, t


def _assert_sweep_equal(got, want):
    ms, uniq, rows = (x.numpy() for x in got)
    np.testing.assert_array_equal(ms, np.asarray(want[0]))
    np.testing.assert_array_equal(uniq, np.asarray(want[1]))
    np.testing.assert_array_equal(rows[uniq], np.asarray(want[2])[uniq])


# ------------------------------------------------------- packed upload


def test_pack_ascii_round_trip():
    rng = np.random.default_rng(0)
    lengths = np.asarray([L, 700, 0, 5], np.int32)
    mat = np.zeros((4, L), np.uint8)
    for q, n in enumerate(lengths):
        mat[q, :n] = BASES[rng.integers(0, 4, n)]
    mat[0, 100:140] = ord("N")
    mat[0, 300:320] |= 0x20  # soft-masked
    mat[1, 10] = ord("$")
    mat[1, 699] = ord("n")
    got = tmap.pack_ascii_host(mat, lengths)
    want = jmap.pack_ascii_host(mat, lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].size == 64 and (got[1] < 4 * L).sum() == 40 + 20 + 2
    lens_t = torch.from_numpy(lengths)
    raw, codes = tmap.decode_packed4_encode_device(
        *(torch.from_numpy(a) for a in got), lens_t
    )
    np.testing.assert_array_equal(raw.numpy(), mat)
    want_codes = np.full((4, L), 255, np.uint8)
    for q, n in enumerate(lengths):
        want_codes[q, :n] = encode_ascii(mat[q, :n].tobytes())
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jmap.encode_ascii_device(jnp.asarray(mat)))
    )


def test_pack_ascii_declines():
    mat = np.full((2, L), ord("A"), np.uint8)
    lengths = np.asarray([L, L], np.int32)
    assert tmap.pack_ascii_host(mat[:, :1022], lengths) is None  # L % 4
    mat[0, :400] = ord("a")  # dense exceptions: more than Q*L/16
    assert tmap.pack_ascii_host(mat, lengths) is None
    mat[0, 128:400] = ord("A")  # exactly Q*L/16 = 128: still packed
    assert tmap.pack_ascii_host(mat, lengths)[1].size == 128


# --------------------------------------------------------- compaction


@pytest.mark.parametrize("cap", [4, 64])
def test_compact_and_next_nondash(cap):
    rng = np.random.default_rng(cap)
    mask = rng.random((3, 300)) < 0.03
    mask[1] = False
    idx = jnp.arange(300, dtype=jnp.int32)
    got = tmap._compact_mask_capped(torch.from_numpy(mask), cap).numpy()
    for q in range(3):
        want = jmap._compact_mask_capped(jnp.asarray(mask[q]), idx, cap)
        np.testing.assert_array_equal(got[q], np.asarray(want))
    dash = rng.random((3, 300)) < 0.6
    lens = np.asarray([[300], [120], [0]], np.int32)
    got = tmap._next_nondash(torch.from_numpy(dash), torch.from_numpy(lens))
    for q in range(3):
        want = jmap._next_nondash(jnp.asarray(dash[q]), idx, lens[q, 0])
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(want))
    slots = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert tmap._pad_slots(slots, 2).tolist() == [[0, 1], [3, 4]]
    assert tmap._pad_slots(slots, 4)[:, 3].tolist() == [2**31 - 1] * 2


# --------------------------------------------------------------- sweep


@pytest.mark.parametrize("k,seed", [(7, 0), (31, 1), (51, 2)])
def test_ms3_rows_sweep_equal(k, seed):
    _, _, _, _, got, want, _ = _sweep_both(k, seed)
    _assert_sweep_equal(got, want)
    assert got[1].any()


@pytest.mark.parametrize("chunk", [256, 300, 1000])
def test_ms3_rows_sweep_chunked_equal(chunk):
    """Chunks that do and do not divide L give the single-shot result."""
    k = 31
    _, idx, codes, _, got, want, _ = _sweep_both(k, 1)
    keys3 = _i32(idx.keys3)
    lcs3 = tms.lcs3_from_keys3(keys3, k)
    out = tmap.ms3_rows_sweep_chunked(
        keys3, tms.rows_ref_packed(lcs3, k), torch.from_numpy(codes), k, chunk,
        want_qtable=True,
    )
    _assert_sweep_equal(out[:3], want)
    assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])
    u = got[1]
    assert torch.equal(out[2][u], got[2][u])
    n_chunks = -(-L // chunk)
    assert len(out[3]) == n_chunks
    for words, limits in out[3]:
        assert words.shape == (tms.w3_for_k(k), 5 * (k - 1 + chunk))
        assert limits.shape == (5 * (k - 1 + chunk),)


# --------------------------------------------------------- postprocess


@pytest.mark.parametrize(
    "k,seed,cap_d,cap_g,w_grid",
    [(31, 1, 16, 8, None), (31, 1, 2, 1, 9), (51, 2, 16, 8, 20), (7, 0, 64, 64, 4)],
)
def test_map_postprocess3_equal(k, seed, cap_d, cap_g, w_grid):
    """chars, the whole packed block and every candidate table, with
    capacities that fit and that overflow."""
    _, _, _, lengths, got_sw, _, t = _sweep_both(k, seed)
    t = min(t, k - 1)
    if w_grid is None:
        w_grid = max(k - t + 1, 1)
    ms, uniq, rows = got_sw
    chars, packed, pieces = tmap.map_postprocess3_core(
        ms, uniq, rows, torch.from_numpy(lengths), k, t, cap_d, cap_g, w_grid
    )
    jchars, jpacked, jpieces = jmap.map_postprocess3(
        jnp.asarray(ms.numpy()), jnp.asarray(uniq.numpy()),
        jnp.asarray(rows.numpy()), jnp.asarray(lengths), k, jnp.int32(t),
        cap_d, cap_g, w_grid,
    )
    np.testing.assert_array_equal(chars.numpy(), np.asarray(jchars))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert packed.shape == (5, 2 + 3 * cap_d + 2 * cap_g + cap_g * w_grid)
    assert set(pieces) == set(jpieces)
    for name, want in jpieces.items():
        assert pieces[name].dtype == torch.int32, name
        np.testing.assert_array_equal(
            pieces[name].numpy(), np.asarray(want), err_msg=name
        )
    counts = pieces["counts"].numpy()
    assert counts[:, 0].max() > 2 and counts[:, 1].max() > 1
    assert (pieces["apos"] >= 0).any()


# ------------------------------------------------------------ assembly


def _chars_and_ref(seed):
    rng = np.random.default_rng(seed)
    Q, W = 3, 256
    lengths = np.asarray([W, 100, 0], np.int32)
    ref = BASES[rng.integers(0, 4, (Q, W))]
    chars = np.frombuffer(b"MMMMMMMMMMMMX-R", np.uint8)[rng.integers(0, 15, (Q, W))]
    chars[0, 40:90] = ord("-")  # one long run
    chars[0, W - 3 :] = ord("-")  # a run up to the row edge ...
    chars[1, :4] = ord("-")  # ... must not continue into the next row
    for q, n in enumerate(lengths):
        ref[q, n:] = 0
    return chars, ref, lengths


def _painted(deltas, ref, lengths, fmt):
    counts, rs, re, rv = (np.asarray(x) for x in deltas)
    n = int(counts[0])
    Q, W = ref.shape
    canvas, row_lens = _canvas(
        [ref[q, : lengths[q]].tobytes() for q in range(Q)], Q, W, fmt, ref
    )
    _paint_runs(canvas, rs[:n], re[:n], rv[:n], W, row_lens)
    return [canvas[q * W : q * W + lengths[q]].tobytes() for q in range(Q)]


@pytest.mark.parametrize("fmt", [True, False])
@pytest.mark.parametrize("cap", [None, 256, 8])
def test_emit_deltas_equal(fmt, cap):
    chars, ref, lengths = _chars_and_ref(3)
    got = tmap._emit_deltas(
        torch.from_numpy(chars).reshape(-1), torch.from_numpy(ref),
        torch.from_numpy(lengths), fmt, cap,
    )
    want = jmap._emit_deltas(
        jnp.asarray(chars).reshape(-1), jnp.asarray(ref), jnp.asarray(lengths),
        fmt, cap,
    )
    n = int(got[0][0])
    assert n > 8
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        # past the run count the end/value columns read a clipped pad slot
        np.testing.assert_array_equal(g[: min(n, g.shape[0])], w[: min(n, g.shape[0])])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if cap != 8:  # all runs present: the painted canvas is the output
        out = _painted([x.numpy() for x in got], ref, lengths, fmt)
        for q, n_q in enumerate(lengths):
            aln = chars[q, :n_q]
            want_q = (
                relative_to_ref(ref[q, :n_q].tobytes(), aln) if fmt
                else aln.tobytes()
            )
            assert out[q] == want_q


@pytest.mark.parametrize("fmt", [True, False])
def test_assemble_map_prio_equal(fmt):
    """Duplicate positions resolve by priority, inert positions drop."""
    chars, ref, lengths = _chars_and_ref(4)
    Q, W = chars.shape
    pos1 = np.asarray([[5, 5, 7, Q * W, -1, W + 2]], np.int32)
    pv1 = np.asarray([[(1 << 8) | ord("A"), (1 << 8) | ord("C"),
                       (1 << 8) | ord("G"), (9 << 8) | ord("T"),
                       (9 << 8) | ord("T"), (1 << 8) | ord("T")]], np.int32)
    pos2 = np.asarray([7, 5, W + 2, 60], np.int32)
    pv2 = np.asarray([(3 << 8) | ord("T"), (2 << 8) | ord("G"),
                      0, (2 << 8) | ord("a")], np.int32)
    got = tmap.assemble_map_prio_core(
        torch.from_numpy(chars), torch.from_numpy(ref), torch.from_numpy(lengths),
        [torch.from_numpy(pos1), torch.from_numpy(pos2)],
        [torch.from_numpy(pv1), torch.from_numpy(pv2)], fmt, 256,
    )
    want = jmap.assemble_map_prio(
        jnp.asarray(chars), jnp.asarray(ref), jnp.asarray(lengths),
        [jnp.asarray(pos1), jnp.asarray(pos2)],
        [jnp.asarray(pv1), jnp.asarray(pv2)], fmt, 256,
    )
    n = int(got[0][0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])
    patched = chars.copy()
    patched[0, 5], patched[0, 7] = ord("G"), ord("T")
    patched[1, 2], patched[0, 60] = ord("T"), ord("a")
    out = _painted([x.numpy() for x in got], ref, lengths, fmt)
    for q, n_q in enumerate(lengths):
        aln = patched[q, :n_q]
        want_q = (
            relative_to_ref(ref[q, :n_q].tobytes(), aln) if fmt else aln.tobytes()
        )
        assert out[q] == want_q
    # no grids: the translation itself
    none = tmap.assemble_map_prio_core(
        torch.from_numpy(chars), torch.from_numpy(ref), torch.from_numpy(lengths),
        [], [], fmt, 256,
    )
    base = tmap._emit_deltas(
        torch.from_numpy(chars).reshape(-1), torch.from_numpy(ref),
        torch.from_numpy(lengths), fmt, 256,
    )
    assert all(torch.equal(a, b) for a, b in zip(none, base))


def test_fetch_delta_runs_extras_equal():
    """Rows longer and shorter than the capacity; counts then extras."""
    rng = np.random.default_rng(6)
    counts = np.asarray([3, 777], np.int32)
    rs = np.sort(rng.integers(0, 1000, 12)).astype(np.int32)
    re = rs + 1
    rv = rng.integers(45, 90, 12).astype(np.uint8)
    extras = np.arange(10, 18, dtype=np.int32)
    for cap in (10, 16):
        got = tmap.fetch_delta_runs_extras(
            *(torch.from_numpy(a) for a in (counts, rs, re, rv, extras)), cap
        )
        want = jmap.fetch_delta_runs_extras(
            *(jnp.asarray(a) for a in (counts, rs, re, rv, extras)), cap
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (4, cap) and got.dtype == torch.int32
        assert got[3, :10].tolist() == [3, 777, *range(10, 18)]
