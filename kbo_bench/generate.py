"""The benchmark's one generator: genomes, draft assemblies, gene panels
and batches of sequencing reads from a seed, read from a configuration file
and a traffic file.

Every size and every position is fixed by the files or drawn from a fixed
stream that does not depend on the seed: where repeats, SNPs, indels,
islands and contig breaks fall, where reads start, which strand they come
from and where they carry substitutions. The seed draws the bases and the
order of the pool, so two seeds send the same work.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b
_FIXED = 0x5EED  # the stream that fixes sizes, whatever the seed


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


def random_bases(g: np.random.Generator, n: int, gc: float) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return BASES[g.choice(4, size=n, p=p)]


def revcomp(a: np.ndarray) -> np.ndarray:
    return _COMP[a][::-1]


def _blocks(total: int, lo: int, hi: int, tag: int) -> list[int]:
    """Block sizes in [lo, hi] summing to about ``total`` (fixed stream)."""
    g = rng(_FIXED, tag)
    out = []
    while sum(out) < total:
        out.append(int(g.integers(lo, hi + 1)))
    return out


def reference(cfg: dict, seed: int) -> tuple[list[bytes], list[int]]:
    """The reference contigs, random at the configuration's GC share, with
    its repeats planted in the first (chromosome) contig; and the midpoints
    of the planted copies, where drafts break."""
    g = rng(seed, 1)
    lay = rng(_FIXED, 1)
    contigs = [random_bases(g, c["length"], cfg["gc"]) for c in cfg["reference"]]
    chrom = contigs[0]
    starts, mids = [], []
    for r in cfg.get("repeats", []):
        unit = random_bases(g, r["length"], cfg["gc"])
        for _ in range(r["copies"]):
            while True:
                s = int(lay.integers(0, chrom.size - r["length"]))
                if all(abs(s - t) > 2 * r["length"] + 10_000 for t in starts):
                    break
            starts.append(s)
            mids.append(s + r["length"] // 2)
            chrom[s: s + r["length"]] = (
                unit if g.integers(2) else revcomp(unit))
    return [c.tobytes() for c in contigs], mids


def _mutate(seq: np.ndarray, asm: dict, lay: np.random.Generator,
            g: np.random.Generator, big: bool, cuts: list[int],
            tag: int) -> list[np.ndarray]:
    """One contig of the reference with SNPs, small indels and (on ``big``
    contigs) deleted blocks and query-only islands, cut at ``cuts``
    (reference coordinates) into draft contigs. ``lay`` places the changes,
    ``g`` draws their bases."""
    n = seq.size
    out = seq.copy()
    # SNPs: a fixed count, each to another base
    n_snp = n // asm["snp_every"]
    pos = lay.choice(n, size=n_snp, replace=False)
    out[pos] = BASES[(np.searchsorted(BASES, out[pos])
                      + g.integers(1, 4, size=n_snp)) % 4]
    events = []  # (position, bases deleted, bases inserted)
    taken = []
    if big:
        for size in _blocks(int(asm["deleted_share"] * n),
                            *asm["deleted_block"], tag=10 + tag):
            while True:
                s = int(lay.integers(1000, n - size - 1000))
                if all(s + size + 1000 < a or b + 1000 < s for a, b in taken):
                    break
            taken.append((s, s + size))
            events.append((s, size, b""))
        for size in _blocks(int(asm["island_share"] * n),
                            *asm["island_block"], tag=20 + tag):
            while True:
                s = int(lay.integers(1000, n - 1000))
                if all(s + 1000 < a or b + 1000 < s for a, b in taken):
                    break
            taken.append((s, s))
            events.append((s, 0, random_bases(g, size, asm["gc"]).tobytes()))
    lens = rng(_FIXED, 30 + tag).integers(
        asm["indel_len"][0], asm["indel_len"][1] + 1,
        size=n // asm["indel_every"])
    for i, size in enumerate(lens.tolist()):
        while True:
            s = int(lay.integers(100, n - 100))
            if all(s + size + 60 < a or b + 60 < s for a, b in taken):
                break
        taken.append((s, s + size))
        if i % 2:
            events.append((s, int(size), b""))
        else:
            events.append((s, 0, random_bases(g, int(size),
                                              asm["gc"]).tobytes()))
    events.sort()
    # cut points in reference coordinates, moved out of deleted spans
    cut = sorted(set(cuts))
    pieces, cur, prev = [], [], 0
    ev = iter(events)
    e = next(ev, None)
    for c in cut + [n]:
        while e is not None and e[0] < c:
            s, dl, ins = e
            cur.append(out[prev:s])
            cur.append(np.frombuffer(ins, dtype=np.uint8))
            prev = max(s + dl, prev)
            e = next(ev, None)
        if c > prev:
            cur.append(out[prev:c])
            prev = c
        if c < n and cur:
            pieces.append(np.concatenate(cur))
            cur = []
    if cur:
        pieces.append(np.concatenate(cur))
    return [p for p in pieces if p.size >= 500]


def _spaced(cuts: list[int], gap: int = 2000) -> list[int]:
    """Cut points at least ``gap`` apart, so that no draft contig is short
    enough to drop (a dropped piece would be a deletion in the draft)."""
    out = []
    for c in sorted(cuts):
        if not out or c - out[-1] >= gap:
            out.append(c)
    return out


def assemblies(cfg: dict, traffic: dict, ref: list[bytes], mids: list[int],
               seed: int) -> list[list[bytes]]:
    """The pool of draft assemblies that requests cycle through."""
    asm = dict(cfg["assembly"], gc=cfg["gc"])
    sets = asm.get("plasmid_sets")
    order = rng(seed, 2).permutation(max(traffic["pool"], len(sets or [0])))
    pool = []
    for i in range(traffic["pool"]):
        g = rng(seed, 3, i)
        lay = rng(_FIXED, 3, int(order[i]))  # member i takes a fixed layout
        chrom = np.frombuffer(ref[0], dtype=np.uint8)
        n_cut = asm["contigs"] - 1 - len(mids)
        cuts = _spaced(mids + lay.integers(1000, chrom.size - 1000,
                                           size=n_cut).tolist())
        contigs = _mutate(chrom, asm, lay, g, True, cuts, 0)
        keep = (range(1, len(ref)) if sets is None
                else sets[int(order[i]) % len(sets)])
        for j in keep:
            pl = np.frombuffer(ref[j], dtype=np.uint8)
            contigs += _mutate(pl, asm, lay, g, False, [], j)
        pool.append([contigs[p].tobytes()
                     for p in lay.permutation(len(contigs))])
    return pool


def panel(cfg: dict, spec: dict, ref: list[bytes], seed: int) -> list[bytes]:
    """A gene panel: log-normal lengths (a fixed set), a share present in
    the reference on either strand with a few substitutions, the rest
    random."""
    sizes = rng(_FIXED, 40).lognormal(np.log(spec["median"]), spec["sigma"],
                                      size=spec["genes"])
    sizes = np.clip(sizes.round().astype(np.int64), spec["min"], spec["max"])
    sizes[np.argmax(sizes)] = spec["max"]
    g = rng(seed, 4)
    sizes = g.permutation(sizes)
    n_present = int(round(spec["present_share"] * spec["genes"]))
    chrom = np.frombuffer(ref[0], dtype=np.uint8)
    genes = []
    for i, L in enumerate(sizes.tolist()):
        if i < n_present:
            s = int(g.integers(0, chrom.size - L))
            gene = chrom[s: s + L].copy()
            n_sub = int(g.integers(0, int(spec["max_subst"] * L) + 1))
            p = g.choice(L, size=n_sub, replace=False)
            gene[p] = BASES[(np.searchsorted(BASES, gene[p])
                             + g.integers(1, 4, size=n_sub)) % 4]
            if g.integers(2):
                gene = revcomp(gene)
        else:
            gene = random_bases(g, L, cfg["gc"])
        genes.append(gene.tobytes())
    order = g.permutation(len(genes))
    return [genes[i] for i in order]


def reads(spec: dict, contigs: list[bytes], seed: int,
          member: int) -> list[bytes]:
    """A batch of ``spec["per_request"]`` reads of ``spec["length"]`` bases
    from one draft's ``contigs``: each from a start drawn uniformly over the
    draft's positions, ``spec["revcomp_share"]`` of them reverse-complemented,
    with ``spec["subst"]`` substitutions per base. Starts, strands and
    substituted positions come from the fixed stream (as fractions of the
    draft, so every draft takes them); the seed draws the substituted
    bases."""
    n, L = spec["per_request"], spec["length"]
    lay = rng(_FIXED, 50, member)
    seq = np.frombuffer(b"".join(contigs), dtype=np.uint8)
    sizes = np.array([len(c) for c in contigs], dtype=np.int64)
    fits = np.maximum(sizes - L + 1, 0)  # the starts a read has, a contig
    cum = np.cumsum(fits)
    u = (lay.random(n) * cum[-1]).astype(np.int64)
    j = np.searchsorted(cum, u, side="right")
    starts = (np.cumsum(sizes) - sizes)[j] + u - (cum - fits)[j]
    batch = seq[starts[:, None] + np.arange(L)]
    n_sub = int(round(spec["subst"] * n * L))
    flat = lay.choice(n * L, size=n_sub, replace=False)
    g = rng(seed, 5, member)
    sub = batch.reshape(-1)
    sub[flat] = BASES[(np.searchsorted(BASES, sub[flat])
                       + g.integers(1, 4, size=n_sub)) % 4]
    flip = lay.permutation(n)[: int(round(spec["revcomp_share"] * n))]
    batch[flip] = _COMP[batch[flip]][:, ::-1]
    return [r.tobytes() for r in batch]


def make(cfg: dict, traffic: dict, seed: int) -> dict:
    """Everything a run sends: the reference contigs, the assembly pool and,
    where the traffic has them, the gene panel and a batch of reads per pool
    member."""
    ref, mids = reference(cfg, seed)
    data = {"reference": ref,
            "pool": assemblies(cfg, traffic, ref, mids, seed)}
    if "panel" in traffic:
        data["panel"] = panel(cfg, traffic["panel"], ref, seed)
    if "reads" in traffic:
        data["reads"] = [reads(traffic["reads"], asm, seed, i)
                         for i, asm in enumerate(data["pool"])]
    return data
