"""``screen``: read batches against the reference's index, built once at
set-up (``build_device(full=True)`` of both strands) and standing for the
whole run; per request ``find_batch`` of one batch over a ``data`` mesh of
the cell's cards, ending in every read's segment list on the host."""

from __future__ import annotations

import time

from kbo_bench.metrics import _bytes
from kbo_bench.reference import kbo_ref


def prepare(cfg, traffic, data, device):
    import torch
    from kbo_tpu_torch import api
    from kbo_tpu_torch.opts import BuildOpts, FindOpts
    from kbo_tpu_torch.parallel.mesh import make_mesh

    cards = traffic["cards"]
    cuda = str(device).startswith("cuda")
    idx = api.build_device(data["reference"],
                           BuildOpts(k=cfg["k"], add_revcomp=True), full=True,
                           device=device)
    mesh = make_mesh(cards) if cuda else make_mesh(cards, device=device)
    return {"api": api, "idx": idx, "mesh": mesh,
            "opts": FindOpts(max_error_prob=cfg["max_error_prob"]),
            "span": torch.profiler.record_function, "reads": data["reads"],
            "bases": [sum(map(len, b)) for b in data["reads"]]}


def request(state, i):
    j = i % len(state["reads"])
    batch = state["reads"][j]
    t0 = time.perf_counter()
    with state["span"]("find_batch"):
        res = state["api"].find_batch(batch, state["idx"], state["opts"],
                                      mesh=state["mesh"])
    t1 = time.perf_counter()
    rec = {"queries": len(batch), "bases": state["bases"][j],
           "spans": {"find_batch": t1 - t0}}
    return res, rec


def _segments(res) -> list:
    """Segment lists as the reference's tuples; made after the window, so
    that at 65,536 reads a request the copy is not timed as the program's."""
    return [[s if isinstance(s, tuple) else
             (s.start, s.end, s.matches, s.mismatches, s.jumps, s.gap_bases,
              s.gap_opens) for s in segs] for segs in res]


def digest(out) -> bytes:
    return repr(_segments(out)).encode()


def reference(cfg, traffic, data, i, exact_only=False):
    rows = kbo_ref.Rows(data["reference"], cfg["k"], add_revcomp=True)
    return kbo_ref.find_batch(rows, data["reads"][i % len(data["reads"])],
                              cfg["max_error_prob"], exact_only=exact_only)


def compare(out, expected) -> dict:
    """Reads whose segment list differs (a missing read counts)."""
    out = _segments(out)
    bad = sum(o != e for o, e in zip(out, expected))
    bad += abs(len(expected) - len(out))
    return {"reads_wrong": bad}


def work_bytes(cfg, traffic, data, i) -> int:
    batch = data["reads"][i % len(data["reads"])]
    return _bytes.screen_bytes(cfg["k"],
                               sum(len(r) for r in data["reference"]),
                               revcomp=True, streamed=[len(r) for r in batch])
