"""``find``: per assembly, ``build_device`` (the sequence index, both
strands) of the draft, then ``find_batch`` of the gene panel against it,
ending in every gene's segment list on the host."""

from __future__ import annotations

import time

from kbo_bench.metrics import _bytes
from kbo_bench.reference import kbo_ref


def prepare(cfg, traffic, data, device):
    import torch
    from kbo_tpu_torch import api
    from kbo_tpu_torch.opts import BuildOpts, FindOpts

    sync = torch.cuda.synchronize if str(device).startswith("cuda") else (
        lambda: None)
    span = torch.profiler.record_function
    return {"api": api, "bo": BuildOpts(k=cfg["k"], add_revcomp=True),
            "opts": FindOpts(max_error_prob=cfg["max_error_prob"]),
            "sync": sync, "span": span, "device": device, "data": data}


def request(state, i):
    api, data = state["api"], state["data"]
    asm = data["pool"][i % len(data["pool"])]
    t0 = time.perf_counter()
    with state["span"]("build_device"):
        idx = api.build_device(asm, state["bo"], device=state["device"])
        state["sync"]()
    t1 = time.perf_counter()
    with state["span"]("find_batch"):
        res = api.find_batch(data["panel"], idx, state["opts"])
    t2 = time.perf_counter()
    out = [[(s.start, s.end, s.matches, s.mismatches, s.jumps, s.gap_bases,
             s.gap_opens) for s in segs] for segs in res]
    rec = {"queries": len(data["panel"]),
           "spans": {"index_build": t1 - t0, "find_batch": t2 - t1}}
    return out, rec


def digest(out) -> bytes:
    return repr(out).encode()


def reference(cfg, traffic, data, i, exact_only=False):
    asm = data["pool"][i % len(data["pool"])]
    rows = kbo_ref.Rows(asm, cfg["k"], add_revcomp=True)
    return kbo_ref.find_batch(rows, data["panel"], cfg["max_error_prob"],
                              exact_only=exact_only)


def compare(out, expected) -> dict:
    """Genes whose segment list differs (a missing gene counts)."""
    bad = sum(o != e for o, e in zip(out, expected))
    bad += abs(len(expected) - len(out))
    return {"find_genes_wrong": bad}


def work_bytes(cfg, traffic, data, i) -> int:
    asm = data["pool"][i % len(data["pool"])]
    return _bytes.request_bytes(cfg["k"], indexed=[len(c) for c in asm],
                                revcomp=True,
                                streamed=[len(g) for g in data["panel"]])
