"""``call``: per assembly, ``build_device(full=True)`` of the draft, then
``call`` of every reference contig against it (``CallOpts`` with the
index's k), ending in each contig's variants on the host."""

from __future__ import annotations

import time
from collections import Counter

from kbo_bench.metrics import _bytes
from kbo_bench.reference import kbo_ref


def prepare(cfg, traffic, data, device):
    import torch
    from kbo_tpu_torch import api
    from kbo_tpu_torch.opts import BuildOpts, CallOpts

    bo = BuildOpts(k=cfg["k"], build_select=True)
    sync = torch.cuda.synchronize if str(device).startswith("cuda") else (
        lambda: None)
    span = torch.profiler.record_function
    return {"api": api, "bo": bo,
            "opts": CallOpts(max_error_prob=cfg["max_error_prob"],
                             sbwt_build_opts=bo),
            "sync": sync, "span": span, "device": device, "data": data}


def request(state, i):
    api, data = state["api"], state["data"]
    asm = data["pool"][i % len(data["pool"])]
    t0 = time.perf_counter()
    with state["span"]("build_device"):
        idx = api.build_device(asm, state["bo"], full=True,
                               device=state["device"])
        state["sync"]()
    t1 = time.perf_counter()
    out = []
    for contig in data["reference"]:
        with state["span"]("call"):
            vs = api.call(idx, contig, state["opts"], device=state["device"])
        out.append([(v.query_pos, bytes(v.query_chars), bytes(v.ref_chars))
                    for v in vs])
    t2 = time.perf_counter()
    rec = {"bases": sum(len(r) for r in data["reference"]),
           "spans": {"index_build": t1 - t0, "call": t2 - t1}}
    return out, rec


def digest(out) -> bytes:
    return repr(out).encode()


def reference(cfg, traffic, data, i, exact_only=False):
    asm = data["pool"][i % len(data["pool"])]
    rows = kbo_ref.Rows(asm, cfg["k"])
    return [kbo_ref.call_variants(rows, r, cfg["max_error_prob"],
                                  exact_only=exact_only)
            for r in data["reference"]]


def compare(out, expected) -> dict:
    """Variants in one answer and not the other, over every contig (one
    more where the same variants come in another order)."""
    bad = 0
    for o, e in zip(out, expected):
        co, ce = Counter(o), Counter(e)
        diff = sum(((co - ce) + (ce - co)).values())
        bad += diff if diff or o == e else 1
    bad += sum(len(e) for e in expected[len(out):])
    return {"call_variants_wrong": bad}


def work_bytes(cfg, traffic, data, i) -> int:
    asm = data["pool"][i % len(data["pool"])]
    return _bytes.request_bytes(cfg["k"], indexed=[len(c) for c in asm],
                                revcomp=False,
                                streamed=[len(r) for r in data["reference"]])
