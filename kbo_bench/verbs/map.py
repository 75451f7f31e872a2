"""``map``: per assembly, ``build_device(full=True)`` of the draft, then
``map_`` of the reference through it (``MapOpts()`` with the index's k), ending
in the mapped bytes on the host."""

from __future__ import annotations

import time

from kbo_bench.metrics import _bytes
from kbo_bench.reference import kbo_ref


def prepare(cfg, traffic, data, device):
    import torch
    from kbo_tpu_torch import api
    from kbo_tpu_torch.opts import BuildOpts, MapOpts

    bo = BuildOpts(k=cfg["k"], build_select=True)
    opts = MapOpts(max_error_prob=cfg["max_error_prob"], sbwt_build_opts=bo)
    sync = torch.cuda.synchronize if str(device).startswith("cuda") else (
        lambda: None)
    span = torch.profiler.record_function
    return {"api": api, "bo": bo, "opts": opts, "sync": sync, "span": span,
            "device": device, "data": data}


def request(state, i):
    api, data = state["api"], state["data"]
    asm = data["pool"][i % len(data["pool"])]
    ref = data["reference"]
    t0 = time.perf_counter()
    with state["span"]("build_device"):
        idx = api.build_device(asm, state["bo"], full=True,
                               device=state["device"])
        state["sync"]()
    t1 = time.perf_counter()
    with state["span"]("map_"):
        if len(ref) == 1:
            out = [api.map_(ref[0], idx, state["opts"],
                            device=state["device"])]
        else:
            out = api.map_batch(ref, idx, state["opts"],
                                device=state["device"])
    t2 = time.perf_counter()
    rec = {"bases": sum(len(r) for r in ref),
           "spans": {"index_build": t1 - t0, "map": t2 - t1}}
    return out, rec


def digest(out) -> bytes:
    return b"\0".join(out)


def reference(cfg, traffic, data, i, exact_only=False):
    asm = data["pool"][i % len(data["pool"])]
    rows = kbo_ref.Rows(asm, cfg["k"])
    return [kbo_ref.map_(rows, r, cfg["max_error_prob"], exact_only=exact_only)
            for r in data["reference"]]


def compare(out, expected) -> dict:
    """Bytes that differ, a length difference counting each missing byte."""
    bad = 0
    for o, e in zip(out, expected):
        bad += sum(a != b for a, b in zip(o, e)) + abs(len(o) - len(e))
    bad += sum(len(e) for e in expected[len(out):])
    return {"map_bytes_wrong": bad}


def work_bytes(cfg, traffic, data, i) -> int:
    asm = data["pool"][i % len(data["pool"])]
    return _bytes.request_bytes(cfg["k"], indexed=[len(c) for c in asm],
                                revcomp=False,
                                streamed=[len(r) for r in data["reference"]])
