"""The run-stat stages as profiler spans, and the spans and counters inside
build_device, map_, find_batch and call, on the CPU at small sizes.

A stage is a ``record_function`` span only while a profiler records (it
then lands in the Chrome trace as a ``user_annotation`` around the ops it
ran); without one it enters none. Each public call records the stages of
its layers in the run's stats."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import kbo_tpu_torch
from kbo_tpu_torch import api
from kbo_tpu_torch.utils import stats as tstats
from kbo_tpu_torch.utils.stats import get_stats, reset_stats, stage

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
BUILD = ("build_pack", "build_sort", "build_fetch")
MAP = ("map_upload", "map_sweep", "map_postprocess", "map_devref",
       "map_fetch", "map_host_gaps", "map_paint")
FIND = ("find_encode", "find_pack", "find_join", "find_fetch", "find_rle")
CALL = ("call_drops", "call_anchors", "call_anchor_fetch", "call_kmer_joins",
        "call_resolve")


def _random(rng, n: int) -> bytes:
    return BASES[rng.integers(0, 4, n)].tobytes()


def _traced(fn, tmp_path):
    """fn() under a CPU profiler: (its result, the Chrome trace's complete
    events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X" and "dur" in e]


def _annotations(events) -> set[str]:
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def _ran(names):
    d = get_stats().as_dict()
    return {n for n in names if d.get(f"{n}_calls", 0) >= 1 and f"{n}_s" in d}


def test_stage_is_a_user_annotation_around_its_ops(tmp_path):
    reset_stats()

    def work():
        with stage("demo_span", bases=7):
            return torch.arange(64).reshape(8, 8).sum(dim=0) + 1

    out, events = _traced(work, tmp_path)
    assert out.tolist() == (torch.arange(64).reshape(8, 8).sum(dim=0)
                            + 1).tolist()
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "demo_span"]
    assert len(spans) == 1
    s0, s1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    inside = [e["name"] for e in events if e.get("cat") == "cpu_op"
              and s0 <= e["ts"] and e["ts"] + e["dur"] <= s1]
    assert "aten::sum" in inside and "aten::add" in inside
    d = get_stats().as_dict()
    assert d["demo_span_calls"] == 1 and d["demo_span_bases"] == 7
    assert d["demo_span_s"] >= 0


def test_stage_enters_no_span_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tstats, "record_function", Counting)
    reset_stats()
    with stage("quiet"):
        torch.ones(3).sum()
    assert entered == []
    with pytest.raises(KeyError):
        with stage("quiet"):
            raise KeyError("the stage passes errors on")
    assert entered == []
    assert get_stats().as_dict()["quiet_calls"] == 2
    with profile(activities=[ProfilerActivity.CPU]):
        with stage("loud"):
            torch.ones(3).sum()
    assert entered == ["loud"]


def test_derived_rates_are_gone():
    reset_stats()
    with stage("demo", bases=1000):
        pass
    d = get_stats().as_dict()
    assert d["demo_bases"] == 1000 and d["demo_calls"] == 1 and "demo_s" in d
    assert not any(key.endswith("_per_s") for key in d)


def test_build_and_map_spans_with_a_host_gap(tmp_path):
    """A 4 kbase draft at k = 31 and a reference with an unrelated 100 base
    stretch: the gap needs the host evaluator, which extends its lanes by
    the walk along the device index's chain links, in no rounds."""
    rng = np.random.default_rng(5)
    query = _random(rng, 4000)
    ref = bytearray(query)
    ref[1000:1100] = _random(rng, 100)
    bo = kbo_tpu_torch.BuildOpts(k=31, build_select=True)
    opts = kbo_tpu_torch.MapOpts(sbwt_build_opts=bo)
    reset_stats()

    def work():
        idx = api.build_device([query], bo, full=True, device="cpu")
        return api.map_(bytes(ref), idx, opts, device="cpu")

    out, events = _traced(work, tmp_path)
    assert len(out) == len(ref)
    assert _ran(BUILD + MAP) == set(BUILD + MAP)
    d = get_stats().as_dict()
    assert d["gaps_to_host"] > 0 and d["host_ext_walk_lanes"] > 0
    assert "host_ext_rounds" not in d
    assert d["map_sweep_bases"] == len(ref)
    assert set(BUILD + MAP) <= _annotations(events)
    # the same answer with no profiler recording
    idx = api.build_device([query], bo, full=True, device="cpu")
    assert api.map_(bytes(ref), idx, opts, device="cpu") == out


def test_find_batch_spans_on_a_sequence_index():
    """Four genes against a 6 kbase draft (both strands, k = 21); one gene
    of 140 pieces of the draft between unrelated stretches overflows the
    first segment table (128 slots), so the fetch runs twice."""
    rng = np.random.default_rng(7)
    draft = _random(rng, 6000)
    many = b"".join(draft[i * 40 : (i + 1) * 40] + _random(rng, 40)
                    for i in range(140))
    genes = [draft[100:400], _random(rng, 300), draft[2000:2600], many]
    bo = kbo_tpu_torch.BuildOpts(k=21, add_revcomp=True)
    reset_stats()
    idx = api.build_device([draft], bo, device="cpu")
    res = api.find_batch(genes, idx, kbo_tpu_torch.FindOpts())
    assert [len(r) for r in res] == [1, 0, 1, 140]
    assert _ran(BUILD + FIND) == set(BUILD + FIND)
    d = get_stats().as_dict()
    assert d["find_rle_retries"] == 1 and d["find_fetch_calls"] == 2
    assert d["find_batch_bases"] == sum(len(g) for g in genes)


def test_call_spans_and_anchor_rounds():
    """A SNP, a 2-base deletion and a 2-base insertion in 3 kbase at
    k = 51 (tests/test_torch_call.py's pair, shorter)."""
    rng = np.random.default_rng(21)
    query = _random(rng, 3000)
    ref = bytearray(query)
    ref[1000] = BASES[(query[1000] % 4 + 1) % 4]
    del ref[1800:1802]
    ref[2500:2500] = b"TT"
    bo = kbo_tpu_torch.BuildOpts(k=51, build_select=True)
    reset_stats()
    idx = api.build_device([query], bo, full=True, device="cpu")
    variants = api.call(idx, bytes(ref),
                        kbo_tpu_torch.CallOpts(sbwt_build_opts=bo),
                        device="cpu")
    assert len(variants) == 3
    assert _ran(CALL) == set(CALL)
    d = get_stats().as_dict()
    assert d["call_anchor_rounds"] >= 1
    # one fetch span a round, and one for the anchors' rows
    assert d["call_anchor_fetch_calls"] == d["call_anchor_rounds"] + 1
