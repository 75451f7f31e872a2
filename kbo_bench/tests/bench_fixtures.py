"""Small shapes for the benchmark's CPU tests."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

TINY_CFG = {
    "k": 51, "max_error_prob": 1e-7, "gc": 0.508,
    "reference": [{"name": "chr", "length": 24000},
                  {"name": "p1", "length": 3000}],
    "repeats": [{"name": "op", "length": 1200, "copies": 2}],
    "assembly": {"snp_every": 1000, "indel_every": 4000, "indel_len": [1, 10],
                 "deleted_share": 0.03, "deleted_block": [300, 600],
                 "island_share": 0.03, "island_block": [300, 600],
                 "contigs": 5},
}


# a read screen over a CPU mesh of four shards: a cell of no BENCHMARK.json
SCREEN_CELL = {"name": "tiny.screen_x4", "config": "tiny", "traffic": "screen",
               "chips": 4, "why": "reads against a standing index, 4 shards"}
SCREEN_TRAFFIC = {"verb": "screen", "pool": 4, "check": 1, "trace_requests": 6,
                  "reads": {"per_request": 65536, "length": 150,
                            "subst": 0.001, "revcomp_share": 0.5}}


def cell(name):
    return next(w for w in BENCH["workloads"] + [SCREEN_CELL]
                if w["name"] == name)


def tiny_traffic(name):
    if name == SCREEN_CELL["name"]:
        t = copy.deepcopy(SCREEN_TRAFFIC)
        t["reads"]["per_request"] = 96
    else:
        t = json.loads((ROOT / "kbo_bench" / "traffic"
                        / f"{cell(name)['traffic']}.json").read_text())
        t = copy.deepcopy(t)
    t["pool"] = 2
    t["trace_requests"] = 1
    if "panel" in t:
        t["panel"].update(genes=24, median=300, min=60, max=700,
                          present_share=0.25)
    return t
