"""The control of a cell's correctness check: the plain reference with one
stated guarantee broken, put in the port's place, on the answers a run
checks. It has to come out as not correct.

    python3 -m kbo_bench.control --workload <cell> --seeds <n,n,...>

The guarantee broken is kbo's matching statistics: the control keeps only
whole k-mer hits (ms = k or 0), the answer of a join that skips the
clamped-LCP scans. For each seed it prints the numbers a run would compare
(``run.py``), read off the control's answers. Needs no card; run it at the
cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kbo_bench import generate
from kbo_bench.run import HERE, load


def control_checks(cfg: dict, traffic: dict, seed: int) -> dict:
    """{compared number: the control's reading}."""
    verb = load(HERE / "verbs" / f"{traffic['verb']}.py")
    data = generate.make(cfg, traffic, seed)
    served = list(range(len(data["pool"])))
    pick = generate.rng(seed, 99).permutation(served)[: traffic["check"]]
    out: dict = {}
    for member in sorted(int(m) for m in pick):
        expected = verb.reference(cfg, traffic, data, member)
        ctl = verb.reference(cfg, traffic, data, member, exact_only=True)
        for name, val in verb.compare(ctl, expected).items():
            out[name] = out.get(name, 0) + val
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((HERE.parent / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = control_checks(cfg, traffic, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": res,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
