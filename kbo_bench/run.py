"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 -m kbo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's data from the seed, builds the port's kernels at
first use and sends every pool assembly once. Then one client sends request
after request (a closed loop) for ``--seconds``; with ``--trace 1`` a few
requests run under ``torch.profiler`` first. After the window the sampled
answers are held against the plain reference (``reference/kbo_ref.py``).
The last line of standard output is one JSON object; the compared numbers
and their limits end standard error. Without a CUDA card (or with fewer
cards than the cell asks for) it prints no result and exits 3.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from kbo_bench import generate, trace as tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kbo_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load(path: Path):
    """A module from a file of the benchmark, found by name."""
    spec = importlib.util.spec_from_file_location(
        "kbo_bench._by_name." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``kbo_tpu_torch`` is not ``kbo_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Run:
    """What the metric readers read."""

    def __init__(self, requests, window_s, setup_s, stats, trace, peak):
        self.requests = requests
        self.window_s = window_s
        self.setup_s = setup_s
        self.stats = stats
        self.trace = trace
        self.peak_bytes_per_s = peak


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    ms = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in ms if cell in m.get("workloads", [cell])]


def peak_bandwidth(kind: str):
    peaks = json.loads((HERE / "peaks.json").read_text())
    return peaks.get(kind, {}).get("hbm_bytes_per_s")


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cfg: dict | None = None,
             traffic: dict | None = None, log=sys.stderr):
    """One run of a cell: returns (result dict or None, exit code)."""
    import torch
    from kbo_tpu_torch.utils import stats as run_stats

    root = HERE.parent
    if cfg is None:
        entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
        cfg = json.loads((root / entry["file"]).read_text())
    if traffic is None:
        traffic = json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    cards = cell["chips"]
    traffic = dict(traffic, cards=cards)  # a verb that spans cards reads it
    verb = load(HERE / "verbs" / f"{traffic['verb']}.py")
    cuda = str(device).startswith("cuda")

    t_gen = time.perf_counter()
    data = generate.make(cfg, traffic, seed)
    t_warm = time.perf_counter()
    state = verb.prepare(cfg, traffic, data, device)
    pool = len(data["pool"])
    for j in range(pool):  # warm-up: first use builds the kernels
        verb.request(state, j)
    setup_s = process_age()
    print(f"set-up {setup_s:.3f} s: data {t_warm - t_gen:.3f} s, warm-up "
          f"{time.perf_counter() - t_warm:.3f} s", file=log)

    red = None
    if trace:
        n = traffic["trace_requests"]
        _, red = tracing.traced(lambda j: verb.request(state, j), n, cards)
        red["bytes"] = sum(verb.work_bytes(cfg, traffic, data, j)
                           for j in range(n))

    run_stats.reset_stats()
    requests, answers, kept, digests = [], [], {}, {}
    failed = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while not requests or time.perf_counter() < deadline:
        ts = time.perf_counter()
        try:
            out, rec = verb.request(state, i)
        except Exception as exc:  # a failed request is counted, not fatal
            failed += 1
            print(f"request {i} failed: {exc!r}", file=log)
            out, rec = None, {"spans": {}}
        rec["latency_s"] = time.perf_counter() - ts
        requests.append(rec)
        answers.append(out)
        i += 1
    window_s = time.perf_counter() - t0
    for i, out in enumerate(answers):  # digests after the window closed
        if out is not None:
            kept.setdefault(i % pool, out)
            digests.setdefault(i % pool, []).append(
                hashlib.sha1(verb.digest(out)).hexdigest())
    del answers
    stats = run_stats.get_stats().as_dict()
    peaks = ([torch.cuda.max_memory_allocated(d) for d in range(cards)]
             if cuda else [0] * cards)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=log)
        return None, 4
    del state
    if cuda:
        torch.cuda.empty_cache()

    # correctness: a seed-drawn sample of the pool members the window served
    checks = {}
    t_ref = time.perf_counter()
    served = sorted(kept)
    pick = generate.rng(seed, 99).permutation(served)[: traffic["check"]]
    for member in sorted(int(m) for m in pick):
        expected = verb.reference(cfg, traffic, data, member)
        for name, val in verb.compare(kept[member], expected).items():
            checks[name] = checks.get(name, 0) + val
    print(f"reference check {time.perf_counter() - t_ref:.3f} s; "
          f"{len(requests)} requests in {window_s:.3f} s", file=log)
    checks["answers_unlike_their_first"] = sum(
        sum(d != ds[0] for d in ds) for ds in digests.values())
    checks["requests_failed"] = failed
    limits = {name: 0 for name in checks}
    correct = all(checks[n] <= limits[n] for n in checks)

    run = Run(requests, window_s, setup_s, stats, red, peak_bandwidth(kind))
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = load(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cards, "memory_peak_bytes": int(max(peaks)),
           "memory_peak_bytes_by_card": [int(p) for p in peaks]}
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": failed, "metrics": metrics, "device": dev}
    if red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        dev["busy_s_by_card"] = red["busy_s_by_card"]
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    result["checks"] = {n: {"value": checks[n], "limit": limits[n]}
                        for n in checks}
    for n in checks:
        print(f"check {n} = {checks[n]} (limit {limits[n]})", file=log)
    return result, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result, rc = run_cell(bench, cell, args.seed, args.seconds,
                          bool(args.trace))
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
