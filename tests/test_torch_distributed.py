"""The port's multi-process run (kbo_tpu_torch.parallel.distributed): two
real processes on the CPU joined by a gloo process group, as the mirror of
tests/test_distributed.py.

Each process brings a 2-shard local mesh, so the global mesh has 4 shards:
matches_batch_sharded and find_rle_batch_sharded run each process's shards
and meet in distributed.gather_to_host; map_batch maps each process's half
of the contigs and the digests merge with one process_allgather. Both
processes must write the same digests, equal to a single-process run's.

Run as a script, this file is the worker: ``python
tests/test_torch_distributed.py OUT`` with torchrun's environment.
"""

import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _inputs():
    """The index, the threshold and the queries of the find digests; the
    map index, its options and four contigs."""
    from kbo_tpu_torch import BuildOpts, MapOpts, build
    from kbo_tpu_torch.index.encode import encode_ascii
    from kbo_tpu_torch.ops.derandomize import random_match_threshold

    rng = np.random.default_rng(21)
    genome = BASES[rng.integers(0, 4, 20000)].tobytes()
    index = build([genome], BuildOpts(k=31))
    thr = random_match_threshold(31, index.n_kmers, 4, 1e-7)
    queries = []
    for i in range(7):  # not a multiple of the 4 shards: padding rows
        q = bytearray(genome[i * 2311 : i * 2311 + 1500])
        q[700] = BASES[(np.searchsorted(BASES, q[700]) + 1) % 4]
        queries.append(encode_ascii(bytes(q)))
    bo = BuildOpts(k=31, build_select=True)
    refs = []
    for i in range(4):
        r = bytearray(genome[i * 4000 : i * 4000 + 3000])
        r[1500] = BASES[(np.searchsorted(BASES, r[1500]) + 1) % 4]
        refs.append(bytes(r))
    return index, thr, queries, build([genome], bo), MapOpts(
        fill_gaps=False, call_variants=False, sbwt_build_opts=bo), refs


def _find_digests(index, thr, queries, m):
    from kbo_tpu_torch.parallel import mesh as pmesh

    chars = pmesh.matches_batch_sharded(index, queries, thr, mesh=m)
    rles = pmesh.find_rle_batch_sharded(index, queries, thr, mesh=m)
    return [hashlib.sha256(b"".join(c.tobytes() for c in chars)).hexdigest(),
            hashlib.sha256(repr(rles).encode()).hexdigest()]


def _map_digest(per_process: np.ndarray) -> str:
    """The merged map digest of [processes, 32] per-process digests."""
    return hashlib.sha256(per_process.tobytes()).hexdigest()


def _local_map_digest(qidx, opts, refs, rank: int) -> np.ndarray:
    from kbo_tpu_torch import api

    out = api.map_batch(refs[rank::2], qidx, opts, device="cpu")
    return np.frombuffer(hashlib.sha256(b"".join(out)).digest(), np.uint8)


def _worker(out_path: str) -> None:
    import torch.distributed as dist

    from kbo_tpu_torch.parallel import distributed, mesh as pmesh

    assert distributed.initialize_from_env(), "expected two processes"
    assert distributed.initialize_from_env()  # a second call joins nothing
    m = pmesh.make_mesh(2, device="cpu")
    rank = distributed.process_index()
    assert m.devices.size == 4 and m.process_count == 2
    assert list(m.local_shards) == [2 * rank, 2 * rank + 1]
    index, thr, queries, qidx, opts, refs = _inputs()
    digests = _find_digests(index, thr, queries, m)
    merged = distributed.process_allgather(
        _local_map_digest(qidx, opts, refs, rank))
    assert merged.shape == (2, 32)
    digests.append(_map_digest(merged))
    Path(out_path).write_text("\n".join(digests))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_from_env_without_the_environment(monkeypatch):
    import torch.distributed as dist

    from kbo_tpu_torch.parallel import distributed

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_from_env() is False
    assert not dist.is_initialized()
    assert distributed.process_count() == 1
    a = np.arange(5, dtype=np.int32)
    assert np.array_equal(distributed.process_allgather(a), a[None])


def test_two_processes_equal_one(tmp_path):
    port = _free_port()
    procs, outs = [], []
    for rank in range(2):
        out = tmp_path / f"digests_{rank}.txt"
        outs.append(out)
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=f"{ROOT}{os.pathsep}"
                   f"{os.environ.get('PYTHONPATH', '')}")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, (stdout.decode()[-2000:]
                                       + stderr.decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [o.read_text().splitlines() for o in outs]
    assert got[0] == got[1]

    from kbo_tpu_torch.parallel import mesh as pmesh

    index, thr, queries, qidx, opts, refs = _inputs()
    want = _find_digests(index, thr, queries,
                         pmesh.make_mesh(4, device="cpu"))
    want.append(_map_digest(np.stack(
        [_local_map_digest(qidx, opts, refs, r) for r in range(2)])))
    assert got[0] == want


if __name__ == "__main__":
    _worker(sys.argv[1])
