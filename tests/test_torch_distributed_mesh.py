"""The port's mesh across processes on the CPU: two processes joined by a
gloo group, each with 2 CPU shards, run the collectives and every sharded
path over the 4-shard global mesh (a 2 x 2 grid for the 2-D map), and both
must give the bytes of one process over the same 4 shards, which in turn
equal kbo_tpu's functions of the same names over a 4-device JAX CPU mesh.

- the collectives: ``all_gather`` (dim 0 and 1), ``psum`` and ``pmax`` on
  uint8, int32 and int64 (the all-ones int32 pad pattern included) and
  ``pmax`` on bool, against one process and numpy;
- ``api.call(mesh=)``; ``api.map_batch(mesh=)`` on each of its three
  routes, each asserting its route counter; ``matches_batch_index_sharded``
  and ``map_batch_index_sharded`` over a 4-shard ``model`` mesh split
  2 + 2, and a prepend-variant block that straddles the process boundary;
  ``map_batch_2d_sharded`` over a 2 x 2 global grid;
- ``make_mesh``'s card choice: each local rank its own block of cards.

Run as a script, this file is the worker: ``python
tests/test_torch_distributed_mesh.py OUT`` with torchrun's environment.
It imports neither jax nor kbo_tpu. Every comparison is exact.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
K = 51


def _digest(x) -> str:
    if not isinstance(x, (bytes, str)):
        x = np.ascontiguousarray(x)
        x = f"{x.dtype}{x.shape}".encode() + x.tobytes()
    return hashlib.sha256(x if isinstance(x, bytes) else x.encode()).hexdigest()


def _pair(n=12_000, seed=9, every=900):
    rng = np.random.default_rng(seed)
    ref = BASES[rng.integers(0, 4, n)].tobytes()
    query = bytearray(ref)
    for p in range(500, n - 500, every):
        query[p] = BASES[rng.integers(0, 4)]
    del query[n // 2 : n // 2 + 3]
    return ref, bytes(query)


def _contigs(genome):
    """Five contigs: more than the 4 data shards (route 2), Q padded to 6
    over the 2-D grid's 2 data rows."""
    cuts = (0, 2600, 4700, 7300, 9500, 12_000)
    return [genome[a:b] for a, b in zip(cuts, cuts[1:])]


def _case():
    """The port's index at k = 51 over the pair's query side, its options
    (MapOpts(), and add_revcomp with variant calling for the classic
    route) and the streamed side."""
    import kbo_tpu_torch

    genome, query = _pair()
    bo = kbo_tpu_torch.BuildOpts(k=K, build_select=True)
    rc = kbo_tpu_torch.BuildOpts(k=K, build_select=True, add_revcomp=True)
    return (genome, kbo_tpu_torch.build([query], bo),
            kbo_tpu_torch.MapOpts(sbwt_build_opts=bo),
            kbo_tpu_torch.MapOpts(sbwt_build_opts=rc))


# ------------------------------------------------------------ the collectives


def _collective_parts():
    """Per global shard (4), per dtype: [3, 5] blocks from one seed; the
    int32 ones hold the all-ones pad pattern (-1) and int32 extremes."""
    import torch

    rng = np.random.default_rng(5)
    parts = {
        "uint8": [rng.integers(0, 60, (3, 5), dtype=np.uint8)
                  for _ in range(4)],
        "int32": [rng.integers(-9, 9, (3, 5)).astype(np.int32)
                  for _ in range(4)],
        "int64": [rng.integers(-2**60, 2**60, (3, 5), dtype=np.int64)
                  for _ in range(4)],
    }
    parts["int32"][1][0] = -1
    parts["int32"][2][1, :2] = (2**31 - 1, -2**31)
    parts["bool"] = [rng.integers(0, 2, (3, 5)).astype(bool)
                     for _ in range(4)]
    return {name: [torch.from_numpy(p) for p in ps]
            for name, ps in parts.items()}


def _collectives(m) -> dict:
    """The digests of every collective over mesh m (4 global shards), with
    another process's shards passed as None."""
    from kbo_tpu_torch.parallel import mesh as pmesh

    out = {}
    for name, parts in _collective_parts().items():
        ps = [p if i in m.local_shards else None for i, p in enumerate(parts)]
        ops = {"pmax": lambda: pmesh.pmax(m, ps)}
        if name != "bool":
            ops.update({
                "all_gather dim 0": lambda: pmesh.all_gather(m, ps, dim=0),
                "all_gather dim 1": lambda: pmesh.all_gather(m, ps, dim=1),
                "psum": lambda: pmesh.psum(m, ps),
            })
        for op, fn in ops.items():
            got = fn()
            assert got.device == m.first_local
            out[f"{op} {name}"] = _digest(got.numpy())
    return out


# -------------------------------------------------------------- the slice


def _routed(fn):
    from kbo_tpu_torch.utils.stats import get_stats, reset_stats

    reset_stats()
    out = fn()
    stats = get_stats().as_dict()
    return out, stats


def _straddle(model) -> dict:
    """A prepend-variant block that straddles the process boundary: the
    key table of a k = 5 index cut into 4 shards whose width puts two rows
    of one (k-1)-suffix on either side of the boundary between shards 1
    and 2 (the processes' halves); the membership of the four variants and
    the left extension of lanes around it, over the processes' shards
    (None for the other's), as digests."""
    import torch

    import kbo_tpu_torch
    from kbo_tpu_torch import engine
    from kbo_tpu_torch.kernels import refine
    from kbo_tpu_torch.parallel import mesh as pmesh

    k = 5
    rng = np.random.default_rng(7)
    seq = BASES[rng.integers(0, 4, 400)].tobytes()
    keys3 = engine.device_index(kbo_tpu_torch.build(
        [seq], kbo_tpu_torch.BuildOpts(k=k, build_select=True)), "cpu").keys3
    n = keys3.shape[1]
    suffix = refine.unpack_rows3(keys3, torch.arange(n, dtype=torch.int32),
                                 k)[:, 1:]
    # rows r, r + 1 with one suffix, r + 1 = 2 m: the boundary of shards 1, 2
    r = next(r for r in range(-(-n // 2) | 1, n - 1, 2)
             if torch.equal(suffix[r], suffix[r + 1]))
    m = (r + 1) // 2
    full = torch.full((keys3.shape[0], 4 * m), -1, dtype=torch.int32)
    full[:, :n] = keys3
    shards = [full[:, i * m : (i + 1) * m].clone()
              if i in model.local_shards else None for i in range(4)]
    sk = refine.ShardedKeys3(shards, m, pmesh.ProcessReduce(model))
    lanes = torch.arange(r - 3, r + 5, dtype=torch.int32)
    kmers = torch.cat([suffix[lanes.long()],
                       torch.ones((8, 1), dtype=torch.uint8)], dim=1)
    budgets = torch.full((8,), k, dtype=torch.int32)
    member = refine._extend_members_device(sk, kmers[:, : k - 1], k)
    exts = refine.left_extend_device(sk, kmers, budgets, k)
    single = (refine._extend_members_device(keys3, kmers[:, : k - 1], k),
              *refine.left_extend_device(keys3, kmers, budgets, k))
    return {"straddle members": int(member[:, 3].sum()),
            "straddle lane 3 length": int(exts[1][3]),
            "straddle": _digest(b"".join(x.numpy().tobytes()
                                         for x in (member, *exts))),
            "straddle single table": _digest(b"".join(
                x.numpy().tobytes() for x in single))}


def _slice(data, model, grid) -> dict:
    """Every sharded path over the data mesh, the model mesh and the 2-D
    grid: digests of the outputs, and the routes and counters of the run's
    stats."""
    from kbo_tpu_torch import CallOpts, api
    from kbo_tpu_torch.index.encode import encode_ascii
    from kbo_tpu_torch.ops.derandomize import random_match_threshold
    from kbo_tpu_torch.parallel import mesh as pmesh

    genome, index, mo, mo_rc = _case()
    contigs = _contigs(genome)
    out, runs = {}, {
        "call": lambda: repr(api.call(index, genome, CallOpts(
            sbwt_build_opts=mo.sbwt_build_opts), mesh=data)),
        "map_batch route 1": lambda: api.map_batch([genome], index, mo,
                                                   mesh=data),
        "map_batch route 2": lambda: api.map_batch(contigs, index, mo,
                                                   mesh=data),
        "map_batch route 3": lambda: api.map_batch(contigs[:3], index, mo_rc,
                                                   mesh=data),
        "matches_batch_index_sharded": lambda: [
            c.tobytes() for c in pmesh.matches_batch_index_sharded(
                index, [encode_ascii(c) for c in contigs],
                random_match_threshold(K, index.n_kmers, 4, 1e-7), model)],
        "map_batch_index_sharded": lambda: pmesh.map_batch_index_sharded(
            [genome], index, mo, model),
        "map_batch_2d_sharded": lambda: pmesh.map_batch_2d_sharded(
            contigs, index, mo, grid),
    }
    for name, fn in runs.items():
        got, stats = _routed(fn)
        if name == "call":
            assert "Variant" in got  # variants were called
        out[name] = _digest(repr(got))
        out[f"{name} stats"] = {
            key: v for key, v in stats.items()
            if key.startswith(("mesh_", "dist_", "left_ext_", "gaps_"))
            and not key.endswith("_s")}
    return out


# ---------------------------------------------------------------- the worker


def _worker(out_path: str) -> None:
    import torch
    import torch.distributed as dist

    from kbo_tpu_torch.parallel import distributed, mesh as pmesh

    torch.set_num_threads(2)
    assert distributed.initialize_from_env(), "expected two processes"
    data = pmesh.make_mesh(2, device="cpu")
    model = pmesh.make_mesh(2, axis="model", device="cpu")
    grid = pmesh.make_mesh((1, 2), axis=("data", "model"), device="cpu")
    assert data.devices.size == model.devices.size == 4
    assert grid.devices.shape == (2, 2) and grid.process_count == 2
    out = {"collectives": _collectives(data), **_straddle(model),
           **_slice(data, model, grid)}
    Path(out_path).write_text(json.dumps(out, sort_keys=True))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two processes' outputs and one process's over the same global
    shard counts (computed while the children run)."""
    import torch

    from kbo_tpu_torch.parallel import mesh as pmesh

    tmp = tmp_path_factory.mktemp("dist_mesh")
    port = _free_port()
    procs, outs = [], []
    for rank in range(2):
        outs.append(tmp / f"out_{rank}.json")
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=f"{ROOT}{os.pathsep}"
                   f"{os.environ.get('PYTHONPATH', '')}")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(outs[-1])], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    try:
        torch.set_num_threads(2)
        one = {"collectives": _collectives(pmesh.make_mesh(4, device="cpu")),
               **_slice(pmesh.make_mesh(4, device="cpu"),
                        pmesh.make_mesh(4, axis="model", device="cpu"),
                        pmesh.make_mesh((2, 2), axis=("data", "model"),
                                        device="cpu"))}
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, (stdout.decode()[-2000:]
                                       + stderr.decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads(o.read_text()) for o in outs], one


def _without_dist(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if not k.startswith("dist_")}


def test_collectives_equal_one_process_and_numpy(runs):
    """all_gather, psum and pmax across the two processes equal one
    process's over the same 4 shards, and numpy's."""
    (r0, r1), one = runs
    assert r0["collectives"] == r1["collectives"] == one["collectives"]
    assert len(one["collectives"]) == 4 * 3 + 1
    for name, parts in _collective_parts().items():
        a = [p.numpy() for p in parts]
        want = {"pmax": np.maximum.reduce(a)}
        if name != "bool":
            want.update({"all_gather dim 0": np.concatenate(a, axis=0),
                         "all_gather dim 1": np.concatenate(a, axis=1),
                         "psum": np.sum(a, axis=0, dtype=a[0].dtype)})
        for op, w in want.items():
            assert one["collectives"][f"{op} {name}"] == _digest(w)


@pytest.mark.parametrize("name,route", [
    ("call", None),
    ("map_batch route 1", "mesh_route_seq"),
    ("map_batch route 2", "mesh_route_data"),
    ("map_batch route 3", "mesh_route_classic"),
    ("matches_batch_index_sharded", None),
    ("map_batch_index_sharded", None),
    ("map_batch_2d_sharded", None),
])
def test_two_processes_equal_one(runs, name, route):
    """Each path's bytes in both processes equal one process's over the
    same global shard count; the routes and counters agree too (the 2-D
    map's extension counters sum: each process runs its own data row), and
    every path moved bytes between the processes."""
    (r0, r1), one = runs
    assert r0[name] == r1[name] == one[name]
    st0, st1, st = (r[f"{name} stats"] for r in (r0, r1, one))
    if name == "map_batch_2d_sharded":
        # each process extends its own data row's lanes: the sum is one
        # process's count over both rows
        for key in ("left_ext_rounds", "left_ext_lanes"):
            assert st0.pop(key) + st1.pop(key) == st.pop(key)
    assert _without_dist(st0) == _without_dist(st1) == _without_dist(st)
    assert st0["dist_bytes"] == st1["dist_bytes"] > 0 and st0["dist_calls"]
    assert "dist_bytes" not in st
    if route is not None:
        routes = {k for k in st if k.startswith("mesh_route")}
        assert routes == {route}
    if name == "map_batch_index_sharded":
        assert st["left_ext_rounds"] > 0 and st["gaps_filled"] > 0


def test_extension_across_the_process_boundary(runs):
    """The four prepend-variants of a suffix split over shards 1 and 2:
    each process's lower bound finds its half, the OR over the processes
    counts both, so lane 3 does not extend; equal to the single table."""
    (r0, r1), _ = runs
    for r in (r0, r1):
        assert r["straddle members"] >= 2 and r["straddle lane 3 length"] == 5
        assert r["straddle"] == r["straddle single table"]


# ---------------------------------------------------------- against kbo_tpu


@pytest.fixture(scope="module")
def j_case():
    import kbo_tpu

    genome, query = _pair()
    bo = kbo_tpu.BuildOpts(k=K, build_select=True)
    return genome, kbo_tpu.build([query], bo), kbo_tpu.MapOpts(
        sbwt_build_opts=bo)


@pytest.mark.parametrize("name", ["map_batch route 1",
                                  "map_batch_index_sharded",
                                  "map_batch_2d_sharded"])
def test_one_process_equals_kbo_tpu(runs, j_case, name):
    """One process's outputs over 4 shards equal kbo_tpu's functions of the
    same names over a 4-device JAX CPU mesh (one compile each)."""
    import jax
    from jax.sharding import Mesh as JMesh

    from kbo_tpu import api as japi
    from kbo_tpu.parallel import mesh as jmesh

    genome, j_idx, j_mo = j_case
    if name == "map_batch route 1":
        want = japi.map_batch([genome], j_idx, j_mo, mesh=jmesh.make_mesh(4))
    elif name == "map_batch_index_sharded":
        want = jmesh.map_batch_index_sharded([genome], j_idx, j_mo,
                                             jmesh.make_mesh(4, axis="model"))
    else:
        want = jmesh.map_batch_2d_sharded(
            _contigs(genome), j_idx, j_mo,
            JMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                  ("data", "model")))
    assert want is not None and runs[1][name] == _digest(repr(want))


# ----------------------------------------------------- each process's cards


@pytest.mark.parametrize("local_rank", [0, 1, 2])
def test_make_mesh_takes_its_own_cards(monkeypatch, local_rank):
    """With device=None or "cuda", local rank r takes cards r*n to
    (r+1)*n - 1 of 6 visible (n: the shards asked, by default the cards
    over LOCAL_WORLD_SIZE); a block past the visible cards raises; a named
    device still holds every shard."""
    import torch

    from kbo_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    cards = [torch.device("cuda", 2 * local_rank + i) for i in range(2)]
    assert list(pmesh.make_mesh().devices) == cards
    assert list(pmesh.make_mesh(2, device="cuda").devices) == cards
    m = pmesh.make_mesh((1, 2), axis=("data", "model"))
    assert list(m.devices.flat) == cards
    assert list(pmesh.make_mesh(1).devices) == [
        torch.device("cuda", local_rank)]
    with pytest.raises(ValueError, match=f"local rank {local_rank} takes"):
        pmesh.make_mesh(6 // (local_rank + 1) + 1)  # past cuda:5
    assert list(pmesh.make_mesh(2, device="cuda:0").devices) == [
        torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()


def test_model_group_never_spans_processes():
    """A hand-built 2-D mesh whose model group would span processes is
    refused; make_mesh stacks processes along the first axis."""
    import torch

    from kbo_tpu_torch.parallel import mesh as pmesh

    cpu = np.array([torch.device("cpu")] * 4, dtype=object)
    with pytest.raises(ValueError, match="split a model group"):
        pmesh.Mesh(cpu.reshape(1, 4), ("data", "model"), process_count=2)
    m = pmesh.Mesh(cpu.reshape(2, 2), ("data", "model"), process_count=2,
                   process_index=1)
    assert list(m.local_shards) == [2, 3] and m.first_local == cpu[2]


if __name__ == "__main__":
    _worker(sys.argv[1])
