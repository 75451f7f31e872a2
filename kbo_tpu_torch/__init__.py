"""kbo_tpu_torch: the PyTorch/CUDA port of kbo_tpu for NVIDIA Hopper.

A second package beside ``kbo_tpu`` (the JAX reference, which it never
imports). Matching statistics come from the same sorted k-mer join: pack
colex window keys -> radix-sort the query side -> merge with the presorted
index table (hand-written CUDA merge-path kernel) -> clamped-LCP scans
(hand-written CUDA scan kernel) -> sort back to position order. The kernels
build from ``kernels/csrc`` at first use; on CPU tensors every kernel runs
its plain PyTorch version.

Served so far, on one device: :func:`build` -> :func:`find` /
:func:`find_batch` / :func:`matches`; :func:`map_` / :func:`map_batch`
with the default ``MapOpts()`` (the 3-bit rows sweep, a hand-written CUDA
derandomize+translate kernel, candidate tables, device gap scoring and
variant resolution, delta-run assembly); :func:`call` (drop scan, sparse
interval probes, the index-free join against the reference sequence);
``api.build_device``'s sequence index for :func:`find_batch` and its full
index for every entry point; and the command line (``python -m
kbo_tpu_torch``, :mod:`kbo_tpu_torch.cli`). ``device=None`` means the CUDA
card. :func:`find_batch`, :func:`call` and :func:`map_batch` also run over
a ``data`` mesh of devices (:mod:`kbo_tpu_torch.parallel.mesh`).
"""

__version__ = "0.1.0"

from kbo_tpu_torch.opts import BuildOpts, CallOpts, FindOpts, MapOpts, MatchOpts
from kbo_tpu_torch.api import (
    build,
    call,
    find,
    find_batch,
    map_,
    map_batch,
    matches,
)
from kbo_tpu_torch.ops.format import RLE
from kbo_tpu_torch.refine.variant_calling import Variant

__all__ = [
    "BuildOpts",
    "CallOpts",
    "FindOpts",
    "MapOpts",
    "MatchOpts",
    "RLE",
    "Variant",
    "build",
    "call",
    "find",
    "find_batch",
    "map_",
    "map_batch",
    "matches",
]
