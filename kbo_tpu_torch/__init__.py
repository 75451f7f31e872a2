"""kbo_tpu_torch: the PyTorch/CUDA port of kbo_tpu for NVIDIA Hopper.

A second package beside ``kbo_tpu`` (the JAX reference, which it never
imports). Matching statistics come from the same sorted k-mer join: pack
colex window keys -> radix-sort the query side -> merge with the presorted
index table (hand-written CUDA merge-path kernel) -> clamped-LCP scans
(hand-written CUDA scan kernel) -> sort back to position order. The kernels
build from ``kernels/csrc`` at first use; on CPU tensors every kernel runs
its plain PyTorch version.

This slice serves :func:`build` -> :func:`find` / :func:`find_batch` /
:func:`matches` on one device; ``device=None`` means the CUDA card.
"""

from kbo_tpu_torch.opts import BuildOpts, FindOpts, MatchOpts
from kbo_tpu_torch.api import build, find, find_batch, matches
from kbo_tpu_torch.ops.format import RLE

__all__ = [
    "BuildOpts",
    "FindOpts",
    "MatchOpts",
    "RLE",
    "build",
    "find",
    "find_batch",
    "matches",
]
