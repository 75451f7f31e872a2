"""Option dataclasses mirroring the reference's ``*Opts`` structs.

Field names and defaults follow the reference exactly so that configurations
translate 1:1 (reference: src/lib.rs:259-313 BuildOpts, :318-353 CallOpts,
:358-382 FindOpts, :387-407 MatchOpts, :412-466 MapOpts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class BuildOpts:
    """Options for SBWT index construction (reference: src/lib.rs:259-313).

    Semantics in this framework:

    - ``num_threads``: parallelizes the colex sort (last-character bucket
      partition, concurrent numpy sorts -- see index/build.py).
    - ``build_select``: accepted for compatibility; select/access support is
      inherent in the packed-bitvector layout, so nothing extra is built.
    - ``prefix_precalc``: accepted; the sort-join engine has no prefix
      lookup table to precompute (it replaces interval extension entirely),
      so the value is unused by design.
    - ``mem_gb``, ``dedup_batches``, ``temp_dir``: the reference's
      external-memory sorting knobs (src/index.rs:64-81). Setting
      ``temp_dir`` switches construction to the disk-backed bucketed
      k-mer sort (index/build.build_index_from_segments_disk):
      ``mem_gb`` bounds the pass-1 packing working set and
      ``dedup_batches`` deduplicates each chunk before it is written,
      mirroring ``BitPackedKmerSorting``. Without ``temp_dir`` the
      build is one vectorized in-memory sort and the other two knobs
      are unused (the ``BitPackedKmerSortingMem`` analogue).
    """

    k: int = 31
    add_revcomp: bool = False
    num_threads: int = 1
    prefix_precalc: int = 8
    build_select: bool = False
    mem_gb: int = 4
    dedup_batches: bool = False
    temp_dir: Optional[str] = None


@dataclasses.dataclass
class CallOpts:
    """Options for :func:`kbo_tpu_torch.call` (reference: src/lib.rs:318-353)."""

    max_error_prob: float = 1e-7
    sbwt_build_opts: BuildOpts = dataclasses.field(
        default_factory=lambda: BuildOpts(build_select=True)
    )


@dataclasses.dataclass
class FindOpts:
    """Options for :func:`kbo_tpu_torch.find` (reference: src/lib.rs:358-382)."""

    max_error_prob: float = 1e-7
    max_gap_len: int = 0


@dataclasses.dataclass
class MatchOpts:
    """Options for :func:`kbo_tpu_torch.matches` (reference: src/lib.rs:387-407)."""

    max_error_prob: float = 1e-7


@dataclasses.dataclass
class MapOpts:
    """Options for :func:`kbo_tpu_torch.map_` (reference: src/lib.rs:412-466)."""

    max_error_prob: float = 1e-7
    fill_gaps: bool = True
    call_variants: bool = True
    format: bool = True
    sbwt_build_opts: BuildOpts = dataclasses.field(
        default_factory=lambda: BuildOpts(build_select=True)
    )
