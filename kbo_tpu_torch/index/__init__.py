"""SBWT index: data structure and host construction."""

from kbo_tpu_torch.index.sbwt import SbwtIndex, index_from_arrays
from kbo_tpu_torch.index.build import build_sbwt_from_seqs

__all__ = ["SbwtIndex", "build_sbwt_from_seqs", "index_from_arrays"]
