"""Index serialization (counterpart of kbo_tpu/index/serialize.py: either
package loads the other's files).

Two on-disk forms:

- ``<prefix>.kbo.npz`` (:func:`save_index` / :func:`load_index`): the
  native checkpoint -- every array needed to reconstruct
  :class:`SbwtIndex`, including the LCS array and the packed join keys.

- ``<prefix>.sbwt`` + ``<prefix>.lcs`` (:func:`serialize_sbwt` /
  :func:`load_sbwt`): the reference's file-pair convention
  (reference: src/index.rs:128-151): a u64-LE length prefix + the variant
  name ``"SubsetMatrix"`` + the sbwt-crate index payload. The payload is
  the documented byte layout in :mod:`kbo_tpu_torch.index.sbwt_format` (subset
  matrix bitvectors + n_kmers/k + prefix lookup table, simple-sds word
  conventions); loading reconstructs the full index -- join keys, caps,
  row texts -- from the bitvectors alone. ``load_sbwt`` also still reads
  the legacy payload (a zip/npz after the header).

The ``.npz`` checkpoint is the system-of-record (SURVEY §5
"Checkpoint / resume"); the file pair is the interop surface for tooling
that expects ``kbo build``-style ``.sbwt``/``.lcs`` outputs.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from kbo_tpu_torch.index import sbwt_format
from kbo_tpu_torch.index.sbwt import SbwtIndex

_FORMAT_VERSION = 3


def save_index(prefix: str, index: SbwtIndex) -> str:
    """Write the index to ``<prefix>.kbo.npz``; returns the path."""
    path = f"{prefix}.kbo.npz"
    np.savez_compressed(
        path,
        format_version=np.int64(_FORMAT_VERSION),
        variant=np.frombuffer(b"SubsetMatrix", dtype=np.uint8),
        k=np.int64(index.k),
        n_rows=np.int64(index.n_rows),
        n_kmers=np.int64(index.n_kmers),
        bits=index.bits,
        cum=index.cum,
        C=index.C,
        lcs=index.lcs,
        keys2=index.keys2,
        cap2=index.cap2,
        keys3=index.keys3,
        row_pos=index.row_pos,
        text=index.text,
        text_is_access=np.bool_(index.text_is_access),
    )
    return path


def load_index(prefix: str) -> SbwtIndex:
    """Load an index written by :func:`save_index` (accepts the full path or
    the prefix)."""
    path = prefix if prefix.endswith(".npz") else f"{prefix}.kbo.npz"
    with np.load(path) as data:
        assert int(data["format_version"]) == _FORMAT_VERSION
        assert bytes(data["variant"].tobytes()) == b"SubsetMatrix"
        index = SbwtIndex(
            k=int(data["k"]),
            n_rows=int(data["n_rows"]),
            n_kmers=int(data["n_kmers"]),
            bits=data["bits"],
            cum=data["cum"],
            C=data["C"],
            lcs=data["lcs"],
            keys2=data["keys2"],
            cap2=data["cap2"],
            keys3=data["keys3"],
            row_pos=data["row_pos"],
            text=data["text"],
            # a .sbwt-loaded index round-tripped through the checkpoint
            # carries per-row access chunks, not a construction buffer
            text_is_access=bool(data.get("text_is_access", False)),
        )
        return index


_VARIANT = b"SubsetMatrix"


def serialize_sbwt(
    prefix: str, index: SbwtIndex, precalc_length: int = 8
) -> tuple[str, str]:
    """Write ``<prefix>.sbwt`` + ``<prefix>.lcs`` (reference file-pair
    convention, src/index.rs:128-151) in the documented sbwt-crate byte
    layout; returns both paths. ``precalc_length`` sizes the emitted
    prefix lookup table (BuildOpts.prefix_precalc)."""
    return sbwt_format.write_kbo_sbwt(
        prefix, index, precalc_length=precalc_length
    )


def load_sbwt(prefix: str) -> SbwtIndex:
    """Load a ``.sbwt``/``.lcs`` pair (reference: src/index.rs:195-212).

    Reads the documented sbwt-crate byte layout and reconstructs the full
    index from the bitvectors; falls back to the legacy payload
    (npz after the header) for old files.
    """
    with open(f"{prefix}.sbwt", "rb") as fh:
        (name_len,) = struct.unpack("<Q", fh.read(8))
        variant = fh.read(name_len)
        if variant != _VARIANT:
            raise ValueError(
                f"unsupported SBWT variant {variant!r} (expected {_VARIANT!r})"
            )
        head = fh.read(4)
    if head[:2] != b"PK":  # zip magic = legacy npz payload
        return sbwt_format.read_kbo_sbwt(prefix)
    with open(f"{prefix}.sbwt", "rb") as fh:
        fh.seek(8 + name_len)
        data = np.load(io.BytesIO(fh.read()))
    with open(f"{prefix}.lcs", "rb") as fh:
        (lcs_len,) = struct.unpack("<Q", fh.read(8))
        lcs = np.frombuffer(fh.read(lcs_len), dtype=np.uint8).copy()
    assert int(data["format_version"]) == _FORMAT_VERSION
    return SbwtIndex(
        k=int(data["k"]),
        n_rows=int(data["n_rows"]),
        n_kmers=int(data["n_kmers"]),
        bits=data["bits"],
        cum=data["cum"],
        C=data["C"],
        lcs=lcs,
        keys2=data["keys2"],
        cap2=data["cap2"],
        keys3=data["keys3"],
        row_pos=data["row_pos"],
        text=data["text"],
    )
