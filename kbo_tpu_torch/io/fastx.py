"""FASTA/FASTQ reading with transparent gzip support (counterpart of
kbo_tpu/io/fastx.py).

The reference reads inputs via needletail, a native parser, and supports
DEFLATE compression (reference: src/lib.rs:52-54); so does this module:
plain or gzip FASTA/FASTQ sniffed from the first bytes, inflated here and
scanned in one pass by the native scanner of the port's host library
(native_src/fastx.cpp through kbo_tpu_torch.native). The pure-Python parser
:func:`read_fastx_py` is its plain version, the tests' oracle; nothing
falls back to it.
"""

from __future__ import annotations

import gzip
import io
import pathlib

from kbo_tpu_torch import native


def _open(path):
    raw = open(path, "rb")
    magic = raw.read(2)
    raw.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=raw))
    return raw


def _read_raw(path) -> bytes:
    """Whole file, gunzipped if needed (the native scanner wants a flat
    buffer; bacterial-scale inputs are tens of MB)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data


def _sniff(data: bytes, path) -> bytes:
    """First significant byte decides the format (leading blank lines are
    tolerated, as the reference's needletail parser does)."""
    first = data[:1]
    if first not in (b">", b"@"):
        raise ValueError(f"{path}: not a FASTA/FASTQ file")
    return first


def read_fastx(path) -> list[tuple[str, bytes]]:
    """Parse a FASTA or FASTQ file -> [(record name, sequence bytes)], with
    the native scanner."""
    path = pathlib.Path(path)
    data = _read_raw(path)
    first = _sniff(data.lstrip(), path)
    if first == b"@":
        # the FASTA scanner tolerates leading blank lines; the FASTQ one
        # treats them as separators, so both read the stripped view
        data = data.lstrip()
    try:
        return native.scan_fastx(data, fastq=first == b"@")
    except ValueError:
        raise ValueError(f"malformed FASTA/FASTQ record in {path}") from None


def read_fastx_py(path) -> list[tuple[str, bytes]]:
    """Pure-Python parser: the native scanner's plain version and the
    tests' oracle."""
    path = pathlib.Path(path)
    records: list[tuple[str, bytes]] = []
    with _open(path) as fh:
        head = fh.read()
        first = _sniff(head.lstrip(), path)
        fh = io.BytesIO(head.lstrip() if first == b"@" else head)
        if first == b">":
            name = None
            chunks: list[bytes] = []
            for line in fh:
                line = line.rstrip()
                if line.startswith(b">"):
                    if name is not None:
                        records.append((name, b"".join(chunks)))
                    name = line[1:].decode(errors="replace")
                    chunks = []
                elif line:
                    chunks.append(line)
            if name is not None:
                records.append((name, b"".join(chunks)))
        elif first == b"@":
            while True:
                header = fh.readline()
                while header and not header.strip():
                    header = fh.readline()  # skip blank separator lines
                if not header:
                    break
                seq = fh.readline().rstrip()
                plus = fh.readline()
                qual = fh.readline()
                if not header.startswith(b"@") or not plus.startswith(b"+"):
                    raise ValueError(f"malformed FASTQ record in {path}")
                records.append((header[1:].rstrip().decode(errors="replace"), bytes(seq)))
                if not qual:
                    break
        else:
            raise ValueError(f"{path}: not a FASTA/FASTQ file")
    return records
