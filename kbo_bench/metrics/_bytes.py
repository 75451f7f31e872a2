"""The least bytes a request's work must move through device memory, from
the request's own sizes (never from which kernels ran).

- the indexed bases, read once (one byte a base);
- one key row per indexed position (both strands with ``revcomp``), written
  once when the index is built and read once when the stream joins it; a
  row holds k bases at two bits each, ``ceil(2k / 8)`` bytes;
- the streamed bases, read once, and one output byte written per streamed
  position (its translated character or MS value).

A request against an index that stands from set-up (``screen_bytes``)
counts no build: its key rows are read once and the indexed bases not at
all.
"""

from __future__ import annotations


def key_bytes(k: int) -> int:
    return (2 * k + 7) // 8


def request_bytes(k: int, indexed: list[int], revcomp: bool,
                  streamed: list[int]) -> int:
    a = sum(indexed)
    rows = a * (2 if revcomp else 1)
    s = sum(streamed)
    return a + 2 * rows * key_bytes(k) + 2 * s


def screen_bytes(k: int, index_positions: int, revcomp: bool,
                 streamed: list[int]) -> int:
    rows = index_positions * (2 if revcomp else 1)
    return rows * key_bytes(k) + 2 * sum(streamed)
