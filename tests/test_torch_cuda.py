"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so without a card these
skip. Run them on a GPU machine with

    python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import kbo_tpu_torch
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.kernels.join import clamp_scan, clamp_scan_plain
from kbo_tpu_torch.kernels.sort import (
    _radix_sort,
    merge_path,
    merge_path_plain,
    to_i32,
)

pytestmark = pytest.mark.cuda

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_words(rng, W, n, top, device, pad_share=0.0):
    raw = rng.integers(0, 9, (W, n)).astype(np.int64) * (top // 8)
    raw[:, rng.random(n) < pad_share] = 0xFFFFFFFF
    words, _ = _radix_sort(to_i32(torch.from_numpy(raw)).to(device))
    return words


@pytest.mark.parametrize("na,nb", [(5000, 7000), (1, 3000), (2048 * 5, 0)])
def test_merge_path_kernel(cuda, na, nb):
    rng = np.random.default_rng(na + nb)
    a = _sorted_words(rng, 4, na, 0xFFFFFFFF, cuda)
    b = _sorted_words(rng, 4, nb, 0xFFFFFFFF, cuda)
    ap = torch.arange(na, dtype=torch.int32, device=cuda)
    bp = torch.arange(na, na + nb, dtype=torch.int32, device=cuda)
    got = merge_path(a, ap, b, bp)
    want = merge_path_plain(a, ap, b, bp)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bits,reverse", [(2, False), (2, True), (3, False),
                                          (3, True)])
def test_clamp_scan_kernel(cuda, bits, reverse):
    rng = np.random.default_rng(bits * 2 + reverse)
    M, W = 50_000, 4
    top = 0xFFFFFFFF if bits == 2 else 0x3FFFFFFF
    words = _sorted_words(rng, W, M, top, cuda, pad_share=0.02)
    per = 16 if bits == 2 else 10
    cap = torch.from_numpy(np.where(
        rng.random(M) < 0.4, rng.integers(0, W * per + 1, M), -1
    ).astype(np.int32)).to(cuda)
    got = clamp_scan(words, cap, bits, reverse)
    want = clamp_scan_plain(words, cap, bits, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_find_batch_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(5)
    genome = BASES[rng.integers(0, 4, 20_000)].tobytes()
    idx = kbo_tpu_torch.build([genome], kbo_tpu_torch.BuildOpts(k=31))
    queries = []
    for s in rng.integers(0, 19_000, 16):
        q = bytearray(genome[s : s + 900])
        for p in rng.integers(0, len(q), 5):
            q[p] = BASES[rng.integers(0, 4)]
        queries.append(bytes(q))
    merge_path.launches = clamp_scan.launches = 0
    got = kbo_tpu_torch.find_batch(queries, idx, device=cuda)
    assert merge_path.launches == 1 and clamp_scan.launches == 2
    assert got == kbo_tpu_torch.find_batch(queries, idx, device="cpu")
    one = kbo_tpu_torch.matches(queries[0], idx, device=cuda)
    assert one == kbo_tpu_torch.matches(queries[0], idx, device="cpu")
    assert encode_ascii(queries[0]).size == len(one)
