"""Top-level API of the port: build, matches, find, find_batch
(counterpart of kbo_tpu/api.py; reference: src/lib.rs:501-506 build,
:612-628 matches, :808-821 find).

Every query runs on ``device`` -- the CUDA card when it is None; pass
``device="cpu"`` to run the kernels' plain versions on the CPU.
"""

from __future__ import annotations

from kbo_tpu_torch import engine, pipeline
from kbo_tpu_torch.index.build import build_sbwt_from_seqs
from kbo_tpu_torch.index.encode import encode_ascii
from kbo_tpu_torch.index.sbwt import SbwtIndex
from kbo_tpu_torch.ops import derandomize, format as fmt, translate
from kbo_tpu_torch.opts import BuildOpts, FindOpts, MatchOpts
from kbo_tpu_torch.utils.stats import stage


def build(seq_data, build_opts: BuildOpts | None = None) -> SbwtIndex:
    """Build an SBWT index (+ LCS) from sequences on the host
    (reference: src/lib.rs:501-506)."""
    return build_sbwt_from_seqs(seq_data, build_opts or BuildOpts())


def matches(query_seq: bytes, sbwt: SbwtIndex,
            match_opts: MatchOpts | None = None, device=None) -> list[str]:
    """Translated alignment characters of a query against an index
    (reference: src/lib.rs:612-628): MS on the device, then the host
    derandomize/translate oracles."""
    opts = match_opts or MatchOpts()
    k = sbwt.k
    threshold = derandomize.random_match_threshold(
        k, sbwt.n_kmers, 4, opts.max_error_prob
    )
    with stage("matches", bases=len(query_seq)):
        noisy_ms = engine.compute_ms_values(
            sbwt, encode_ascii(bytes(query_seq)), device
        )
        derand_ms = derandomize.derandomize_ms_vec(noisy_ms, k, threshold)
        return translate.translate_ms_vec(derand_ms, k, threshold)


def find(query_seq: bytes, sbwt: SbwtIndex,
         find_opts: FindOpts | None = None, device=None) -> list[fmt.RLE]:
    """Local alignment segments of a query within the index
    (reference: src/lib.rs:808-821)."""
    opts = find_opts or FindOpts()
    aln = matches(
        query_seq, sbwt, MatchOpts(max_error_prob=opts.max_error_prob), device
    )
    if opts.max_gap_len > 0:
        return fmt.run_lengths_gapped(aln, opts.max_gap_len)
    return fmt.run_lengths(aln)


def find_batch(query_seqs: list[bytes], sbwt, find_opts: FindOpts | None = None,
               mesh=None, device=None) -> list[list[fmt.RLE]]:
    """Batched :func:`find`: all queries go through one device pipeline,
    with segments extracted on the device at ``max_gap_len == 0``."""
    opts = find_opts or FindOpts()
    if mesh is not None:
        raise NotImplementedError(
            "find_batch over a mesh: the multi-GPU layer is ROADMAP "
            "Queue 1 item 8"
        )
    if not isinstance(sbwt, SbwtIndex):
        raise NotImplementedError(
            "find_batch against a device-built index (DeviceSeqIndex): "
            "ROADMAP Queue 1 item 6"
        )
    if not query_seqs:
        return []
    threshold = derandomize.random_match_threshold(
        sbwt.k, sbwt.n_kmers, 4, opts.max_error_prob
    )
    code_list = [encode_ascii(bytes(q)) for q in query_seqs]
    total = sum(c.size for c in code_list)
    with stage("find_batch", bases=total):
        if opts.max_gap_len == 0:
            return pipeline.find_rle_batch(sbwt, code_list, threshold, device)
        chars_list = pipeline.matches_batch(sbwt, code_list, threshold, device)
    return [
        fmt.run_lengths_gapped([chr(c) for c in chars], opts.max_gap_len)
        for chars in chars_list
    ]
