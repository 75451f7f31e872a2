"""kbo-compatible command line interface: ``call``, ``find``, ``map``,
``build`` (counterpart of kbo_tpu/cli.py, with the same options and the same
output bytes).

The reference CLI lives in the separate kbo-cli repo; its output formats are
documented in the reference library's rustdoc and mirrored here:

- ``call`` -> VCF v4.4 records          (reference: src/lib.rs:70-98)
- ``find`` -> 13-column TSV             (reference: src/lib.rs:122-127)
- ``map``  -> fasta-style .aln          (reference: src/lib.rs:230-236)
- ``build``-> serialized index          (reference: src/lib.rs:48-50)

Strand handling for ``find`` follows the CLI convention: the query and its
reverse complement are both searched; reverse hits are reported with '-'
strand and coordinates mapped back to the forward query
(reference: src/lib.rs:160-163).

The commands run on the CUDA card. ``main`` and the ``cmd_*`` functions
take ``device`` as a Python keyword (``device="cpu"`` runs the kernels'
plain versions); the command line has no flag for it, as kbo_tpu's has
none. ``python -m kbo_tpu_torch <verb> ...`` runs :func:`main`.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

from kbo_tpu_torch import __version__
from kbo_tpu_torch.api import build, build_device, call, find_batch, map_batch
from kbo_tpu_torch.index.encode import revcomp_ascii
from kbo_tpu_torch.index.serialize import (
    load_index,
    load_sbwt,
    save_index,
    serialize_sbwt,
)
from kbo_tpu_torch.io.fastx import read_fastx
from kbo_tpu_torch.opts import BuildOpts, CallOpts, FindOpts, MapOpts
from kbo_tpu_torch.utils.stats import get_stats, profile_trace


def _build_opts(args, build_select=False) -> BuildOpts:
    return BuildOpts(
        k=args.kmer_size,
        add_revcomp=getattr(args, "add_revcomp", False),
        num_threads=getattr(args, "threads", 1),
        build_select=build_select,
        temp_dir=getattr(args, "temp_dir", None),
        mem_gb=getattr(args, "mem_gb", 4),
        dedup_batches=getattr(args, "dedup_batches", False),
    )


def _vcf_row(contig: str, ref_seq: bytes, v) -> str:
    """One VCF record from a Variant (positions in the user's reference;
    v.query_chars = reference-side chars, v.ref_chars = query-side chars --
    see the role inversion note in kbo_tpu_torch.api.call)."""
    ref_allele = v.query_chars.decode()
    alt_allele = v.ref_chars.decode()
    info = "."
    if len(ref_allele) != len(alt_allele):
        info = "INDEL"
        if v.query_pos > 0:
            # indel: anchor on the preceding reference base (VCF convention)
            anchor_pos = v.query_pos - 1
            anchor = chr(ref_seq[anchor_pos])
            ref_allele = anchor + ref_allele
            alt_allele = anchor + alt_allele
            pos = anchor_pos + 1
        else:
            # event at reference position 1: VCF v4.4 anchors on the base
            # AFTER the event instead (no preceding base exists)
            after_pos = len(ref_allele)  # first ref base past the event
            anchor = chr(ref_seq[after_pos]) if after_pos < len(ref_seq) else ""
            ref_allele = ref_allele + anchor
            alt_allele = alt_allele + anchor
            pos = 1
    else:
        pos = v.query_pos + 1
    return (
        f"{contig}\t{pos}\t.\t{ref_allele}\t{alt_allele}\t.\t.\t{info}\tGT\t1"
    )


def cmd_call(args, out=None, device=None):
    out = out or sys.stdout
    ref_records = read_fastx(args.reference)
    query_seqs = [seq for f in args.inputs for _, seq in read_fastx(f)]
    opts = CallOpts(
        max_error_prob=args.max_error_prob,
        sbwt_build_opts=_build_opts(args, build_select=True),
    )
    sbwt_query = build(query_seqs, opts.sbwt_build_opts)

    today = datetime.date.today().strftime("%Y%m%d")
    print("##fileformat=VCFv4.4", file=out)
    for name, seq in ref_records:
        contig = name.split()[0]
        print(f"##contig=<ID={contig},length={len(seq)}>", file=out)
    print(f"##fileDate={today}", file=out)
    print(f"##source=kbo-tpu v{__version__}", file=out)
    print(f"##reference={os.path.basename(args.reference)}", file=out)
    print("##phasing=none", file=out)
    print(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tunknown",
        file=out,
    )
    for name, seq in ref_records:
        contig = name.split()[0]
        for v in call(sbwt_query, seq, opts, device=device):
            print(_vcf_row(contig, seq, v), file=out)


def _find_rows(rles, strand: str, qlen: int):
    for rle in rles:
        if strand == "+":
            start, end = rle.start + 1, rle.end
        else:  # map reverse-complement coordinates back to the forward query
            start, end = qlen - rle.end + 1, qlen - rle.start
        yield rle, start, end


def cmd_find(args, out=None, device=None):
    """Find with per-(target, query-file) checkpointing.

    Queries are stateless, so failure recovery is batch-granular
    (SURVEY §5): with -o/--output, every completed (reference target,
    query file) pair is recorded in <output>.ckpt and --resume skips
    completed pairs, appending only missing results.
    """
    ckpt_path = f"{args.output}.ckpt" if args.output else None
    done: set[str] = set()
    resume_offset = None
    if args.output and args.resume and os.path.exists(ckpt_path):
        # ckpt lines: "<target>\t<query-file>\t<output byte offset after
        # the pair>"; the offset lets resume truncate away rows a crash
        # flushed mid-pair (they would otherwise duplicate on rerun)
        for line in open(ckpt_path).read().splitlines():
            parts = line.rsplit("\t", 1)
            if len(parts) == 2 and parts[1].isdigit():
                done.add(parts[0])
                resume_offset = int(parts[1])
            else:  # legacy entry without an offset
                done.add(line)
    if args.output:
        mode = "a" if args.resume and os.path.exists(args.output) else "w"
        if mode == "w" and ckpt_path and os.path.exists(ckpt_path):
            # a fresh run invalidates any previous checkpoint: stale
            # entries would make a later --resume skip pairs the
            # truncated output no longer contains
            os.remove(ckpt_path)
        out = open(args.output, mode)
        if mode == "a" and resume_offset is not None:
            out.truncate(resume_offset)
            out.seek(resume_offset)
        write_header = mode == "w"
    else:
        out = out or sys.stdout
        write_header = True

    ref_file = os.path.basename(args.index or args.reference)
    find_opts = FindOpts(
        max_error_prob=args.max_error_prob, max_gap_len=args.max_gap_len
    )

    if args.index:
        # prebuilt indexes are only usable with find (reference: src/lib.rs:48-50)
        loader = load_sbwt if os.path.exists(f"{args.index}.sbwt") else load_index
        targets = [(ref_file, loader(args.index), None)]
    else:
        ref_records = read_fastx(args.reference)
        if args.device_index:
            # one-shot path: ephemeral device-built index (no host SBWT
            # construction; sorts the sequence's window keys on device)
            def make_index(seqs, opts):
                return build_device(seqs, opts, device=device)
        else:
            make_index = build
        if args.detailed:
            targets = [
                (name, make_index([seq], _build_opts(args)), len(seq))
                for name, seq in ref_records
            ]
        else:
            targets = [
                (
                    ref_file,
                    make_index([s for _, s in ref_records], _build_opts(args)),
                    sum(len(s) for _, s in ref_records),
                )
            ]

    header = (
        "query\tref\tq.start\tq.end\tstrand\tlength\tmismatches\tgap_bases"
        "\tgap_opens\tidentity\tcoverage\tquery.contig\tref.contig"
    )
    if write_header:
        print(header, file=out)
    for target_name, index, ref_len in targets:
        for path in args.inputs:
            query_file = os.path.basename(path)
            key = f"{target_name}\t{query_file}"
            if key in done:
                continue
            query_records = read_fastx(path)
            # one fused device batch per (target, file): every query
            # contig, both strands
            batch = [
                seq
                for _, qseq in query_records
                for seq in (qseq, revcomp_ascii(qseq))
            ]
            rle_lists = find_batch(batch, index, find_opts, device=device)
            for qi, (qname, qseq) in enumerate(query_records):
                qlen = len(qseq)
                for si, strand in enumerate("+-"):
                    rles = rle_lists[2 * qi + si]
                    for rle, start, end in _find_rows(rles, strand, qlen):
                        length = rle.end - rle.start
                        aligned = rle.matches + rle.mismatches
                        identity = (
                            100.0 * rle.matches / length if length else 0.0
                        )
                        coverage = (
                            100.0 * aligned / ref_len if ref_len else 0.0
                        )
                        print(
                            f"{query_file}\t{ref_file}\t{start}\t{end}"
                            f"\t{strand}\t{length}\t{rle.mismatches}"
                            f"\t{rle.gap_bases}\t{rle.gap_opens}"
                            f"\t{identity:.2f}\t{coverage:.2f}"
                            f"\t{qname}\t{target_name}",
                            file=out,
                        )
            if ckpt_path:
                out.flush()
                with open(ckpt_path, "a") as ck:
                    print(f"{key}\t{out.tell()}", file=ck)
    if args.output:
        out.close()


def cmd_map(args, out=None, device=None):
    out = out or sys.stdout
    ref_records = read_fastx(args.reference)
    query_seqs = [seq for f in args.inputs for _, seq in read_fastx(f)]
    query_name = ",".join(os.path.basename(f) for f in args.inputs)
    opts = MapOpts(
        max_error_prob=args.max_error_prob,
        sbwt_build_opts=_build_opts(args, build_select=True),
    )
    sbwt_query = build(query_seqs, opts.sbwt_build_opts)
    print(f">{query_name}", file=out)
    refs = [seq for _, seq in ref_records]
    for aln in map_batch(refs, sbwt_query, opts, device=device):
        print(aln.decode(), file=out)


def cmd_build(args, out=None, device=None):
    out = out or sys.stdout
    seqs = [seq for f in args.inputs for _, seq in read_fastx(f)]
    opts = _build_opts(args, build_select=True)
    index = build(seqs, opts)
    if args.format == "sbwt":
        paths = serialize_sbwt(
            args.output, index, precalc_length=opts.prefix_precalc
        )
        path = " + ".join(paths)
    else:
        path = save_index(args.output, index)
    print(
        f"built index: k={index.k} n_kmers={index.n_kmers} "
        f"n_rows={index.n_rows} -> {path}",
        file=sys.stderr,
    )


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kbo-tpu",
        description="k-bounded matching statistics engine on a CUDA card "
        "(kbo-compatible operations)",
    )
    p.add_argument("--version", action="version", version=f"kbo-tpu {__version__}")
    p.add_argument(
        "--stats",
        action="store_true",
        help="print structured run statistics (JSON) to stderr on exit",
    )
    p.add_argument(
        "--profile-dir",
        help="write a torch.profiler trace of the run to this directory",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, reference_required=True):
        sp.add_argument("inputs", nargs="+", help="query FASTA/FASTQ file(s)")
        if reference_required:
            sp.add_argument("-r", "--reference", required=False, help="reference FASTA")
        sp.add_argument("-k", "--kmer-size", type=int, default=31)
        sp.add_argument("--max-error-prob", type=float, default=1e-7)
        sp.add_argument("-t", "--threads", type=int, default=1)

    sp = sub.add_parser("call", help="call variants vs a reference (VCF)")
    common(sp)
    sp.set_defaults(func=cmd_call)

    sp = sub.add_parser("find", help="locate alignment segments (TSV)")
    common(sp)
    sp.add_argument("--max-gap-len", type=int, default=0)
    sp.add_argument("--detailed", action="store_true")
    sp.add_argument("-i", "--index", help="prebuilt index prefix (.kbo.npz or .sbwt)")
    sp.add_argument("-o", "--output", help="write TSV to this file (enables --resume)")
    sp.add_argument(
        "--device-index",
        action="store_true",
        help="build an ephemeral device index (fast one-shot runs; "
        "skips host SBWT construction)",
    )
    sp.add_argument(
        "--resume",
        action="store_true",
        help="skip (reference, query-file) pairs recorded in <output>.ckpt",
    )
    sp.set_defaults(func=cmd_find)

    sp = sub.add_parser("map", help="reference-based alignment (.aln)")
    common(sp)
    sp.set_defaults(func=cmd_map)

    sp = sub.add_parser("build", help="build and serialize an index")
    common(sp, reference_required=False)
    sp.add_argument("-o", "--output", required=True, help="output prefix")
    sp.add_argument("--add-revcomp", action="store_true")
    sp.add_argument(
        "--temp-dir",
        help="disk-backed k-mer sorting in this directory "
        "(the reference's BitPackedKmerSorting)",
    )
    sp.add_argument("--mem-gb", dest="mem_gb", type=int, default=4)
    sp.add_argument("--dedup-batches", action="store_true")
    sp.add_argument(
        "--format",
        choices=("npz", "sbwt"),
        default="npz",
        help="npz checkpoint or the reference's .sbwt/.lcs file pair",
    )
    sp.set_defaults(func=cmd_build)
    return p


def main(argv=None, device=None):
    """Run one command line. ``device`` is where the commands run (None:
    the CUDA card; "cpu": the kernels' plain versions)."""
    args = make_parser().parse_args(argv)
    if args.command in ("call", "find", "map") and not getattr(args, "index", None):
        if not args.reference:
            sys.exit(f"error: {args.command} requires --reference")
    with profile_trace(args.profile_dir):
        args.func(args, device=device)
    if args.stats:
        print(get_stats().dump_json(), file=sys.stderr)


if __name__ == "__main__":
    main()
