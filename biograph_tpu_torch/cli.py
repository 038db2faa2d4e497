"""Command-line interface of the port: ``version``, ``create``, ``kmers`` and
``merge``.

Counterpart of ``biograph_tpu/cli.py`` (the reference's command surface,
modules/biograph/main.cpp:51-70): the same subcommands take the same
arguments and write the same artifacts, plus ``--device`` (default
``cuda``; the tests pass ``cpu``).  The JAX package's other subcommands
wait for the modules they call, and BAM/SAM, CRAM and QSEQ input waits for
``io/bam.py``, ``io/cram.py`` and ``io/qseq.py``.

Stage timings are read after the device has finished the stage.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from biograph_tpu_torch import resolve_device, version

BIOGRAPH_VERSION = "biograph_tpu_torch-0.1"
_NOT_PORTED = ((".bam", "io/bam.py"), (".sam", "io/bam.py"), (".cram", "io/cram.py"), (".qseq", "io/qseq.py"))


def _fence(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_inputs(paths):
    for p in paths:
        stem = p.split(".gz")[0].split(".bz2")[0]
        for suffix, module in _NOT_PORTED:
            if stem.endswith(suffix):
                raise NotImplementedError(f"{p}: {suffix[1:].upper()} input needs {module}, which is not ported yet")


def cmd_create(args):
    """reads -> .bgt dir (seqset + readmap + metadata + qc).
    (reference: bgbinary create, modules/biograph/biograph_create.cpp)"""
    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.build.seqset_build import build_seqset
    from biograph_tpu_torch.io.fastq import cut_reads, pad_batches, read_fastq, sample_mask, subset_batch
    from biograph_tpu_torch.kmers.count import count_kmers
    from biograph_tpu_torch.runtime.log import LOG, Progress
    from biograph_tpu_torch.runtime.resources import MemoryBudget
    from biograph_tpu_torch.tools.qc import write_kmer_quality_report

    dev = resolve_device(args.device)
    _check_inputs(args.reads)
    t_start = time.time()
    timings = {}
    os.makedirs(os.path.join(args.out, "qc"), exist_ok=True)
    LOG.tee_to(os.path.join(args.out, "qc", "create_log.txt"))
    progress = Progress(label="create")

    mate_of = None
    t0 = time.time()
    batches = [read_fastq(p, spill_dir=args.spill_dir) for p in args.reads]
    batch = batches[0] if len(batches) == 1 else pad_batches(batches)
    timings["import"] = time.time() - t0
    LOG.info(f"import: {batch.num_reads} reads x <={batch.max_len}bp")

    if args.paired:
        # interleaved pairing: read 2i <-> 2i+1 (reference read_importer
        # pair association, build_seqset/read_importer.h:43-48)
        R = batch.num_reads
        mate_of = np.arange(R, dtype=np.int64)
        mate_of[0::2] += 1
        mate_of[1::2] -= 1
        if R % 2:
            mate_of[-1] = -1

    if args.cut_reads:
        lo, _, hi = args.cut_reads.partition("-")
        batch = cut_reads(batch, int(lo), int(hi))
        LOG.info(f"cut_reads: kept bases {lo}-{hi}")
    if args.sample_reads:
        # sampling runs after pairing so mates of dropped reads just become
        # unpaired, matching import-time sampling (biograph_create.cpp:125)
        keep = sample_mask(batch.num_reads, args.sample_reads)
        remap = np.full(batch.num_reads, -1, np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        batch = subset_batch(batch, keep)
        if mate_of is not None:
            mate_of = np.where(mate_of >= 0, remap[mate_of], -1)[keep]
        LOG.info(f"sample_reads: kept {batch.num_reads} reads")

    with progress.stage("kmerize"):
        kc = count_kmers(batch.codes, batch.lengths, k=args.kmer_size, device=dev)
    timings["kmerize"] = progress.timings["kmerize"]
    LOG.info(f"kmerize: {len(kc.kmers)} distinct canonical {args.kmer_size}-mers")

    codes, lengths = batch.codes, batch.lengths
    n_corrected = 0
    if args.correct:
        from biograph_tpu_torch.build.correct import correct_reads
        from biograph_tpu_torch.kmers.kmer_set import KmerSet

        t0 = time.time()
        kstats = {}
        ks = KmerSet.from_counts(
            kc,
            min_count=args.min_kmer_count,
            stats_out=kstats,
            device=dev,
            skew_cutoff=args.skew_cutoff,
            overrep_threshold=args.overrep_threshold,
            sys_err_thresh=args.sys_err_thresh,
            rnd_err_thresh=args.rnd_err_thresh,
        )
        if kstats.get("SKEWED") or kstats.get("NEAR_OVERREP"):
            LOG.info("kmer filter: " + " ".join(f"{k}={v}" for k, v in sorted(kstats.items())))
        res = correct_reads(
            ks,
            codes,
            lengths,
            max_corrections=args.max_corrections,
            min_good_run=args.min_good_run,
        )
        # dropped reads keep zero length; they fall out of the suffix set
        codes, lengths = res.codes, res.lengths
        n_corrected = int((res.corrections > 0).sum())
        timings["read_correction"] = time.time() - t0
        LOG.info(f"read_correction: {n_corrected} corrected, {int((res.lengths == 0).sum())} dropped")

    # drop zero-length (uncorrectable) reads, remapping mate indices
    if (lengths == 0).any():
        keep = lengths > 0
        remap = np.full(len(lengths), -1, np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        codes, lengths = codes[keep], lengths[keep]
        if mate_of is not None:
            mate_of = np.where(mate_of >= 0, remap[mate_of], -1)[keep]

    with progress.stage("seqset"):
        ss = build_seqset(codes, lengths, budget=MemoryBudget.detect(dev), device=dev)
        _fence(dev)
    timings["seqset"] = progress.timings["seqset"]
    LOG.info(f"seqset: {ss.n_entries} entries ({timings['seqset']:.1f}s)")
    ss.save(os.path.join(args.out, "seqset"))

    with progress.stage("readmap"):
        rm = build_readmap(ss, codes, lengths, mate_of, device=dev)
        _fence(dev)
    timings["readmap"] = progress.timings["readmap"]
    rm.save(os.path.join(args.out, "readmap"))
    LOG.info(f"readmap: {rm.num_entries} entries ({timings['readmap']:.1f}s)")

    meta = {
        "biograph_version": BIOGRAPH_VERSION,
        "num_reads": int(batch.num_reads),
        "num_seqset_entries": int(ss.n_entries),
        "kmer_size": args.kmer_size,
        "paired": bool(args.paired),
        "accession_id": os.path.basename(args.out.rstrip("/")),
    }
    with open(os.path.join(args.out, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)
    kq = write_kmer_quality_report(
        os.path.join(args.out, "qc", "kmer_quality_report.html"), kc.total, args.kmer_size
    )
    progress.add("num_reads", int(batch.num_reads))
    progress.add("num_corrected", int(n_corrected))
    progress.add("num_seqset_entries", int(ss.n_entries))
    qc = {
        "timings": timings,
        "total_s": time.time() - t_start,
        "kmer_quality": kq,
        **progress.stats_dict(),  # per-stage wall/cpu + counters
    }
    with open(os.path.join(args.out, "qc", "create_stats.json"), "w") as f:
        json.dump(qc, f, indent=1)
    LOG.info(f"create: done in {qc['total_s']:.1f}s -> {args.out}")
    LOG.close()


def cmd_kmers(args):
    """reads -> kmer count text (reference: kmerize_reads + kmer_count
    exporter, golden/kmer_count.txt format)."""
    from biograph_tpu_torch.io.fastq import read_fastq
    from biograph_tpu_torch.kmers.count import count_kmers

    dev = resolve_device(args.device)
    _check_inputs([args.reads])
    batch = read_fastq(args.reads)
    kc = count_kmers(batch.codes, batch.lengths, k=args.kmer_size, device=dev)
    kc.write_text(args.out)
    print(f"kmers: {len(kc.kmers)} -> {args.out}")


def cmd_merge(args):
    """Merge sample .bgt dirs into one merged seqset + migrated readmaps.
    (reference: bgbinary merge, modules/biograph/biograph_merge.cpp:33)"""
    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.build.merge import merge_seqsets, migrate_readmap

    t0 = time.time()
    samples = [BioGraph(p, device=args.device) for p in args.biographs]
    merged, mergemaps = merge_seqsets([s.seqset for s in samples])
    os.makedirs(args.out, exist_ok=True)
    merged.save(os.path.join(args.out, "seqset"))
    names = []
    for s, mm in zip(samples, mergemaps):
        name = s.metadata.get("accession_id") or os.path.basename(s.path.rstrip("/"))
        names.append(name)
        if s.readmap is not None:
            migrate_readmap(s.readmap, merged, mm).save(os.path.join(args.out, f"readmap_{name}"))
    with open(os.path.join(args.out, "metadata.json"), "w") as f:
        json.dump(
            {
                "biograph_version": BIOGRAPH_VERSION,
                "merged_samples": names,
                "num_seqset_entries": int(merged.n_entries),
            },
            f,
            indent=1,
        )
    print(f"merge: {len(samples)} samples -> {merged.n_entries} entries ({time.time()-t0:.1f}s) -> {args.out}")


def _device_arg(p):
    p.add_argument("--device", default="cuda", help="torch device to run on (default cuda; cpu on the host)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="biograph_tpu_torch", description="BioGraph-class engine on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    pver = sub.add_parser("version", help="print the package version")
    pver.set_defaults(fn=lambda a: print(f"biograph_tpu_torch version {version()}"))

    pc = sub.add_parser("create", help="reads -> seqset+readmap (.bgt)")
    pc.add_argument("--reads", nargs="+", required=True, help="FASTQ(.gz) input")
    pc.add_argument("--ref", help="reference (for CRAM input, which needs io/cram.py)")
    pc.add_argument("--out", required=True)
    pc.add_argument("--kmer-size", type=int, default=23)
    pc.add_argument("--paired", action="store_true")
    pc.add_argument("--correct", action="store_true", help="error-correct reads against the trusted k-mer set")
    pc.add_argument("--min-kmer-count", type=int, default=2)
    pc.add_argument("--max-corrections", type=int, default=8)
    pc.add_argument("--min-good-run", type=int, default=2)
    pc.add_argument(
        "--overrep-threshold",
        type=int,
        default=0,
        help="occurrences before overrepresentation filtering kicks in; 0 disables (biograph_create.cpp:309)",
    )
    pc.add_argument("--sys-err-thresh", type=float, default=0.1, help="systematic error threshold for overrep filtering")
    pc.add_argument("--rnd-err-thresh", type=float, default=0.005, help="random error threshold for overrep filtering")
    pc.add_argument("--skew-cutoff", type=float, default=0.0, help="fwd/rev strand-skew filter cutoff (0 disables)")
    pc.add_argument(
        "--spill-dir",
        help="spill imported reads to disk memmaps (bounded host RAM; the seqset build streams them "
        "to the device when its plan needs passes)",
    )
    pc.add_argument(
        "--sample-reads",
        type=float,
        default=0.0,
        help="if non-zero, keep this portion of the input reads (e.g. 0.25 keeps 1 in 4; biograph_create.cpp:316)",
    )
    pc.add_argument(
        "--cut-reads",
        help="START-END: keep only these bases of each read, 1-based inclusive (biograph_create.cpp:319)",
    )
    _device_arg(pc)
    pc.set_defaults(fn=cmd_create)

    pk = sub.add_parser("kmers", help="reads -> kmer count text")
    pk.add_argument("--reads", required=True)
    pk.add_argument("--out", required=True)
    pk.add_argument("--kmer-size", type=int, default=23)
    _device_arg(pk)
    pk.set_defaults(fn=cmd_kmers)

    pm = sub.add_parser("merge", help="merge sample .bgt dirs")
    pm.add_argument("--biographs", nargs="+", required=True)
    pm.add_argument("--out", required=True)
    _device_arg(pm)
    pm.set_defaults(fn=cmd_merge)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
