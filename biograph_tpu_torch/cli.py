"""Command-line interface of the port: the product's pipeline.

Counterpart of ``biograph_tpu/cli.py`` (the reference's command surface,
modules/biograph/main.cpp:51-70, and its pipeline, python/biograph/tools/
bgbinary_cmds.py:332-372): ``version``, ``reference``, ``create``,
``kmers``, ``merge``, ``ref2bwt``, ``bwtquery``, ``discovery``,
``coverage``, ``grm``, ``qual_classifier``, ``gt_classifier``,
``full_pipeline``, the store subcommands ``query``, ``dump_flat``,
``ref2seqset``, ``metadata``, ``export_fastq``, ``upgrade`` (a reference
``.bg`` archive to ``.bgt``), ``export_aligned``, ``refhash`` and ``stats``
take the JAX package's arguments and write the same artifacts and text,
plus ``--device`` (default ``cuda``; the tests pass ``cpu``) wherever
tensors are touched.  ``create`` reads FASTQ, BAM, SAM, CRAM (with
``--ref``) and QSEQ; a reference may be a FASTA, a dir holding one or a
BWA ``.pac`` index.  ``grm`` takes ``--cache-dir`` where the JAX package
reads ``BGT_CACHE``; ``full_pipeline`` keeps its FM-index cache under its
run dir and writes discovery's counters to ``qc/discovery_stats.json``.
The tool subcommands ``squareoff`` and ``pvcf_pipe`` (each sample's store
on ``--device``), ``vcf_sample_paste``, ``freq_filter``, ``rvg_cleaner``,
``vcf_to_ml_table``, ``mendelian`` and ``vdb`` (the flat ``ingest``,
``list``, ``query``, ``export`` and the ``vcf``, ``anno`` and ``study``
groups) print the JAX package's summaries.  ``discovery --dist-dir DIR``
runs one process a card: each is started with the same arguments and its
own ``--process-id`` (``--coordinator``, ``--num-processes``: the JAX
package reads these from ``BGT_*`` variables), the wavefront region-sharded
and the SV pass read-sliced through ``parallel/discovery.py``, and process 0
writes the outputs.  Every subcommand takes ``--profile DIR``, where the JAX
package reads ``BGT_PROFILE``: the command is traced, host and device, into
``DIR/<subcommand>.json`` (``runtime/log.maybe_profile``), discovery itself
and each stage of ``full_pipeline`` a range inside it; a process of a
distributed discovery writes ``DIR/discovery.p<process-id>.json``.

Stage timings are read after the device has finished the stage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from biograph_tpu_torch import resolve_device, version
from biograph_tpu_torch.runtime.log import maybe_profile

BIOGRAPH_VERSION = "biograph_tpu_torch-0.1"


def _fence(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _import_reads(args):
    """create's input -> (ReadBatch, mate_of or None).  One BAM or SAM
    file pairs its reads by name and FLAG, one CRAM (with --ref) too; one
    QSEQ file, or FASTQ files, leave pairing to --paired."""
    from biograph_tpu_torch.io.fastq import pad_batches, read_fastq

    reads = args.reads
    one = reads[0] if len(reads) == 1 else ""
    if one.endswith((".bam", ".sam")):
        from biograph_tpu_torch.io.bam import mate_pairs_from_names, read_bam, read_sam

        batch, _ = read_bam(one, spill_dir=args.spill_dir) if one.endswith(".bam") else read_sam(one)
        return batch, None if batch.names is None else mate_pairs_from_names(batch.names, batch.flags)
    if one.endswith(".cram"):
        from biograph_tpu_torch.io.bam import mate_pairs_from_names
        from biograph_tpu_torch.io.cram import read_cram_batch

        if not args.ref:
            raise SystemExit("CRAM import needs --ref (reference-compressed)")
        batch, hdr = read_cram_batch(one, _load_reference(args.ref))
        return batch, mate_pairs_from_names(batch.names, hdr["flags"])
    if one.split(".gz")[0].split(".bz2")[0].endswith(".qseq"):
        from biograph_tpu_torch.io.qseq import read_qseq

        return read_qseq(one), None
    batches = [read_fastq(p, spill_dir=args.spill_dir) for p in reads]
    return (batches[0] if len(batches) == 1 else pad_batches(batches)), None


def cmd_create(args):
    """reads -> .bgt dir (seqset + readmap + metadata + qc).
    (reference: bgbinary create, modules/biograph/biograph_create.cpp)"""
    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.build.seqset_build import build_seqset
    from biograph_tpu_torch.io.fastq import cut_reads, sample_mask, subset_batch
    from biograph_tpu_torch.kmers.count import count_kmers
    from biograph_tpu_torch.runtime.log import LOG, Progress
    from biograph_tpu_torch.runtime.resources import MemoryBudget
    from biograph_tpu_torch.tools.qc import write_kmer_quality_report

    dev = resolve_device(args.device)
    t_start = time.time()
    timings = {}
    os.makedirs(os.path.join(args.out, "qc"), exist_ok=True)
    LOG.tee_to(os.path.join(args.out, "qc", "create_log.txt"))
    progress = Progress(label="create")

    t0 = time.time()
    batch, mate_of = _import_reads(args)
    timings["import"] = time.time() - t0
    LOG.info(f"import: {batch.num_reads} reads x <={batch.max_len}bp")

    if args.paired and mate_of is None:
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


def _is_artifact(path):
    from biograph_tpu_torch.core import container

    return os.path.isdir(path) and container.exists(path)


def _load_reference(path):
    """A reference artifact dir, a dir holding a FASTA or a BWA .pac index,
    or a FASTA file."""
    from biograph_tpu_torch.index.reference import Reference

    if _is_artifact(path):
        return Reference.load(path)
    return Reference.from_reference_dir(path) if os.path.isdir(path) else Reference.from_fasta(path)


def cmd_reference(args):
    """FASTA (or a dir holding one, or a BWA .pac index) -> reference
    artifact.  (reference: bgbinary reference, modules/main/make_ref.cpp:21)"""
    from biograph_tpu_torch.index.reference import Reference

    t0 = time.time()
    ref = Reference.from_reference_dir(args.input) if os.path.isdir(args.input) else Reference.from_fasta(args.input)
    ref.save(args.out)
    print(f"reference: {len(ref.contigs)} contigs, {ref.total_bases} bases -> {args.out} ({time.time()-t0:.1f}s)")


def cmd_ref2bwt(args):
    """The reference FM-index artifact.
    (reference: bgbinary ref2bwt / make_bwt, modules/bio_mapred/make_bwt.cpp)"""
    from biograph_tpu_torch.index.bwt import RefBwt

    dev = resolve_device(args.device)
    ref = _load_reference(args.ref)
    t0 = time.time()
    bwt = RefBwt.build(np.asarray(ref.flat), device=dev)
    bwt.save(args.out)
    print(f"ref2bwt: {bwt.length} bases indexed -> {args.out} ({time.time()-t0:.1f}s)")


def cmd_bwtquery(args):
    """Exact reference lookups of any length (reference: bgbinary bwtquery)."""
    from biograph_tpu_torch.index.bwt import RefBwt

    bwt = RefBwt.load(args.bwt, args.device)
    lo, hi = bwt.find(args.seq)
    n = int(hi[0] - lo[0])
    print(f"{args.seq}: {n} occurrence(s), SA range [{int(lo[0])}, {int(hi[0])})")
    if n:
        pos = bwt.locate(int(lo[0]), int(hi[0]), max_hits=args.max_hits)
        print("positions:", " ".join(str(int(p)) for p in pos))


def _rec_in_region(ref, rec, region):
    c = ref.contig_by_name(rec["chrom"])
    flat = c.start + rec["pos"] - 1
    return region[0] <= flat < region[1]


def _load_bed(ref, path):
    """BED (contig, start, end; 0-based half-open) -> sorted, merged flat
    intervals [N, 2]: the known-variant or blacklist regions of the
    reference's rvg_exclude (modules/variants/rvg_exclude.h), by region."""
    iv = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith(("#", "track", "browser")):
                continue
            fields = line.split("\t")
            c = ref.contig_by_name(fields[0])
            iv.append((c.start + int(fields[1]), c.start + int(fields[2])))
    iv.sort()
    merged = []  # overlap-free, so one bisection answers intersection
    for lo, hi in iv:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return np.asarray(merged, np.int64).reshape(-1, 2)


def _flat_overlaps(iv, lo, hi) -> bool:
    """True if [lo, hi) intersects an interval of the sorted [N, 2] array."""
    if len(iv) == 0:
        return False
    i = int(np.searchsorted(iv[:, 0], hi))  # the first interval starting at or after hi
    return i > 0 and iv[i - 1, 1] > lo


def _discovery_assemble(args, ref, dev):
    """discovery --mode assemble: the wavefront, then the SV pass when the
    store has a readmap; returns (records, options, what --stats holds)."""
    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.runtime.config import apply_options
    from biograph_tpu_torch.variants.discover import DiscoverOptions, discover_variants, write_assembly_csv

    if not args.biograph:
        raise SystemExit("--mode assemble requires --biograph <dir.bgt>")
    bg = BioGraph(args.biograph, device=dev)
    opt = DiscoverOptions(min_alt_support=args.min_depth)
    applied = apply_options(opt, args.opt)
    if applied:
        print("options: " + " ".join(f"{k}={v}({src})" for k, (v, src) in applied.items()))
    region = None
    if args.region:
        cname, span = args.region.split(":")
        lo, hi = (int(x) for x in span.split("-"))
        c = ref.contig_by_name(cname)
        region = (c.start + lo, c.start + hi)
    stats = {}
    if args.iterate > 1:
        # donor-patching rounds for divergent genomes (variants/iterate.py)
        from biograph_tpu_torch.variants.iterate import discover_variants_iterative

        recs = discover_variants_iterative(bg.seqset, ref, opt=opt, readmap=bg.readmap, max_rounds=args.iterate, region=region, stats=stats)
    elif args.dist_dir:
        # region-sharded over the run's processes (parallel/discovery.py)
        from biograph_tpu_torch.parallel.discovery import discover_variants_distributed

        with maybe_profile("discovery", args.profile):
            recs = discover_variants_distributed(bg.seqset, ref, args.dist_dir, region=region, opt=opt, readmap=bg.readmap, stats=stats)
    else:
        asm_dump = [] if args.assemblies_out else None
        with maybe_profile("discovery", args.profile):
            recs = discover_variants(bg.seqset, ref, region=region, opt=opt, readmap=bg.readmap, out_assemblies=asm_dump, stats=stats)
        if asm_dump is not None:
            n = write_assembly_csv(args.assemblies_out, ref, asm_dump)
            print(f"assemblies: {n} -> {args.assemblies_out}")
    n_wave = len(recs)
    if bg.readmap is not None and not args.no_sv:
        # the pair/split SV pass (pop_tracer): events past the wavefront's
        # path cap, merged into the same records
        from biograph_tpu_torch.variants.pop_tracer import discover_structural

        t0 = time.time()
        sv_stats = stats.setdefault("sv", {})
        if args.dist_dir:
            # the read scan split over the processes, the finalize on each
            from biograph_tpu_torch.parallel.discovery import discover_structural_distributed

            sv_all = discover_structural_distributed(bg.readmap, ref, args.dist_dir)
        else:
            codes, lens, mate = bg.readmap.forward_reads()
            sv_all = discover_structural(ref, codes, lens, mate_of=mate, device=dev, stats=sv_stats)
        seen = {(r["chrom"], r["pos"], r["ref"], r["alt"]) for r in recs}
        sv = [
            r for r in sv_all
            if (r["chrom"], r["pos"], r["ref"], r["alt"]) not in seen and (region is None or _rec_in_region(ref, r, region))
        ]
        recs = sorted(recs + sv, key=lambda r: (r["chrom"], r["pos"]))
        _fence(dev)
        sv_stats["records"] = len(sv_all)
        stats.setdefault("stage_s", {})["sv"] = time.time() - t0
    stats["n_wavefront"] = n_wave
    stats["n_sv"] = len(recs) - n_wave
    return recs, opt, stats


def _discovery_assemble_out(args, ref, dev, t0, writes=True):
    """discovery --mode assemble with its outputs: --exclude, --stats and the
    VCF.  A process of a distributed run other than process 0 computes the
    same records and writes nothing."""
    from biograph_tpu_torch.variants.discover import write_discovery_vcf

    recs, opt, stats = _discovery_assemble(args, ref, dev)
    n_wave, n_sv = stats["n_wavefront"], stats["n_sv"]
    if args.exclude:
        excl = _load_bed(ref, args.exclude)
        n0 = len(recs)

        def flat_span(r):
            start = ref.contig_by_name(r["chrom"]).start + r["pos"] - 1
            return start, start + max(len(r["ref"]), 1)

        recs = [r for r in recs if not _flat_overlaps(excl, *flat_span(r))]
        if n0 != len(recs):
            print(f"exclude: dropped {n0 - len(recs)} calls in {args.exclude}")
    if not writes:
        return
    if args.stats:
        # engine counters and per-stage seconds (bgbinary --stats,
        # modules/io/runtime_stats.h:14-50)
        stats["stage_s"] = {k: round(v, 3) for k, v in stats.get("stage_s", {}).items()}
        with open(args.stats, "w") as f:
            json.dump(stats, f, indent=1, default=int)
    excluded = f" -> {len(recs)} after exclusion" if len(recs) != n_wave + n_sv else ""
    print(f"discovery: {n_wave} assembled + {n_sv} SV records{excluded} ({time.time()-t0:.1f}s)")
    write_discovery_vcf(args.out, ref, recs, sample=args.sample, opt=opt)


def cmd_discovery(args):
    """reads or .bgt + reference -> VCF.
    (reference: bgbinary discovery, modules/biograph/biograph_variants.cpp)

    --mode assemble: seqset wavefront assembly and the SV pass (needs --biograph)
    --mode golden-parity: the 2012 final.vcf preset (needs --reads)
    --mode pileup: place reads, pileup SNP caller (--reads or --biograph)
    """
    dev = resolve_device(args.device)
    ref = _load_reference(args.ref)
    t0 = time.time()
    if args.mode == "assemble" and args.dist_dir:
        from biograph_tpu_torch.parallel.distributed import initialize, shutdown

        ctx = initialize(args.coordinator, args.num_processes, args.process_id, device=dev)
        try:
            _discovery_assemble_out(args, ref, ctx.device, t0, writes=ctx.process_id == 0)
        finally:
            shutdown(ctx)
    elif args.mode == "assemble":
        _discovery_assemble_out(args, ref, dev, t0)
    elif args.mode == "golden-parity":
        from biograph_tpu_torch.io.fastq import read_fastq
        from biograph_tpu_torch.variants.golden_parity import golden_parity_calls, write_golden_parity_vcf

        if not args.reads:
            raise SystemExit("discovery --mode golden-parity needs --reads")
        batch = read_fastq(args.reads)
        calls = golden_parity_calls(ref, batch.codes, batch.lengths, device=dev)
        print(f"golden-parity: {len(calls)} calls ({time.time()-t0:.1f}s)")
        write_golden_parity_vcf(args.out, calls)
    else:
        from biograph_tpu_torch.variants.pileup import run_pileup_pipeline, write_pileup_vcf

        if args.reads:
            from biograph_tpu_torch.io.fastq import read_fastq

            batch = read_fastq(args.reads)
            codes, lengths, num_reads = batch.codes, batch.lengths, batch.num_reads
        elif args.biograph:
            # the read set of the store itself, from seqset and readmap
            from biograph_tpu_torch.api import BioGraph

            bg = BioGraph(args.biograph, device=dev)
            if bg.readmap is None:
                raise SystemExit(f"{args.biograph}: no readmap")
            codes, lengths, _ = bg.readmap.forward_reads()
            num_reads = len(lengths)
        else:
            raise SystemExit("discovery --mode pileup needs --reads or --biograph")
        pl, counts, calls = run_pileup_pipeline(ref, codes, lengths, min_depth=args.min_depth, device=dev)
        placed = int((pl.pos >= 0).sum())
        if args.exclude:
            excl = _load_bed(ref, args.exclude)
            n0 = len(calls)
            calls = [c for c in calls if not _flat_overlaps(excl, c.flat_pos, c.flat_pos + 1)]
            if n0 != len(calls):
                print(f"exclude: dropped {n0 - len(calls)} calls in {args.exclude}")
        print(f"discovery: placed {placed}/{num_reads} reads, {len(calls)} calls ({time.time()-t0:.1f}s)")
        write_pileup_vcf(args.out, ref, counts, calls, sample=args.sample)
    print(f"vcf -> {args.out}")


def cmd_coverage(args):
    """VCF + .bgt + reference -> coverage-annotated, genotyped VCF.
    (reference: biograph coverage, python/biograph/tools/coverage.py:739)"""
    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.variants.coverage_tool import run_coverage, run_coverage_parallel

    dev = resolve_device(args.device)
    t0 = time.time()
    if args.workers > 1:
        run_coverage_parallel(
            args.vcf, args.out, args.biograph, args.ref, n_workers=args.workers, sample=args.sample,
            features_out=args.features, joint_graph=args.joint_graph, device=dev,
        )
        print(f"coverage: {args.workers}-worker region-parallel run ({time.time()-t0:.1f}s) -> {args.out}")
        return
    ref = _load_reference(args.ref)
    bg = BioGraph(args.biograph, device=dev)
    if bg.readmap is None:
        raise SystemExit(f"{args.biograph}: no readmap")
    ann = run_coverage(args.vcf, args.out, bg, ref, sample=args.sample, features_out=args.features, joint_graph=args.joint_graph)
    _fence(dev)
    print(f"coverage: {len(ann.gt)} records annotated ({time.time()-t0:.1f}s) -> {args.out}")


def cmd_grm(args):
    """SV breakend mappability through the reference FM-index.
    (reference: truvari anno grm, bgbinary_cmds.py:371)"""
    from biograph_tpu_torch.index.bwt import RefBwt
    from biograph_tpu_torch.tools.grm import run_grm

    dev = resolve_device(args.device)
    ref = _load_reference(args.ref)
    t0 = time.time()
    if args.bwt:
        bwt = RefBwt.load(args.bwt, dev)
    elif args.cache_dir:
        bwt = RefBwt.cached_build(np.asarray(ref.flat), args.cache_dir, device=dev)
    else:
        bwt = RefBwt.build(np.asarray(ref.flat), device=dev)
    recs = run_grm(args.vcf, args.out, bwt, ref, sample=args.sample, k=args.k)
    n_sv = sum(1 for r in recs if "GRM_UP" in r.info or "GRM_DN" in r.info)
    print(f"grm: {n_sv}/{len(recs)} records annotated ({time.time()-t0:.1f}s) -> {args.out}")


def cmd_qual_classifier(args):
    """Train or apply the variant quality classifier.
    (reference: biograph qual_classifier, classifier/qual_classifier.py:271)"""
    from biograph_tpu_torch.classifier.model import Classifier, apply_to_vcf, train_classifier
    from biograph_tpu_torch.io.vcf import read_vcf

    dev = resolve_device(args.device)
    feats = dict(np.load(args.features))
    if args.train:
        # contig names differ between pipelines ("Chromosome" against the
        # supercontig "Chromosome:0"): match on the base name
        def key(r):
            return (r.chrom.split(":")[0], r.pos, r.ref, r.alt)

        truth = {key(r) for r in read_vcf(args.truth_vcf)}
        labels = np.array([key(r) in truth for r in read_vcf(args.vcf)], bool)
        clf = train_classifier(feats, labels, device=dev)
        clf.save(args.model)
        acc = ((clf.predict_proba(feats) > 0.5) == labels).mean()
        print(f"qual_classifier: trained on {len(labels)} records ({labels.sum()} true), train acc {acc:.3f} -> {args.model}")
    else:
        clf = Classifier.load(args.model, device=dev)
        prob = apply_to_vcf(clf, args.vcf, args.out, feats, min_prob=args.min_prob, sample=args.sample)
        print(f"qual_classifier: {int((prob >= args.min_prob).sum())}/{len(prob)} PASS -> {args.out}")


def cmd_gt_classifier(args):
    """Train or apply the ML re-genotyper (reference: biograph
    gt_classifier, python/biograph/classifier/gt_classifier.py)."""
    import collections

    from biograph_tpu_torch.classifier.model import GT_CLASSES, GtClassifier, gt_apply_to_vcf, train_gt_classifier
    from biograph_tpu_torch.io.vcf import read_vcf

    dev = resolve_device(args.device)
    feats = dict(np.load(args.features))
    if args.train:
        gt_map = {g: i for i, g in enumerate(GT_CLASSES)}
        labels = np.array([gt_map.get(str(r.fmt.get("GT", "./.")).replace("|", "/"), -1) for r in read_vcf(args.vcf)])
        keep = labels >= 0
        if not keep.all():
            print(f"gt_classifier: skipping {int((~keep).sum())} records with non-diploid/missing GT")
            feats = {k: v[keep] for k, v in feats.items()}
            labels = labels[keep]
        clf = train_gt_classifier(feats, labels, device=dev)
        clf.save(args.model)
        acc = (clf.predict(feats) == labels).mean()
        print(f"gt_classifier: trained on {len(labels)} records, train acc {acc:.3f} -> {args.model}")
    else:
        clf = GtClassifier.load(args.model, device=dev)
        cls = gt_apply_to_vcf(clf, args.vcf, args.out, feats, sample=args.sample)
        print(f"gt_classifier: {dict(collections.Counter(GT_CLASSES[c] for c in cls))} -> {args.out}")


def cmd_full_pipeline(args):
    """reads + reference -> results VCF, end to end with stage resume.
    (reference: biograph full_pipeline, python/biograph/tools/
    bgbinary_cmds.py:332-372: create | discovery | coverage | grm |
    qual_classifier, each stage an immutable artifact and a timings entry)

    Each stage is this CLI's own subcommand with the arguments the JAX
    package's full_pipeline gives it."""
    import shutil

    from biograph_tpu_torch.runtime.stages import Stage, StageRunner

    out = args.out
    analysis = os.path.join(out, "analysis")
    qc_dir = os.path.join(out, "qc")
    for d in (out, analysis, qc_dir):
        os.makedirs(d, exist_ok=True)
    bgt = os.path.join(out, "sample.bgt")
    vcf = {name: os.path.join(analysis, name + ".vcf") for name in ("discovery", "coverage", "grm", "results")}
    feats = os.path.join(analysis, "features.npz")
    dev = ["--device", args.device]
    create = ["create", "--reads", *args.reads, "--out", bgt, "--kmer-size", str(args.kmer_size)]
    create += ["--paired"] * args.paired + ["--correct"] * args.correct
    discovery = ["discovery", "--mode", "assemble", "--biograph", bgt, "--ref", args.ref, "--out", vcf["discovery"],
                 "--sample", args.sample, "--min-depth", str(args.min_depth), "--stats", os.path.join(qc_dir, "discovery_stats.json")]
    discovery += ["--region", args.region] if args.region else []
    coverage = ["coverage", "--vcf", vcf["discovery"], "--biograph", bgt, "--ref", args.ref, "--out", vcf["coverage"],
                "--sample", args.sample, "--features", feats]
    grm = ["grm", "--vcf", vcf["coverage"], "--ref", args.ref, "--out", vcf["grm"], "--sample", args.sample, "--k", "50",
           "--cache-dir", os.path.join(out, "cache")]

    def stage(argv):
        """A stage: the subcommand argv[0], a range of full_pipeline's trace."""
        def run(runner):
            with maybe_profile(argv[0], args.profile):
                main(argv + dev)

        return run

    stages = [
        Stage(name="create", outputs=[os.path.join(bgt, "metadata.json")], fn=stage(create)),
        Stage(name="discovery", outputs=[vcf["discovery"]], fn=stage(discovery)),
        Stage(name="coverage", outputs=[vcf["coverage"]], fn=stage(coverage)),
        Stage(name="grm", outputs=[vcf["grm"]], fn=stage(grm)),
    ]
    if args.classifier_model:
        qual = ["qual_classifier", "--vcf", vcf["grm"], "--features", feats, "--model", args.classifier_model,
                "--out", vcf["results"], "--min-prob", "0.5", "--sample", args.sample]
        stages.append(Stage(name="qual_classifier", outputs=[vcf["results"]], fn=stage(qual)))

    runner = StageRunner(out, resume=args.resume)
    stopped = runner.run(stages, stop_after=args.stop, rerun=args.rerun, verbose=True)
    # qc/timings.json: the manifest's per-stage wall seconds
    timings = {name: rec["wall_s"] for name, rec in runner.manifest["stages"].items() if "wall_s" in rec}
    with open(os.path.join(qc_dir, "timings.json"), "w") as f:
        json.dump(timings, f, indent=1)
    if stopped:
        print(f"--stop {stopped}: halting")
        raise SystemExit(0)
    if not args.classifier_model:
        shutil.copyfile(vcf["grm"], vcf["results"])
    print(f"full_pipeline: done -> {vcf['results']}")


def cmd_query(args):
    """Query a seqset for a DNA string: entry count + matching sequences.
    (reference: bgbinary query, modules/biograph/biograph_query.cpp:56)"""
    from biograph_tpu_torch.api import BioGraph

    bg = BioGraph(args.biograph, device=args.device)
    e = bg.find(args.query)
    if not args.quiet:
        print(f'Query: "{args.query}"')
    if not e.valid:
        if not args.quiet:
            print("No valid results were found.")
        return
    count = e.end - e.begin
    if not args.quiet:
        print(f"Query has {e.size} bases.")
        print(f"{count} seqset entries share this prefix.")
    limit = count if args.verbose else min(count, 10)
    ss = bg.seqset
    for ent in range(e.begin, e.begin + limit):
        print(ss.entry_sequence(ent))
    if limit < count and not args.quiet:
        print(f"... {count - limit} more (use --verbose)")


def _entry_sequences(ss, entries, lengths):
    """Yield (entry's sequence as text) for each entry, 2^14 a batch."""
    from biograph_tpu_torch.core import dna

    L = int(lengths.max(initial=0))
    for lo in range(0, len(entries), 1 << 14):
        hi = min(len(entries), lo + (1 << 14))
        ids = torch.from_numpy(np.ascontiguousarray(entries[lo:hi], np.int64)).to(ss.device)
        seqs = ss.d.sequences(ids, L).cpu().numpy()
        for i in range(hi - lo):
            yield dna.codes_to_seq(seqs[i, : int(lengths[lo + i])])


def cmd_dump_flat(args):
    """Dump every seqset entry's sequence, one per line, in entry order.
    (reference: bgbinary dump_flat, modules/biograph/dump_biograph_flat.cpp:49)"""
    import sys

    from biograph_tpu_torch.api import BioGraph

    bg = BioGraph(args.biograph, device=args.device)
    ss = bg.seqset
    sizes = ss.entry_sizes.cpu().numpy()
    out = open(args.out, "w") if args.out else sys.stdout
    for seq in _entry_sequences(ss, np.arange(ss.n_entries), sizes):
        out.write(seq + "\n")
    if args.out:
        out.close()
        print(f"dump_flat: {ss.n_entries} entries -> {args.out}")


def cmd_ref2seqset(args):
    """Build a seqset from the reference itself, cut into read-size tiles.
    (reference: bgbinary ref2seqset, modules/biograph/ref_to_seqset.cpp:173:
    non-overlapping read_size tiles; suffixes come from seqset expansion)"""
    from biograph_tpu_torch.build.seqset_build import build_seqset
    from biograph_tpu_torch.runtime.resources import MemoryBudget

    dev = resolve_device(args.device)
    rs = args.read_size
    if not 30 <= rs <= 255:
        raise SystemExit(f"--read-size must be in [30, 255], got {rs}")
    ref = _load_reference(args.ref)
    t0 = time.time()
    flat, is_n = np.asarray(ref.flat), np.asarray(ref.is_n)
    tiles = []
    for c in ref.contigs:
        for lo in range(c.start, c.start + c.length, rs):
            hi = min(lo + rs, c.start + c.length)
            if hi - lo >= 30 and not is_n[lo:hi].any():
                tiles.append(flat[lo:hi])
    if not tiles:
        raise SystemExit("ref2seqset: no N-free tiles >= 30 bases")
    lengths = np.array([len(t) for t in tiles], np.int32)
    codes = np.zeros((len(tiles), rs), np.uint8)
    for i, t in enumerate(tiles):
        codes[i, : len(t)] = t
    ss = build_seqset(codes, lengths, budget=MemoryBudget.detect(dev), device=dev)
    os.makedirs(args.out, exist_ok=True)
    ss.save(os.path.join(args.out, "seqset"))
    with open(os.path.join(args.out, "metadata.json"), "w") as f:
        json.dump(
            {
                "biograph_version": BIOGRAPH_VERSION,
                "source": "ref2seqset",
                "read_size": rs,
                "num_reads": len(tiles),
                "num_seqset_entries": int(ss.n_entries),
                "accession_id": os.path.basename(args.out.rstrip("/")),
            },
            f,
            indent=1,
        )
    print(f"ref2seqset: {len(tiles)} tiles x <={rs}bp -> {ss.n_entries} entries ({time.time()-t0:.1f}s) -> {args.out}")


def cmd_metadata(args):
    """Show (and optionally edit) a biograph dir's metadata.
    (reference: bgbinary metadata, modules/biograph/biograph_info.cpp)"""
    for path in args.biograph:
        mpath = os.path.join(path, "metadata.json")
        meta = {}
        if os.path.isfile(mpath):
            with open(mpath) as f:
                meta = json.load(f)
        changed = False
        if args.set_sample_id is not None:
            meta["sample_id"] = args.set_sample_id
            changed = True
        if args.set_accession_id is not None:
            meta["accession_id"] = args.set_accession_id
            changed = True
        if changed:
            with open(mpath, "w") as f:
                json.dump(meta, f, indent=1)
        size = 0
        for root, _dirs, files in os.walk(path):
            size += sum(os.path.getsize(os.path.join(root, fn)) for fn in files)
        print(f"{path}: {size/1e6:.1f} MB")
        print(json.dumps(meta, indent=1))


def cmd_export_fastq(args):
    """Reconstruct the forward reads from seqset+readmap -> FASTQ.
    (reference: bgbinary export_fastq)"""
    from biograph_tpu_torch.api import BioGraph

    bg = BioGraph(args.biograph, device=args.device)
    rm = bg.readmap
    if rm is None:
        raise SystemExit(f"{args.biograph}: no readmap")
    fwd_ids = np.nonzero(rm.is_forward.cpu().numpy())[0]
    entries = rm.entry_of_rm.cpu().numpy()[fwd_ids]
    lens = rm.read_lengths.cpu().numpy()[fwd_ids]
    read_ids = rm.read_ids.cpu().numpy()[fwd_ids]
    n = 0
    with open(args.out, "w") as f:
        for i, s in enumerate(_entry_sequences(bg.seqset, entries, lens)):
            f.write(f"@r{int(read_ids[i])}\n{s}\n+\n{'I' * len(s)}\n")
            n += 1
    print(f"export_fastq: {n} reads -> {args.out}")


def cmd_upgrade(args):
    """Convert a reference-format .bg archive to a .bgt dir.
    (reference: bgbinary upgrade, modules/biograph/main.cpp command list)"""
    from biograph_tpu_torch.io.bgimport import open_bg_dir

    t0 = time.time()
    ss, rm, meta = open_bg_dir(args.input, args.device)
    os.makedirs(args.out, exist_ok=True)
    ss.save(os.path.join(args.out, "seqset"))
    if rm is not None:
        rm.save(os.path.join(args.out, "readmap"))
    with open(os.path.join(args.out, "metadata.json"), "w") as f:
        json.dump(
            {
                "biograph_version": BIOGRAPH_VERSION,
                "upgraded_from": os.path.abspath(args.input),
                "accession_id": meta.get("accession_id", ""),
                "num_seqset_entries": int(ss.n_entries),
            },
            f,
            indent=1,
        )
    print(
        f"upgrade: {ss.n_entries} entries"
        + (f", {rm.read_count} reads" if rm else "")
        + f" -> {args.out} ({time.time()-t0:.1f}s)"
    )


def cmd_export_aligned(args):
    """Place the biograph's reads and export SAM/BAM over VCF regions
    (reference: biograph export_aligned, tools/export_aligned.py)."""
    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.tools.export_aligned import export_aligned

    bg = BioGraph(args.biograph, device=args.device)
    if bg.readmap is None:
        raise SystemExit(f"{args.biograph}: no readmap")
    ref = _load_reference(args.ref)
    n = export_aligned(
        bg,
        ref,
        args.out,
        vcf_path=args.vcf,
        window=args.window,
        max_mismatches=args.max_mismatches,
        include_unplaced=args.include_unplaced,
        device=args.device,
    )
    print(f"export_aligned: {n} records -> {args.out}")


def cmd_refhash(args):
    """Reference fingerprint (reference: tools/refhash.py)."""
    from biograph_tpu_torch.tools.qc import refhash

    print(refhash(_load_reference(args.ref)))


def cmd_stats(args):
    """.bgt or .bg dir -> summary (reference: biograph stats)."""
    from biograph_tpu_torch.api import BioGraph

    bg = BioGraph(args.biograph, device=args.device)
    print(json.dumps(bg.metadata, indent=1))
    print(f"seqset entries: {bg.seqset.n_entries}")
    if bg.readmap:
        print(f"readmap entries: {bg.readmap.num_entries}")
        print(json.dumps(bg.readmap.get_pair_stats(), indent=1))


def _open_samples(args, dev):
    """--biographs opened on dev, and their names: --samples, else each
    store's accession_id or its directory's name."""
    from biograph_tpu_torch.api import BioGraph

    bgs = [BioGraph(p, device=dev) for p in args.biographs]
    return bgs, args.samples or [bg.metadata.get("accession_id") or os.path.basename(bg.path.rstrip("/")) for bg in bgs]


def cmd_squareoff(args):
    """Union call set re-genotyped in every sample -> multi-sample VCF.
    (reference: biograph squareoff, bgbinary_cmds.py)"""
    from biograph_tpu_torch.tools.squareoff import squareoff

    dev = resolve_device(args.device)
    ref = _load_reference(args.ref)
    bgs, names = _open_samples(args, dev)
    t0 = time.time()
    recs = squareoff(args.vcfs, bgs, ref, args.out, names)
    _fence(dev)
    print(f"squareoff: {len(recs)} union records x {len(bgs)} samples ({time.time()-t0:.1f}s) -> {args.out}")


def cmd_pvcf_pipe(args):
    """Project-level VCF: union squareoff across samples + Mendelian
    annotation (reference: tools/pvcf_pipe.py, which ships as a stub whose
    docstring describes this merge -> per-sample pcmp -> paste -> meanno
    chain)."""
    from biograph_tpu_torch.tools.squareoff import squareoff

    dev = resolve_device(args.device)
    ref = _load_reference(args.ref)
    bgs, names = _open_samples(args, dev)
    if args.pedigree:
        from biograph_tpu_torch.utils.pedigree import Pedigree

        ped = Pedigree(args.pedigree)
        missing = [n for n in names if n not in ped]
        if missing:
            raise SystemExit(f"samples not in pedigree: {missing}")
    t0 = time.time()
    target = args.output if not args.pedigree else args.output + ".sqoff.tmp.vcf"
    recs = squareoff(args.vcfs, bgs, ref, target, names)
    _fence(dev)
    print(f"pvcf: {len(recs)} union records x {len(bgs)} samples ({time.time()-t0:.1f}s)")
    if args.pedigree:
        from biograph_tpu_torch.tools.mendelian import annotate_vcf

        report = annotate_vcf(target, args.output, ped)
        base = args.output.rsplit(".vcf", 1)[0]
        report.write_json(base + "_stats.json")
        report.write_text(base + "_stats.txt")
        os.remove(target)
        print(f"pvcf: mendelian-annotated -> {args.output} (+_stats.json/_stats.txt)")
    else:
        print(f"pvcf: -> {args.output}")


def cmd_vcf_tools(args):
    """Cohort VCF utilities (reference: tools/vcf_sample_paste.py,
    freq_filter.py, rvg_cleaner.py, vcf_to_ml_table.py)."""
    from biograph_tpu_torch.tools import vcf_tools

    if args.cmd == "vcf_sample_paste":
        n = vcf_tools.sample_paste(args.vcfs, args.output)
        print(f"vcf_sample_paste: {n} records -> {args.output}", file=sys.stderr)
    elif args.cmd == "rvg_cleaner":
        stats = vcf_tools.rvg_cleaner(args.variants, args.output)
        print(f"rvg_cleaner: {stats}", file=sys.stderr)
    elif args.cmd == "freq_filter":
        stats = vcf_tools.freq_filter(
            args.variants, args.output,
            min_observations=args.min_observations,
            min_individuals=args.individuals,
            depth_field=args.depth_field,
        )
        print(f"freq_filter: {stats}", file=sys.stderr)
    else:
        n = vcf_tools.vcf_to_ml_table(args.vcf, args.output)
        print(f"vcf_to_ml_table: {n} allele rows -> {args.output}", file=sys.stderr)


def cmd_mendelian(args):
    """Mendelian-error annotation of a family VCF against a pedigree
    (reference: python/biograph/tools/mendelian_annotator.py)."""
    from biograph_tpu_torch.tools.mendelian import annotate_vcf
    from biograph_tpu_torch.utils.pedigree import Pedigree

    ped = Pedigree(args.pedigree)
    report = annotate_vcf(args.vcf, args.output, ped, ref_count=args.ref_count)
    base = args.output[: -len(".vcf.gz")] if args.output.endswith(".vcf.gz") else args.output.rsplit(".vcf", 1)[0]
    report.write_json(base + "_stats.json")
    report.write_text(base + "_stats.txt")
    overall = report.finalize()["overall"]
    n_err = sum(c["err"] for c in overall["type_counts"].values())
    print(f"mendelian: {report.var_count} variants, {n_err} with a family error -> {args.output} (+_stats.json/_stats.txt)")


def cmd_vdb(args):
    """Local variant warehouse (reference: biograph vdb, python/biograph/vdb/).

    Command groups mirror vcf_cmd/anno_cmd/study_cmd/query_cmd; the flat
    ingest/list/query/export spellings are the original VDB-lite surface and
    keep working on the same sqlite store."""
    from biograph_tpu_torch.tools import vdb

    c = args.vdb_cmd
    if c == "ingest":
        n = vdb.ingest(args.db, args.vcf, args.sample)
        print(f"vdb ingest: {n} records from {args.vcf} as {args.sample!r}")
        return
    if c == "list":
        for s, info in sorted(vdb.list_samples(args.db).items()):
            print(f"{s}\t{info['records']} records\t{info['ingested']}")
        return
    if c == "query" and getattr(args, "sql", None) is None:
        rows = vdb.query(
            args.db,
            sample=args.sample,
            chrom=args.chrom,
            pos_min=args.pos_min,
            pos_max=args.pos_max,
            min_qual=args.min_qual,
            passing=args.passing,
        )
        for r in rows[: args.limit]:
            print(f"{r['sample']}\t{r['chrom']}\t{r['pos']}\t{r['ref']}\t{r['alt']}\t{r['qual']:.0f}\t{r['filter']}\t{r['gt']}")
        print(f"# {len(rows)} rows")
        return
    if c == "export" and not hasattr(args, "aid"):
        n = vdb.export(args.db, args.sample, args.out)
        print(f"vdb export: {n} records -> {args.out}")
        return
    if c == "vcf" and args.vcf_cmd == "sort":  # pure file op, no warehouse
        n = vdb.sort_vcf(args.input, args.output, chromosomal=args.chromosomal)
        print(f"sorted {n} records -> {args.output}")
        return

    v = vdb.VDB(args.db)
    try:
        if c == "query":  # raw SQL (query_cmd.py / Athena analog)
            for row in v.query(args.sql):
                print("\t".join("." if x is None else str(x) for x in row))
        elif c == "vcf":
            vc = args.vcf_cmd
            if vc == "import":
                aid, n = v.import_vcf(
                    args.input, sample=args.sample, description=args.description,
                    refname=args.refname, aid=args.aid,
                )
                print(f"{aid}\t{n} records")
            elif vc == "list":
                for r in v.list_vcfs(args.sample):
                    print(f"{r['aid']}\t{r['sample_name']}\t{r['record_count']}\t{r['refname']}\t{r['imported_on']}")
            elif vc == "export":
                n = v.export_vcf(args.aid, args.output)
                print(f"vdb vcf export: {n} records -> {args.output}")
            elif vc == "delete":
                print(f"deleted {v.delete_vcf(*args.aid)} dataset(s)")
        elif c == "anno":
            ac = args.anno_cmd
            if ac == "import":
                aid, n = v.import_anno(args.input, name=args.name, version=args.version)
                print(f"{aid}\t{n} records")
            elif ac == "list":
                for r in v.list_annos():
                    print(f"{r['aid']}\t{r['anno_name']}\t{r['version']}\t{r['record_count']}\t{r['imported_on']}")
            elif ac == "export":
                n = v.export_anno(args.aid, args.output)
                print(f"vdb anno export: {n} records -> {args.output}")
            elif ac == "delete":
                print(f"deleted {v.delete_anno(*args.aid)} annotation(s)")
        elif c == "study":
            sc = args.study_cmd
            if sc == "create":
                v.create_study(args.study_name)
                print(f"Study '{args.study_name}' created")
            elif sc == "list":
                for name, created in v.list_studies():
                    print(f"{name:<21} {(created or '')[:19]}")
            elif sc == "show":
                s = v.show_study(args.study_name)
                for k, val in sorted(s["meta"].items()):
                    print(f"{k:>16}: {val}")
                print(f"{'checkpoint':>16}: {s['checkpoint']}")
                print(f"\n{'sample_name':<17}variant_count")
                for name, count in s["samples"]:
                    print(f"{name:<17}{count}")
            elif sc == "add":
                if args.src_study:
                    cp = v.copy_from_study(args.src_study, args.checkpoint, args.study_name, args.sample)
                else:
                    cp = v.add_to_study(args.study_name, args.sample)
                print(f"Study '{args.study_name}' at checkpoint {cp}")
            elif sc == "filter":
                cp, kept = v.filter_study(args.study_name, args.include or args.exclude, exclude=args.include is None)
                print(f"checkpoint {cp}: {kept} rows kept")
            elif sc == "export":
                n = v.export_study(
                    args.study_name, args.output, checkpoint=args.checkpoint,
                    anno=args.anno, square_off=args.square_off,
                    chromosomal=args.chromosomal,
                    fields=args.fields.split(":") if args.fields else None,
                    no_header=args.no_header,
                )
                print(f"study export: {n} sites -> {args.output}")
            elif sc == "revert":
                cp = v.revert_study(args.study_name, args.checkpoint)
                print(f"Study '{args.study_name}' reverted to checkpoint {cp}")
            elif sc == "freeze":
                v.freeze_study(args.study_name)
                print(f"Study '{args.study_name}' frozen")
            elif sc == "unfreeze":
                v.freeze_study(args.study_name, frozen=False)
                print(f"Study '{args.study_name}' unfrozen")
            elif sc == "delete":
                v.delete_study(args.study_name)
                print(f"Study '{args.study_name}' deleted")
    finally:
        v.close()


def _device_arg(p):
    p.add_argument("--device", default="cuda", help="torch device to run on (default cuda; cpu on the host)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="biograph_tpu_torch", description="BioGraph-class engine on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    pver = sub.add_parser("version", help="print the package version")
    pver.set_defaults(fn=lambda a: print(f"biograph_tpu_torch version {version()}"))

    pc = sub.add_parser("create", help="reads -> seqset+readmap (.bgt)")
    pc.add_argument("--reads", nargs="+", required=True, help="FASTQ(.gz) / BAM / SAM / CRAM / QSEQ input")
    pc.add_argument("--ref", help="reference (required for CRAM input)")
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

    pr = sub.add_parser("reference", help="build reference artifact")
    pr.add_argument("--in", dest="input", required=True)
    pr.add_argument("--out", required=True)
    pr.set_defaults(fn=cmd_reference)

    pb = sub.add_parser("ref2bwt", help="build reference BWT/FM-index")
    pb.add_argument("--ref", required=True)
    pb.add_argument("--out", required=True)
    _device_arg(pb)
    pb.set_defaults(fn=cmd_ref2bwt)

    pbq = sub.add_parser("bwtquery", help="exact reference lookups via BWT")
    pbq.add_argument("--bwt", required=True, help="ref2bwt artifact")
    pbq.add_argument("--seq", required=True)
    pbq.add_argument("--max-hits", type=int, default=64)
    _device_arg(pbq)
    pbq.set_defaults(fn=cmd_bwtquery)

    pd = sub.add_parser("discovery", help="call variants -> VCF")
    pd.add_argument("--reads", help="FASTQ (pileup and golden-parity modes)")
    pd.add_argument("--biograph", help=".bgt dir (assemble mode; pileup mode reads its reads)")
    pd.add_argument("--ref", required=True)
    pd.add_argument("--out", required=True)
    pd.add_argument("--sample", default="SAMPLE")
    pd.add_argument("--min-depth", type=int, default=8)
    pd.add_argument("--mode", choices=["pileup", "assemble", "golden-parity"], default="pileup",
                    help="golden-parity: the 2012 final.vcf reproduction preset (variants/golden_parity.py)")
    pd.add_argument("--region", help="contig:lo-hi (0-based)")
    pd.add_argument("--no-sv", action="store_true", help="skip the pair/split-evidence SV pass (assemble mode)")
    pd.add_argument("--iterate", type=int, default=1, help="donor-patching discovery rounds (divergent genomes)")
    pd.add_argument("--opt", action="append", metavar="FIELD=VALUE",
                    help="engine knob override (any DiscoverOptions field; repeatable)")
    pd.add_argument("--stats", metavar="JSON", help="write engine counters and per-stage seconds here")
    pd.add_argument("--dist-dir", metavar="DIR",
                    help="shared run dir of region-sharded multi-process discovery: start one process a card, "
                         "each with the same arguments and its own --process-id")
    pd.add_argument("--coordinator", default="localhost:12421", metavar="HOST:PORT",
                    help="with --dist-dir: the rendezvous address of process 0")
    pd.add_argument("--num-processes", type=int, default=1, metavar="N", help="with --dist-dir: the processes of the run")
    pd.add_argument("--process-id", type=int, default=0, metavar="I", help="with --dist-dir: this process's rank, 0..N-1")
    pd.add_argument("--assemblies-out", metavar="CSV", help="dump the scored wavefront assemblies to this CSV")
    pd.add_argument("--exclude", metavar="BED", help="drop calls overlapping these regions")
    _device_arg(pd)
    pd.set_defaults(fn=cmd_discovery)

    pcov = sub.add_parser("coverage", help="annotate + genotype a VCF (pcmp)")
    pcov.add_argument("--vcf", required=True)
    pcov.add_argument("--biograph", required=True)
    pcov.add_argument("--ref", required=True)
    pcov.add_argument("--out", required=True)
    pcov.add_argument("--sample", default="SAMPLE")
    pcov.add_argument("--features", help="write classifier feature matrix (.npz)")
    pcov.add_argument("--joint-graph", action="store_true", dest="joint_graph",
                      help="re-genotype via the variant-graph path walk (vargraph analog)")
    pcov.add_argument("--workers", type=int, default=1, help="region-parallel worker processes")
    _device_arg(pcov)
    pcov.set_defaults(fn=cmd_coverage)

    pf = sub.add_parser("full_pipeline", help="reads -> results VCF, all stages")
    pf.add_argument("--reads", nargs="+", required=True)
    pf.add_argument("--ref", required=True)
    pf.add_argument("--out", required=True)
    pf.add_argument("--sample", default="SAMPLE")
    pf.add_argument("--kmer-size", type=int, default=23)
    pf.add_argument("--paired", action="store_true")
    pf.add_argument("--correct", action="store_true")
    pf.add_argument("--min-depth", type=int, default=5)
    pf.add_argument("--region")
    pf.add_argument("--classifier-model", help="trained model .npz")
    pf.add_argument("--resume", action="store_true")
    pf.add_argument("--stop", help="halt after the named stage")
    pf.add_argument("--rerun", help="force one named stage to run again, keeping every other completed stage's artifact")
    _device_arg(pf)
    pf.set_defaults(fn=cmd_full_pipeline)

    pg = sub.add_parser("grm", help="SV breakend mappability annotation")
    pg.add_argument("--vcf", required=True)
    pg.add_argument("--ref", required=True)
    pg.add_argument("--bwt", help="prebuilt ref2bwt artifact (else built)")
    pg.add_argument("--cache-dir", help="keep the FM-index built from --ref here, keyed by the reference's bytes")
    pg.add_argument("--out", required=True)
    pg.add_argument("--sample", default="SAMPLE")
    pg.add_argument("--k", type=int, default=50)
    _device_arg(pg)
    pg.set_defaults(fn=cmd_grm)

    pq = sub.add_parser("qual_classifier", help="variant quality classifier")
    pq.add_argument("--vcf", required=True)
    pq.add_argument("--features", required=True)
    pq.add_argument("--train", action="store_true")
    pq.add_argument("--truth-vcf", help="truth VCF for --train labels")
    pq.add_argument("--model", required=True, help="model .npz path")
    pq.add_argument("--out", help="output VCF (apply mode)")
    pq.add_argument("--min-prob", type=float, default=0.5)
    pq.add_argument("--sample", default="SAMPLE")
    _device_arg(pq)
    pq.set_defaults(fn=cmd_qual_classifier)

    pgt = sub.add_parser("gt_classifier", help="ML re-genotyper (GT/GQ/PL)")
    pgt.add_argument("--vcf", required=True, help="VCF to re-genotype (or GT label source with --train)")
    pgt.add_argument("--features", required=True, help="coverage features .npz")
    pgt.add_argument("--train", action="store_true")
    pgt.add_argument("--model", required=True, help="model .npz path")
    pgt.add_argument("--out", help="output VCF (apply mode)")
    pgt.add_argument("--sample", default="SAMPLE")
    _device_arg(pgt)
    pgt.set_defaults(fn=cmd_gt_classifier)

    pqr = sub.add_parser("query", help="query a seqset for a DNA string")
    pqr.add_argument("--biograph", required=True)
    pqr.add_argument("--query", required=True)
    pqr.add_argument("--verbose", action="store_true", help="print more than 10 matching entries")
    pqr.add_argument("--quiet", action="store_true")
    _device_arg(pqr)
    pqr.set_defaults(fn=cmd_query)

    pdf = sub.add_parser("dump_flat", help="dump all seqset entry sequences")
    pdf.add_argument("--biograph", required=True)
    pdf.add_argument("--out", help="output file (default stdout)")
    _device_arg(pdf)
    pdf.set_defaults(fn=cmd_dump_flat)

    pr2s = sub.add_parser("ref2seqset", help="seqset from the reference itself")
    pr2s.add_argument("--ref", required=True)
    pr2s.add_argument("--out", required=True)
    pr2s.add_argument("--read-size", type=int, default=100)
    _device_arg(pr2s)
    pr2s.set_defaults(fn=cmd_ref2seqset)

    pmd = sub.add_parser("metadata", help="show/edit biograph dir metadata")
    pmd.add_argument("biograph", nargs="+")
    pmd.add_argument("--set-sample-id", default=None)
    pmd.add_argument("--set-accession-id", default=None)
    pmd.set_defaults(fn=cmd_metadata)

    pe = sub.add_parser("export_fastq", help="reconstruct reads -> FASTQ")
    pe.add_argument("--biograph", required=True)
    pe.add_argument("--out", required=True)
    _device_arg(pe)
    pe.set_defaults(fn=cmd_export_fastq)

    ps = sub.add_parser("stats", help="biograph dir stats")
    ps.add_argument("biograph")
    _device_arg(ps)
    ps.set_defaults(fn=cmd_stats)

    pu = sub.add_parser("upgrade", help="convert reference .bg to .bgt")
    pu.add_argument("--in", dest="input", required=True)
    pu.add_argument("--out", required=True)
    _device_arg(pu)
    pu.set_defaults(fn=cmd_upgrade)

    pea = sub.add_parser("export_aligned", help="aligned reads -> SAM/BAM")
    pea.add_argument("--biograph", required=True)
    pea.add_argument("--ref", required=True)
    pea.add_argument("--vcf", help="restrict to windows around these variants")
    pea.add_argument("--out", required=True, help=".sam or .bam")
    pea.add_argument("--window", type=int, default=400)
    pea.add_argument("--max-mismatches", type=int, default=5)
    pea.add_argument("--include-unplaced", action="store_true")
    _device_arg(pea)
    pea.set_defaults(fn=cmd_export_aligned)

    ph = sub.add_parser("refhash", help="reference fingerprint")
    ph.add_argument("--ref", required=True)
    ph.set_defaults(fn=cmd_refhash)

    psq = sub.add_parser("squareoff", help="joint multi-sample re-genotyping")
    psq.add_argument("--vcfs", nargs="+", required=True)
    psq.add_argument("--biographs", nargs="+", required=True)
    psq.add_argument("--ref", required=True)
    psq.add_argument("--out", required=True)
    psq.add_argument("--samples", nargs="+")
    _device_arg(psq)
    psq.set_defaults(fn=cmd_squareoff)

    ppv = sub.add_parser("pvcf_pipe", help="project VCF: squareoff + meanno")
    ppv.add_argument("--biographs", nargs="+", required=True, help=".bgt dirs")
    ppv.add_argument("--vcfs", nargs="+", required=True, help="per-sample discovery VCFs forming the union")
    ppv.add_argument("-r", "--ref", required=True)
    ppv.add_argument("-p", "--pedigree", help="PED file (enables meanno)")
    ppv.add_argument("--samples", nargs="+", help="sample names (match PED)")
    ppv.add_argument("-o", "--output", required=True)
    _device_arg(ppv)
    ppv.set_defaults(fn=cmd_pvcf_pipe)

    pvp = sub.add_parser("vcf_sample_paste", help="paste single-sample VCFs")
    pvp.add_argument("vcfs", nargs="+")
    pvp.add_argument("-o", "--output", default="/dev/stdout")
    pvp.set_defaults(fn=cmd_vcf_tools)

    pff = sub.add_parser("freq_filter", help="filter VCF by cohort support")
    pff.add_argument("-v", "--variants", required=True, help="VCF ('-' = stdin)")
    pff.add_argument("-o", "--output", default="/dev/stdout")
    pff.add_argument("-m", "--min-observations", type=int, default=1)
    pff.add_argument("-i", "--individuals", type=int, default=1)
    pff.add_argument("-d", "--depth-field", default="AD")
    pff.set_defaults(fn=cmd_vcf_tools)

    prc = sub.add_parser("rvg_cleaner", help="drop pair-bare unphased noise")
    prc.add_argument("-v", "--variants", default="/dev/stdin")
    prc.add_argument("-o", "--output", default="/dev/stdout")
    prc.set_defaults(fn=cmd_vcf_tools)

    pml = sub.add_parser("vcf_to_ml_table", help="VCF -> per-allele ML table")
    pml.add_argument("vcf")
    pml.add_argument("-o", "--output", default="/dev/stdout")
    pml.set_defaults(fn=cmd_vcf_tools)

    pmn = sub.add_parser("mendelian", help="trio Mendelian-error annotation")
    pmn.add_argument("-v", "--vcf", required=True, help="family VCF ('-' = stdin)")
    pmn.add_argument("-p", "--pedigree", required=True, help="PED file")
    pmn.add_argument(
        "-r",
        "--ref-count",
        action="store_true",
        help="count all-hom-ref trios as consistent instead of skipping",
    )
    pmn.add_argument("-o", "--output", required=True, help="annotated VCF out")
    pmn.set_defaults(fn=cmd_mendelian)

    pv = sub.add_parser("vdb", help="local variant warehouse")
    vsub = pv.add_subparsers(dest="vdb_cmd", required=True)
    # flat VDB-lite spellings (kept for compatibility)
    vi = vsub.add_parser("ingest", help="(flat) import a VCF under a sample name")
    vi.add_argument("--db", required=True)
    vi.add_argument("--vcf", required=True)
    vi.add_argument("--sample", required=True)
    vl = vsub.add_parser("list", help="(flat) list samples")
    vl.add_argument("--db", required=True)
    vq = vsub.add_parser("query", help="filter query, or raw SQL when SQL is given")
    vq.add_argument("--db", required=True)
    vq.add_argument("sql", nargs="?", help="raw SELECT over the warehouse tables")
    vq.add_argument("--sample")
    vq.add_argument("--chrom")
    vq.add_argument("--pos-min", type=int)
    vq.add_argument("--pos-max", type=int)
    vq.add_argument("--min-qual", type=float)
    vq.add_argument("--passing", action="store_true")
    vq.add_argument("--limit", type=int, default=50)
    ve = vsub.add_parser("export", help="(flat) export a sample to VCF")
    ve.add_argument("--db", required=True)
    ve.add_argument("--sample", required=True)
    ve.add_argument("--out", required=True)
    # vcf group (reference: python/biograph/vdb/vcf_cmd.py)
    pvv = vsub.add_parser("vcf", help="imported-VCF datasets")
    vvsub = pvv.add_subparsers(dest="vcf_cmd", required=True)
    x = vvsub.add_parser("import")
    x.add_argument("--db", required=True)
    x.add_argument("input")
    x.add_argument("-s", "--sample", help="sample name (default: from VCF header)")
    x.add_argument("-d", "--description", default="")
    x.add_argument("-r", "--refname", help="reference name/hash (default: from file)")
    x.add_argument("--aid", help="explicit GUID (default: autogenerate)")
    x = vvsub.add_parser("list")
    x.add_argument("--db", required=True)
    x.add_argument("-s", "--sample", help="sample name prefix filter")
    x = vvsub.add_parser("export")
    x.add_argument("--db", required=True)
    x.add_argument("-a", "--aid", required=True)
    x.add_argument("-o", "--output", default="/dev/stdout")
    x = vvsub.add_parser("delete")
    x.add_argument("--db", required=True)
    x.add_argument("aid", nargs="+")
    x = vvsub.add_parser("sort")
    x.add_argument("-i", "--input", default="/dev/stdin")
    x.add_argument("-o", "--output", default="/dev/stdout")
    x.add_argument("-c", "--chromosomal", action="store_true", help="natural order (1,2,10,X) instead of alphabetic")
    x.set_defaults(db=".")  # sort is file->file; no warehouse needed
    # anno group (anno_cmd.py)
    pva = vsub.add_parser("anno", help="annotation datasets")
    vasub = pva.add_subparsers(dest="anno_cmd", required=True)
    x = vasub.add_parser("import")
    x.add_argument("--db", required=True)
    x.add_argument("input")
    x.add_argument("-n", "--name", required=True)
    x.add_argument("-V", "--version", default="1")
    x = vasub.add_parser("list")
    x.add_argument("--db", required=True)
    x = vasub.add_parser("export")
    x.add_argument("--db", required=True)
    x.add_argument("-a", "--aid", required=True, help="aid or annotation name")
    x.add_argument("-o", "--output", default="/dev/stdout")
    x = vasub.add_parser("delete")
    x.add_argument("--db", required=True)
    x.add_argument("aid", nargs="+")
    # study group (study_cmd.py)
    pvs = vsub.add_parser("study", help="checkpointed variant studies")
    vssub = pvs.add_subparsers(dest="study_cmd", required=True)
    for name in ("create", "show", "freeze", "unfreeze", "delete"):
        x = vssub.add_parser(name)
        x.add_argument("--db", required=True)
        x.add_argument("study_name")
    x = vssub.add_parser("list")
    x.add_argument("--db", required=True)
    x = vssub.add_parser("add")
    x.add_argument("--db", required=True)
    x.add_argument("study_name")
    x.add_argument("sample", nargs="+", help="sample name (wildcards ok) or aid")
    x.add_argument("--from", dest="src_study", help="copy from this study")
    x.add_argument("--checkpoint", type=int, help="with --from: source checkpoint")
    x = vssub.add_parser("filter")
    x.add_argument("--db", required=True)
    x.add_argument("study_name")
    g = x.add_mutually_exclusive_group(required=True)
    g.add_argument("-i", "--include", help="keep variants matching this filter")
    g.add_argument("-e", "--exclude", help="drop variants matching this filter")
    x = vssub.add_parser("export")
    x.add_argument("--db", required=True)
    x.add_argument("study_name")
    x.add_argument("-o", "--output", default="/dev/stdout")
    x.add_argument("-a", "--anno")
    x.add_argument("-c", "--chromosomal", action="store_true")
    x.add_argument("--fields", help="FORMAT fields to export, ':'-separated")
    x.add_argument("--checkpoint", type=int)
    x.add_argument("--square-off", dest="square_off")
    x.add_argument("--no-header", dest="no_header", action="store_true")
    x = vssub.add_parser("revert")
    x.add_argument("--db", required=True)
    x.add_argument("study_name")
    x.add_argument("--checkpoint", type=int, help="target (default: back one)")
    pv.set_defaults(fn=cmd_vdb)
    for sp in sub.choices.values():
        sp.add_argument("--profile", metavar="DIR",
                        help="trace the command, host and device, into DIR/<command>.json (Perfetto, chrome://tracing)")

    args = p.parse_args(argv)
    # one file a process where several run one command
    process = args.process_id if getattr(args, "dist_dir", None) and args.num_processes > 1 else None
    with maybe_profile(args.cmd, args.profile, process):
        args.fn(args)


if __name__ == "__main__":
    main()
