"""Command-line interface of the port: the product's pipeline.

Counterpart of ``biograph_tpu/cli.py`` (the reference's command surface,
modules/biograph/main.cpp:51-70, and its pipeline, python/biograph/tools/
bgbinary_cmds.py:332-372): ``version``, ``reference``, ``create``,
``kmers``, ``merge``, ``ref2bwt``, ``bwtquery``, ``discovery``,
``coverage``, ``grm``, ``qual_classifier``, ``gt_classifier`` and
``full_pipeline`` take the JAX package's arguments and write the same
artifacts, plus ``--device`` (default ``cuda``; the tests pass ``cpu``).
``grm`` takes ``--cache-dir`` where the JAX package reads ``BGT_CACHE``;
``full_pipeline`` keeps its FM-index cache under its run dir and writes
discovery's counters to ``qc/discovery_stats.json``.  The JAX package's
other subcommands wait for the modules they call; BAM/SAM, CRAM and QSEQ
input waits for ``io/bam.py``, ``io/cram.py`` and ``io/qseq.py``, a BWA
``.pac`` reference dir for ``io/pac.py``, and ``discovery --dist-dir`` for
``parallel/discovery.py``.

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


def _is_artifact(path):
    from biograph_tpu_torch.core import container

    return os.path.isdir(path) and container.exists(path)


def _load_reference(path):
    """A reference artifact dir, a dir holding a FASTA, or a FASTA file."""
    from biograph_tpu_torch.index.reference import Reference

    if _is_artifact(path):
        return Reference.load(path)
    return Reference.from_reference_dir(path) if os.path.isdir(path) else Reference.from_fasta(path)


def cmd_reference(args):
    """FASTA (or a dir holding one) -> reference artifact.
    (reference: bgbinary reference, modules/main/make_ref.cpp:21)"""
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
    if args.dist_dir:
        raise NotImplementedError("discovery --dist-dir needs parallel/discovery.py, which is not ported yet")
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
    else:
        asm_dump = [] if args.assemblies_out else None
        recs = discover_variants(bg.seqset, ref, region=region, opt=opt, readmap=bg.readmap, out_assemblies=asm_dump, stats=stats)
        if asm_dump is not None:
            n = write_assembly_csv(args.assemblies_out, ref, asm_dump)
            print(f"assemblies: {n} -> {args.assemblies_out}")
    n_wave = len(recs)
    if bg.readmap is not None and not args.no_sv:
        # the pair/split SV pass (pop_tracer): events past the wavefront's
        # path cap, merged into the same records
        from biograph_tpu_torch.variants.pop_tracer import discover_structural, reads_from_readmap

        t0 = time.time()
        sv_stats = stats.setdefault("sv", {})
        codes, lens, mate = reads_from_readmap(bg.readmap)
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
    if args.mode == "assemble":
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
        if args.stats:
            # engine counters and per-stage seconds (bgbinary --stats,
            # modules/io/runtime_stats.h:14-50)
            stats["stage_s"] = {k: round(v, 3) for k, v in stats.get("stage_s", {}).items()}
            with open(args.stats, "w") as f:
                json.dump(stats, f, indent=1, default=int)
        excluded = f" -> {len(recs)} after exclusion" if len(recs) != n_wave + n_sv else ""
        print(f"discovery: {n_wave} assembled + {n_sv} SV records{excluded} ({time.time()-t0:.1f}s)")
        write_discovery_vcf(args.out, ref, recs, sample=args.sample, opt=opt)
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
            from biograph_tpu_torch.variants.pop_tracer import reads_from_readmap

            bg = BioGraph(args.biograph, device=dev)
            if bg.readmap is None:
                raise SystemExit(f"{args.biograph}: no readmap")
            codes, lengths, _ = reads_from_readmap(bg.readmap)
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
    stages = [
        Stage(name="create", outputs=[os.path.join(bgt, "metadata.json")], fn=lambda r: main(create + dev)),
        Stage(name="discovery", outputs=[vcf["discovery"]], fn=lambda r: main(discovery + dev)),
        Stage(name="coverage", outputs=[vcf["coverage"]], fn=lambda r: main(coverage + dev)),
        Stage(name="grm", outputs=[vcf["grm"]], fn=lambda r: main(grm + dev)),
    ]
    if args.classifier_model:
        qual = ["qual_classifier", "--vcf", vcf["grm"], "--features", feats, "--model", args.classifier_model,
                "--out", vcf["results"], "--min-prob", "0.5", "--sample", args.sample]
        stages.append(Stage(name="qual_classifier", outputs=[vcf["results"]], fn=lambda r: main(qual + dev)))

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
                    help="shared run dir of region-sharded multi-process discovery (needs parallel/discovery.py)")
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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
