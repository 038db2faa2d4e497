"""Coverage annotation and Bayesian genotyping of VCF variants (torch).

Counterpart of ``biograph_tpu/variants/coverage_tool.py``.  For every VCF
record the alt haplotype window (left flank + alt + right flank, the flanks
taken from the donor genome with every record applied) and the matching ref
window go through ``Readmap.coverage`` in one batch of records; allele
depths feed a binomial ref/het/hom genotyper; the result is an annotated VCF
and a feature matrix for the quality classifier.

The device work is the coverage walk (and, for pair coverage, read
reconstruction and placement): it runs on the readmap's device and ends in
one host copy a batch.  Everything after it (window statistics, genotypes,
PL and GQ) is numpy float64, as in the JAX package, so the numbers are the
same, not close.  ``run_coverage_parallel`` fans region chunks out to
spawned processes, each opening the sample on the caller's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch
from scipy.special import gammaln

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.vcf import VcfRecord, VcfWriter, read_vcf

WIN_CAP = 192  # alleles longer than 2 * WIN_CAP + C score at their breakpoints
BATCH = 128  # records a coverage batch
READ_CHUNK = 1 << 14  # reads rebuilt a chunk for pair coverage


def genotyper_log10(tot_cov: np.ndarray, alt_cov: np.ndarray, priors=(0.05, 0.5, 0.95)):
    """Vectorized binomial genotype likelihoods: log10-likelihoods [N, 3]
    for 0, 1 and 2 alt copies."""
    tot = np.asarray(tot_cov, np.int64)
    alt = np.minimum(np.asarray(alt_cov, np.int64), tot)
    non = tot - alt
    comb = (gammaln(tot + 1) - gammaln(alt + 1) - gammaln(non + 1)) / np.log(10)
    out = np.zeros((len(tot), 3))
    for g, p in enumerate(priors):
        out[:, g] = comb + alt * np.log10(p) + non * np.log10(1 - p)
    return out


@dataclass
class CoverageAnnotation:
    alt_depth: np.ndarray  # int32 [N] min coverage across the best alt allele's window
    ref_depth: np.ndarray  # int32 [N] min coverage across the ref allele's window
    gt: List[str]
    gq: np.ndarray  # int32 [N]
    pl: np.ndarray  # int32 [N, 3]
    ad: List[str] = None  # "ref,alt1[,alt2...]" per record
    # min depth over the window's upstream / downstream flank, per allele
    us_alt: np.ndarray = None  # int32 [N]
    ds_alt: np.ndarray = None
    us_ref: np.ndarray = None
    ds_ref: np.ndarray = None
    # window shape per allele: max depth, mean depth, min of the two edge depths
    xc_alt: np.ndarray = None  # int32 [N]
    mc_alt: np.ndarray = None  # float32 [N]
    ec_alt: np.ndarray = None  # int32 [N]
    xc_ref: np.ndarray = None
    mc_ref: np.ndarray = None
    ec_ref: np.ndarray = None
    # GC share of the allele window
    gc_alt: np.ndarray = None  # float32 [N]
    gc_ref: np.ndarray = None


_DNA_CHARS = frozenset("ACGTacgt")


def _is_dna(s: str) -> bool:
    """True for a plain A/C/G/T allele (symbolic <DEL>, breakends, '*' and
    IUPAC codes cannot be walked through the seqset)."""
    return len(s) > 0 and all(ch in _DNA_CHARS for ch in s)


def build_donor(ref_flat: np.ndarray, flat_records: List[tuple]):
    """Apply variants to the reference -> (donor codes, donor position of
    each reference position, applied mask).

    flat_records: [(flat_p0, ref_codes, alt_codes)] sorted; a record that
    overlaps an applied one, or runs past the genome, is skipped."""
    G = len(ref_flat)
    pieces = []
    applied = np.zeros(len(flat_records), bool)
    donor_of_ref = np.zeros(G + 1, np.int64)
    prev = 0
    offset = 0
    last_end = 0
    for i, (p0, ra, aa) in enumerate(flat_records):
        if p0 < last_end or p0 + len(ra) > G:
            continue
        pieces.append(ref_flat[prev:p0])
        pieces.append(aa)
        donor_of_ref[prev:p0] = np.arange(prev, p0) + offset
        # positions inside the replaced span map to its start
        donor_of_ref[p0 : p0 + len(ra)] = p0 + offset
        applied[i] = True
        offset += len(aa) - len(ra)
        prev = p0 + len(ra)
        last_end = prev
    pieces.append(ref_flat[prev:])
    donor_of_ref[prev : G + 1] = np.arange(prev, G + 1) + offset
    donor = np.concatenate(pieces) if pieces else ref_flat.copy()
    return donor, donor_of_ref, applied


def _padded(queries):
    """uint8 [B, L] rows and int32 [B] lengths of a list of code arrays."""
    L = max(len(q) for q in queries)
    qc = np.zeros((len(queries), L), np.uint8)
    ql = np.zeros(len(queries), np.int32)
    for i, q in enumerate(queries):
        qc[i, : len(q)] = q
        ql[i] = len(q)
    return qc, ql


def annotate_coverage(readmap, reference, records: List[VcfRecord], batch: int = BATCH) -> CoverageAnnotation:
    """Allele depths and genotypes for VCF records.

    Alleles are evaluated on the donor genome (every sorted, non-overlapping
    record applied), so neighbouring variants keep their reads.  A
    multi-allelic record gets a depth an alt allele (AD lists them all) and
    its genotype from the best-supported pair of alleles.  Symbolic and
    non-ACGT alleles come back './.' with zero depths."""
    if not records:
        return CoverageAnnotation(
            np.zeros(0, np.int32), np.zeros(0, np.int32), [], np.zeros(0, np.int32),
            np.zeros((0, 3), np.int32), [],
        )
    ref_flat = np.asarray(reference.flat)
    C = int(readmap.max_read_len) + 2
    N = len(records)
    alt_depth = np.zeros(N, np.int32)
    ref_depth = np.zeros(N, np.int32)

    alts_of: List[List[str]] = []
    valid = np.ones(N, bool)
    for i, rec in enumerate(records):
        alts = rec.alt.split(",")
        if not _is_dna(rec.ref) or not all(_is_dna(a) for a in alts):
            valid[i] = False
            alts_of.append([])
        else:
            alts_of.append(alts)

    flat_records = []
    for i, rec in enumerate(records):
        contig = reference.contig_by_name(rec.chrom)
        p0 = contig.start + rec.pos - 1
        ra = dna.seq_to_codes(rec.ref) if valid[i] else np.zeros(0, np.uint8)
        aa = dna.seq_to_codes(alts_of[i][0]) if valid[i] else ra
        flat_records.append((p0, ra, aa))
    order = sorted((i for i in range(N) if valid[i]), key=lambda i: flat_records[i][0])
    donor, donor_of_ref, _ = build_donor(ref_flat, [flat_records[i] for i in order])

    # one query an alt allele and one for the ref allele of each valid
    # record; a giant allele is evaluated at its two breakpoint windows
    all_alt_depths = [np.zeros(max(len(a), 1), np.int32) for a in alts_of]
    flank_min: dict = {}
    win_stats: dict = {}
    work = [i for i in range(N) if valid[i]]
    for lo in range(0, len(work), batch):
        chunk = work[lo : lo + batch]
        queries = []
        spans = []
        owners = []
        alleles = []

        def emit(ri, ai, left, mid, right):
            lo_b = max(len(left) - 1, 0)
            if len(mid) <= 2 * WIN_CAP + C:
                queries.append(np.concatenate([left, mid, right]))
                spans.append((lo_b, lo_b + len(mid) + 1))
                owners.append(ri)
                alleles.append(ai)
            else:
                # left breakpoint: the window stops C short of the cut, so
                # positions of truncated context stay out of the min
                queries.append(np.concatenate([left, mid[: WIN_CAP + C]]))
                spans.append((lo_b, len(left) + WIN_CAP))
                owners.append(ri)
                alleles.append(ai)
                # right breakpoint: the last WIN_CAP allele bases (positions
                # >= C have full context in the row) through the junction
                queries.append(np.concatenate([mid[-(WIN_CAP + C) :], right]))
                spans.append((C, WIN_CAP + C + 1))
                owners.append(ri)
                alleles.append(ai)

        for ri in chunk:
            p0, ref_allele, _ = flat_records[ri]
            dp0 = int(donor_of_ref[p0])
            left = donor[max(dp0 - C, 0) : dp0]
            dright_start = int(donor_of_ref[min(p0 + len(ref_allele), len(ref_flat))])
            right = donor[dright_start : dright_start + C]
            for ai, alt_str in enumerate(alts_of[ri]):
                emit(ri, ai, left, dna.seq_to_codes(alt_str), right)
            emit(ri, -1, left, ref_allele, right)
        qc, ql = _padded(queries)
        fwd, rev = readmap.coverage(qc, ql)
        tot = (fwd + rev).cpu().numpy()
        depth_min: dict = {}
        for i, (ri, ai) in enumerate(zip(owners, alleles)):
            lo_b, hi_b = spans[i]
            win = tot[i, lo_b : min(hi_b, ql[i])]
            depth = int(win.min()) if len(win) else 0
            key = (ri, ai)
            depth_min[key] = min(depth_min.get(key, 1 << 30), depth)
            if len(win):
                # window shape; split giant alleles combine max of maxes,
                # mean of means and min of edges
                k3 = (ri, ai, "xc")
                win_stats[k3] = max(win_stats.get(k3, 0), int(win.max()))
                k3 = (ri, ai, "mc")
                prev = win_stats.get(k3, (0.0, 0))
                win_stats[k3] = (prev[0] + float(win.mean()), prev[1] + 1)
                k3 = (ri, ai, "ec")
                edge = int(min(win[0], win[-1]))
                win_stats[k3] = min(win_stats.get(k3, 1 << 30), edge)
            mid_codes = qc[i, lo_b : min(hi_b, ql[i])]
            if len(mid_codes):
                k3 = (ri, ai, "gc")
                prev = win_stats.get(k3, (0.0, 0))
                win_stats[k3] = (
                    prev[0] + float(np.mean((mid_codes == 1) | (mid_codes == 2))),
                    prev[1] + 1,
                )
            # flank minima: upstream the window's left flank, downstream its
            # right (a split allele contributes the flank each window carries)
            left = tot[i, :lo_b]
            right = tot[i, hi_b : ql[i]]
            if len(left):
                k2 = (ri, ai, "us")
                flank_min[k2] = min(flank_min.get(k2, 1 << 30), int(left.min()))
            if len(right):
                k2 = (ri, ai, "ds")
                flank_min[k2] = min(flank_min.get(k2, 1 << 30), int(right.min()))
        for (ri, ai), depth in depth_min.items():
            if ai < 0:
                ref_depth[ri] = depth
            else:
                all_alt_depths[ri][ai] = depth

    # the best alt allele of each record drives the binomial genotyper
    best_alt = np.array([int(np.argmax(d)) if valid[i] else 0 for i, d in enumerate(all_alt_depths)])
    us_alt = np.zeros(N, np.int32)
    ds_alt = np.zeros(N, np.int32)
    us_ref = np.zeros(N, np.int32)
    ds_ref = np.zeros(N, np.int32)
    xc = {"alt": np.zeros(N, np.int32), "ref": np.zeros(N, np.int32)}
    mc = {"alt": np.zeros(N, np.float32), "ref": np.zeros(N, np.float32)}
    ec = {"alt": np.zeros(N, np.int32), "ref": np.zeros(N, np.int32)}
    gc = {"alt": np.zeros(N, np.float32), "ref": np.zeros(N, np.float32)}
    for i in range(N):
        us_alt[i] = flank_min.get((i, int(best_alt[i]), "us"), 0)
        ds_alt[i] = flank_min.get((i, int(best_alt[i]), "ds"), 0)
        us_ref[i] = flank_min.get((i, -1, "us"), 0)
        ds_ref[i] = flank_min.get((i, -1, "ds"), 0)
        for name, ai in (("alt", int(best_alt[i])), ("ref", -1)):
            xc[name][i] = win_stats.get((i, ai, "xc"), 0)
            m = win_stats.get((i, ai, "mc"))
            mc[name][i] = m[0] / m[1] if m else 0.0
            e = win_stats.get((i, ai, "ec"), 0)
            ec[name][i] = 0 if e == (1 << 30) else e
            g = win_stats.get((i, ai, "gc"))
            gc[name][i] = g[0] / g[1] if g else 0.0
    alt_depth = np.array([int(d[best_alt[i]]) for i, d in enumerate(all_alt_depths)], np.int32)
    tot_cov = alt_depth + ref_depth
    gl = genotyper_log10(np.maximum(tot_cov, 1), alt_depth)
    gorder = np.argsort(-gl, axis=1)
    best = gorder[:, 0]
    second = gorder[:, 1]
    pl = np.round(-10 * (gl - gl[np.arange(N), best][:, None])).astype(np.int32)
    gq = np.round(10 * (gl[np.arange(N), best] - gl[np.arange(N), second])).astype(np.int32)
    gt = []
    ad = []
    for i in range(N):
        if not valid[i] or tot_cov[i] <= 0:
            gt.append("./.")
            ad.append(",".join(["0"] * (1 + max(len(alts_of[i]), 1))))
            continue
        k = int(best_alt[i]) + 1  # 1-based allele index
        names = {0: "0/0", 1: f"0/{k}", 2: f"{k}/{k}"}
        g = names[int(best[i])]
        # het-alt: two alt alleles both strongly supported, little ref
        if len(alts_of[i]) >= 2:
            d = all_alt_depths[i].astype(np.int64)
            o2 = np.argsort(-d)
            a1, a2 = int(o2[0]), int(o2[1])
            total = int(d.sum()) + int(ref_depth[i])
            if d[a2] >= 3 and d[a2] >= 0.25 * total and ref_depth[i] < 0.2 * total:
                g = f"{min(a1, a2) + 1}/{max(a1, a2) + 1}"
        gt.append(g)
        ad.append(f"{int(ref_depth[i])}," + ",".join(str(int(x)) for x in all_alt_depths[i]))
    return CoverageAnnotation(
        alt_depth=alt_depth, ref_depth=ref_depth, gt=gt, gq=gq, pl=pl, ad=ad,
        us_alt=us_alt, ds_alt=ds_alt, us_ref=us_ref, ds_ref=ds_ref,
        xc_alt=xc["alt"], mc_alt=mc["alt"], ec_alt=ec["alt"],
        xc_ref=xc["ref"], mc_ref=mc["ref"], ec_ref=ec["ref"],
        gc_alt=gc["alt"], gc_ref=gc["ref"],
    )


def sample_reads(readmap):
    """The sample's reads rebuilt from the store, forward orientation:
    (forward readmap entries int64 [R], codes uint8 [R, L], lengths int32
    [R]), on the host.  The bases come from ``Seqset.d.sequences`` a chunk
    of READ_CHUNK reads at a time, on the readmap's device."""
    rm = readmap
    fwd_ids = torch.nonzero(rm.is_forward)[:, 0]
    entries = rm.entry_of_rm[fwd_ids]
    lens = rm.read_lengths[fwd_ids].cpu().numpy()
    L = int(lens.max(initial=1))
    codes = np.zeros((len(lens), L), np.uint8)
    for lo in range(0, len(lens), READ_CHUNK):
        hi = min(len(lens), lo + READ_CHUNK)
        codes[lo:hi] = rm.seqset.d.sequences(entries[lo:hi], L).cpu().numpy()
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    return fwd_ids.cpu().numpy(), codes, lens


def annotate_pair_coverage(readmap, reference, records: List[VcfRecord], max_frag: int = 1000) -> np.ndarray:
    """Mate-pair support a variant: the sample's reads, rebuilt from the
    readmap, are placed on the donor genome, and read pairs with both mates
    placed within max_frag on opposite strands whose span covers the
    variant are counted.  Returns int32 [N] pair counts."""
    from biograph_tpu_torch.variants.align import RefKmerIndex, place_reads

    N = len(records)
    if N == 0 or readmap is None:
        return np.zeros(N, np.int32)
    rm = readmap
    loop = rm.mate_pair_ptr.cpu().numpy()
    mate2 = loop[loop]  # the mate's forward entry (fwd -> rc -> mate's fwd); self if unpaired
    fwd_ids, codes, lens = sample_reads(rm)
    # the donor with the first alt allele of every record applied (symbolic
    # and non-ACGT alleles are left out and get no pair count)
    ref_flat = np.asarray(reference.flat)
    flat_records = []
    valid = np.ones(N, bool)
    for i, rec in enumerate(records):
        contig = reference.contig_by_name(rec.chrom)
        p0 = contig.start + rec.pos - 1
        alt1 = rec.alt.split(",")[0]
        if not _is_dna(rec.ref) or not _is_dna(alt1):
            valid[i] = False
            flat_records.append((p0, np.zeros(0, np.uint8), np.zeros(0, np.uint8)))
        else:
            flat_records.append((p0, dna.seq_to_codes(rec.ref), dna.seq_to_codes(alt1)))
    order = sorted((i for i in range(N) if valid[i]), key=lambda i: flat_records[i][0])
    donor, donor_of_ref, _ = build_donor(ref_flat, [flat_records[i] for i in order])
    idx = RefKmerIndex.build(donor, 13, device=rm.device)
    pl = place_reads(idx, codes, lens, max_mismatches=3)

    # the readmap's forward entry -> its index among the forward entries
    pos_of_fwd = np.full(rm.num_entries, -1, np.int64)
    pos_of_fwd[fwd_ids] = np.arange(len(fwd_ids))
    mate_idx = pos_of_fwd[mate2[fwd_ids]]  # an index into the forward arrays, or self
    mate_c = np.clip(mate_idx, 0, len(fwd_ids) - 1)
    placed = pl.pos >= 0
    paired = (mate_idx != np.arange(len(fwd_ids))) & (mate_idx >= 0)
    both = placed & paired & placed[mate_c]
    frag_ok = both & (np.abs(pl.pos - pl.pos[mate_c]) <= max_frag)
    frag_ok &= pl.is_rc != pl.is_rc[mate_c]  # proper orientation: opposite strands

    # the pair's span on the donor
    a = np.minimum(pl.pos, pl.pos[mate_c])
    b = np.maximum(pl.pos + lens, pl.pos[mate_c] + lens)
    sel = np.nonzero(frag_ok)[0]
    a, b = a[sel], b[sel]
    pc = np.zeros(N, np.int32)
    for i in range(N):
        if not valid[i]:
            continue
        p0, ra, aa = flat_records[i]
        dlo = int(donor_of_ref[p0])
        dhi = dlo + len(aa)
        cover = (a <= dlo) & (b >= dhi)
        pc[i] = int(cover.sum()) // 2  # each pair is counted from both mates
    return pc


COVERAGE_HEADERS = [
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="Total allele depth">',
    '##INFO=<ID=PC,Number=1,Type=Integer,Description="Read pairs spanning the variant in proper orientation">',
    '##INFO=<ID=VG,Number=1,Type=Integer,Description="Best variant-graph edge traversal count (joint path context)">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths (ref,alt)">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred genotype likelihoods">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">',
]


def run_coverage(
    vcf_in: str,
    vcf_out: str,
    biograph,
    reference,
    sample: str = "SAMPLE",
    features_out: str | None = None,
    pair_cov: bool = True,
    phase: bool = True,
    joint_graph: bool = False,
):
    """Annotate a VCF with coverage evidence and genotypes.

    pair_cov adds the PC INFO field (mate pairs spanning the variant; zero
    unless the readmap is paired); phase links read-spanned het pairs into
    '|'-phased blocks with PS tags; joint_graph genotypes through the
    variant-graph path walk (``variants/vargraph.py``) and adds VG, the best
    edge traversal count.  The sample's device is its readmap's."""
    records = read_vcf(vcf_in)
    ann = annotate_coverage(biograph.readmap, reference, records)
    vg = None
    if joint_graph:
        from biograph_tpu_torch.variants.vargraph import evaluate_vargraph

        vg = evaluate_vargraph(biograph.readmap, reference, records)
        ann.gt[:] = vg.gt
    if pair_cov:
        pc = annotate_pair_coverage(biograph.readmap, reference, records)
    else:
        pc = np.zeros(len(records), np.int32)
    gt = ann.gt
    ps = [None] * len(records)
    if phase:
        from biograph_tpu_torch.variants.phase import phase_records

        pr = phase_records(biograph.readmap, reference, records, gt)
        gt, ps = pr.gt, pr.ps
    with VcfWriter(
        vcf_out,
        sample=sample,
        contigs=[(c.name, c.length) for c in reference.contigs],
        extra_headers=COVERAGE_HEADERS,
    ) as w:
        for i, rec in enumerate(records):
            dp = int(ann.alt_depth[i] + ann.ref_depth[i])
            rec.info["DP"] = dp
            rec.info["PC"] = int(pc[i])
            if vg is not None:
                rec.info["VG"] = int(max(vg.edge_reads[i].max(initial=0), 0))
            rec.fmt = {
                "GT": gt[i],
                "GQ": int(ann.gq[i]),
                "AD": ann.ad[i],
                "PL": ",".join(str(int(x)) for x in ann.pl[i]),
                "DP": dp,
            }
            if ps[i] is not None:
                rec.fmt["PS"] = int(ps[i])
            w.write(rec)
    if features_out:
        np.savez(features_out, **feature_matrix(records, ann, pc))
    return ann


def _region_chunks(records: List[VcfRecord], max_workers: int, safe_gap: int = 10_000):
    """Split records into contiguous chunks whose boundaries fall on gaps of
    at least safe_gap bases (or contig changes), so no read, mate pair or
    phase link spans two chunks; tiny chunks are merged so that there are
    about four a worker."""
    if not records:
        return []
    cuts = [0]
    for i in range(1, len(records)):
        a, b = records[i - 1], records[i]
        if b.chrom != a.chrom or b.pos - a.pos >= safe_gap:
            cuts.append(i)
    cuts.append(len(records))
    chunks = [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]
    target = max(len(records) // (4 * max_workers), 1)
    merged = []
    lo = chunks[0][0]
    size = 0
    for a, b in chunks:
        size += b - a
        if size >= target:
            merged.append((lo, b))
            lo, size = b, 0
    if size:
        merged.append((lo, chunks[-1][1]))
    return merged


def _load_ref_any(path: str):
    """A reference from an artifact dir, a reference dir holding a FASTA, or
    a FASTA file."""
    import os

    from biograph_tpu_torch.core import container
    from biograph_tpu_torch.index.reference import Reference

    if os.path.isdir(path):
        if container.exists(path):
            return Reference.load(path)
        return Reference.from_reference_dir(path)
    return Reference.from_fasta(path)


def _coverage_region_worker(args):
    """One region in a spawned process: open the sample on ``device`` and
    the reference by path, and run ``run_coverage`` on the region's VCF."""
    (bg_path, ref_path, vcf_in, vcf_out, feats_out, sample, pair_cov, phase, joint_graph, device) = args
    from biograph_tpu_torch.api import BioGraph

    bg = BioGraph(bg_path, device=device)
    ref = _load_ref_any(ref_path)
    run_coverage(
        vcf_in, vcf_out, bg, ref, sample=sample, features_out=feats_out,
        pair_cov=pair_cov, phase=phase, joint_graph=joint_graph,
    )
    return vcf_out


def run_coverage_parallel(
    vcf_in: str,
    vcf_out: str,
    bg_path: str,
    ref_path: str,
    n_workers: int = 2,
    sample: str = "SAMPLE",
    features_out: str | None = None,
    pair_cov: bool = True,
    phase: bool = True,
    joint_graph: bool = False,
    safe_gap: int = 10_000,
    device="cuda",
):
    """``run_coverage`` over region chunks in a pool of spawned processes.

    Records are cut at gaps of at least safe_gap bases (no read, pair or
    phase evidence crosses one), each chunk runs the whole single-process
    pipeline in a worker that opens the sample on ``device``, and the
    chunks' VCF bodies and features are concatenated in region order: the
    output is run_coverage's.  With one worker or one chunk it runs in this
    process, reading the reference as a reference directory."""
    import multiprocessing as mp
    import os
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from biograph_tpu_torch import resolve_device

    resolve_device(device)
    records = read_vcf(vcf_in)
    chunks = _region_chunks(records, n_workers, safe_gap=safe_gap)
    if n_workers <= 1 or len(chunks) <= 1:
        from biograph_tpu_torch.api import BioGraph
        from biograph_tpu_torch.index.reference import Reference

        bg = BioGraph(bg_path, device=device)
        ref = Reference.from_reference_dir(ref_path)
        return run_coverage(
            vcf_in, vcf_out, bg, ref, sample=sample,
            features_out=features_out, pair_cov=pair_cov, phase=phase,
            joint_graph=joint_graph,
        )

    with tempfile.TemporaryDirectory(prefix="bgt_pcmp_") as tmp:
        jobs = []
        for i, (lo, hi) in enumerate(chunks):
            sub_in = os.path.join(tmp, f"in{i}.vcf")
            with VcfWriter(sub_in, sample=sample) as w:
                for r in records[lo:hi]:
                    w.write(r)
            jobs.append((
                bg_path, ref_path, sub_in,
                os.path.join(tmp, f"out{i}.vcf"),
                os.path.join(tmp, f"feat{i}.npz") if features_out else None,
                sample, pair_cov, phase, joint_graph, str(device),
            ))
        with ProcessPoolExecutor(max_workers=n_workers, mp_context=mp.get_context("spawn")) as ex:
            outs = list(ex.map(_coverage_region_worker, jobs))
        # the header from the first region, the bodies in region order
        with open(vcf_out, "w") as f:
            for i, path in enumerate(outs):
                with open(path) as part:
                    for ln in part:
                        if ln.startswith("#") and i > 0:
                            continue
                        f.write(ln)
        if features_out:
            parts = [np.load(j[4]) for j in jobs]
            merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0].files}
            np.savez(features_out, **merged)


def feature_matrix(records: List[VcfRecord], ann: CoverageAnnotation, pc: np.ndarray | None = None):
    """Per-variant feature columns for the quality classifier."""
    var_len = np.array([len(r.alt.split(",")[0]) - len(r.ref) for r in records], np.int32)
    is_snp = np.array([len(r.alt) == 1 == len(r.ref) for r in records], bool)
    frac = ann.alt_depth / np.maximum(ann.alt_depth + ann.ref_depth, 1)
    out = {
        "alt_depth": ann.alt_depth,
        "ref_depth": ann.ref_depth,
        "alt_frac": frac.astype(np.float32),
        "var_len": var_len,
        "is_snp": is_snp.astype(np.int8),
        "gq": ann.gq,
        "qual": np.array([r.qual or 0 for r in records], np.float32),
        "ad_ratio": (
            (ann.alt_depth - ann.ref_depth) / np.maximum(ann.alt_depth + ann.ref_depth, 1)
        ).astype(np.float32),
        "var_type": np.sign(var_len).astype(np.int8),
        "abs_var_len": np.abs(var_len),
        "refspan": np.array([len(r.ref) for r in records], np.int32),
        "asmlen": np.array([len(r.alt.split(",")[0]) for r in records], np.int32),
        "pl_ref": np.asarray(ann.pl[:, 0], np.int32),
        "pl_het": np.asarray(ann.pl[:, 1], np.int32),
        "pl_hom": np.asarray(ann.pl[:, 2], np.int32),
    }
    for name in ("us_alt", "ds_alt", "us_ref", "ds_ref", "xc_alt", "ec_alt", "xc_ref", "ec_ref"):
        col = getattr(ann, name, None)
        if col is not None:
            out[name] = np.asarray(col, np.int32)
    for name in ("mc_alt", "mc_ref", "gc_alt", "gc_ref"):
        col = getattr(ann, name, None)
        if col is not None:
            out[name] = np.asarray(col, np.float32)
    if pc is not None:
        out["pair_cov"] = np.asarray(pc, np.int32)
    return out
