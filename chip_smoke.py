"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT.json]

Builds the CUDA kernels of ``biograph_tpu_torch`` from the sources in this
checkout, holds each against its plain PyTorch version on the card (exact
equality: everything is integer), then drives the port's create-and-query
path at a real size: 120 000 reads of 100 bases over a 2 Mb genome with
4000 planted SNPs, half of them reverse-complemented, generated in-process
from seed 12345.  The path is build_seqset -> build_readmap -> save/load ->
find of all 240 000 oriented reads -> rank4 at the found ranges' ends (and
the same through rank4_tiled over a tiled table the caller builds) -> push4
(and sizes_at at the children it returns) -> probe_exact (depth 32) over every
position of the doubled fwd+rc genome text.  Then variant discovery runs on the
same store, from the read store to records (prescreen, chain-kernel front end,
anchor scan, beam wavefront, extract + affine DP), cold and warm, and is held
to the genome, to the planted SNPs and, over a region, to the same call on a
CPU copy of the store, where every kernel's plain version runs; the call is
then replayed stage by stage with push4, rank and chain_window each held
against its plain version on the very lanes discovery hands it; a small
genome with an insertion, a deletion and a block substitution is discovered on
the card and on the CPU with identical records, which takes the affine DP to
the card.  Then discovery runs with the readmap the path built and loaded
(scoring by read coverage, the min_alt_support filter, the pair gate), cold
and warm, and its records are held to the JAX package's CPU leg on the same
workload (``tests/data/torch_scaled_leg_records.tsv``) and written as VCF and
read back; over a region the same call runs on a CPU copy of the store and
the readmap; coverage of a slab of the scored rows runs without the hash
index, through chain_fixed, held against its plain version and against the
hash route; a paired library (a 400-base insertion, mates at fragment 260)
is discovered on the card and on a CPU copy with identical records, and its
insertion culled on both by a gate that asks for more pairs than exist; so is
coverage on a library of mixed read lengths (its general route: probe_ranges,
then the chain kernel).  The scored call then runs twice more, cold and
warm, each held to the same records: by the dense front end
(``discover.NO_PRESCREEN``: the restart chain through rank over every
position, the filter and the bisection through chain_window over the lanes
that restarted), with rank and push4 then held against their plain versions
on its lanes; and with a memory plan that leaves no room for the trunc
tables (``discover.BUDGET_BYTES``), so each beam step truncates through the
seqset's LtSearch.  The widen family (truncate_ranges, pop_front_ranges,
push_front_drop) runs over the ranges find gave every oriented read, and
LtSearch on 2^20 random queries, on the card and on a CPU copy of the store
with identical answers; a .bgt of the store and the readmap is opened with
BioGraph on the card and on the CPU, and find, SeqsetEntry.pop_front and
truncate and read iteration on a sample of reads give identical answers.
The coverage stage runs twice.  On the scaled leg (coverage's hash route)
``run_coverage`` annotates the VCF of the 2299 records, with pair coverage
and phasing, on a BioGraph of the store, cold and warm, and the annotated
VCF and every feature column must equal the JAX CPU leg's
(``tests/data/torch_scaled_leg_coverage.tsv``); the JAX-trained classifier
(``tests/data/torch_scaled_leg_qual_model.npz``) is applied on the card
within 1e-5 of the file's probabilities; ``run_coverage_parallel`` with two
spawned workers gives run_coverage's output.  Then a trimmed, paired,
diploid library (120 000 pairs over the same genome: 3000 het and 1000 hom
SNPs, 200 het indels, half the reads trimmed by 1-30 bases) is built with
its mate pairs, discovered with the pair gate and annotated with pairs,
phasing and the joint graph on coverage's general route, which must launch
rank and chain_window; a region of 200 records is held to a CPU copy, the
genotypes to the library's truth, and a classifier trained on the card to
the same training on the CPU.
The create stage follows.  The main path's reads are built again under a
budget that forces at least 8 passes of the prefix-partitioned build, equal
to the in-memory store in every field, whose own peak must stay within the
plan's bytes a row (``create_partitioned_scaled``).  Leg 3, leg 2's library
with 0.5 % substitutions written as an interleaved FASTQ, goes through the
CLI on the card, ``create --paired --correct``, cold and warm: the native
scan equal to the numpy parser, every stored field, the k-mer count text,
the filter's stats and the corrected reads equal to the JAX package's CPU
run (``tests/data/torch_create_leg.json``), count_kmers and 4096 corrected
reads equal to CPU copies (``create_corrected``).  The scaled leg's store
and leg 3's merge on the card into the store of both read sets, mergemap
entries prefixes of their merged entries, migrated readmaps' coverage equal
to their own stores' (``merge_checks``).  Then a whole-genome library,
100-base reads at 10x over a genome from the seed, sized so the in-memory
sort would need twice the detected budget, is built under that budget and
under half of it, equal in every field, each peak within its budget and its
entries, its readmap built and 4096 reads found
(``create_partitioned_full``).
Leg 4 is the product's pipeline on a library users send for SV calling:
``sv_paired_library`` (seed 12406) over the same genome, a diploid sample
with 1000 het and 1000 hom SNPs, 100 het indels, 30 hom and 10 het
deletions of 50-5000 and 50-1000 bases, one hom deletion of 49 000 bases,
20 novel insertions of 60-300 bases and 4 of 1000-2000, as 150 000 pairs of
100-base reads (fragments of mean 400), half trimmed, with 0.5 %
substitutions, an interleaved FASTQ and a FASTA.  ``cli.main(["full_pipeline",
..., "--paired", "--correct", "--classifier-model", ...])`` runs create,
discovery (the wavefront, then the SV pass), coverage, grm and the
classifier on the card, cold: every stage's VCF (but its ``##source=``
line, and QUAL of the classifier's), every feature array, the records by
engine and the SV pass's counts equal to the JAX package's CPU run
(``tests/data/torch_pipeline_sv_leg.json``), results.vcf's QUAL the phred
of probabilities within 1e-5 of the file's, every stage done at its first
attempt; it must launch rank_cum, push4, rank and chain_window, and the
first and the widest call of each in each stage (create's rank_cum,
discovery's push4, rank and chain_window, coverage's rank and
chain_window) is kept and held against its plain version on the same
inputs.  ``--resume`` must run no stage and leave results.vcf as it was;
``--resume --rerun`` of each stage gives its warm seconds and the same
artifacts.  The SV engine then runs by parts on the leg's store (the split
events alone, the breakend walks alone), each equal to the file, and every
clip cluster's walk on the card equals the host oracle on a CPU copy of
the index; the walk's steps are counted, and its device operations over
its first two blocks of steps under torch.profiler.  The FM-index of the genome is
built on the card and on the CPU, equal to each other and to the file's
digests, and 65 536 substrings and 4096 random 40-mers are found and
located on both.  The planted SVs' recall by class is printed, not gated.
Last, the rank kernels are timed side by side on a
rank structure that outgrows the card's L2 cache, where the rank-block table
and the bucketing kernels of rank4_tiled are held against their plain
versions too.

Any failure raises and the exit code is non-zero; there is no CPU fallback.
Stage times are host-clock times read after ``torch.cuda.synchronize()``;
kernel times are CUDA-event times over repeated launches.  The last line of
standard output is ``{"ok": true, "device": {...}}``.  With ``--profile`` the
main path runs twice more, warm and then with each stage under
``torch.profiler``, and each stage's cold and warm time, the device's busy
time and its heaviest kernels go to OUT.json; the ``kernels`` and
``rank_past_l2`` lines then also split a ``rank4_tiled`` call into its
kernels.  The ``kernels`` line's ``launches_*`` columns are each kernel's
launches in each leg's counted run (``launches_pipeline``: leg 4's cold
``full_pipeline``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from biograph_tpu_torch.build.readmap_build import build_readmap
from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.convert import reference_from_numpy
from biograph_tpu_torch.index import probes
from biograph_tpu_torch.index import readmap as readmap_mod
from biograph_tpu_torch.index.readmap import Readmap
from biograph_tpu_torch.io.vcf import read_vcf
from biograph_tpu_torch.classifier import model as clf_model
from biograph_tpu_torch.index.seqset import Seqset, SeqsetRanges
from biograph_tpu_torch.ops import _build, rank4 as rank4_ops, rank_cum as rank_cum_ops
from biograph_tpu_torch.ops.ltsearch import LtSearch
from biograph_tpu_torch.variants import coverage_tool as cov
from biograph_tpu_torch.variants import discover as disc

SEED = 12345
GENOME, READ_LEN, READS, SNPS = 2_000_000, 100, 120_000, 4000
DEPTH = 32
PROBE_CHUNK = 1 << 20
# a rank structure past the 50 MB L2: 2^24 words a base, 805 MB as stored
BIG_NW, BIG_QUERIES = 1 << 24, 1 << 22

# NVIDIA H100 SXM data-sheet peaks: device memory rate, and the float32 rate
# outside the tensor cores, taken as the rate of the 32-bit integer lanes.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Integer operations that one push_front step of one lane needs, whatever the
# rank layout: two ranks (word index, mask, popcount, the adds) plus the
# window base, the gate, the size compare and the kick.
CHAIN_OPS_PER_STEP = 48
# the trimmed, paired, diploid leg: reads over a het SNP for its genotype to
# count, and the least shares of well-read het SNPs called het and of hom
# SNPs called 1/1.  The same generator and path on the CPU at 12 000 and
# 40 000 bases (tests/test_torch_slice.py) gave 0.79 and 0.82 het (the rest
# not discovered at 5.5x a haplotype) and 1.0 hom; its planted variants
# annotated directly (tests/test_torch_coverage_tool.py) 0.97 and 1.0.
MIN_HET_READS = 8
HET_FLOOR = 0.7
HOM_FLOOR = 0.9

WRAPPERS = {
    "rank4": rank4_ops.rank4,
    "rank": rank4_ops.rank,
    "rank4_tiled": rank4_ops.rank4_tiled,
    "gather_sizes": rank4_ops.gather_sizes,
    "push4": rank4_ops.push4,
    "chain_window": rank4_ops.chain_window,
    "chain_fixed": rank4_ops.chain_fixed,
    "rank_cum": rank_cum_ops.rank_cum,
}
# the kernels of the create-and-query path: chain_fixed is coverage's (its
# uniform route without the hash index), which scored_checks drives
MAIN_PATH_KERNELS = tuple(name for name in WRAPPERS if name != "chain_fixed")
SOURCES = {"rank": "rank4", "chain_fixed": "chain_window"}  # kernels whose source is not named after them
REPLACES = {
    "rank4": "biograph_tpu/ops/rank4.py:134",
    "rank": "biograph_tpu/ops/rank4.py:134",
    "rank4_tiled": "biograph_tpu/ops/rank4.py:559",
    "gather_sizes": "biograph_tpu/ops/rank4.py:202",
    "push4": "biograph_tpu/ops/rank4.py:202",
    "chain_window": "biograph_tpu/ops/rank4.py:359",
    "chain_fixed": "biograph_tpu/ops/rank4.py:407",
    "rank_cum": "biograph_tpu/ops/pallas_rank.py:89",
}


def say(**kw):
    print(json.dumps(kw), flush=True)


PROFILE = None  # {stage: {...}} while a --profile run is on


def timed(fn, stage=None):
    """(result, seconds) of fn(), the device drained before and after.  In
    a --profile run a named stage also runs under torch.profiler, which
    gives the time the device was busy and its heaviest kernels."""
    torch.cuda.synchronize()
    if PROFILE is not None and stage is not None:
        return _profiled(fn, stage)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profiled(fn, stage):
    from torch.profiler import ProfilerActivity, profile

    # discovery and coverage are tens of thousands of launches: their
    # traces keep the device side only
    activities = [ProfilerActivity.CUDA] if stage.startswith(("discover", "coverage")) else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        out = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    PROFILE[stage] = {
        "device_busy_s": sum(_device_us(e) for e in kernels) / 1e6,
        "launches": sum(e.count for e in kernels),
        "top": [[e.key[:80], e.count, _device_us(e) / 1e3] for e in kernels[:8]],
    }
    return out, seconds


def _device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernels_us(fn, reps: int = 10) -> dict:
    """Mean device microseconds of every kernel that one fn() launches, by
    the kernel's name (cut at its argument list), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:48]: _device_us(e) / reps for e in prof.key_averages() if _device_us(e)}


def event_ms(fn, reps: int, warm: int = 2, stall=None) -> float:
    """Mean CUDA-event time of one fn() over ``reps`` back-to-back calls.

    With ``stall`` (a callable that queues some tens of milliseconds of
    device work) the calls are enqueued while the device is still busy, so
    the events bracket device time alone; without it the time includes
    whatever the host needs to issue each call."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if stall is not None:
        stall()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_stall(dev):
    """A callable that queues some tens of milliseconds of device work."""
    a = torch.randn(8192, 8192, device=dev)

    def stall():
        for _ in range(4):
            torch.mm(a, a)

    return stall


def max_abs_err(got, want) -> int:
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype differ: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


def require_equal(name, got, want):
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel and plain version differ (max abs {err})")
    return err


def make_workload(genome_len: int, n_reads: int, n_snps: int, read_len: int):
    """(genome, codes [R, L], lengths [R]): reads of a SNP-carrying donor,
    the first half reverse-complemented."""
    return simulate(genome_len, n_reads, n_snps, read_len)[:3]


def simulate(genome_len: int, n_reads: int, n_snps: int, read_len: int):
    """The workload and its truth: (genome, codes, lengths, SNP positions,
    donor, read starts)."""
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    donor = genome.copy()
    snp = rng.choice(np.arange(200, genome_len - 200), n_snps, replace=False)
    donor[snp] = (donor[snp] + 1 + rng.integers(0, 3, n_snps)) % 4
    starts = rng.integers(0, genome_len - read_len, n_reads)
    codes = donor[starts[:, None] + np.arange(read_len)]
    half = n_reads // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    return genome, codes.astype(np.uint8), np.full(n_reads, read_len, np.int32), snp, donor, starts


def trimmed_paired_library(genome, n_pairs: int, n_het: int, n_hom: int, n_indel: int, seed: int = SEED + 31):
    """A paired, trimmed, diploid library over ``genome``.

    The donor carries n_het het SNPs (each on one haplotype, chosen at
    random), n_hom hom SNPs and n_indel het indels of 1-8 bases, half of
    them insertions, on a grid of 20 bases so no two overlap.  Each pair is
    drawn from one haplotype: a fragment of normal length (mean 400, sd 40),
    read 1 its first READ_LEN bases, read 2 the reverse complement of its
    last; half the reads are trimmed at the 3' end by 1-30 bases.  Returns
    (codes [2 n_pairs, READ_LEN], lengths, mate_of, truth), truth a dict of
    the planted variants: ``het`` and ``hom`` as (0-based position, ref
    code, alt code) arrays, ``indel`` as (0-based position, ref, alt)
    strings in VCF form (the base before the event first), and
    ``het_reads`` / ``hom_reads`` the reads over each SNP."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    slots = rng.choice(np.arange(200, G - 200, 20), n_het + n_hom + n_indel, replace=False)
    het, hom, ind = np.sort(slots[:n_het]), np.sort(slots[n_het : n_het + n_hom]), np.sort(slots[n_het + n_hom :])
    het_alt = ((genome[het] + 1 + rng.integers(0, 3, n_het)) % 4).astype(np.uint8)
    hom_alt = ((genome[hom] + 1 + rng.integers(0, 3, n_hom)) % 4).astype(np.uint8)
    het_hap = rng.integers(0, 2, n_het)
    ind_hap = rng.integers(0, 2, n_indel)
    ind_len = rng.integers(1, 9, n_indel)
    is_ins = np.arange(n_indel) % 2 == 0
    ins_seq = [rng.integers(0, 4, n, dtype=np.uint8) for n in ind_len]
    haps = []
    for h in range(2):
        snp_pos = np.concatenate([het[het_hap == h], hom])
        snp_alt = np.concatenate([het_alt[het_hap == h], hom_alt])
        hap = genome.copy()
        hap[snp_pos] = snp_alt
        pieces, prev = [], 0
        for k in np.nonzero(ind_hap == h)[0]:
            p = int(ind[k])
            pieces.append(hap[prev : p + 1])
            if is_ins[k]:
                pieces.append(ins_seq[k])
                prev = p + 1
            else:
                prev = p + 1 + int(ind_len[k])
        pieces.append(hap[prev:])
        haps.append(np.concatenate(pieces))
    hap_of = rng.integers(0, 2, n_pairs)
    frag = np.clip(np.round(rng.normal(400, 40, n_pairs)), READ_LEN, 700).astype(np.int64)
    codes = np.zeros((2 * n_pairs, READ_LEN), np.uint8)
    start = np.zeros(n_pairs, np.int64)
    for h in range(2):
        sel = np.nonzero(hap_of == h)[0]
        start[sel] = rng.integers(0, len(haps[h]) - frag[sel])
        codes[2 * sel] = haps[h][start[sel, None] + np.arange(READ_LEN)]
        codes[2 * sel + 1] = (3 - haps[h][(start[sel] + frag[sel] - READ_LEN)[:, None] + np.arange(READ_LEN)])[:, ::-1]
    lengths = np.full(2 * n_pairs, READ_LEN, np.int32)
    trimmed = rng.random(2 * n_pairs) < 0.5
    lengths[trimmed] -= rng.integers(1, 31, int(trimmed.sum())).astype(np.int32)
    codes = np.where(np.arange(READ_LEN)[None, :] < lengths[:, None], codes, 0).astype(np.uint8)
    mate_of = np.arange(2 * n_pairs) ^ 1
    # reads over each SNP, both haplotypes: a read's span on its haplotype
    # (read 2 loses its trimmed bases at the fragment's inner end), and a
    # SNP's place on a haplotype, shifted by the indels before it there
    lo = np.stack([start, start + frag - lengths[1::2]], axis=1).reshape(-1)
    hi = np.stack([start + lengths[0::2], start + frag], axis=1).reshape(-1)
    hap_of_read = np.repeat(hap_of, 2)

    def reads_over(pos):
        n = np.zeros(len(pos), np.int64)
        for h in range(2):
            k = np.nonzero(ind_hap == h)[0]
            shift = np.where(is_ins[k], ind_len[k], -ind_len[k])
            at = pos + np.concatenate([[0], np.cumsum(shift)])[np.searchsorted(ind[k], pos)]
            mine = hap_of_read == h
            n += np.searchsorted(np.sort(lo[mine]), at, side="right") - np.searchsorted(np.sort(hi[mine]), at, side="right")
        return n

    code = "ACGT"
    indels = []
    for k in range(n_indel):
        p = int(ind[k])
        if is_ins[k]:
            indels.append((p, code[genome[p]], code[genome[p]] + "".join(code[c] for c in ins_seq[k])))
        else:
            indels.append((p, "".join(code[c] for c in genome[p : p + 1 + int(ind_len[k])]), code[genome[p]]))
    truth = {
        "het": (het, genome[het], het_alt), "hom": (hom, genome[hom], hom_alt), "indel": indels,
        "het_reads": reads_over(het), "hom_reads": reads_over(hom),
    }
    return codes, lengths, mate_of, truth


def truth_records(truth, chrom):
    """The planted variants of ``trimmed_paired_library`` as (chrom, pos,
    ref, alt) tuples in VCF order."""
    out = [(chrom, int(p) + 1, "ACGT"[r], "ACGT"[a]) for kind in ("het", "hom") for p, r, a in zip(*truth[kind])]
    out += [(chrom, p + 1, r, a) for p, r, a in truth["indel"]]
    return sorted(out, key=lambda t: t[1])


def genotype_shares(records, truth, chrom):
    """How the annotated records of a ``trimmed_paired_library`` stand
    against its truth: the share of planted het SNPs with at least
    MIN_HET_READS reads over them that come out het (0/1, or phased 0|1 or
    1|0), the share of planted hom SNPs that come out 1/1, the phase blocks
    (distinct PS values) and the share of records with PC > 0."""
    gt_of = {(r.chrom, r.pos, r.ref, r.alt): str(r.fmt.get("GT")) for r in records}

    def share(kind, want, keep):
        p, ref, alt = truth[kind]
        hits = [gt_of.get((chrom, int(q) + 1, "ACGT"[a], "ACGT"[b])) in want for q, a, b in zip(p[keep], ref[keep], alt[keep])]
        return float(np.mean(hits)) if hits else 0.0

    well_read = truth["het_reads"] >= MIN_HET_READS
    return {
        "het_snps_well_read": int(well_read.sum()),
        "het_right": share("het", ("0/1", "0|1", "1|0"), well_read),
        "hom_right": share("hom", ("1/1",), np.ones(len(truth["hom"][0]), bool)),
        "phase_blocks": len({r.fmt["PS"] for r in records if "PS" in r.fmt}),
        "pc_positive": float(np.mean([int(r.info["PC"]) > 0 for r in records])) if records else 0.0,
    }


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def check_rank_blocks(name, words, cum, blocks, pos):
    """The rank-block table, its two plain versions and its two kernels
    against the structure as stored.  ``pos`` may lie outside [0, 32*nw]:
    the table's forms clamp it, the stored form is asked the clamped one."""
    inside = pos.clamp(0, 32 * words.shape[1])
    for b in range(4):
        base = torch.full_like(pos, b)
        require_equal(f"rank_blocks {name} base {b}", rank4_ops.rank_blocks_plain(blocks, base, pos),
                      rank4_ops.rank_plain(words, cum, base, inside))
    got4 = rank4_ops.rank4(blocks, pos)
    require_equal(f"rank4 {name}", got4, rank4_ops.rank4_blocks_plain(blocks, pos))
    require_equal(f"rank4 {name} vs the structure as stored", got4, rank4_ops.rank4_plain(words, cum, inside))
    b = (pos * 2654435761 >> 7) & 3  # a base a query, in no pattern
    ends = pos.flip(0).contiguous()
    got = rank4_ops.rank(blocks, b, pos)
    require_equal(f"rank {name}", got, rank4_ops.rank_blocks_plain(blocks, b, pos))
    require_equal(f"rank {name} vs the structure as stored", got, rank4_ops.rank_plain(words, cum, b, inside))
    require_equal(f"rank {name}, both ends of a range", rank4_ops.rank(blocks, b, pos, ends),
                  (got, rank4_ops.rank_blocks_plain(blocks, b, ends)))
    return got4


def check_buckets(name, tiles, pos):
    """The bucketing kernels of rank4_tiled against tile_buckets: the same
    buckets and block map, and the same queries in every bucket (the order
    inside a bucket is left open on both sides)."""
    n_tiles = tiles.base.shape[0]
    at, perm, *got = rank4_ops.tile_buckets_kernel(tiles, pos)
    want_perm, *want = rank4_ops.tile_buckets(rank4_ops.tile_of(tiles, pos), n_tiles)
    for what, g, w in zip(("bt", "blk_first", "q_first", "q_count"), got, want):
        require_equal(f"tile_buckets {name} {what}", g.to(torch.int64), w.to(torch.int64))
    perm = perm.to(torch.int64)
    in_tile = pos.clamp(0, 32 * tiles.words.shape[0] - 1) % (32 * rank4_ops.TILE_W)
    require_equal(f"tile_buckets {name} place in the tile", at.to(torch.int64), in_tile[perm])
    # every query once, and each bucket's slots hold that bucket's queries:
    # perm and tile_buckets' perm are then equal once sorted inside each bucket
    bucket = torch.repeat_interleave(torch.arange(n_tiles, device=pos.device), want[3])
    tile = rank4_ops.tile_of(tiles, pos).to(torch.int64)
    require_equal(f"tile_buckets {name} perm is a permutation", perm.sort().values, torch.arange(pos.shape[0], device=pos.device))
    require_equal(f"tile_buckets {name} bucket of each slot", tile[perm], bucket)
    require_equal(f"tile_buckets {name} plain bucket of each slot", tile[want_perm], bucket)


def chain_block_edges(dev, g, words, blocks, nw):
    """chain_window on a made-up store whose range ends sit on the edges of
    the rank blocks: the first step ranks 0 and n for n at a block's last
    entry, the next block's first, and 32*nw; later steps rank wherever
    those land."""
    depth = 3
    win = torch.randint(0, 4, (64, depth), generator=g).to(torch.uint8).to(dev)
    m = torch.full((64,), depth, dtype=torch.int32, device=dev)
    m[::5] = 1
    sizes_all = torch.randint(1, 5, (32 * nw,), generator=g).to(torch.int32).to(dev)
    for n in sorted({1, 191, 192, 193, 32 * nw - 1, 32 * nw}):
        if n > 32 * nw:
            continue
        fixed = torch.tensor([0, 0, 0, 0, n], device=dev)
        args = (blocks, sizes_all[:n].contiguous(), fixed, win, m, depth)
        require_equal(f"chain_window block edge nw={nw} n={n}", rank4_ops.chain_window(*args), rank4_ops.chain_window_plain(*args))


def random_words(shape, dev, g):
    """int32 words with every bit random, from the CPU generator g."""
    words64 = torch.randint(0, 1 << 32, shape, generator=g)
    return torch.where(words64 >= 1 << 31, words64 - (1 << 32), words64).to(torch.int32).to(dev)


def rank_cum_edges(dev, g):
    """rank_cum at every small size, around the multiples of the words a
    block takes (a row's first 16-byte group may start up to three words
    before the row), as one row and as four, on whole allocations and on row
    views that start off a 16-byte boundary, and on a row whose total passes
    2^30."""
    T = rank_cum_ops.TILE_WORDS
    sizes = [*range(1, 70), 127, 128, 129, 1000, 1023, 1024, 1025, 3000]
    sizes += [k * T + o for k in (1, 2, 3) for o in (-4, -3, -2, -1, 0, 1, 2, 3)]
    for nw in sizes:
        words = random_words((4, nw), dev, g)
        want = rank_cum_ops.rank_cum_plain(words)
        require_equal(f"rank_cum [4, {nw}]", rank_cum_ops.rank_cum(words), want)
        require_equal(f"rank_cum [1, {nw}]", rank_cum_ops.rank_cum(words[:1]), want[:1])
        for r in range(4):
            require_equal(f"rank_cum [{nw}], row {r} as a view", rank_cum_ops.rank_cum(words[r]), want[r])
    ones = torch.full(((1 << 25) + T + 3,), -1, dtype=torch.int32, device=dev)
    got = rank_cum_ops.rank_cum(ones)
    if int(got[-1]) <= 1 << 30:
        raise AssertionError("rank_cum: the long row's total does not pass 2^30")
    require_equal("rank_cum, total past 2^30", got, rank_cum_ops.rank_cum_plain(ones))


def push4_unfused(d, r):
    """push4 as it was before the push4 kernel: the rank4 kernel over both
    range ends stacked, the gather_sizes kernel, and tensor code around
    them.  Kept here as the yardstick the fused kernel is timed against."""
    B = r.begin.shape[0]
    r4 = rank4_ops.rank4(d.rank_blocks, torch.cat([r.begin, r.end])).to(torch.int64)
    nb = d.fixed[None, :4] + r4[:B]
    ne = d.fixed[None, :4] + r4[B:]
    sizes_nb = rank4_ops.gather_sizes(d.entry_sizes, nb.clamp(max=d.n_entries - 1))
    kick = (nb < ne) & (sizes_nb < (r.size + 1)[:, None])
    nb = nb + kick.to(nb.dtype)
    was_valid = (r.begin < r.end)[:, None]
    return torch.where(was_valid, nb, r.begin[:, None]), torch.where(was_valid, ne, r.begin[:, None])


def push4_edges(dev, g, ss):
    """push4 against push4_plain and against four push_front calls over the
    structure as stored: every range of a small seqset's entry pairs, B not a
    multiple of the block, empty and reversed ranges, begin and end in one
    rank block and in different ones, end == n, sizes that do and do not
    trigger the kick, and a made-up store whose pushed begin reaches n (the
    min(nb, n - 1) clamp)."""
    d = ss.d
    n = ss.n_entries
    words, cum = ss.prev_words.to(dev), ss.prev_cum.to(dev)

    def check(name, begin, end, size):
        args = (d.rank_blocks, d.entry_sizes, d.fixed, begin.contiguous(), end.contiguous(), size.contiguous())
        got = rank4_ops.push4(*args)
        require_equal(f"push4 {name}", got, rank4_ops.push4_plain(*args))
        for b in range(4):
            want = rank4_ops.push_front_plain(words, cum, d.entry_sizes, d.fixed, begin, end, size, torch.full_like(begin, b))
            require_equal(f"push4 {name} column {b} vs push_front as stored", (got[0][:, b], got[1][:, b]), want[:2])

    entry = torch.arange(n + 1, device=dev)
    for width in (0, 1, 2, 7, 191, 192, 193, 1000):
        end = (entry + width).clamp(max=n)
        for size in (0, 1, 24, 39, 40):  # below, at and above the entries' sizes: the kick on and off
            check(f"every entry, width {width}, size {size}", entry, end, torch.full_like(entry, size, dtype=torch.int32))
    B = 1003  # not a multiple of the block
    begin = torch.randint(0, n + 1, (B,), generator=g).to(dev)
    end = torch.randint(0, n + 1, (B,), generator=g).to(dev)  # about half reversed: invalid
    size = torch.randint(0, 45, (B,), generator=g).to(torch.int32).to(dev)
    check("random ends", begin, end, size)
    check("whole store", torch.zeros(5, dtype=torch.int64, device=dev), torch.full((5,), n, device=dev), torch.arange(5, dtype=torch.int32, device=dev))
    check("one range", begin[:1], begin[:1] + 1, size[:1])
    # a store whose last base's first child begins at n: fixed[3] + rank == n
    # needs every bit of prev[3] below `begin` set and fixed[3] = n - begin;
    # made up, so only the two push4 forms are compared
    nw = 7
    n2 = 32 * nw
    ones = torch.full((4, nw), -1, dtype=torch.int32, device=dev)
    blocks = rank4_ops.build_rank_blocks(ones, rank_cum_ops.rank_cum_plain(ones).to(torch.int64))
    sizes = torch.randint(1, 5, (n2,), generator=g).to(torch.int32).to(dev)
    begin = torch.arange(n2 + 1, device=dev)
    end = torch.full_like(begin, n2)
    for f3 in (0, 5, n2 - 1, n2):
        fixed = torch.tensor([0, 0, 0, f3, n2], device=dev)
        args = (blocks, sizes, fixed, begin, end, torch.full_like(begin, 2, dtype=torch.int32))
        got = rank4_ops.push4(*args)
        require_equal(f"push4 pushed begin up to n, fixed[3]={f3}", got, rank4_ops.push4_plain(*args))
    if not bool((got[0][:, 3] >= n2).any()):
        raise AssertionError("push4: the made-up store never pushed a begin to n")


def edge_checks(dev):
    """Small and ragged shapes: B not a multiple of the block, pos == 0,
    pos == n, pos == 32*nw, pos < 0, m == 0, m == depth, scan sizes around the
    multiples of the scan's tile, rank blocks that end inside the structure's
    last word group, buckets that are empty, single or hold every query."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    rank_cum_edges(dev, g)
    for nw in (1, 5, 6, 7, 193, 1000, 1023, 1024, 1025, 3000):
        words = random_words((4, nw), dev, g)
        cum = rank_cum_ops.rank_cum_plain(words).to(torch.int64)
        n = 32 * nw - 5
        pos = torch.cat([
            torch.randint(0, n + 1, (1003,), generator=g),
            torch.tensor([0, 1, 31, 32, 191, 192, n - 1, n, 32 * nw - 1, 32 * nw]).clamp(0, 32 * nw),
        ]).to(dev)
        want = rank4_ops.rank4_plain(words, cum, pos)
        # the rank-block table (nw that is and is not a multiple of the
        # block), with positions before the structure and past it as well
        blocks = rank4_ops.build_rank_blocks(words, cum)
        outside = torch.tensor([-1, -7, -(1 << 40), 32 * nw + 1, 32 * nw + 200, 1 << 40], device=dev)
        check_rank_blocks(f"nw={nw}", words, cum, blocks, torch.cat([pos, outside]))
        # rank4_tiled: a dense bucket (its tile staged in shared memory), a
        # sparse one (read in place), one query, and every query in one tile
        tiles = rank4_ops.build_rank4_tiles(words, cum)
        require_equal(f"rank4_tiled table nw={nw}", rank4_ops.rank4_tiled_plain(tiles, pos), want)
        middle = (pos >> 15) == 1  # the queries of the second tile, sent to the first: an empty tile
        for name, sel in (("dense", pos), ("sparse", pos[-40:].contiguous()), ("one", pos[-1:].contiguous()),
                          ("one tile", (pos % min(n + 1, 32 * 1024)).contiguous()),
                          ("empty tile", torch.where(middle, pos % 1000, pos))):
            require_equal(f"rank4_tiled {name} nw={nw}", rank4_ops.rank4_tiled(tiles, sel),
                          rank4_ops.rank4_plain(words, cum, sel))
            check_buckets(f"{name} nw={nw}", tiles, sel)
        chain_block_edges(dev, g, words, blocks, nw)
    sizes = torch.randint(1, 70000, (777,), generator=g).to(torch.int32).to(dev)
    idx = torch.randint(0, 777, (5, 201), generator=g).to(dev)
    require_equal("gather_sizes", rank4_ops.gather_sizes(sizes, idx), rank4_ops.gather_sizes_plain(sizes, idx))

    _, codes, lengths = make_workload(6000, 900, 30, 40)
    lengths = lengths.copy()
    lengths[::7] = 25
    ss = build_seqset(codes, lengths, device=dev)
    rng = np.random.default_rng(SEED)
    text = torch.from_numpy(rng.integers(0, 4, 6000, dtype=np.uint8)).to(dev)
    text[:3000] = torch.from_numpy(codes[:75].reshape(-1)).to(dev)
    d = ss.d
    check_rank_blocks("seqset", ss.prev_words, ss.prev_cum, d.rank_blocks, torch.arange(ss.n_entries + 1, device=dev))
    push4_edges(dev, g, ss)
    entry = torch.arange(ss.n_entries, device=dev)
    for b in range(4):  # the entry's bit, from the block's word slot and from the stored word
        stored = (ss.prev_words[b, entry >> 5].to(torch.int64) >> (entry & 31)) & 1
        require_equal(f"entry_has_front base {b}", d.entry_has_front(entry, torch.full_like(entry, b)), stored.to(torch.bool))
    # depths whose rows the kernel fetches 16 bytes at a time (16, 32, 48) and byte by byte (1, 17)
    for depth in (1, 16, 17, 32, 48):
        pos = torch.arange(0, 6000, 3, device=dev)[:1999]
        mixed = torch.randint(0, depth + 1, (pos.shape[0],), generator=g).to(torch.int32).to(dev)
        mixed[:5] = 0
        mixed[5:10] = depth
        win = probes._window_bases(text, pos, depth)
        for name, m in (("mixed m", mixed), ("m == depth", torch.full_like(mixed, depth)), ("m == 0", torch.zeros_like(mixed))):
            args = (d.rank_blocks, d.entry_sizes, d.fixed, win, m, depth)
            require_equal(f"chain_window depth={depth} {name}", rank4_ops.chain_window(*args), rank4_ops.chain_window_plain(*args))
    got = rank4_ops.chain_fixed(d.rank_blocks, d.entry_sizes, d.fixed, text, 17)
    want = probes.find_window(d, text, torch.arange(6000, device=dev), 17, 17)
    keep = torch.arange(6000, device=dev) >= 16
    require_equal("chain_fixed", tuple(x[keep] for x in got), tuple(x[keep] for x in want))
    torch.cuda.synchronize()


def chain_sectors(d, win, m, depth):
    """What one chain_window call asks of the memory system, counted by
    replaying its steps with tensor code: (steps, sectors, sectors as
    stored).  A live step asks for one 32-byte sector of the rank-block
    table for ``begin``, one more when ``end`` lies in another block, and one
    of entry_sizes when the pushed range is not empty; against the structure
    as stored the two ranks ask for four (a word and a count each)."""
    blocks, n = d.rank_blocks, d.n_entries
    last_word = blocks.shape[0] * rank4_ops.BLOCK_WORDS - 1
    begin, end, size = probes._start(d, win.shape[0])
    steps = sectors = stored = 0
    for s in range(depth):
        live = (s >= depth - m) & (begin < end)
        dead = (s >= depth - m) & (begin >= end)
        kb = (begin >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS
        ke = (end >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS
        b = win[:, s].to(torch.int64)
        nb = d.fixed[b] + rank4_ops.rank_blocks_plain(blocks, b, begin)
        ne = d.fixed[b] + rank4_ops.rank_blocks_plain(blocks, b, end)
        reads_size = live & (nb < ne)
        kick = reads_size & (d.entry_sizes[nb.clamp(0, n - 1)] < size + 1)
        steps += int(live.sum())
        sectors += int(live.sum()) + int((live & (ke != kb)).sum()) + int(reads_size.sum())
        stored += 4 * int(live.sum()) + int(reads_size.sum())
        begin = torch.where(live, nb + kick, begin)
        end = torch.where(live, ne, torch.where(dead, begin, end))
        size = torch.where(live, size + 1, size)
    return steps, sectors, stored, (begin, end, size)


# One 32-byte sector: what a random read of 4 or 8 bytes moves.
SECTOR = 32


def kernel_table(ss, launches, find_ranges, probe_text, probe_pos, probe_m, probe_m_mixed, coverage_slab, breakdown=False):
    """Each kernel at the main path's shapes: equality with the plain
    version, times, and the least time the card could take.  ``ms``,
    ``plain_ms`` and ``library_ms`` are device times (calls queued behind a
    stall); ``call_ms`` is the kernel wrapper's time per call as a caller
    issuing it in a loop sees it, host cost included.  coverage_slab: (text,
    depth) of the slab of scored rows that scored_checks ran through
    chain_fixed."""
    rows = []
    d = ss.d
    dev = d.device
    stall = make_stall(dev)

    def row(name, kernel, plain, bytes_moved, operations, library=None, plain_reps=3):
        got, want = kernel(), plain()
        err = require_equal(name, got, want)
        bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
        ops_ms = operations / PEAK_OPS_PER_S * 1e3
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"biograph_tpu_torch/csrc/{SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": err,
            "ms": event_ms(kernel, 20, stall=stall),
            "call_ms": event_ms(kernel, 20),
            "plain_ms": event_ms(plain, plain_reps, warm=1, stall=stall),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": event_ms(library, 20, stall=stall) if library else None,
        })
        return rows[-1]

    # the structure as stored, brought to the card as the oracle of the table's forms
    words, cum = ss.prev_words.to(dev), ss.prev_cum.to(dev)
    nw = words.shape[1]
    n = d.n_entries
    blocks = d.rank_blocks
    blocks_bytes = blocks.numel() * 4

    # rank4 as push4 calls it: both ends of every find range, stacked, against
    # the rank-block table.  A query asks for four sectors of the table, a
    # quarter of one for its position and half of one for its result.
    pos = torch.cat([find_ranges.begin, find_ranges.end]).contiguous()
    B = pos.shape[0]
    require_equal("rank4 vs the structure as stored", rank4_ops.rank4(blocks, pos), rank4_ops.rank4_plain(words, cum, pos))
    r = row(
        "rank4",
        lambda: rank4_ops.rank4(blocks, pos),
        lambda: rank4_ops.rank4_blocks_plain(blocks, pos),
        B * 8 + B * 16 + min(B * 4 * SECTOR, blocks_bytes),
        B * 24,
    )
    r["sectors"] = B * 4 + B * (8 + 16) // SECTOR
    r["sectors_per_s"] = r["sectors"] / r["ms"] * 1e3

    # rank as find's push_front calls it: one base a query, both ends of each
    # range in one launch (two sectors, or one when they share a block)
    b = torch.randint(0, 4, find_ranges.begin.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 3))
    ends = (find_ranges.begin.contiguous(), find_ranges.end.contiguous())
    require_equal("rank vs the structure as stored", rank4_ops.rank(blocks, b, *ends),
                  tuple(rank4_ops.rank_plain(words, cum, b, p) for p in ends))
    row(
        "rank",
        lambda: rank4_ops.rank(blocks, b, *ends),
        lambda: tuple(rank4_ops.rank_blocks_plain(blocks, b, p) for p in ends),
        B // 2 * (8 + 16 + 16) + min(B * SECTOR, blocks_bytes),
        B * 6,
    )

    # rank4_tiled as a bulk caller calls it: the same positions against the
    # tiled table; the time is the whole call (the bucketing kernels and the
    # rank kernel, one C call), prologue_ms the bucketing kernels alone and
    # plain_prologue_ms their plain version (a sort, two searches, a scan)
    tiles = rank4_ops.build_rank4_tiles(words, cum)
    table_bytes = tiles.words.numel() * 4 + tiles.rel.numel() * 2 + tiles.base.numel() * 8
    check_buckets("main path", tiles, pos)

    def plain_prologue():
        return pos[rank4_ops.tile_buckets(rank4_ops.tile_of(tiles, pos), tiles.base.shape[0])[0]]

    row(
        "rank4_tiled",
        lambda: rank4_ops.rank4_tiled(tiles, pos),
        lambda: rank4_ops.rank4_tiled_plain(tiles, pos),
        B * 8 + B * 16 + min(B * 24, table_bytes),
        B * 28,
    )
    rows[-1]["prologue_ms"] = event_ms(lambda: rank4_ops.tile_buckets_kernel(tiles, pos), 20, stall=stall)
    rows[-1]["plain_prologue_ms"] = event_ms(plain_prologue, 20, stall=stall)
    if breakdown:
        rows[-1]["kernels_us"] = kernels_us(lambda: rank4_ops.rank4_tiled(tiles, pos))
    require_equal("rank4_tiled vs rank4", rank4_ops.rank4_tiled(tiles, pos), rank4_ops.rank4(blocks, pos))

    # gather_sizes as push4 calls it: the [B/2, 4] pushed begins.  The byte
    # bound counts 4 bytes a gathered size; a read of 4 bytes at a random
    # place moves a whole sector, so beside it stand the sectors the call asks
    # for (one an index, plus the indices read and the sizes written), the
    # distinct sectors of entry_sizes among them, and two floors: those
    # sectors' bytes at the device-memory rate, and, since entry_sizes sits in
    # L2, the sectors over the rate at which chain_window below is served them.
    nb4, _ = d.push4(find_ranges)
    idx = nb4.clamp(max=n - 1).contiguous()
    gather = row(
        "gather_sizes",
        lambda: rank4_ops.gather_sizes(d.entry_sizes, idx),
        lambda: rank4_ops.gather_sizes_plain(d.entry_sizes, idx),
        idx.numel() * (8 + 4) + min(idx.numel() * 4, n * 4),
        idx.numel() * 2,
        library=lambda: torch.index_select(d.entry_sizes, 0, idx.reshape(-1)),
        plain_reps=20,
    )
    gather["sectors"] = idx.numel() + idx.numel() * (8 + 4) // SECTOR
    gather["distinct_sectors_gathered"] = int(torch.unique(idx >> 3).numel())
    gather["sector_bytes_ms"] = gather["sectors"] * SECTOR / PEAK_BYTES_PER_S * 1e3

    # push4 as the main path calls it: the children of every find range.  A
    # range asks for the 128-byte line of begin's four blocks, another when end
    # lies in another block, its 20 bytes of input and 64 of output, and one
    # sector of entry_sizes for every child that is not empty.  Beside it,
    # unfused_ms: the form push4 had before this kernel (the rank4 and
    # gather_sizes kernels and tensor code around them), on the same ranges.
    r = SeqsetRanges(find_ranges.begin.contiguous(), find_ranges.end.contiguous(), find_ranges.size.contiguous())
    R = r.begin.shape[0]
    p4 = (blocks, d.entry_sizes, d.fixed, r.begin, r.end, r.size)
    require_equal("push4 vs its unfused form", rank4_ops.push4(*p4), push4_unfused(d, r))
    valid = r.begin < r.end
    last_word = blocks.shape[0] * rank4_ops.BLOCK_WORDS - 1
    two_lines = valid & ((r.begin >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS != (r.end >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS)
    r4 = rank4_ops.rank4(blocks, torch.cat([r.begin, r.end])).to(torch.int64)
    gathered = int((valid[:, None] & (r4[:R] < r4[R:])).sum())  # children not empty before the kick
    lines = int(valid.sum()) + int(two_lines.sum())
    fused = row(
        "push4",
        lambda: rank4_ops.push4(*p4),
        lambda: rank4_ops.push4_plain(*p4),
        R * (8 + 8 + 4) + R * 64 + min(lines * 4 * SECTOR, blocks_bytes) + min(gathered * 4, n * 4) + 40,
        2 * R * 24 + R * 16,
    )
    fused["sectors"] = lines * 4 + gathered + R * (20 + 64) // SECTOR
    fused["sectors_per_s"] = fused["sectors"] / fused["ms"] * 1e3
    fused["children_not_empty"] = gathered
    fused["unfused_ms"] = event_ms(lambda: push4_unfused(d, r), 20, stall=stall)
    fused["unfused_call_ms"] = event_ms(lambda: push4_unfused(d, r), 20)
    if breakdown:
        fused["unfused_kernels_us"] = kernels_us(lambda: push4_unfused(d, r))
    # and at the widths the beam wavefront calls it, where the time is the launch's
    fused["ms_by_ranges"] = {
        str(k): event_ms(lambda: rank4_ops.push4(*p4[:3], r.begin[:k], r.end[:k], r.size[:k]), 20, stall=stall)
        for k in (512, 4096, 32768)
    }
    fused["call_ms_by_ranges"] = {
        str(k): event_ms(lambda: rank4_ops.push4(*p4[:3], r.begin[:k], r.end[:k], r.size[:k]), 20)
        for k in (512, 4096, 32768)
    }
    fused["unfused_call_ms_by_ranges"] = {
        str(k): event_ms(lambda: push4_unfused(d, SeqsetRanges(r.begin[:k], r.end[:k], r.size[:k])), 20)
        for k in (512, 4096, 32768)
    }

    # chain_window as a probe_exact round calls it, twice: every lane at
    # full depth, and the per-lane lengths the bisection's third round tests.
    # The byte bound counts each input once (rows, lengths, the block table,
    # the sizes touched) and the outputs.  The operation bound counts the
    # steps this run's data needs (every push of a lane whose range was not
    # empty, the one that empties it included: the sum of the sizes that
    # come back) at CHAIN_OPS_PER_STEP integer operations: what a push_front
    # step needs by its definition, whatever the layout.
    # Beside it: the sectors this run's steps ask for, which is what the
    # kernel's time follows while everything sits in L2.
    win = probes._window_bases(probe_text, probe_pos, DEPTH)
    P = probe_pos.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    check_rank_blocks("main path", words, cum, blocks, torch.randint(0, 32 * nw + 1, (1 << 20,), device=dev, generator=g))
    for case, m in (("m == depth", probe_m), ("mixed m: round 3 of probe_exact", probe_m_mixed)):
        args = (d.rank_blocks, d.entry_sizes, d.fixed, win, m, DEPTH)
        steps, sectors, stored, replayed = chain_sectors(d, win, m, DEPTH)
        got = rank4_ops.chain_window(*args)
        require_equal(f"chain_window replay, {case}", got, replayed)
        if steps != int(got[2].sum()):
            raise AssertionError(f"chain_window {case}: the replay's steps are not the pushes the kernel counted")
        row(
            "chain_window",
            lambda: rank4_ops.chain_window(*args),
            lambda: rank4_ops.chain_window_plain(*args),
            P * DEPTH + P * 4 + P * 20 + blocks_bytes + min(steps * 4, n * 4) + 40,
            steps * CHAIN_OPS_PER_STEP,
            plain_reps=2,
        )
        ms = rows[-1]["ms"]
        rows[-1].update({
            "case": case,
            "steps": steps,
            "sectors": sectors,
            "sectors_per_step": sectors / max(steps, 1),
            "sectors_as_stored": stored,
            "sectors_per_s": sectors / ms * 1e3,
            "sector_bytes_per_s": sectors * 32 / ms * 1e3,
            "mean_m": float(m.to(torch.float64).mean()),
            # the same call on the first 1/16 and 1/4 of the lanes: time that
            # follows the lanes is throughput, time that does not is latency
            "ms_by_lanes": {
                str(k): event_ms(lambda: rank4_ops.chain_window(*args[:3], win[:k], m[:k], DEPTH), 20, stall=stall)
                for k in (P // 16, P // 4, P)
            },
        })

    # chain_fixed as coverage's uniform route without the hash calls it: the
    # depth-long window ending at every position of a slab of scored rows
    # (the window rows built inside the call).  The byte bound counts the
    # text, the outputs, the block table and the sizes touched; the
    # operations, this run's pushes (the sum of the sizes that come back) at
    # CHAIN_OPS_PER_STEP.
    cov_text, cov_depth = coverage_slab
    PC = cov_text.shape[0]
    cov_m = torch.full((PC,), cov_depth, dtype=torch.int32, device=dev)
    cov_steps = int(rank4_ops.chain_fixed(blocks, d.entry_sizes, d.fixed, cov_text, cov_depth)[2].to(torch.int64).sum())
    row(
        "chain_fixed",
        lambda: rank4_ops.chain_fixed(blocks, d.entry_sizes, d.fixed, cov_text, cov_depth),
        lambda: rank4_ops.chain_window_plain(blocks, d.entry_sizes, d.fixed, rank4_ops.contig_windows(cov_text, cov_depth), cov_m, cov_depth),
        PC + PC * 20 + blocks_bytes + min(cov_steps * 4, n * 4) + 40,
        cov_steps * CHAIN_OPS_PER_STEP,
        plain_reps=2,
    )
    rows[-1].update(
        lanes=PC, depth=cov_depth, steps=cov_steps, launches_counted_in="scored_checks",
        windows_ms=event_ms(lambda: rank4_ops.contig_windows(cov_text, cov_depth), 20, stall=stall),
    )

    # the sector floor of gather_sizes in L2, at the rate this run's
    # chain_window (m == depth) is served its sectors
    l2_sectors_per_s = next(r["sectors_per_s"] for r in rows if r["name"] == "chain_window")
    gather["sector_floor_ms"] = gather["sectors"] / l2_sectors_per_s * 1e3

    # rank_cum as the build calls it: the four base rows in one launch
    row(
        "rank_cum",
        lambda: rank_cum_ops.rank_cum(words),
        lambda: rank_cum_ops.rank_cum_plain(words),
        4 * nw * 8,
        4 * nw * 16,
        plain_reps=20,
    )
    rows[-1]["one_row_ms"] = event_ms(lambda: rank_cum_ops.rank_cum(words[0]), 20, stall=stall)
    if breakdown:  # the scan kernel and the memset of its descriptors, apart
        rows[-1]["kernels_us"] = kernels_us(lambda: rank_cum_ops.rank_cum(words))
    return rows


def bisection_lengths(d, text, pos, seg_lo, depth, round_no):
    """The per-lane window lengths that round ``round_no`` (from 1) of
    probe_exact's bisection hands to chain_window."""
    win = probes._window_bases(text, pos, depth)
    lo_m, hi_m = probes._bracket(pos, seg_lo, depth, 0)
    best = probes._start(d, pos.shape[0])
    for _ in range(round_no - 1):
        mid = probes._exact_mid(lo_m, hi_m)
        lo_m, hi_m, *best = probes._exact_round(lo_m, hi_m, mid, *best, *probes._chain(d, win, mid, depth))
    return probes._exact_mid(lo_m, hi_m).to(torch.int32).contiguous()


def rank_past_l2(dev, stall, breakdown=False):
    """rank4, rank and rank4_tiled side by side on a random rank structure
    that outgrows the L2 cache, at uniformly random positions: equality with
    the plain versions, and device time per call; with ``breakdown`` also the
    time of each kernel inside a rank4_tiled call.  The structure's counts
    come from one rank_cum call on its four rows of 2^24 words."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    words = torch.randint(-(1 << 31), 1 << 31, (4, BIG_NW), dtype=torch.int32, device=dev, generator=g)
    cum32 = rank_cum_ops.rank_cum(words)
    require_equal("rank_cum past L2", cum32, rank_cum_ops.rank_cum_plain(words))
    copy_to = torch.empty_like(words)
    times = {
        "rank_cum_ms": event_ms(lambda: rank_cum_ops.rank_cum(words), 10, stall=stall),
        "rank_cum_one_row_ms": event_ms(lambda: rank_cum_ops.rank_cum(words[0]), 10, stall=stall),
        "rank_cum_bound_ms": words.numel() * 8 / PEAK_BYTES_PER_S * 1e3,
        "rank_cum_plain_ms": event_ms(lambda: rank_cum_ops.rank_cum_plain(words), 3, warm=1, stall=stall),
        # a yardstick: one copy of as many bytes in and out
        "copy_same_bytes_ms": event_ms(lambda: copy_to.copy_(words), 10, stall=stall),
    }
    del copy_to
    cum = cum32.to(torch.int64)
    del cum32
    tiles = rank4_ops.build_rank4_tiles(words, cum)
    blocks = rank4_ops.build_rank_blocks(words, cum)
    pos = torch.randint(0, 32 * BIG_NW + 1, (BIG_QUERIES,), device=dev, generator=g)
    want = check_rank_blocks("past L2", words, cum, blocks, pos)
    require_equal("rank4_tiled past L2", rank4_ops.rank4_tiled(tiles, pos), want)
    check_buckets("past L2", tiles, pos)
    pos_sorted = pos.sort().values
    require_equal("rank4 past L2, sorted positions", rank4_ops.rank4(blocks, pos_sorted), rank4_ops.rank4_plain(words, cum, pos_sorted))
    # many tiles: warps whose queries all share a tile, and warps where half do
    check_buckets("past L2, sorted", tiles, pos_sorted)
    half = BIG_QUERIES // 2
    check_buckets("past L2, every other sorted", tiles, torch.stack([pos_sorted[:half], pos[:half]], dim=1).reshape(-1))
    # few tiles, thousands of blocks each: the block map filled by whole warps
    pos_one_tile = pos % (32 * rank4_ops.TILE_W)
    for name, sel in (("one tile", pos_one_tile), ("three tiles", pos % (3 * 32 * rank4_ops.TILE_W))):
        check_buckets(f"past L2, {name}", tiles, sel)
        require_equal(f"rank4_tiled past L2, {name}", rank4_ops.rank4_tiled(tiles, sel), rank4_ops.rank4_plain(words, cum, sel))
    split = {
        "rank4_tiled_kernels_us": kernels_us(lambda: rank4_ops.rank4_tiled(tiles, pos)),
        "rank4_tiled_sorted_positions_kernels_us": kernels_us(lambda: rank4_ops.rank4_tiled(tiles, pos_sorted)),
    } if breakdown else {}
    b = pos & 3
    ends = (pos[:half].contiguous(), pos[half:].contiguous())
    return {
        **split,
        **times,
        "words_per_base": BIG_NW,
        "positions": BIG_QUERIES,
        "structure_bytes": words.numel() * 4 + cum.numel() * 8,
        "table_bytes": tiles.words.numel() * 4 + tiles.rel.numel() * 2 + tiles.base.numel() * 8,
        "rank_blocks_bytes": blocks.numel() * 4,
        "tiles": tiles.base.shape[0],
        "rank4_tiled_buckets_ms": event_ms(lambda: rank4_ops.tile_buckets_kernel(tiles, pos), 10, stall=stall),
        "rank4_ms": event_ms(lambda: rank4_ops.rank4(blocks, pos), 10, stall=stall),
        "rank4_tiled_ms": event_ms(lambda: rank4_ops.rank4_tiled(tiles, pos), 10, stall=stall),
        "rank4_sorted_positions_ms": event_ms(lambda: rank4_ops.rank4(blocks, pos_sorted), 10, stall=stall),
        "rank4_tiled_sorted_positions_ms": event_ms(lambda: rank4_ops.rank4_tiled(tiles, pos_sorted), 10, stall=stall),
        "rank4_tiled_one_tile_ms": event_ms(lambda: rank4_ops.rank4_tiled(tiles, pos_one_tile), 10, stall=stall),
        "rank4_tiled_one_tile_buckets_ms": event_ms(lambda: rank4_ops.tile_buckets_kernel(tiles, pos_one_tile), 10, stall=stall),
        "rank_one_position_ms": event_ms(lambda: rank4_ops.rank(blocks, b, pos), 10, stall=stall),
        "rank_both_ends_ms": event_ms(lambda: rank4_ops.rank(blocks, b[:half].contiguous(), *ends), 10, stall=stall),
        "plain_ms": event_ms(lambda: rank4_ops.rank4_blocks_plain(blocks, pos), 3, warm=1, stall=stall),
    }


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def main_path(dev, genome, codes, lengths, depth=DEPTH):
    """reads -> seqset -> readmap -> save/load -> find -> rank4 ->
    rank4_tiled -> push4 -> sizes_at -> probe_exact.  Returns (stage stats, what the
    later checks need)."""
    R = codes.shape[0]
    stats = {}
    ss, stats["build_s"] = timed(lambda: build_seqset(codes, lengths, device=dev), "build")
    rm, stats["readmap_s"] = timed(lambda: build_readmap(ss, codes, lengths, device=dev), "readmap")

    def save_load():
        with tempfile.TemporaryDirectory() as tmp:
            ss.save(tmp + "/seqset.bgt")
            rm.save(tmp + "/readmap.bgt")
            ss2 = Seqset.load(tmp + "/seqset.bgt", device=dev)
            return ss2, Readmap.load(tmp + "/readmap.bgt", ss2, device=dev)

    (ss2, rm2), stats["save_load_s"] = timed(save_load)
    for name in ("fixed", "prev_words", "prev_cum", "entry_sizes", "shared", "pop_sel"):
        if not torch.equal(getattr(ss, name).cpu(), getattr(ss2, name).cpu()):
            raise AssertionError(f"seqset field {name} changed across save/load")
    del ss, rm
    # the query engine reads the rank structure through the rank-block table
    # alone, built here from the stored pair, which stays where load put it
    d, stats["rank_blocks_s"] = timed(lambda: ss2.d)
    d.rank4(torch.zeros(1, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    held = [ss2.fixed, ss2.entry_sizes, ss2.shared, ss2.pop_sel, d.rank_blocks]
    stats["memory"] = {
        "allocated_after_load_and_first_query_bytes": torch.cuda.memory_allocated() if dev.type == "cuda" else None,
        "seqset_on_device_bytes": sum(t.numel() * t.element_size() for t in held),
        "stored_pair_bytes": sum(t.numel() * t.element_size() for t in (ss2.prev_words, ss2.prev_cum)),
        "stored_pair_on": ss2.prev_words.device.type,
        "rank_blocks_bytes": d.rank_blocks.numel() * 4,
    }

    codes_dev = torch.from_numpy(codes).to(dev)
    lens_dev = torch.from_numpy(lengths).to(dev)
    from biograph_tpu_torch.core.dna import revcomp_codes

    oriented = torch.cat([codes_dev, revcomp_codes(codes_dev, lens_dev)])
    olens = torch.cat([lens_dev, lens_dev])
    found, stats["find_s"] = timed(lambda: d.find(oriented, olens), "find")
    if not bool(found.valid.all()):
        raise AssertionError(f"{int((~found.valid).sum())} of {2 * R} oriented reads not found")
    if not bool((found.size == olens).all()):
        raise AssertionError("find: a range's size differs from its read's length")
    # each read's range contains the seqset entry its readmap entry hangs on
    oriented_id = rm2.read_ids + (~rm2.is_forward).to(torch.int64) * R
    entry_of = torch.empty(2 * R, dtype=torch.int64, device=dev)
    entry_of[oriented_id] = rm2.entry_of_rm
    if not bool(((found.begin <= entry_of) & (entry_of < found.end)).all()):
        raise AssertionError("a read's find range does not contain its readmap entry")

    ranked, stats["rank4_s"] = timed(lambda: d.rank4(torch.cat([found.begin, found.end])), "rank4")
    # the same ranks as a bulk caller of rank4_tiled gets them: the tiled
    # table is that caller's to build, from the stored pair
    tiles, stats["rank4_tiles_s"] = timed(lambda: rank4_ops.build_rank4_tiles(ss2.prev_words.to(dev), ss2.prev_cum.to(dev)))
    stats["memory"]["rank4_tiles_bytes"] = tiles.words.numel() * 4 + tiles.rel.numel() * 2 + tiles.base.numel() * 8
    ranked_tiled, stats["rank4_tiled_s"] = timed(lambda: rank4_ops.rank4_tiled(tiles, torch.cat([found.begin, found.end])), "rank4_tiled")
    if not torch.equal(ranked_tiled, ranked):
        raise AssertionError("rank4_tiled differs from rank4 on the find ranges' ends")
    del tiles, ranked_tiled
    (nb4, ne4), stats["push4_s"] = timed(lambda: d.push4(found), "push4")
    # the children's first entries, through sizes_at (the gather_sizes kernel):
    # after the kick, a child that is not empty begins at an entry long enough
    # to hold the pushed base and the range's sequence
    child_sizes, stats["sizes_at_s"] = timed(lambda: d.sizes_at(nb4), "sizes_at")
    if not bool(((nb4 >= ne4) | (child_sizes > found.size[:, None])).all()):
        raise AssertionError("push4: a child begins at an entry shorter than its sequence")

    text = torch.from_numpy(np.concatenate([genome, (3 - genome)[::-1]])).to(dev)
    G = genome.shape[0]

    def probe_all():
        outs = []
        for p0 in range(0, 2 * G, PROBE_CHUNK):
            pos = torch.arange(p0, min(p0 + PROBE_CHUNK, 2 * G), device=dev)
            seg_lo = torch.where(pos >= G, G, 0)
            outs.append(probes.probe_exact_kernel(d, text, pos, seg_lo, depth))
        return tuple(torch.cat(x) for x in zip(*outs))

    probed, stats["probe_exact_s"] = timed(probe_all, "probe_exact")
    stats["probe_positions"] = 2 * G
    stats["n_entries"] = ss2.n_entries
    stats["reads"] = R
    stats["genome"] = G
    return stats, (ss2, rm2, found, ranked, (nb4, ne4), text, probed)


def check_results(dev, genome, codes, ss, found, ranked, pushed, text, probed, depth=DEPTH, sample=4096, host_sample=128):
    """Sampled lanes recomputed with the plain versions on the card, and an
    independent numpy/bytes check on the host."""
    d = ss.d
    G = genome.shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    if int(d.fixed[4]) != ss.n_entries:
        raise AssertionError("fixed[4] != n_entries")
    if int(ss.entry_sizes.max()) != codes.shape[1] or ss.max_entry_len != codes.shape[1]:
        raise AssertionError("longest entry is not a whole read")

    # rank4 and push4 (kernels over the rank-block table) against the plain
    # versions over the structure as stored: column b == rank(b, .) at both
    # ends of the range, and == push_front(r, b); d.rank and d.push_front (the
    # rank kernel) against the same
    words, cum = ss.prev_words.to(dev), ss.prev_cum.to(dev)
    pick = torch.randint(0, found.begin.shape[0], (sample,), generator=g).to(dev)
    r = SeqsetRanges(found.begin[pick], found.end[pick], found.size[pick])
    B = found.begin.shape[0]
    for b in range(4):
        base = torch.full((sample,), b, device=dev)
        want_begin, want_end = (rank4_ops.rank_plain(words, cum, base, p) for p in (r.begin, r.end))
        if not (torch.equal(ranked[pick, b].to(torch.int64), want_begin) and torch.equal(ranked[B + pick, b].to(torch.int64), want_end)):
            raise AssertionError(f"rank4 column {b} differs from rank over the structure as stored")
        if not (torch.equal(d.rank(base, r.begin), want_begin) and torch.equal(d.rank(base, r.end), want_end)):
            raise AssertionError(f"rank of base {b} differs from rank over the structure as stored")
        want = rank4_ops.push_front_plain(words, cum, d.entry_sizes, d.fixed, r.begin, r.end, r.size, base)
        if not (torch.equal(pushed[0][pick, b], want[0]) and torch.equal(pushed[1][pick, b], want[1])):
            raise AssertionError(f"push4 column {b} differs from push_front over the structure as stored")
        if not all(torch.equal(x, y) for x, y in zip(d.push_front(r, base), want)):
            raise AssertionError(f"push_front of base {b} differs from push_front over the structure as stored")

    # probe_exact through chain_window == the loop of push_front steps
    pos = torch.randint(0, 2 * G, (sample,), generator=g).to(dev)
    seg_lo = torch.where(pos >= G, G, 0)
    want = probes.probe_exact(d, text, pos, seg_lo, depth)
    for got_x, want_x in zip(probed, want):
        if not torch.equal(got_x[pos], want_x):
            raise AssertionError("probe_exact: the chain_window path differs from the push_front loop")

    # host: a window reported present is a substring of some read or its
    # reverse complement, and one base longer (still inside the search
    # bracket, whose upper end is exclusive) is not
    both = np.concatenate([codes, (3 - codes)[:, ::-1]])
    sep = np.full((both.shape[0], 1), 255, np.uint8)
    haystack = np.concatenate([both, sep], axis=1).tobytes()
    text_h = text.cpu().numpy()
    pos_h = pos[:host_sample].cpu().numpy()
    size_h = probed[2][pos[:host_sample]].cpu().numpy()
    valid_h = (probed[0] < probed[1])[pos[:host_sample]].cpu().numpy()
    for p, s, ok in zip(pos_h, size_h, valid_h):
        lo = G if p >= G else 0
        if s > 0 and not ok:
            raise AssertionError("probe_exact: nonempty window with an empty range")
        if s > 0 and haystack.find(text_h[p - s + 1 : p + 1].tobytes()) < 0:
            raise AssertionError(f"window of {s} bases ending at {p} reported present but is in no read")
        if s + 1 < min(depth, p - lo + 1) and haystack.find(text_h[p - s : p + 1].tobytes()) >= 0:
            raise AssertionError(f"window ending at {p}: {s + 1} bases exist but {s} was reported longest")
    return {"sampled_lanes": sample, "host_checked_windows": int(len(pos_h))}


# ---------------------------------------------------------------------------
# discovery: from the read store to records
# ---------------------------------------------------------------------------

DISCOVER_KERNELS = ("push4", "rank", "chain_window")
DISCOVER_OPT = dict(min_alt_support=5)
REGION = (0, 32768)  # held against the plain versions on a CPU copy of the store
MIN_READS_OVER_SNP = 5
# the least share of the well-covered planted SNPs that discovery must find
MIN_SNP_SHARE = 0.99


def run_discover(ss, reference, stage=None, opt=None, **kw):
    """One discover_variants call (with DISCOVER_OPT unless ``opt`` is
    given) with every kernel's count set to 0 just before it and read just
    after: (records, stats, seconds, launches)."""
    opt = opt or disc.DiscoverOptions(**DISCOVER_OPT)
    for fn in WRAPPERS.values():
        fn.launches = 0
    stats = {}
    records, seconds = timed(lambda: disc.discover_variants(ss, reference, opt=opt, stats=stats, **kw), stage)
    return records, stats, seconds, {name: fn.launches for name, fn in WRAPPERS.items()}


def discover_phase(ss, reference):
    """discover_variants over the whole genome on the card, cold (the
    prescreen bitmap and the trunc tables are built and cached on the
    seqset) and warm.  Fails if a kernel of the path was launched no time."""
    out = {}
    for run in ("cold", "warm"):
        records, stats, seconds, launches = run_discover(ss, reference)
        missing = [name for name in DISCOVER_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"discovery launched no {missing} kernel")
        out[run] = {
            "seconds": seconds,
            "stage_s": stats["stage_s"],
            "launches": launches,
        }
    out.update(
        records=len(records),
        prescreen_probed=stats["prescreen_probed"],
        anchors_found=stats["anchors_found"],
        anchors_truncated=stats["anchors_truncated"],
        assemblies_truncated=stats["assemblies_truncated"],
        beam_steps=stats.get("wave_steps", 0),
        compactions=stats.get("wave_compactions", 0),
        branch_retry_rescued=stats.get("branch_retry_rescued", 0),
        memory_plan=stats["memory_plan"],
    )
    return records, out


def key_of(r):
    return (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"], r["ref_support"])


def discover_checks(dev, ss, ss_cpu, reference, genome, records, snp, donor, starts, read_len, min_share=MIN_SNP_SHARE):
    """(a) every record's ref allele is the genome's at its position; (b) the
    planted SNPs that at least MIN_READS_OVER_SNP reads cover together with
    min_anchor_ctx bases before and rejoin_k + 1 after are found, at
    ``min_share`` of them or more; (c) over REGION the card and ss_cpu, a CPU
    copy of the store (every kernel's plain version), give identical
    records."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    G = genome.shape[0]
    code_of = {c: i for i, c in enumerate("ACGT")}
    for r in records:
        want = genome[r["pos"] - 1 : r["pos"] - 1 + len(r["ref"])]
        if [code_of[c] for c in r["ref"]] != want.tolist():
            raise AssertionError(f"record at {r['pos']}: ref allele {r['ref']} is not the genome's")
    # reads that hold [p - min_anchor_ctx, p + rejoin_k + 1]
    before, after = opt.min_anchor_ctx, opt.rejoin_k + 1
    sorted_starts = np.sort(starts)
    over = np.searchsorted(sorted_starts, snp - before, side="right") - np.searchsorted(sorted_starts, snp + after - read_len + 1, side="left")
    covered = over >= MIN_READS_OVER_SNP
    called = {(r["pos"] - 1, r["ref"], r["alt"]) for r in records}
    found = np.array([(int(p), "ACGT"[genome[p]], "ACGT"[donor[p]]) in called for p in snp])
    share = float(found[covered].mean())
    result = {
        "planted": int(len(snp)), "well_covered": int(covered.sum()), "found_of_well_covered": int(found[covered].sum()),
        "share": share, "missed": int((covered & ~found).sum()), "found_of_all": int(found.sum()),
    }
    if share < min_share:
        raise AssertionError(f"discovery found {share:.4f} of the well-covered planted SNPs, under {min_share}: {result}")
    # (c) the same region on the card and on a CPU copy of the store
    on_card, _, result["region_card_s"], launches = run_discover(ss, reference, region=REGION)
    on_cpu = disc.discover_variants(ss_cpu, reference, region=REGION, opt=opt)
    if not on_card or list(map(key_of, on_card)) != list(map(key_of, on_cpu)):
        raise AssertionError(f"discovery over {REGION}: {len(on_card)} records on the card, {len(on_cpu)} on the CPU copy, or they differ")
    result.update(region=list(REGION), region_records=len(on_card), region_launches=launches)
    return result


class HeldEngine:
    """A seqset's query engine whose push4 and push_front hold the kernel
    under them against its plain version on the very tensors the caller
    hands in, at every call; everything else is the engine's own.  ``held``
    counts the calls by kernel and lane count."""

    def __init__(self, d):
        self._d = d
        self.held = {"push4": {}, "rank": {}}

    def __getattr__(self, name):
        return getattr(self._d, name)

    def _count(self, kernel, lanes):
        self.held[kernel][lanes] = self.held[kernel].get(lanes, 0) + 1

    def push4(self, r):
        d = self._d
        got = d.push4(r)
        require_equal(
            f"push4 in discovery, {r.begin.shape[0]} lanes", got,
            rank4_ops.push4_plain(d.rank_blocks, d.entry_sizes, d.fixed, r.begin, r.end, r.size),
        )
        self._count("push4", r.begin.shape[0])
        return got

    def push_front(self, r, b):
        d = self._d
        b = b.to(torch.int64).contiguous()
        require_equal(
            f"rank in discovery, {b.shape[0]} lanes",
            rank4_ops.rank(d.rank_blocks, b, r.begin.contiguous(), r.end.contiguous()),
            (rank4_ops.rank_blocks_plain(d.rank_blocks, b, r.begin), rank4_ops.rank_blocks_plain(d.rank_blocks, b, r.end)),
        )
        self._count("rank", b.shape[0])
        return d.push_front(r, b)


def discover_kernel_holds(ss, reference, anchors_found=None):
    """Every kernel of the discovery path against its plain version on the
    inputs discovery gives it.  The whole-genome call is replayed stage by
    stage through the package's own functions: the filter and every bisection
    round hold chain_window at depth probe_ctx over all candidate lanes; the
    anchor scan holds push4 on those lanes; the first beam group of each
    orientation, seeded and driven to its end, holds rank on the seed and
    push4 at every beam step, at the full and at every compacted width."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    d, dev = ss.d, ss.device
    held = HeldEngine(d)
    G = len(reference.flat)
    ref2_dev = torch.from_numpy(np.concatenate([reference.flat, (3 - reference.flat[::-1]).astype(np.uint8)])).to(dev)
    stats = {}
    hit_pos, pos, cap, ctx = disc._candidate_lanes(ss, ref2_dev, disc._segments(opt, 0, G, G), opt, stats)
    win = probes._window_bases(ref2_dev, pos, opt.probe_ctx)
    chains = []

    def find(m):
        args = (d.rank_blocks, d.entry_sizes, d.fixed, win, m.to(torch.int32).contiguous(), opt.probe_ctx)
        got = rank4_ops.chain_window(*args)
        require_equal(f"chain_window in discovery, chain {len(chains)}", got, rank4_ops.chain_window_plain(*args))
        chains.append(float(m.float().mean()) if m.numel() else 0.0)
        return got

    seed = find(torch.full_like(pos, opt.min_anchor_ctx, dtype=torch.int32))
    b2, e2, s2 = probes._probe_exact(d, pos, ctx, opt.probe_ctx, opt.min_anchor_ctx, seed, find)
    n_raw, stacked = disc._anchor_scan_at(held, ref2_dev, pos, b2, e2, s2, opt.min_anchor_ctx, opt.min_branch_width, cap)
    if anchors_found is not None and n_raw != anchors_found:
        raise AssertionError(f"the replayed front end found {n_raw} anchors, discover_variants {anchors_found}")
    live = stacked.cpu().numpy()
    trunc = disc._trunc_tables(ss, opt.probe_ctx)
    for rev_half in (False, True):
        half = (live[0] >= G) == rev_half
        c = disc._asm_start(held, tuple(col[half][: disc.WAVE_LANES] for col in live), opt, 2 * G if rev_half else G, ref2_dev)
        if c is not None:
            disc._drive(held, c, trunc, stats)
    for kernel, calls in held.held.items():
        if not calls:
            raise AssertionError(f"the replayed discovery path never reached {kernel}")
    return {
        "lanes": int(pos.shape[0]), "anchors": n_raw, "chain_window_depth": opt.probe_ctx, "chain_window_mean_m": chains,
        "push4_calls_by_lanes": held.held["push4"], "rank_calls_by_lanes": held.held["rank"],
        "beam_steps": stats.get("wave_steps", 0), "compactions": stats.get("wave_compactions", 0),
    }


def small_genome_checks(dev):
    """What the scaled workload, SNPs only, does not reach on the card: an
    insertion, a deletion and a block substitution (a complex block, so the
    batched affine DP of ops/align_dp.py runs) on a 6000-base genome at 30x,
    discovered on the card and on a CPU copy of the store with identical
    records; and the aligner alone on block pairs full of score ties, the
    card's op lists against the CPU's."""
    from biograph_tpu_torch.ops.align_dp import align_blocks_batch

    rng = np.random.default_rng(SEED + 7)
    n = 6000
    ref = rng.integers(0, 4, n, dtype=np.uint8)
    block = (ref[[3300, 3303, 3306]] + 1) % 4  # three bases for seven, differing at both ends
    donor = np.concatenate([
        ref[:700], [(ref[700] + 1) % 4], ref[701:1501], rng.integers(0, 4, 5, dtype=np.uint8),
        ref[1501:2400], ref[2407:3300], block, ref[3307:],
    ]).astype(np.uint8)
    starts = rng.integers(0, len(donor) - 40, len(donor) * 30 // 40)
    codes = donor[starts[:, None] + np.arange(40)]
    half = len(starts) // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    ss = build_seqset(codes, np.full(len(starts), 40, np.int32), device=dev)
    reference = reference_from_numpy(ref, np.zeros(n, bool), [("chr1", 0, n)])
    on_card = disc.discover_variants(ss, reference)
    on_cpu = disc.discover_variants(ss.to("cpu"), reference)
    if list(map(key_of, on_card)) != list(map(key_of, on_cpu)):
        raise AssertionError(f"small genome: {len(on_card)} records on the card, {len(on_cpu)} on the CPU copy, or they differ")
    kinds = {len(r["alt"]) - len(r["ref"]) for r in on_card}
    in_block = [r for r in on_card if 3295 <= r["pos"] <= 3310]
    if not {0, 5, -7} <= kinds or not in_block:
        raise AssertionError(f"small genome: planted events not all found: length changes {sorted(kinds)}, {len(in_block)} records in the block")
    refs, alts = [], []
    for _ in range(64):  # homopolymer runs and their stretched or cut copies: a gap has many equally cheap places
        runs = [np.full(rng.integers(1, 9), rng.integers(0, 4), np.uint8) for _ in range(rng.integers(1, 12))]
        refs.append(np.concatenate(runs))
        alts.append(np.concatenate([np.resize(r, max(1, len(r) + rng.integers(-3, 4))) for r in runs if rng.random() > 0.15] or [runs[0]]))
    if align_blocks_batch(refs, alts, dev) != align_blocks_batch(refs, alts, "cpu"):
        raise AssertionError("align_blocks_batch: the card's op lists differ from the CPU's")
    return {"records": len(on_card), "records_in_the_block": len(in_block), "length_changes": sorted(kinds), "aligned_pairs": len(refs)}


def beam_step_profile(ss, reference, steps=8):
    """One beam group of the warm discovery, stepped by hand under
    torch.profiler: kernel launches and device microseconds a beam step, and
    the step's wall time."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    d, dev = ss.d, ss.device
    G = len(reference.flat)
    ref2_dev = torch.from_numpy(np.concatenate([reference.flat, (3 - reference.flat[::-1]).astype(np.uint8)])).to(dev)
    stats = {"anchors_found": 0, "anchors_truncated": 0}
    parts, _ = disc._find_anchors(ss, ref2_dev, disc._segments(opt, 0, G, G), opt, stats, disc._StageClock(dev, {}), G)
    anchors = tuple(c[: disc.WAVE_LANES] for c in parts[False])
    trunc = disc._trunc_tables(ss, opt.probe_ctx)
    c = disc._asm_start(d, anchors, opt, G, ref2_dev)

    def step():
        c["st"] = disc._wavefront_body(d, c["packed"], *trunc, c["n_packed"], c["st"], c["step"], c["MAXP"], c["k"], c["min_w"], c["probe_ctx"], c["pos_bits"])
        c["step"] += 1

    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _device_us(e)]
    kernels.sort(key=_device_us, reverse=True)
    return {
        "lanes": int(c["st"]["begin"].shape[0]),
        "launches_a_step": sum(e.count for e in kernels) / steps,
        "device_us_a_step": sum(_device_us(e) for e in kernels) / steps,
        "wall_us_a_step_under_the_profiler": seconds / steps * 1e6,
        "wall_us_a_step": event_ms(step, steps, warm=0) * 1e3,
        "top": [[e.key.split("(")[0][:60], e.count / steps, _device_us(e) / steps] for e in kernels[:6]],
    }


# ---------------------------------------------------------------------------
# discovery with the readmap: scoring, the pair gate, VCF
# ---------------------------------------------------------------------------

RECORDS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "torch_scaled_leg_records.tsv")


def read_records_file(path=RECORDS_FILE):
    """The JAX package's records of this workload with its readmap, on the
    CPU (the file's header names the command that made it): (chrom, pos,
    ref, alt, support, ref_support) tuples."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            chrom, pos, ref, alt, sup, rsup = line.rstrip("\n").split("\t")
            out.append((chrom, int(pos), ref, alt, int(sup), int(rsup)))
    return out


def require_records(name, records, want):
    """The records must be ``want``, the JAX CPU leg's, tuple for tuple; the
    first six of each difference are printed."""
    got = [key_of(r) for r in records]
    if got != want:
        lost, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        raise AssertionError(
            f"{name}: {len(got)} records, the JAX CPU leg {len(want)}; {len(lost)} of its records "
            f"missing (first {lost[:6]}), {len(extra)} not among them (first {extra[:6]})"
        )


def discover_scored_phase(ss, rm, reference, want, build_s, reads):
    """discover_variants with the readmap over the whole genome on the card,
    cold (the window hash index is built and cached on the readmap) and
    warm; its records must be the JAX CPU leg's.  The VCF of them is written
    and read back.  Fails if a kernel of the path was launched no time.
    Returns (records, the scored assemblies, what to print)."""
    out = {}
    for run in ("cold", "warm"):
        asms = []
        records, stats, seconds, launches = run_discover(ss, reference, readmap=rm, out_assemblies=asms)
        missing = [name for name in DISCOVER_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"scored discovery launched no {missing} kernel")
        out[run] = {"seconds": seconds, "stage_s": stats["stage_s"], "launches": launches}
    require_records("scored discovery", records, want)
    with tempfile.TemporaryDirectory() as tmp:
        disc.write_discovery_vcf(tmp + "/scored.vcf", reference, records, opt=disc.DiscoverOptions(**DISCOVER_OPT))
        back = read_vcf(tmp + "/scored.vcf")
    by_site = {(r["chrom"], r["pos"], r["ref"], r["alt"]): r for r in records}
    for v in back:
        r = by_site[(v.chrom, v.pos, v.ref, v.alt)]
        if (int(v.info["SUP"]), int(v.info["RSUP"])) != (r["support"], r["ref_support"]):
            raise AssertionError(f"VCF record {v.chrom}:{v.pos} does not carry its record's support")
    if not back:
        raise AssertionError("no record passed the genotype filter into the VCF")
    out.update(
        records=len(records), want_records=len(want), pair_gated=stats.get("pair_gated", 0),
        assemblies_scored=len(asms), anchors_found=stats["anchors_found"],
        vcf_records_passing_genotype_filter=len(back), build_and_readmap_s=build_s,
        reads_per_s_build_and_warm_call=reads / (build_s + out["warm"]["seconds"]),
        reads_per_s_build_and_cold_call=reads / (build_s + out["cold"]["seconds"]),
    )
    return records, asms, out


def coverage_slab(rm, asms, ref):
    """The first slab of the coverage batch that scoring builds for asms:
    (q, ql, Lp) with as many rows as one slab of the coverage walk holds."""
    _, q, ql = disc._score_rows(ref, asms, rm.max_read_len + 2)
    Lp = max(64, -(-q.shape[1] // 64) * 64)
    rows = 1 << ((readmap_mod.SLAB_LANES // Lp).bit_length() - 1)
    return q[:rows], ql[:rows], Lp


def coverage_text(q, Lp):
    """The text the coverage walk hands its probes for these rows: each row
    padded to Lp bases, the row count to a power of two, flattened."""
    Bp = 1 << max((q.shape[0] - 1).bit_length(), 0)
    cp = np.zeros((Bp, Lp), np.uint8)
    cp[: q.shape[0], : q.shape[1]] = q
    return cp.reshape(-1)


def paired_library(rng, donor, n_pairs=1500, L=60, frag=260):
    """Mates at fragment 260, the second reverse-complemented: the library
    of tests/test_pair_gate.py, at 1500 pairs."""
    s = rng.integers(0, len(donor) - frag, n_pairs)
    first = donor[s[:, None] + np.arange(L)]
    second = (3 - donor[(s + frag - L)[:, None] + np.arange(L)])[:, ::-1]
    codes = np.stack([first, second], axis=1).reshape(2 * n_pairs, L).astype(np.uint8)
    mate = np.arange(2 * n_pairs)
    mate[0::2] += 1
    mate[1::2] -= 1
    return codes, np.full(2 * n_pairs, L, np.int32), mate


def card_and_cpu(name, ss, rm, rm_cpu, reference, opt, **kw):
    """discover_variants with the readmap on the card and on rm_cpu, a CPU
    copy of the store and the readmap: the same records and pair_gated, or
    fail.  Returns the card's (records, stats) and the scored, gated
    assemblies of both, card first."""
    runs = []
    for on_ss, on_rm in ((ss, rm), (rm_cpu.seqset, rm_cpu)):
        stats, asms = {}, []
        runs.append((disc.discover_variants(on_ss, reference, opt=opt, readmap=on_rm, stats=stats, out_assemblies=asms, **kw), stats, asms))
    (on_card, card_stats, card_asms), (on_cpu, cpu_stats, cpu_asms) = runs
    if list(map(key_of, on_card)) != list(map(key_of, on_cpu)):
        raise AssertionError(f"{name}: {len(on_card)} records on the card, {len(on_cpu)} on the CPU copy, or they differ")
    require_same_gate(name, card_stats, cpu_stats)
    return on_card, card_stats, (card_asms, cpu_asms)


def require_same_gate(name, card_stats, cpu_stats):
    if card_stats.get("pair_gated") != cpu_stats.get("pair_gated"):
        raise AssertionError(f"{name}: pair_gated {card_stats.get('pair_gated')} on the card, {cpu_stats.get('pair_gated')} on the CPU copy")


def region_check(ss, rm, rm_cpu, reference):
    """Over REGION, scored discovery on the card and on rm_cpu, a CPU copy of
    the store and the readmap, gives the same records, and some."""
    on_card, _, _ = card_and_cpu("scored discovery over REGION", ss, rm, rm_cpu, reference, disc.DiscoverOptions(**DISCOVER_OPT), region=REGION)
    if not on_card:
        raise AssertionError(f"scored discovery over {REGION}: no record")
    return len(on_card)


def chain_fixed_check(dev, ss, rm, reference, asms):
    """Coverage of a slab of the scored rows through the uniform route
    without the hash index launches chain_fixed, which is held against its
    plain version on the same windows, and gives the hash route's coverage.
    Returns (what to print, the slab as (text, depth))."""
    q, ql, Lp = coverage_slab(rm, asms, reference.flat)
    for fn in WRAPPERS.values():
        fn.launches = 0
    chained = rm._coverage_full(q, ql, 16, use_hash=False)
    launches = rank4_ops.chain_fixed.launches
    if launches == 0:
        raise AssertionError("coverage without the hash index launched no chain_fixed kernel")
    hashed = rm._coverage_full(q, ql, 16)
    require_equal("coverage through chain_fixed vs the hash route", tuple(chained), tuple(hashed))
    d = ss.d
    depth = min(ss.max_entry_len, Lp)
    text = torch.from_numpy(coverage_text(q, Lp)).to(dev)
    m = torch.full((text.shape[0],), depth, dtype=torch.int32, device=dev)
    require_equal(
        "chain_fixed on the scored slab",
        rank4_ops.chain_fixed(d.rank_blocks, d.entry_sizes, d.fixed, text, depth),
        rank4_ops.chain_window_plain(d.rank_blocks, d.entry_sizes, d.fixed, rank4_ops.contig_windows(text, depth), m, depth),
    )
    return {
        "rows": int(q.shape[0]), "lanes": int(text.shape[0]), "depth": depth, "launches": launches,
        "read_ends_counted": int(hashed[3].sum()),
    }, (text, depth)


def paired_check(dev, seed=SEED + 11, n_pairs=1500):
    """A 6000-base genome whose donor carries a novel 400-base insertion,
    read as pairs: discovered with its readmap (read placement and the pair
    gate) on the card and on a CPU copy with the same records; the
    insertion is kept, and culled on both by a gate that asks for more pairs
    than exist."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 6000, dtype=np.uint8)
    ins = rng.integers(0, 4, 400, dtype=np.uint8)
    codes, lens, mate = paired_library(rng, np.concatenate([genome[:3000], ins, genome[3000:]]), n_pairs)
    ss = build_seqset(codes, lens, device=dev)
    rm = build_readmap(ss, codes, lens, mate_of=mate, device=dev)
    reference = reference_from_numpy(genome, np.zeros(6000, bool), [("chr1", 0, 6000)])
    rm_cpu = rm.to("cpu")
    kept, kstats, (card_asms, cpu_asms) = card_and_cpu("paired library", ss, rm, rm_cpu, reference, disc.DiscoverOptions(min_alt_support=5, max_path=480))
    strict = disc.DiscoverOptions(min_alt_support=5, max_path=480, min_pair_evidence=10**6)
    cstats, cpu_cstats = {}, {}
    culled = disc.pair_gate_assemblies(rm, genome, card_asms, strict, cstats) + disc.pair_gate_assemblies(rm_cpu, genome, cpu_asms, strict, cpu_cstats)
    require_same_gate("paired library, strict gate", cstats, cpu_cstats)
    if [len(r["alt"]) - len(r["ref"]) for r in kept] != [400] or culled or not cstats.get("pair_gated"):
        raise AssertionError(f"paired library: the 400-base insertion not kept by the gate and culled by a strict one: {kept}, {culled}, {cstats}")
    return {
        "records": len(kept), "pair_gated": kstats.get("pair_gated", 0), "strict_gate_pair_gated": cstats["pair_gated"],
        "proper_pairs": int(len(rm.__dict__[("_ref_pair_spans", 1000)][0])),
    }


def mixed_lengths_check(dev, seed=SEED + 13, genome_len=6000, n_reads=1800):
    """Reads of 100 bases, about half trimmed by 1-20: coverage (both strands
    and the start/end events) of windows along the genome takes the general
    route (probe_ranges through rank, then chain_window), launches both
    kernels and equals that of a CPU copy of the store and the readmap."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    donor = genome.copy()
    snp = rng.choice(np.arange(200, genome_len - 200), 40, replace=False)
    donor[snp] = (donor[snp] + 1 + rng.integers(0, 3, 40)) % 4
    starts = rng.integers(0, genome_len - 100, n_reads)
    codes = donor[starts[:, None] + np.arange(100)]
    half = n_reads // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    lens = np.full(n_reads, 100, np.int32)
    lens[1::2] -= rng.integers(1, 21, n_reads - half).astype(np.int32)
    codes = np.where(np.arange(100)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    ss = build_seqset(codes, lens, device=dev)
    rm = build_readmap(ss, codes, lens, device=dev)
    windows = np.stack([genome[i : i + 500] for i in range(0, genome_len - 500, 700)])  # 8 rows, no padding row
    wlens = np.full(len(windows), 500, np.int32)
    for fn in WRAPPERS.values():
        fn.launches = 0
    got = rm._coverage_full(windows, wlens)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    require_equal("coverage, general route, card vs CPU copy", tuple(x.cpu() for x in got), rm.to("cpu")._coverage_full(windows, wlens))
    if launches["rank"] == 0 or launches["chain_window"] == 0:
        raise AssertionError(f"coverage's general route launched {launches}: no rank or no chain_window")
    return {"read_lengths": [rm.min_read_len, rm.max_read_len], "windows": len(windows),
            "read_ends_counted": int(got[3].sum()), "coverage_launches": {k: v for k, v in launches.items() if v}}


def scored_checks(dev, ss, rm, rm_cpu, reference, asms):
    """The scored path's checks beyond the records: the region on a CPU copy,
    chain_fixed on coverage's path, a paired library and a library of mixed
    read lengths.  Returns (what to print, the chain_fixed slab as (text,
    depth), chain_fixed's launches)."""
    (chained, slab), chained["seconds"] = timed(lambda: chain_fixed_check(dev, ss, rm, reference, asms))
    region, region_s = timed(lambda: region_check(ss, rm, rm_cpu, reference))
    paired, paired["seconds"] = timed(lambda: paired_check(dev))
    mixed, mixed["seconds"] = timed(lambda: mixed_lengths_check(dev))
    result = {"region_records": region, "region_s": region_s, "chain_fixed": chained, "paired": paired, "mixed_lengths": mixed}
    return result, slab, chained["launches"]


# ---------------------------------------------------------------------------
# the dense front end, the wavefront without trunc tables, the widen family,
# the SDK
# ---------------------------------------------------------------------------

TINY_BUDGET_BYTES = 1 << 16  # a memory plan with no room for the trunc tables
WIDEN_SIZES = (25, 1)  # truncate_ranges targets: probe_ctx, and the longest walks
LT_QUERIES = 1 << 20


@contextlib.contextmanager
def discovery_constants(**values):
    """The discovery module's constants set as given, restored after."""
    saved = {k: getattr(disc, k) for k in values}
    try:
        for k, v in values.items():
            setattr(disc, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(disc, k, v)


def scored_calls(ss, rm, reference, want, name, **constants):
    """The scored call (discovery with the readmap) cold and warm with the
    discovery module's constants set as given (``discovery_constants``).
    Each call's records must be the JAX CPU leg's, tuple for tuple, and each
    must launch every kernel of DISCOVER_KERNELS.  Returns (what to print,
    the last call's stats)."""
    out = {}
    with discovery_constants(**constants):
        for run in ("cold", "warm"):
            records, stats, seconds, launches = run_discover(ss, reference, readmap=rm)
            require_records(name, records, want)
            missing = [k for k in DISCOVER_KERNELS if launches[k] == 0]
            if missing:
                raise AssertionError(f"{name} launched no {missing} kernel")
            out[run] = {"seconds": seconds, "stage_s": stats["stage_s"], "launches": launches}
    out.update(records=len(want), anchors_found=stats["anchors_found"], memory_plan=stats["memory_plan"],
               beam_steps=stats.get("wave_steps", 0))
    return out, stats


def dense_kernel_holds(ss, reference):
    """The dense front end's first batch replayed with rank held against its
    plain version at every step of the restart chain (1 M lanes a step) and
    push4 on the dense anchor scan's lanes."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    dev = ss.device
    held = HeldEngine(ss.d)
    G = len(reference.flat)
    ref2_dev = torch.from_numpy(np.concatenate([reference.flat, (3 - reference.flat[::-1]).astype(np.uint8)])).to(dev)
    batches, P = disc._dense_batches(disc._segments(opt, 0, G, G), opt, 0, G)
    (_, _, p0, _, seg_hi), = first = batches[:1]
    (b, e, s), = disc._dense_probes(held, ref2_dev, first, P, opt, disc._StageClock(dev, {}))
    lane = torch.arange(P, device=dev)
    n_raw, _ = disc._anchor_scan_at(held, ref2_dev, p0 + lane, b, e, s, opt.min_anchor_ctx, opt.min_branch_width,
                                    torch.full_like(lane, min(seg_hi, p0 + P)))
    if not held.held["rank"] or not held.held["push4"]:
        raise AssertionError(f"the replayed dense front end never reached a kernel: {held.held}")
    return {"batches": len(batches), "lanes_a_batch": P, "first_batch_anchors": n_raw,
            "rank_calls_by_lanes": held.held["rank"], "push4_calls_by_lanes": held.held["push4"]}


def discover_dense_phase(ss, rm, reference, want):
    """The scored call with the dense front end forced (``NO_PRESCREEN``),
    cold and warm, its records held to the JAX CPU leg's; then rank and
    push4 held against their plain versions on the dense route's lanes."""
    out, _ = scored_calls(ss, rm, reference, want, "dense front end", NO_PRESCREEN=True)
    out["holds"], out["holds"]["seconds"] = timed(lambda: dense_kernel_holds(ss, reference))
    out["holds"]["max_abs_err"] = 0
    return out


def discover_no_trunc_phase(ss, rm, reference, want, with_tables):
    """The scored call with a memory plan that drops the trunc tables (the
    wavefront truncates through the seqset's LtSearch), cold and warm, its
    records held to the JAX CPU leg's; the wavefront's seconds beside those
    of ``with_tables``, the warm call with them."""
    out, stats = scored_calls(ss, rm, reference, want, "discovery without trunc tables", BUDGET_BYTES=TINY_BUDGET_BYTES)
    if stats["memory_plan"]["use_trunc_tables"]:
        raise AssertionError(f"the tiny budget kept the trunc tables: {stats['memory_plan']}")
    out["wavefront_s"] = {"without_tables_warm": out["warm"]["stage_s"]["wavefront"],
                          "with_tables_warm": with_tables["stage_s"]["wavefront"]}
    return out


def require_same(name, card, cpu):
    if not isinstance(card, tuple):
        card, cpu = (card,), (cpu,)
    require_equal(name, tuple(x.cpu() for x in card), tuple(cpu))


def widen_checks(ss, ss_cpu, found):
    """The widen family on the full store, over the ranges find gave every
    oriented read, and LtSearch on LT_QUERIES random (pos, c): each on the
    card and on ss_cpu, a CPU copy of the store, with identical answers.
    Each timed on both; the card's LtSearch is built by its first query."""
    d, dc = ss.d, ss_cpu.d
    dev = ss.device
    cpu = SeqsetRanges(*(x.cpu() for x in found))
    g = torch.Generator(device="cpu").manual_seed(SEED + 21)
    bases = torch.randint(0, 4, found.begin.shape, generator=g)
    out = {"ranges": int(found.begin.shape[0]), "n_entries": ss.n_entries}
    lt, out["ltsearch_build_s"] = timed(lambda: LtSearch.build(d.shared))
    out["ltsearch_bytes"] = sum(t.numel() * t.element_size() for t in (lt.values, lt.block_min, lt.levels))
    calls = [(f"truncate_ranges_to_{m}", lambda d, r, b, m=m: d.truncate_ranges(r, m)) for m in WIDEN_SIZES]
    calls += [
        ("pop_front_ranges", lambda d, r, b: d.pop_front_ranges(r)),
        ("push_front_drop", lambda d, r, b: d.push_front_drop(r, b)),
        ("push_front_drop_min_ctx_60", lambda d, r, b: d.push_front_drop(r, b, min_ctx=60)),
    ]
    for name, fn in calls:
        got, out[name + "_s"] = timed(lambda: fn(d, found, bases.to(dev)))
        t0 = time.perf_counter()
        want = fn(dc, cpu, bases)
        out[name + "_cpu_s"] = time.perf_counter() - t0
        require_same(name, tuple(got), tuple(want))
        out[name + "_valid"] = int(got.valid.sum())
    n = ss.n_entries
    pos = torch.randint(0, n + 1, (LT_QUERIES,), generator=g)
    c = torch.randint(0, 101, (LT_QUERIES,), generator=g).to(torch.int32)
    lt, lt_cpu = d.shared_lt, dc.shared_lt
    for name in ("next_backward_lt", "next_forward_lt"):
        got, out[f"ltsearch_{name}_s"] = timed(lambda: getattr(lt, name)(pos.to(dev), c.to(dev)))
        t0 = time.perf_counter()
        want = getattr(lt_cpu, name)(pos, c)
        out[f"ltsearch_{name}_cpu_s"] = time.perf_counter() - t0
        require_same(f"LtSearch {name}", got, want)
    out["ltsearch_queries"] = LT_QUERIES
    return out


def sdk_checks(dev, ss, rm, codes, genome):
    """BioGraph on a .bgt of the store and the readmap, opened on the card
    and on the CPU: find, SeqsetEntry.pop_front and truncate, and the read
    iteration methods on a sample of reads, with identical answers."""
    from biograph_tpu_torch.api import BioGraph

    from biograph_tpu_torch.core import dna

    rng = np.random.default_rng(SEED + 23)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(tmp + "/sample.bgt")
        ss.save(tmp + "/sample.bgt/seqset")
        rm.save(tmp + "/sample.bgt/readmap")
        bg, out["open_s"] = timed(lambda: BioGraph(tmp + "/sample.bgt", device=dev))
        bg_cpu = BioGraph(tmp + "/sample.bgt", device="cpu")
    if not bg.num_reads == bg_cpu.num_reads == codes.shape[0]:
        raise AssertionError(f"BioGraph: {bg.num_reads} reads on the card, {bg_cpu.num_reads} on the CPU")
    sample = rng.choice(codes.shape[0], 16, replace=False)
    overlap_at = dict(zip(sample.tolist(), rng.integers(0, genome.shape[0] - 150, 16).tolist()))

    def entry_tuple(e):
        return (e.begin, e.end, e.size)

    def walk(g):
        res = []
        for i in sample:
            e = g.find(dna.codes_to_seq(codes[i]))
            res.append(entry_tuple(e))
            res += [entry_tuple(e.pop_front()), entry_tuple(e.truncate(30)), entry_tuple(e.truncate(1))]
            res.append(g.readmap.get_prefix_reads(e))
            res.append(g.readmap.get_reads_containing(codes[i][30:60]))
            p = overlap_at[int(i)]
            res.append(g.readmap.find_overlap_reads(genome[p : p + 150], min_overlap=60))
        return res

    on_card, out["queries_s"] = timed(lambda: walk(bg))
    on_cpu = walk(bg_cpu)
    if on_card != on_cpu:
        diff = next(i for i, (a, b) in enumerate(zip(on_card, on_cpu)) if a != b)
        raise AssertionError(f"BioGraph: the card and the CPU differ at answer {diff}: {on_card[diff]} vs {on_cpu[diff]}")
    if not all(r[0] < r[1] for r in on_card[::7]):
        raise AssertionError("BioGraph: a sampled read was not found")
    out.update(reads_sampled=len(sample), answers=len(on_card),
               reads_containing=sum(len(x) for x in on_card[5::7]), overlap_reads=sum(len(x) for x in on_card[6::7]))
    return out


# ---------------------------------------------------------------------------
# the coverage stage and the classifier: the scaled leg, and a trimmed,
# paired, diploid library
# ---------------------------------------------------------------------------

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
COVERAGE_FILE = os.path.join(DATA, "torch_scaled_leg_coverage.tsv")
MODEL_FILE = os.path.join(DATA, "torch_scaled_leg_qual_model.npz")
COVERAGE_KERNELS = ("rank", "chain_window")  # coverage's general route
PROB_TOL = 1e-5  # the classifier's probabilities against the JAX CPU leg's file (float32 here, float64 there)
TRAIN_TOL = 1e-4  # training on the card against the same training on a CPU copy
TRIMMED = dict(n_pairs=120_000, n_het=3000, n_hom=1000, n_indel=200)
REGION_RECORDS = 200  # records of leg 2 held to a CPU copy
PARALLEL_GAP = 1000  # leg 1's region chunks: unpaired reads of 100 bases, so no evidence crosses 1000 bases


@contextlib.contextmanager
def step_clock():
    """The coverage stage's steps (annotate_coverage,
    annotate_pair_coverage, phase_records, evaluate_vargraph) each timed,
    the device drained before and after, while the block runs: yields
    {step: seconds}."""
    from biograph_tpu_torch.variants import phase, vargraph

    seconds = {}
    targets = [(cov, "annotate_coverage"), (cov, "annotate_pair_coverage"), (phase, "phase_records"), (vargraph, "evaluate_vargraph")]
    saved = [(m, name, getattr(m, name)) for m, name in targets]

    def clocked(name, fn):
        def run(*args, **kw):
            out, sec = timed(lambda: fn(*args, **kw))
            seconds[name] = seconds.get(name, 0.0) + sec
            return out

        return run

    try:
        for m, name, fn in saved:
            setattr(m, name, clocked(name, fn))
        yield seconds
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


@contextlib.contextmanager
def held_kernels():
    """rank and chain_window, as coverage's general route calls them
    (``Seqset.d`` and ``probes``), each held against its plain version on
    the very tensors it is handed, at every call, while the block runs:
    yields {kernel: {lanes: calls}}."""
    held = {"rank": {}, "chain_window": {}}
    real_rank, real_chain = rank4_ops.rank, probes.chain_window

    def count(kernel, lanes):
        held[kernel][lanes] = held[kernel].get(lanes, 0) + 1

    def rank(blocks, b, pos, pos_end=None):
        got = real_rank(blocks, b, pos, pos_end)
        want = tuple(rank4_ops.rank_blocks_plain(blocks, b, p) for p in ((pos,) if pos_end is None else (pos, pos_end)))
        require_equal(f"rank in coverage, {b.numel()} lanes", got if pos_end is not None else (got,), want)
        count("rank", b.numel())
        return got

    def chain_window(*args):
        got = real_chain(*args)
        require_equal(f"chain_window in coverage, {args[3].shape[0]} lanes", got, rank4_ops.chain_window_plain(*args))
        count("chain_window", args[3].shape[0])
        return got

    rank.launches = 0  # the wrapped rank counts its launches here while the block runs
    try:
        rank4_ops.rank, probes.chain_window = rank, chain_window
        yield held
    finally:
        rank4_ops.rank, probes.chain_window = real_rank, real_chain


def run_coverage_counted(bg, reference, vcf_in, vcf_out, feats_out, stage=None, **kw):
    """One run_coverage call with every kernel's count set to 0 just before
    it and read just after, its steps timed: (annotated records, features,
    seconds, steps' seconds, launches)."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    with step_clock() as steps:
        _, seconds = timed(lambda: cov.run_coverage(vcf_in, vcf_out, bg, reference, features_out=feats_out, **kw), stage)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    return read_vcf(vcf_out), dict(np.load(feats_out)), seconds, steps, launches


COVERAGE_VCF_COLUMNS = ["chrom", "pos", "ref", "alt", "GT", "GQ", "AD", "PL", "DP", "PC", "PS"]


def coverage_rows(records, feats, prob=None):
    """The coverage file's (column names, rows of text): a row a record, the
    annotated VCF's columns, every feature column in name order, and prob
    when given; floats as the shortest text that reads back to the same
    value."""
    names = sorted(feats)
    rows = []
    for i, r in enumerate(records):
        row = [r.chrom, str(r.pos), r.ref, r.alt] + [str(r.fmt.get(k, ".")) for k in ("GT", "GQ", "AD", "PL", "DP")]
        row += [str(r.info["PC"]), str(r.fmt.get("PS", "."))]
        row += [repr(float(feats[k][i])) if feats[k].dtype.kind == "f" else str(int(feats[k][i])) for k in names]
        if prob is not None:
            row.append(repr(float(prob[i])))
        rows.append(row)
    return COVERAGE_VCF_COLUMNS + names + (["prob"] if prob is not None else []), rows


def read_coverage_file():
    """The JAX CPU leg's coverage of the scaled workload (the file's header
    names the command that made it): (column names, rows of text)."""
    with open(COVERAGE_FILE) as f:
        lines = [ln.rstrip("\n").split("\t") for ln in f if not ln.startswith("##")]
    lines[0][0] = lines[0][0].lstrip("# ")
    return lines[0], lines[1:]


def save_sample(path, ss, rm):
    """A .bgt of the store and the readmap at path."""
    os.makedirs(path)
    ss.save(path + "/seqset")
    rm.save(path + "/readmap")
    return path


def fasta_dir(path, genome, name):
    """A reference dir holding the genome as source.fasta, one contig."""
    from biograph_tpu_torch.core import dna

    os.makedirs(path)
    with open(path + "/source.fasta", "w") as f:
        f.write(f">{name}\n{dna.codes_to_seq(genome)}\n")
    return path


def coverage_scored_phase(dev, ss, rm, reference, genome, want_records, tmp):
    """Leg 1, the scaled leg: run_coverage (pairs, phasing) of the VCF of
    the JAX CPU leg's 2299 records on a BioGraph of the store and readmap on
    the card, cold and warm, each equal to the committed JAX CPU leg's
    coverage file, every column exact; the committed JAX-trained model
    applied (apply_to_vcf), its probabilities within PROB_TOL of the file's
    and FILTER the same; run_coverage_parallel with 2 workers equal to
    run_coverage.  Returns (what to print, the warm call's launches, a
    callable that runs the warm call again)."""
    from biograph_tpu_torch.api import BioGraph

    names, want = read_coverage_file()
    vcf_in = tmp + "/scored.vcf"
    records = [dict(zip(("chrom", "pos", "ref", "alt", "support", "ref_support"), r)) for r in want_records]
    disc.write_discovery_vcf(vcf_in, reference, records, opt=disc.DiscoverOptions(**DISCOVER_OPT, simple_genotype_filter=False))
    bgt = save_sample(tmp + "/scaled.bgt", ss, rm)
    bg, open_s = timed(lambda: BioGraph(bgt, device=dev))
    out = {"records": len(records), "open_s": open_s}
    for run in ("cold", "warm"):
        annotated, feats, seconds, steps, launches = run_coverage_counted(
            bg, reference, vcf_in, tmp + f"/cov_{run}.vcf", tmp + f"/cov_{run}.npz", pair_cov=True, phase=True)
        got_names, got = coverage_rows(annotated, feats)
        if got_names + ["prob"] != names or got != [w[:-1] for w in want]:
            bad = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w[:-1]), min(len(got), len(want)))
            raise AssertionError(f"coverage_scored {run}: {len(got)} rows, the JAX CPU leg {len(want)}; first difference at row {bad}: "
                                 f"{got[bad] if bad < len(got) else None} vs {want[bad][:-1] if bad < len(want) else None}")
        out[run] = {"seconds": seconds, "steps_s": steps, "launches": launches}
    # the JAX-trained model on the card, its float32 matmuls at full precision
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("coverage_scored: TF32 is on; the classifier's matmuls must run in full float32")
    out["float32_matmul_precision"] = torch.get_float32_matmul_precision()
    want_prob = np.array([float(w[-1]) for w in want])
    for run in ("cold", "warm"):
        clf, load_s = timed(lambda: clf_model.Classifier.load(MODEL_FILE, device=dev))
        prob, apply_s = timed(lambda: clf_model.apply_to_vcf(clf, tmp + "/cov_warm.vcf", tmp + f"/qual_{run}.vcf", feats))
        out[run]["classifier_s"] = load_s + apply_s
    err = float(np.abs(prob.astype(np.float64) - want_prob).max())
    filters = [r.filter for r in read_vcf(tmp + "/qual_warm.vcf")]
    if err > PROB_TOL or filters != ["PASS" if p >= 0.5 else "lowq" for p in want_prob]:
        raise AssertionError(f"coverage_scored: the classifier's probabilities differ from the JAX CPU leg's by {err} (limit {PROB_TOL}), or FILTER does")
    out.update(classifier_max_abs_err=err, passing=filters.count("PASS"))
    # region-parallel: 2 workers, each opening the .bgt on the card
    ref_dir = fasta_dir(tmp + "/scaled_ref", genome, reference.contigs[0].name)
    _, out["parallel_s"] = timed(lambda: cov.run_coverage_parallel(
        vcf_in, tmp + "/par.vcf", bgt, ref_dir, n_workers=2, features_out=tmp + "/par.npz",
        pair_cov=True, phase=True, safe_gap=PARALLEL_GAP, device=dev))
    with open(tmp + "/par.vcf") as f, open(tmp + "/cov_warm.vcf") as g:
        same = f.read() == g.read()
    par = dict(np.load(tmp + "/par.npz"))
    if not same or sorted(par) != sorted(feats) or not all(np.array_equal(par[k], feats[k]) for k in feats):
        raise AssertionError("coverage_scored: run_coverage_parallel differs from run_coverage")
    out["parallel_chunks"] = len(cov._region_chunks(read_vcf(vcf_in), 2, safe_gap=PARALLEL_GAP))

    def again():
        return cov.run_coverage(vcf_in, tmp + "/again.vcf", bg, reference, features_out=tmp + "/again.npz", pair_cov=True, phase=True)

    return out, out["warm"]["launches"], again


def truth_labels(records, truth, chrom, slack=10):
    """True where a record is a planted variant: a SNP at its place, an
    indel of the same length change within ``slack`` bases (an indel in a
    repeat has several places)."""
    snps = {(chrom, int(p) + 1, "ACGT"[r], "ACGT"[a]) for kind in ("het", "hom") for p, r, a in zip(*truth[kind])}
    indels = [(p + 1, len(a) - len(r)) for p, r, a in truth["indel"]]
    out = []
    for r in records:
        change = len(r.alt) - len(r.ref)
        out.append((r.chrom, r.pos, r.ref, r.alt) in snps or (change != 0 and any(abs(r.pos - p) <= slack and change == c for p, c in indels)))
    return np.array(out)


def coverage_trimmed_phase(dev, genome, tmp, trimmed=TRIMMED, region_records=REGION_RECORDS, min_entries=1_000_000):
    """Leg 2, a trimmed, paired, diploid library at full size
    (``trimmed_paired_library``): the store and the readmap built with
    mate_of on the card; discover_variants with the readmap and the pair
    gate; run_coverage (pairs, phasing, the joint graph) of its VCF, which
    must launch rank and chain_window (coverage's general route); over a
    region of region_records records the annotated VCF and features equal to
    the same call on a CPU copy of the store and readmap; genotypes against
    the truth; train_classifier on the card against the truth labels, its
    probabilities held to the same training on a CPU copy from the same
    init.  Returns (what to print, the coverage call's launches, a callable
    that runs the coverage call again)."""
    codes, lengths, mate_of, truth = trimmed_paired_library(genome, **trimmed)
    G = len(genome)
    out = {"pairs": trimmed["n_pairs"], "reads": len(lengths), "read_lengths": [int(lengths.min()), int(lengths.max())],
           "mean_read_length": float(lengths.mean()), "per_haplotype_coverage": float(lengths.sum()) / G / 2}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ss, out["build_s"] = timed(lambda: build_seqset(codes, lengths, device=dev))
    rm, out["readmap_s"] = timed(lambda: build_readmap(ss, codes, lengths, mate_of=mate_of, device=dev))
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    out["n_entries"] = ss.n_entries
    if ss.n_entries < min_entries:
        raise AssertionError(f"leg 2: n_entries {ss.n_entries} is below the real-size floor of {min_entries}")
    reference = reference_from_numpy(genome, np.zeros(G, bool), [("chr1", 0, G)])
    opt = disc.DiscoverOptions()
    records, stats, out["discover_s"], out["discover_launches"] = run_discover(ss, reference, opt=opt, readmap=rm)
    out.update(records=len(records), pair_gated=stats.get("pair_gated", 0), discover_stage_s=stats["stage_s"])
    vcf_in = tmp + "/trimmed.vcf"
    disc.write_discovery_vcf(vcf_in, reference, records, opt=opt)
    bg = SimpleNamespace(readmap=rm)  # what run_coverage reads of a BioGraph
    annotated, feats, out["coverage_s"], out["steps_s"], launches = run_coverage_counted(
        bg, reference, vcf_in, tmp + "/trimmed_cov.vcf", tmp + "/trimmed_cov.npz", pair_cov=True, phase=True, joint_graph=True)
    out["vcf_records"], out["coverage_launches"] = len(annotated), launches
    missing = [k for k in COVERAGE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"leg 2: run_coverage launched no {missing} kernel (the general route)")
    # the kernels against their plain versions on the lanes of one batch
    with held_kernels() as held:
        _, out["kernel_holds_s"] = timed(lambda: cov.annotate_coverage(rm, reference, read_vcf(vcf_in)[: cov.BATCH]))
    if not all(held.values()):
        raise AssertionError(f"leg 2: a coverage batch replayed with the kernels held never reached one: {held}")
    out["kernel_holds"] = {k: {str(lanes): n for lanes, n in v.items()} for k, v in held.items()}
    # a region of region_records records on the card and on a CPU copy
    from biograph_tpu_torch.io.vcf import VcfWriter

    lo = max(len(annotated) // 2 - region_records // 2, 0)
    part = read_vcf(vcf_in)[lo : lo + region_records]
    with VcfWriter(tmp + "/region.vcf", contigs=[("chr1", G)]) as w:
        for r in part:
            w.write(r)
    rm_cpu = rm.to("cpu")
    region = {}
    for name, sample in (("card", bg), ("cpu", SimpleNamespace(readmap=rm_cpu))):
        region[name] = run_coverage_counted(sample, reference, tmp + "/region.vcf", tmp + f"/region_{name}.vcf", tmp + f"/region_{name}.npz",
                                            pair_cov=True, phase=True, joint_graph=True)
    if coverage_rows(*region["card"][:2]) != coverage_rows(*region["cpu"][:2]):
        raise AssertionError(f"leg 2: the region of {len(part)} records differs between the card and the CPU copy")
    out["region"] = {"records": len(part), "from_pos": part[0].pos, "to_pos": part[-1].pos,
                     "card_s": region["card"][2], "cpu_s": region["cpu"][2], "cpu_steps_s": region["cpu"][3]}
    del rm_cpu, region
    # the truth
    shares = genotype_shares(annotated, truth, "chr1")
    out["truth"] = shares
    if shares["het_right"] < HET_FLOOR or shares["hom_right"] < HOM_FLOOR:
        raise AssertionError(f"leg 2: genotypes under the floors (het {HET_FLOOR}, hom {HOM_FLOOR}): {shares}")
    # the classifier, trained on the card and on the CPU from one init
    labels = truth_labels(annotated, truth, "chr1")
    init = clf_model.init_params(SEED, [len(clf_model.FEATURES), 32, 32, 1])
    trained = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        clf, train_s = timed(lambda: clf_model.train_classifier(feats, labels, device=where, init=init))
        trained[name] = (clf.predict_proba(feats), train_s)
    (p_card, out["train_s"]), (p_cpu, out["train_cpu_s"]) = trained["card"], trained["cpu"]
    err = float(np.abs(p_card - p_cpu).max())
    clear = np.abs(p_cpu - 0.5) > 1e-3
    if err > TRAIN_TOL or ((p_card >= 0.5) != (p_cpu >= 0.5))[clear].any():
        raise AssertionError(f"leg 2: the classifier trained on the card differs from the CPU copy's by {err} (limit {TRAIN_TOL}), or a decision does")
    called = p_card >= 0.5
    out["classifier"] = {
        "steps": 2000, "records": len(labels), "true_records": int(labels.sum()), "max_abs_err_card_vs_cpu": err,
        "precision": float((called & labels).sum() / max(called.sum(), 1)), "recall": float((called & labels).sum() / max(labels.sum(), 1)),
    }

    def again():
        return cov.run_coverage(vcf_in, tmp + "/again2.vcf", bg, reference, features_out=tmp + "/again2.npz",
                                pair_cov=True, phase=True, joint_graph=True)

    return out, launches, again


# ---------------------------------------------------------------------------
# the create stage (leg 3) and merge
# ---------------------------------------------------------------------------

CREATE_LEG_FILE = os.path.join(DATA, "torch_create_leg.json")
ERROR_RATE = 0.005  # leg 3: uniform substitutions over leg 2's library
ERROR_SEED = SEED + 41
CREATE_ARGS = ["--paired", "--correct"]  # and the defaults: k 23, min k-mer count 2, 8 corrections a read


def corrected_leg_reads(genome, trimmed=None):
    """Leg 3: leg 2's trimmed, paired, diploid library
    (``trimmed_paired_library``, seed SEED + 31) with ERROR_RATE uniform
    substitutions (each base of a read independently, the new base one of
    the other three at random) drawn from ERROR_SEED.  Returns (codes,
    lengths), mates interleaved."""
    codes, lengths, _, _ = trimmed_paired_library(genome, **(trimmed or TRIMMED))
    rng = np.random.default_rng(ERROR_SEED)
    hit = (rng.random(codes.shape) < ERROR_RATE) & (np.arange(codes.shape[1])[None, :] < lengths[:, None])
    codes = codes.copy()
    codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return codes.astype(np.uint8), lengths


def write_fastq(path, codes, lengths):
    """Reads as FASTQ (quality 'I' throughout), read 2i and 2i + 1 mates."""
    text = np.frombuffer(b"ACGT", np.uint8)[codes]
    with open(path, "wb") as f:
        for i, n in enumerate(lengths.tolist()):
            f.write(b"@r%d/%d\n%s\n+\n%s\n" % (i // 2, i % 2 + 1, text[i, :n].tobytes(), b"I" * n))
    return path


def sha256(arr) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def artifact_digests(bgt_dir):
    """sha256 of every field of the .bgt's seqset and readmap as stored."""
    from biograph_tpu_torch.core import container
    from biograph_tpu_torch.convert import READMAP_DTYPES, SEQSET_DTYPES

    out = {}
    for part, fields in (("seqset", SEQSET_DTYPES), ("readmap", READMAP_DTYPES)):
        r = container.ArtifactReader(os.path.join(bgt_dir, part), part, mmap=False)
        out[part] = {name: sha256(r.array(name)) for name in fields}
        if part == "seqset":
            out["n_entries"] = int(r.scalar("n_entries"))
    return out


def create_leg_digests(bgt_dir, kmer_text, n_kmers, filter_stats, codes, lengths, corrections):
    """What the committed file holds of one create of leg 3: the k-mer
    count text, the filter's stats, the corrected reads and every stored
    field."""
    with open(kmer_text, "rb") as f:
        text_sha = sha256(np.frombuffer(f.read(), np.uint8))
    return {
        "kmers": {"distinct": int(n_kmers), "text_sha256": text_sha},
        "filter_stats": {k: int(v) for k, v in sorted(filter_stats.items())},
        "correction": {
            "corrected": int((np.asarray(corrections) > 0).sum()),
            "dropped": int((np.asarray(lengths) == 0).sum()),
            "codes_sha256": sha256(np.asarray(codes, np.uint8)),
            "lengths_sha256": sha256(np.asarray(lengths, np.int32)),
        },
        **artifact_digests(bgt_dir),
    }


def read_create_leg_file(path=CREATE_LEG_FILE):
    with open(path) as f:
        return json.load(f)


CREATE_KERNELS = ("rank_cum",)  # every seqset_from_entries: the builds, create and merge
SCALED_PASSES = 8  # the least passes the scaled leg's partitioned build must take
FULL_COVERAGE = 10  # the whole-genome leg: 100-base reads at 10x over a genome made from the seed
FULL_OVER_BUDGET = 2  # ... sized so the in-memory sort would need twice the detected budget
SAMPLED = 4096  # reads found, reads corrected on a CPU copy, mergemap entries checked
WINDOWS = 64  # coverage windows a migrated readmap is held on


def counted(fn, names=None):
    """(fn(), {kernel: launches in fn()}): the counts set to 0 before."""
    names = names or tuple(WRAPPERS)
    for name in names:
        WRAPPERS[name].launches = 0
    out = fn()
    return out, {name: WRAPPERS[name].launches for name in names}


def own_peak(dev, fn):
    """(fn(), seconds, the device bytes fn() allocated at its peak above
    what was allocated before it; None off the card)."""
    if dev.type != "cuda":
        return (*timed(fn), None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, seconds = timed(fn)
    return out, seconds, torch.cuda.max_memory_allocated() - base


SEQSET_FIELDS = ("fixed", "prev_words", "prev_cum", "entry_sizes", "shared", "pop_sel")


def require_same_seqset(name, got, want):
    if got.n_entries != want.n_entries or got.max_entry_len != want.max_entry_len:
        raise AssertionError(f"{name}: {got.n_entries} entries, want {want.n_entries}")
    for field in SEQSET_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        if not torch.equal(a, b.to(a.device)):
            raise AssertionError(f"{name}: seqset field {field} differs")


def create_partitioned_scaled_phase(dev, codes, lengths, ss):
    """The main path's reads built again under a budget that forces at
    least SCALED_PASSES passes, equal to the main path's in-memory store in
    every field; and the in-memory build alone, whose peak must stay within
    the plan's bytes a row."""
    from biograph_tpu_torch.build import seqset_build as sb
    from biograph_tpu_torch.core.dna import words_for_bases

    rows = 2 * int(lengths.sum())
    W = words_for_bases(codes.shape[1])
    out = {"rows": rows, "plan_row_bytes": sb.suffix_row_bytes(W)}
    (one, launches), out["in_memory_s"], peak = own_peak(dev, lambda: counted(lambda: build_seqset(codes, lengths, device=dev)))
    out["in_memory_peak_bytes"] = peak
    out["in_memory_bytes_per_row"] = None if peak is None else peak / rows
    if peak is not None and peak > rows * out["plan_row_bytes"]:
        raise AssertionError(f"the in-memory build peaked at {peak} bytes, over the plan's {rows * out['plan_row_bytes']}")
    require_same_seqset("in-memory build", one, ss)
    del one
    budget = rows * out["plan_row_bytes"] // (SCALED_PASSES + 2)
    (parted, launches), out["seconds"], out["peak_bytes"] = own_peak(dev, lambda: counted(lambda: build_seqset(codes, lengths, budget=budget, device=dev)))
    plan = parted.build_info["plan"]
    # the passes alone, without the final assembly (seqset_from_entries over
    # every entry), which the plan does not bound
    _, _, out["passes_peak_bytes"] = own_peak(dev, lambda: sb._entries_partitioned(codes, lengths, W, plan, True, dev))
    if out["passes_peak_bytes"] is not None and out["passes_peak_bytes"] > budget + parted.n_entries * (8 * W + 4):
        raise AssertionError(f"the scaled leg's passes peaked at {out['passes_peak_bytes']}, over the budget and the entries")
    out.update(budget=budget, d=plan.d, passes=parted.build_info["passes"], per_pass_rows=plan.per_pass_rows,
               chunk_rows=plan.chunk_rows, rank_cum_launches=launches["rank_cum"])
    if out["passes"] < SCALED_PASSES:
        raise AssertionError(f"the scaled leg's build took {out['passes']} passes, not {SCALED_PASSES} or more")
    require_same_seqset("partitioned build of the scaled leg", parted, ss)
    return out


def full_genome_reads(n_reads, read_len=READ_LEN, coverage=FULL_COVERAGE):
    """(genome, codes, lengths): n_reads reads of read_len bases at
    ``coverage`` over a random genome from seed SEED + 51, the first half
    reverse-complemented."""
    rng = np.random.default_rng(SEED + 51)
    genome = rng.integers(0, 4, n_reads * read_len // coverage, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)]
    half = n_reads // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    return genome, np.ascontiguousarray(codes), np.full(n_reads, read_len, np.int32)


def create_partitioned_full_phase(dev, bytes_per_row, budget=None):
    """The path a whole-genome library takes: a read set whose in-memory
    sort, at the bytes a row measured on the card, would need
    FULL_OVER_BUDGET times the detected budget; built under that budget and
    under half of it, equal in every field, each peak within its budget and
    the output entries; the readmap built and SAMPLED reads found."""
    from biograph_tpu_torch.build import seqset_build as sb
    from biograph_tpu_torch.runtime.resources import MemoryBudget

    budget = budget or MemoryBudget.detect(dev).bytes
    W = (READ_LEN + 15) // 16
    per_read = 2 * READ_LEN * max(bytes_per_row or 0, sb.suffix_row_bytes(W))
    n_reads = -(-FULL_OVER_BUDGET * budget // per_read)
    genome, codes, lengths = full_genome_reads(int(n_reads))
    rows = 2 * int(lengths.sum())
    plan = sb.build_plan(rows, W, READ_LEN, budget)
    if plan.in_memory:
        raise AssertionError("the whole-genome leg fits the plan's in-memory sort")
    out = {"reads": int(n_reads), "genome": len(genome), "rows": rows, "bytes_per_row_measured": bytes_per_row,
           "in_memory_sort_bytes": plan.sort_bytes, "builds": []}
    first = None
    for b in (budget, budget // 2):
        (ss, launches), seconds, peak = own_peak(dev, lambda: counted(lambda: build_seqset(codes, lengths, budget=b, device=dev)))
        entries_bytes = ss.n_entries * (8 * W + 4)
        build = {"budget": b, "passes": ss.build_info["passes"], "d": ss.build_info["plan"].d,
                 "chunk_rows": ss.build_info["plan"].chunk_rows, "build_s": seconds, "peak_bytes": peak,
                 "entries_bytes": entries_bytes, "rank_cum_launches": launches["rank_cum"]}
        out["builds"].append(build)
        if build["passes"] < 2:
            raise AssertionError(f"the whole-genome build under {b} bytes took one pass")
        if peak is not None and peak > b + entries_bytes:
            raise AssertionError(f"the build under {b} bytes peaked at {peak}, over the budget and its entries")
        if first is None:
            first = ss
            out["entries"] = ss.n_entries
            rm, out["readmap_s"] = timed(lambda: build_readmap(ss, codes, lengths, device=dev))
            out["reads_per_s"] = n_reads / (seconds + out["readmap_s"])
            pick = np.sort(np.random.default_rng(SEED + 52).choice(n_reads, SAMPLED, replace=False))
            (found, found_launches) = counted(lambda: ss.d.find(torch.from_numpy(codes[pick]).to(dev), torch.from_numpy(lengths[pick]).to(dev)))
            if not bool((found.valid & (found.size == READ_LEN)).all()):
                raise AssertionError("a sampled read of the whole-genome leg was not found")
            out["found"] = SAMPLED
            out["rank_launches_find"] = found_launches["rank"]
            del rm, found
            ss.__dict__.pop("_entry_cache", None)
        else:
            require_same_seqset("the whole-genome builds under two budgets", ss, first)
        del ss
    del first
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def correction_profile(dev, ks, codes, lengths, rows=1 << 14):
    """One batch of correct_reads (its first ``rows`` reads) with the early
    exit and with every one of its L steps, the latter under
    torch.profiler: kernel launches a step, the device's busy time, and the
    batch's seconds both ways.  None off the card."""
    from torch.profiler import ProfilerActivity, profile

    from biograph_tpu_torch.build import correct as corr

    if dev.type != "cuda":
        return None
    L = codes.shape[1]
    args = (ks, torch.from_numpy(codes[:rows]).to(dev), torch.from_numpy(lengths[:rows]).to(dev), 8, 2, 6)
    corr.correct_batch(*args)
    _, exit_s = timed(lambda: corr.correct_batch(*args))
    saved, corr.SYNC_EVERY = corr.SYNC_EVERY, 1 << 30
    try:
        _, all_s = timed(lambda: corr.correct_batch(*args))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            corr.correct_batch(*args)
            torch.cuda.synchronize()
    finally:
        corr.SYNC_EVERY = saved
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in kernels)
    busy = sum(_device_us(e) for e in kernels) / 1e6
    return {"rows": rows, "steps": L, "launches_all_steps": launches, "launches_a_step": launches / L,
            "device_busy_s_all_steps": busy, "seconds_all_steps": all_s, "seconds_early_exit": exit_s,
            "idle_share_all_steps": max(0.0, 1 - busy / all_s)}


def create_corrected_phase(dev, genome, tmp):
    """Leg 3 through the CLI on the card, cold and warm: ``create --paired
    --correct --device cuda`` on its FASTQ, every stored field held to the
    JAX package's CPU run (``tests/data/torch_create_leg.json``), and the
    k-mer counts, filter and correction create makes, run again here, held
    to it too; the native scan against the numpy parser, count_kmers
    against a CPU copy, correct_reads against a CPU copy on SAMPLED reads.
    Returns (what to print, the cold create's launches, its .bgt, the
    corrected reads it stored)."""
    from biograph_tpu_torch import cli
    from biograph_tpu_torch.build.correct import correct_reads
    from biograph_tpu_torch.io.fastq import read_fastq
    from biograph_tpu_torch.kmers.count import count_kmers
    from biograph_tpu_torch.kmers.kmer_set import KmerSet

    want = read_create_leg_file()
    codes, lengths = corrected_leg_reads(genome)
    fq = write_fastq(os.path.join(tmp, "leg3.fq"), codes, lengths)
    batch, scan_s = timed(lambda: read_fastq(fq))
    numpy_batch, numpy_s = timed(lambda: read_fastq(fq, use_native=False))
    for name in ("codes", "lengths", "quals"):
        if not np.array_equal(getattr(batch, name), getattr(numpy_batch, name)):
            raise AssertionError(f"leg 3: the native scan's {name} differ from the numpy parser's")
    if not (np.array_equal(batch.codes, codes) and np.array_equal(batch.lengths, lengths)):
        raise AssertionError("leg 3: the scanned reads are not the reads written")
    out = {"reads": len(lengths), "scan_s": scan_s, "numpy_scan_s": numpy_s, "runs": {}}
    bgt = None
    for run in ("cold", "warm"):
        path = os.path.join(tmp, f"leg3_{run}.bgt")
        (_, launches), seconds = timed(lambda: counted(lambda: cli.main(["create", "--reads", fq, "--out", path, *CREATE_ARGS, "--device", dev.type])))
        with open(os.path.join(path, "qc", "create_stats.json")) as f:
            stats = json.load(f)
        got = artifact_digests(path)
        for key in ("seqset", "readmap", "n_entries"):
            if got[key] != want[key]:
                raise AssertionError(f"leg 3 ({run}): the card's create differs from the JAX CPU leg's file in {key}")
        out["runs"][run] = {"seconds": seconds, "stages": stats["timings"], "launches": launches}
        if bgt is None:
            bgt, create_launches = path, launches
    out["n_entries"] = want["n_entries"]

    kc, out["kmerize_s"] = timed(lambda: count_kmers(batch.codes, batch.lengths, k=23, device=dev))
    text = os.path.join(tmp, "leg3_kmers.txt")
    kc.write_text(text)
    kstats = {}
    ks = KmerSet.from_counts(kc, min_count=2, stats_out=kstats, device=dev)
    res, out["correct_s"] = timed(lambda: correct_reads(ks, batch.codes, batch.lengths, max_corrections=8, min_good_run=2))
    got = create_leg_digests(bgt, text, len(kc.kmers), kstats, res.codes, res.lengths, res.corrections)
    for key in ("kmers", "filter_stats", "correction"):
        if got[key] != want[key]:
            raise AssertionError(f"leg 3: {key} differ from the JAX CPU leg's file: {got[key]} vs {want[key]}")
    out.update(distinct_kmers=got["kmers"]["distinct"], **{k: got["correction"][k] for k in ("corrected", "dropped")})
    out["correction_batch"] = correction_profile(dev, ks, batch.codes, batch.lengths)

    cpu_kc, out["cpu_kmerize_s"] = timed(lambda: count_kmers(batch.codes, batch.lengths, k=23, device="cpu"))
    for name in ("kmers", "fwd", "rev"):
        if not np.array_equal(getattr(cpu_kc, name), getattr(kc, name)):
            raise AssertionError(f"leg 3: count_kmers on the card differs from a CPU copy in {name}")
    pick = np.sort(np.random.default_rng(SEED + 53).choice(len(lengths), SAMPLED, replace=False))
    cpu_ks = KmerSet(k=ks.k, kmers=ks.kmers.cpu())
    cpu_res, out["cpu_correct_s"] = timed(lambda: correct_reads(cpu_ks, batch.codes[pick], batch.lengths[pick], max_corrections=8, min_good_run=2))
    for name in ("codes", "lengths", "corrections"):
        if not np.array_equal(getattr(cpu_res, name), getattr(res, name)[pick]):
            raise AssertionError(f"leg 3: correct_reads on the card differs from a CPU copy in {name}")
    out["cpu_checked_reads"] = SAMPLED
    keep = res.lengths > 0
    return out, create_launches, bgt, (res.codes[keep], res.lengths[keep])


def merge_checks(dev, ss, rm, codes, lengths, leg3_bgt, leg3_reads, genome):
    """The scaled leg's store merged with leg 3's on the card: equal in
    every field to the store of both read sets built at once; SAMPLED
    entries of each input a prefix of their merged entry; each migrated
    readmap's coverage on WINDOWS windows of the genome equal to its own
    store's.  Returns (what to print, the merge's launches)."""
    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.build.merge import merge_seqsets, migrate_readmap

    leg3 = BioGraph(leg3_bgt, device=dev)
    ((merged, maps), launches), merge_s = timed(lambda: counted(lambda: merge_seqsets([ss, leg3.seqset])))
    out = {"entries": [ss.n_entries, leg3.seqset.n_entries], "merged_entries": merged.n_entries, "merge_s": merge_s}
    moved, out["migrate_s"] = timed(lambda: [migrate_readmap(r, merged, m) for r, m in zip((rm, leg3.readmap), maps)])
    c3, l3 = leg3_reads
    both, out["build_both_s"] = timed(lambda: build_seqset(np.concatenate([codes, c3]), np.concatenate([lengths, l3]), device=dev))
    require_same_seqset("the merged store against the store of both read sets", merged, both)
    del both
    rng = np.random.default_rng(SEED + 54)
    L = merged.max_entry_len
    for src, mm in zip((ss, leg3.seqset), maps):
        ids = torch.from_numpy(rng.choice(src.n_entries, SAMPLED, replace=False)).to(dev)
        mine, theirs = src.d.sequences(ids, L), merged.d.sequences(mm[ids], L)
        size = src.entry_sizes[ids].to(torch.int64)
        within = torch.arange(L, device=dev)[None, :] < size[:, None]
        if not bool(((mine == theirs) | ~within).all() & (merged.entry_sizes[mm[ids]].to(torch.int64) >= size).all()):
            raise AssertionError("a mergemap entry is not a prefix of its merged entry")
    # every migrated readmap entry hangs on a merged entry that begins with
    # its read, as its old entry did
    for own, new in zip((rm, leg3.readmap), moved):
        ids = torch.from_numpy(rng.choice(own.num_entries, SAMPLED, replace=False)).to(dev)
        rl = own.read_lengths[ids].to(torch.int64)
        within = torch.arange(L, device=dev)[None, :] < rl[:, None]
        old_seq = own.seqset.d.sequences(own.entry_of_rm[ids], L)
        # the same (read id, strand) in the migrated readmap
        key_new = new.read_ids * 2 + new.is_forward.to(torch.int64)
        order = torch.argsort(key_new)
        key_old = own.read_ids[ids] * 2 + own.is_forward[ids].to(torch.int64)
        new_pos = order[torch.searchsorted(key_new[order], key_old)]
        if not bool((new.read_lengths[new_pos] == own.read_lengths[ids]).all()):
            raise AssertionError("migration changed a read's length")
        new_seq = merged.d.sequences(new.entry_of_rm[new_pos], L)
        if not bool(((old_seq == new_seq) | ~within).all()):
            raise AssertionError("a migrated read hangs on a merged entry that does not begin with it")
    # coverage: equal on the scaled leg (one read length, every probe range
    # decided by whole entries); on leg 3 a window's probe range can stop
    # being unique once the other sample's entries join, as in the JAX
    # package (ROADMAP §3), so its windows that differ are counted
    starts = rng.integers(0, len(genome) - 150, WINDOWS)
    win = torch.from_numpy(genome[starts[:, None] + np.arange(150)]).to(dev)
    wlen = torch.full((WINDOWS,), 150, dtype=torch.int32, device=dev)
    covered = []
    for name, own, new in (("scaled", rm, moved[0]), ("leg3", leg3.readmap, moved[1])):
        a, b = own.coverage(win, wlen), new.coverage(win, wlen)
        differ = int(((a[0] != b[0]) | (a[1] != b[1])).any(dim=1).sum())
        if name == "scaled" and differ:
            raise AssertionError(f"the migrated {name} readmap's coverage differs from its own store's")
        out[f"{name}_windows_differing"] = differ
        covered.append(int((a[0] + a[1]).sum()))
    out["coverage_reads_summed"] = covered
    return out, launches


# ---------------------------------------------------------------------------
# leg 4: the product's pipeline, with structural variants
# ---------------------------------------------------------------------------

SV_SEED = SEED + 61  # 12406
SV_LIBRARY = dict(
    n_pairs=150_000, n_het=1000, n_hom=1000, n_indel=100,
    hom_dels=30, het_dels=10, big_del=49_000, ins=20, long_ins=4,
)
SV_GAP = 2000  # least bases between two structural variants
SV_CHROM = "chr1"
PIPELINE_LEG_FILE = os.path.join(DATA, "torch_pipeline_sv_leg.json")
PIPELINE_FLAGS = ["--paired", "--correct"]
# the command as the committed file records it; MODEL_FILE is the same file
PIPELINE_ARGS = [*PIPELINE_FLAGS, "--classifier-model", "tests/data/torch_scaled_leg_qual_model.npz"]
PIPELINE_VCFS = ("discovery", "coverage", "grm", "results")
PIPELINE_STAGES = ("create", "discovery", "coverage", "grm", "qual_classifier")
PIPELINE_KERNELS = ("rank_cum", "push4", "rank", "chain_window")
# the kernels each stage of the cold run must call, each call kept held
# against its plain version
PIPELINE_HOLDS = {"create": ("rank_cum",), "discovery": ("push4", "rank", "chain_window"), "coverage": ("rank", "chain_window")}
BWT_QUERIES, BWT_ABSENT = 1 << 16, 4096


def _plain_rank(blocks, b, pos, pos_end=None):
    out = tuple(rank4_ops.rank_blocks_plain(blocks, b, p) for p in ((pos,) if pos_end is None else (pos, pos_end)))
    return out[0] if pos_end is None else out


# kernel: (module, attribute the path calls it by, plain version, positions
# of the stored tables among its arguments, position of the argument whose
# elements are the call's lanes)
PIPELINE_CALL_SITES = {
    "rank_cum": ("biograph_tpu_torch.build.seqset_build", "rank_cum", rank_cum_ops.rank_cum_plain, (), 0),
    "push4": ("biograph_tpu_torch.ops.rank4", "push4", rank4_ops.push4_plain, (0, 1, 2), 3),
    "rank": ("biograph_tpu_torch.ops.rank4", "rank", _plain_rank, (0,), 1),
    "chain_window": ("biograph_tpu_torch.index.probes", "chain_window", rank4_ops.chain_window_plain, (0, 1, 2), 4),
}


def _copy(x):
    """A clone of a tensor, or of each tensor of a tuple; anything else as is."""
    return x.clone() if torch.is_tensor(x) else tuple(_copy(y) for y in x) if isinstance(x, tuple) else x


class _Kept:
    """A kernel's wrapper in place of itself: it calls the wrapper and, for
    each stage of a full_pipeline run, keeps the first call and the call
    over the most lanes, their lanes and outputs cloned, the stored tables
    by reference.  ``launches`` is the wrapper's own, which the wrapper
    counts through this name."""

    def __init__(self, name, real, tables, lanes_at, stage, kept):
        self.name, self.real, self.tables, self.lanes_at, self.stage, self.kept = name, real, tables, lanes_at, stage, kept

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n

    def __call__(self, *args):
        out = self.real(*args)
        calls = self.kept.setdefault((self.stage[0], self.name), {"calls": 0})
        calls["calls"] += 1
        lanes = args[self.lanes_at].numel()
        if "first" not in calls or lanes > calls["widest"][0]:
            call = (lanes, [a if i in self.tables else _copy(a) for i, a in enumerate(args)], _copy(out))
            calls.setdefault("first", call)
            calls["widest"] = call
        return out


@contextlib.contextmanager
def kept_pipeline_calls():
    """While the block runs, each kernel of PIPELINE_CALL_SITES keeps its
    calls by the stage of the full_pipeline run that made them (``_Kept``):
    yields {(stage, kernel): {"calls": n, "first": call, "widest": call}}."""
    from biograph_tpu_torch.runtime import stages as stages_mod

    kept, stage = {}, [None]
    real_run = stages_mod.StageRunner.run

    def run(self, stage_list, *args, **kw):
        def tagged(s):
            def fn(runner):
                stage[0] = s.name
                try:
                    return s.fn(runner)
                finally:
                    stage[0] = None

            return dataclasses.replace(s, fn=fn)

        return real_run(self, [tagged(s) for s in stage_list], *args, **kw)

    saved = []
    try:
        stages_mod.StageRunner.run = run
        for name, (module, attr, _, tables, lanes_at) in PIPELINE_CALL_SITES.items():
            m = importlib.import_module(module)
            saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, _Kept(name, getattr(m, attr), tables, lanes_at, stage, kept))
        yield kept
    finally:
        stages_mod.StageRunner.run = real_run
        for m, attr, fn in saved:
            setattr(m, attr, fn)


def hold_kept_calls(kept):
    """Every kept call against its kernel's plain version on the same
    inputs, and every stage's kernels of PIPELINE_HOLDS reached: {stage:
    {kernel: {calls, first_lanes, widest_lanes}}}."""
    missing = [(s, k) for s, names in PIPELINE_HOLDS.items() for k in names if (s, k) not in kept]
    if missing:
        raise AssertionError(f"pipeline_sv: the cold run's stages never called {missing}")
    out = {}
    for (stage, name), calls in sorted(kept.items(), key=str):
        plain = PIPELINE_CALL_SITES[name][2]
        for which in ("first", "widest"):
            lanes, args, got = calls[which]
            require_equal(f"{name} in the pipeline's {stage} stage, {which} call ({lanes} lanes)", got, plain(*args))
        out.setdefault(stage, {})[name] = {"calls": calls["calls"], "first_lanes": calls["first"][0], "widest_lanes": calls["widest"][0]}
    return out


def leg_genome(genome_len=GENOME):
    """The 2 Mb genome of every leg: the first draw from seed SEED."""
    return np.random.default_rng(SEED).integers(0, 4, genome_len, dtype=np.uint8)


def sv_paired_library(genome, n_pairs, n_het, n_hom, n_indel, hom_dels, het_dels, big_del, ins, long_ins,
                      seed=SV_SEED, read_len=READ_LEN, error_rate=ERROR_RATE, gap=SV_GAP):
    """Leg 4: a paired library of a diploid sample with structural variants.

    Structural variants, at least ``gap`` bases apart and in random order
    along the genome: hom_dels hom deletions of 50-5000 bases (log-uniform),
    het_dels het deletions of 50-1000, one hom deletion of big_del bases
    (none when 0), ins hom novel insertions of 60-300 bases and long_ins of
    1000-2000.  Small variants on a grid of 20 bases, at least 300 bases
    from any structural variant: n_het het and n_hom hom SNPs and n_indel
    het indels of 1-8 bases, half of them insertions.  Each pair comes from
    one haplotype: a fragment of normal length (mean 400, sd 40), read 1
    its first read_len bases, read 2 the reverse complement of its last;
    half the reads trimmed at the 3' end by 1-30 bases; then error_rate
    uniform substitutions.  Returns (codes [2 n_pairs, read_len], lengths,
    truth), mates interleaved; truth["sv"] lists (class, 0-based left,
    svlen) and truth["small"] the small variants as (0-based pos, ref, alt)
    strings in VCF form."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    code = "ACGT"

    def loguniform(lo, hi, n):
        return np.round(np.exp(rng.uniform(np.log(lo), np.log(hi), n))).astype(np.int64)

    events = [("hom_del", int(n), 2) for n in loguniform(50, 5000, hom_dels)]
    events += [("het_del", int(n), int(h)) for n, h in zip(loguniform(50, 1000, het_dels), rng.integers(0, 2, het_dels))]
    events += [("big_del", big_del, 2)] if big_del else []
    events += [("ins", int(n), 2) for n in rng.integers(60, 301, ins)]
    events += [("long_ins", int(n), 2) for n in rng.integers(1000, 2001, long_ins)]
    events = [events[i] for i in rng.permutation(len(events))]
    spans = np.array([n if kind.endswith("del") else 0 for kind, n, _ in events], np.int64)
    margin = 1000
    free = G - 2 * margin - int(spans.sum()) - gap * len(events)
    if free < 0:
        raise ValueError(f"{len(events)} structural variants do not fit {G} bases")
    cuts = np.sort(rng.integers(0, free + 1, len(events)))
    lefts = margin + cuts + gap * np.arange(len(events)) + np.concatenate([[0], np.cumsum(spans)[:-1]])
    sv = []  # (class, left, svlen, haplotype or 2, inserted codes)
    for (kind, n, hap), left in zip(events, lefts.tolist()):
        if kind.endswith("del"):
            sv.append((kind, left, -n, hap, np.zeros(0, np.uint8)))
        else:
            sv.append((kind, left, n, hap, rng.integers(0, 4, n, dtype=np.uint8)))
    # small variants on a grid of 20, away from every structural variant
    grid = np.arange(200, G - 200, 20)
    near = np.zeros(len(grid), bool)
    for _, left, svlen, _, _ in sv:
        near |= (grid >= left - 300) & (grid < left + max(-svlen, 0) + 300)
    slots = rng.choice(grid[~near], n_het + n_hom + n_indel, replace=False)
    het, hom, ind = np.sort(slots[:n_het]), np.sort(slots[n_het : n_het + n_hom]), np.sort(slots[n_het + n_hom :])
    het_alt = ((genome[het] + 1 + rng.integers(0, 3, n_het)) % 4).astype(np.uint8)
    hom_alt = ((genome[hom] + 1 + rng.integers(0, 3, n_hom)) % 4).astype(np.uint8)
    het_hap = rng.integers(0, 2, n_het)
    ind_hap = rng.integers(0, 2, n_indel)
    ind_len = rng.integers(1, 9, n_indel)
    is_ins = np.arange(n_indel) % 2 == 0
    ins_seq = [rng.integers(0, 4, n, dtype=np.uint8) for n in ind_len]
    haps = []
    for h in range(2):
        hap = genome.copy()
        hap[np.concatenate([het[het_hap == h], hom])] = np.concatenate([het_alt[het_hap == h], hom_alt])
        # (0-based position of the first changed base, bases removed, bases added)
        edits = [(int(ind[i]) + 1, 0 if is_ins[i] else int(ind_len[i]), ins_seq[i] if is_ins[i] else np.zeros(0, np.uint8))
                 for i in np.nonzero(ind_hap == h)[0]]
        edits += [(left, max(-svlen, 0), seq) for _, left, svlen, on, seq in sv if on in (h, 2)]
        pieces, prev = [], 0
        for at, removed, added in sorted(edits, key=lambda e: e[0]):
            pieces += [hap[prev:at], added]
            prev = at + removed
        pieces.append(hap[prev:])
        haps.append(np.concatenate(pieces))
    hap_of = rng.integers(0, 2, n_pairs)
    frag = np.clip(np.round(rng.normal(400, 40, n_pairs)), read_len, 700).astype(np.int64)
    codes = np.zeros((2 * n_pairs, read_len), np.uint8)
    for h in range(2):
        sel = np.nonzero(hap_of == h)[0]
        start = rng.integers(0, len(haps[h]) - frag[sel])
        codes[2 * sel] = haps[h][start[:, None] + np.arange(read_len)]
        codes[2 * sel + 1] = (3 - haps[h][(start + frag[sel] - read_len)[:, None] + np.arange(read_len)])[:, ::-1]
    lengths = np.full(2 * n_pairs, read_len, np.int32)
    trimmed = rng.random(2 * n_pairs) < 0.5
    lengths[trimmed] -= rng.integers(1, 31, int(trimmed.sum())).astype(np.int32)
    inside = np.arange(read_len)[None, :] < lengths[:, None]
    hit = (rng.random(codes.shape) < error_rate) & inside
    codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    codes = np.where(inside, codes, 0).astype(np.uint8)
    small = [(int(p), code[genome[p]], code[a]) for p, a in zip(np.concatenate([het, hom]), np.concatenate([het_alt, hom_alt]))]
    for i in range(n_indel):
        p = int(ind[i])
        if is_ins[i]:
            small.append((p, code[genome[p]], code[genome[p]] + "".join(code[c] for c in ins_seq[i])))
        else:
            small.append((p, "".join(code[c] for c in genome[p : p + 1 + int(ind_len[i])]), code[genome[p]]))
    truth = {"sv": [(kind, left, svlen) for kind, left, svlen, _, _ in sv], "small": sorted(small)}
    return codes, lengths, truth


def write_leg_inputs(tmp, genome, codes, lengths, name="leg4"):
    """(FASTQ path, FASTA path): the reads interleaved, the genome as one
    contig SV_CHROM."""
    from biograph_tpu_torch.core import dna

    fa = os.path.join(tmp, name + ".fa")
    with open(fa, "w") as f:
        f.write(f">{SV_CHROM}\n{dna.codes_to_seq(genome)}\n")
    return write_fastq(os.path.join(tmp, name + ".fq"), codes, lengths), fa


def vcf_digest(path, drop_qual=False):
    """(sha256, records) of a VCF's text without its ``##source=`` line;
    with drop_qual the QUAL column of every record is left out too."""
    import hashlib

    h, n = hashlib.sha256(), 0
    with open(path) as f:
        for line in f:
            if line.startswith("##source="):
                continue
            if not line.startswith("#"):
                n += 1
                if drop_qual:
                    cols = line.split("\t")
                    line = "\t".join(cols[:5] + cols[6:])
            h.update(line.encode())
    return h.hexdigest(), n


def pipeline_digests(out_dir):
    """What the committed file holds of one full_pipeline run: each VCF's
    digest and record count (results.vcf without QUAL, which is the phred of
    the classifier's float probabilities) and every feature array's."""
    analysis = os.path.join(out_dir, "analysis")
    out = {}
    for name in PIPELINE_VCFS:
        sha, n = vcf_digest(os.path.join(analysis, name + ".vcf"), drop_qual=name == "results")
        out[name] = {"sha256": sha, "records": n}
    feats = np.load(os.path.join(analysis, "features.npz"))
    out["features"] = {k: {"dtype": str(feats[k].dtype), "shape": list(feats[k].shape), "sha256": sha256(feats[k])} for k in sorted(feats.files)}
    return out


def sv_record_digest(records):
    """sha256 of SV records as text, one (chrom, pos, ref, alt, support,
    pair_support, svlen) line each in the engine's order."""
    import hashlib

    text = "".join(f"{r['chrom']}\t{r['pos']}\t{r['ref']}\t{r['alt']}\t{r['support']}\t{r['pair_support']}\t{r['svlen']}\n" for r in records)
    return hashlib.sha256(text.encode()).hexdigest()


def bwt_digests(sa_sample, occ_words, occ_cum, counts, sentinel_pos):
    """sha256 of the FM-index's stored arrays (occ_words as uint32)."""
    return {
        "sa_sample": sha256(np.asarray(sa_sample, np.int64)),
        "occ_words": sha256(np.asarray(occ_words).view(np.uint32) if np.asarray(occ_words).dtype == np.int32 else np.asarray(occ_words, np.uint32)),
        "occ_cum": sha256(np.asarray(occ_cum, np.int64)),
        "counts": [int(c) for c in counts],
        "sentinel_pos": int(sentinel_pos),
    }


def sv_recall(records, truth, pad=8):
    """Per SV class: (planted, found), found = a record within pad bases of
    the event's left with the same svlen."""
    got = [(int(r.pos), len(r.alt) - len(r.ref)) for r in records if "," not in r.alt]
    out = {}
    for kind, left, svlen in truth["sv"]:
        hit = any(abs(p - left) <= pad and n == svlen for p, n in got)
        planted, found = out.get(kind, (0, 0))
        out[kind] = (planted + 1, found + int(hit))
    return {k: {"planted": v[0], "found": v[1]} for k, v in sorted(out.items())}


def read_pipeline_leg_file(path=PIPELINE_LEG_FILE):
    with open(path) as f:
        return json.load(f)


def stage_seconds(out_dir):
    with open(os.path.join(out_dir, "qc", "timings.json")) as f:
        return json.load(f)


def discovery_stats(out_dir):
    with open(os.path.join(out_dir, "qc", "discovery_stats.json")) as f:
        return json.load(f)


def file_sha(path):
    with open(path, "rb") as f:
        return sha256(np.frombuffer(f.read(), np.uint8))


def qual_of(p):
    """QUAL as ``apply_to_vcf`` writes it for a probability p."""
    return max(round(float(-10 * np.log10(max(1 - p, 1e-10))), 1), 0.0)


def require_qual(name, vcf, want_prob, tol):
    """QUAL and FILTER of each record of a classified VCF, in the file's
    order, against probabilities tol or less from want_prob: QUAL between
    the QUALs of want_prob - tol and want_prob + tol (QUAL grows with p),
    FILTER PASS or lowq as want_prob is at least 0.5, but where tol could
    move it across."""
    records = read_vcf(vcf)
    if len(records) != len(want_prob):
        raise AssertionError(f"{name}: {len(records)} classified records, the JAX CPU leg {len(want_prob)}")
    for i, (r, p) in enumerate(zip(records, want_prob)):
        lo, hi = qual_of(max(p - tol, 0.0)), qual_of(min(p + tol, 1.0))
        if r.qual is None or not lo <= r.qual <= hi:
            raise AssertionError(f"{name}: record {i} ({r.chrom}:{r.pos}) has QUAL {r.qual}; p {p} within {tol} gives {lo}-{hi}")
        if abs(p - 0.5) > tol and r.filter != ("PASS" if p >= 0.5 else "lowq"):
            raise AssertionError(f"{name}: record {i} ({r.chrom}:{r.pos}) has FILTER {r.filter} at p {p}")


def require_manifest(name, out_dir, stages=PIPELINE_STAGES):
    """Each of these stages of the run's manifest done at its first
    attempt: a stage that failed and passed on its retry fails here."""
    with open(os.path.join(out_dir, "run_manifest.json")) as f:
        recs = json.load(f)["stages"]
    bad = {s: (recs.get(s, {}).get("status"), recs.get(s, {}).get("attempts")) for s in stages
           if recs.get(s, {}).get("status") != "done" or recs.get(s, {}).get("attempts") != 1}
    if bad:
        raise AssertionError(f"{name}: stages not done at their first attempt (status, attempts): {bad}")


def require_pipeline(name, out_dir, want):
    """Every stage's artifact, the records by engine and the classifier's
    stage output (results.vcf's QUAL and FILTER) of a full_pipeline run
    against the committed JAX run."""
    got = pipeline_digests(out_dir)
    for stage in want["stages"]:
        if got[stage] != want["stages"][stage]:
            raise AssertionError(f"{name}: {stage} differs from the JAX CPU leg's: {got[stage] if stage != 'features' else '(features)'}")
    stats = discovery_stats(out_dir)
    by_engine = {"wavefront": stats["n_wavefront"], "sv": stats["n_sv"]}
    if by_engine != want["records_by_engine"]:
        raise AssertionError(f"{name}: records by engine {by_engine}, the JAX CPU leg {want['records_by_engine']}")
    require_qual(name, os.path.join(out_dir, "analysis", "results.vcf"), want["classifier_prob"], PROB_TOL)


def pipeline_sv_phase(dev, genome, tmp, library=None, want=None):
    """Leg 4: ``full_pipeline --paired --correct`` with the committed
    classifier through the port's CLI on the card, cold; every stage's
    artifact held to the JAX CPU run's file (the caller holds the cold
    run's launches of PIPELINE_KERNELS).  Then ``--resume``, which must
    run no stage and leave results.vcf as it was, and ``--rerun`` of each
    stage in turn (its warm seconds), each output again equal to the file.
    Returns (what to print, the cold run's launches, the run's dir, the
    FASTA, the truth)."""
    from biograph_tpu_torch import cli

    want = want or read_pipeline_leg_file()
    codes, lengths, truth = sv_paired_library(genome, **(library or SV_LIBRARY))
    fq, fa = write_leg_inputs(tmp, genome, codes, lengths)
    out_dir = os.path.join(tmp, "leg4")
    argv = ["full_pipeline", "--reads", fq, "--ref", fa, "--out", out_dir, *PIPELINE_FLAGS, "--classifier-model", MODEL_FILE, "--device", str(dev)]
    out = {"reads": int(len(lengths))}
    with kept_pipeline_calls() as kept:
        (_, launches), out["cold_s"] = timed(lambda: counted(lambda: cli.main(argv)))
    require_manifest("pipeline_sv cold", out_dir)
    out["cold_stage_s"] = stage_seconds(out_dir)
    require_pipeline("pipeline_sv cold", out_dir, want)
    # the cold run's first and widest call of each kernel in each stage
    # against its plain version on the same inputs
    out["kernel_holds"] = hold_kept_calls(kept)
    del kept
    stats = discovery_stats(out_dir)
    sv = stats["sv"]
    for key in ("unplaced_reads", "split_events", "clip_candidates"):
        if sv[key] != want["sv_engine"][key]:
            raise AssertionError(f"pipeline_sv: the SV pass's {key} {sv[key]}, the JAX CPU leg's {want['sv_engine'][key]}")
    if sv["split_events"] < 1 or sv["breakend_lanes"] < 1:
        raise AssertionError(f"pipeline_sv: the SV pass had {sv['split_events']} split events and {sv['breakend_lanes']} breakend lanes")
    out["sv_pass"] = {**sv, "seconds": stats["stage_s"]["sv"], "share_of_discovery": stats["stage_s"]["sv"] / out["cold_stage_s"]["discovery"]}
    out["discovery_stage_s"] = stats["stage_s"]

    # --resume: nothing runs again, results.vcf stays as it was
    results = os.path.join(out_dir, "analysis", "results.vcf")
    before = (file_sha(results), os.stat(results).st_mtime_ns, json.load(open(os.path.join(out_dir, "run_manifest.json")))["stages"])
    (_, resumed), out["resume_s"] = timed(lambda: counted(lambda: cli.main(argv + ["--resume"])))
    after = (file_sha(results), os.stat(results).st_mtime_ns, json.load(open(os.path.join(out_dir, "run_manifest.json")))["stages"])
    if after != before or any(resumed.values()):
        raise AssertionError("pipeline_sv: --resume ran a stage again or changed results.vcf")
    # --rerun of each stage: its warm seconds, its output the same
    warm = {}
    for stage in PIPELINE_STAGES:
        timed(lambda: cli.main(argv + ["--resume", "--rerun", stage]))
        require_manifest(f"pipeline_sv --rerun {stage}", out_dir)
        warm[stage] = stage_seconds(out_dir)[stage]
        require_pipeline(f"pipeline_sv --rerun {stage}", out_dir, want)
    out["warm_stage_s"] = warm
    out["recall"] = sv_recall(read_vcf(results), truth)
    return out, launches, out_dir, fa


def device_ops(fn):
    """(fn(), device operations it ran: kernels and copies, under
    torch.profiler; None when the profiler sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return fn(), None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return res, (n or None)


def walk_device_ops(seeds, lefts, ek, ec, index, opt, steps):
    """Device operations of the breakend walk on these lanes
    (``_breakend_walk``, the loop alone, without the copies in and out),
    counted under torch.profiler, which makes each operation slow: the walk
    runs its first WALK_SYNC_EVERY steps, then its first two blocks of
    them; one block's count is the difference, the same at every block (the
    steps' tensor code does not depend on the data), and the walk of
    ``steps`` steps is the first block and the rest as blocks, short of its
    last exit check.  A walk of two blocks or fewer is counted whole.
    (first block, a block, the walk) or None off the card."""
    from biograph_tpu_torch.variants import pop_tracer as pt

    dev = index.ref_codes.device
    if dev.type != "cuda":
        return None

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64).copy()).to(dev)

    lanes = (t(seeds), t(lefts), t(ek), t(ec))
    defaults = inspect.signature(pt._assemble_breakends_batch).parameters
    confirm, max_assembly = defaults["confirm"].default, defaults["max_assembly"].default

    def walk(n):
        return device_ops(lambda: pt._breakend_walk(*lanes, index, confirm, n, int(opt.cluster_pad)))[1]

    W = pt.WALK_SYNC_EVERY
    if steps <= 2 * W:
        return {"walk": walk(max_assembly)}
    first, two = walk(W), walk(2 * W)
    if first is None or two is None:
        return None
    return {"first_block": first, "a_block": two - first, "walk": first + (-(-steps // W) - 1) * (two - first)}


def sv_engine_checks(dev, bgt, fa, want):
    """The SV pass of leg 4's store on the card, by its parts: the reads
    from the readmap, the scan's counts, the records of the split events
    alone and of the breakend walks alone (the records by engine), each
    equal to the JAX CPU leg's; every clip cluster's walk on the card equal
    to the host oracle ``_assemble_breakend`` on a CPU copy of the index,
    its steps counted and its device operations counted over two blocks of
    steps (``walk_device_ops``)."""
    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.index.reference import Reference
    from biograph_tpu_torch.variants import pop_tracer as pt
    from biograph_tpu_torch.variants.align import RefKmerIndex

    want = want["sv_engine"]
    bg = BioGraph(bgt, device=dev)
    ref = Reference.from_fasta(fa)
    (codes, lens, mate), read_s = timed(lambda: pt.reads_from_readmap(bg.readmap))
    if len(lens) != want["reads"] or sha256(codes) != want["codes_sha256"]:
        raise AssertionError("sv_engine: the reads from the readmap differ from the JAX CPU leg's")
    opt = pt.SvOptions()
    index, index_s = timed(lambda: RefKmerIndex.build(ref.flat, opt.k, is_n=ref.is_n, device=dev))
    stats = {}
    (pl, raw, clips, ek, ec), scan_s = timed(lambda: pt._sv_scan_reads(index, codes, lens, opt, stats=stats))
    got = {"reads": len(lens), "codes_sha256": want["codes_sha256"], "unplaced_reads": int((pl.pos < 0).sum()),
           "split_events": len(raw), "clip_candidates": len(clips), "edge_keys": len(ek)}
    out = {"read_s": read_s, "index_s": index_s, "scan_s": scan_s}
    for name, events, cands in (("sv_split", raw, []), ("sv_breakend", [], clips)):
        recs, out[name + "_s"] = timed(lambda: pt._sv_finalize(ref, index, events, cands, ek, ec, pl.pos, pl.is_rc, lens, mate, opt))
        got[name] = {"records": len(recs), "sha256": sv_record_digest(recs)}
    if got != {k: want[k] for k in got}:
        raise AssertionError(f"sv_engine: {got} differs from the JAX CPU leg's {want}")
    groups = pt._clip_clusters(clips, index.k, opt)
    walk = {}
    seeds = np.array([g[2] for g in groups], np.int64)
    lefts = np.array([g[0] for g in groups], np.int64)
    card, walk_s = timed(lambda: pt._assemble_breakends_batch(seeds, lefts, ek, ec, index, opt, stats=walk))
    cpu_index = RefKmerIndex.build(ref.flat, opt.k, is_n=ref.is_n, device="cpu")
    t0 = time.perf_counter()
    host = [pt._assemble_breakend(g[3], ek, ec, cpu_index, g[0], opt) for g in groups]
    oracle_s = time.perf_counter() - t0
    for i, (h, c) in enumerate(zip(host, card)):
        if (h is None) != (c is None) or (h is not None and (not np.array_equal(h[0], c[0]) or h[1] != c[1])):
            raise AssertionError(f"sv_engine: the walk of cluster {i} (left {groups[i][0]}) differs from the host oracle")
    out.update(clusters=len(groups), assembled=sum(c is not None for c in card), walk_steps=walk["walk_steps"],
               walk_device_ops=walk_device_ops(seeds, lefts, ek, ec, index, opt, walk["walk_steps"]) if groups else None,
               walk_s=walk_s, oracle_s=oracle_s, longest_insertion=max((len(c[0]) for c in card if c), default=0))
    return out


def bwt_checks(dev, genome, want):
    """The FM-index of the genome on the card: cold and warm builds, equal
    to a CPU copy's and to the JAX CPU leg's digests; find of BWT_QUERIES
    substrings of the genome (20-100 bases) and BWT_ABSENT random 40-mers
    equal to the CPU copy's, every substring found; locate of each found
    range's first row equal to the CPU copy's and spelling the query."""
    from biograph_tpu_torch.index import bwt as bwt_mod

    g = np.random.default_rng(SV_SEED + 1)
    bwt, cold_s = timed(lambda: bwt_mod.RefBwt.build(genome, device=dev))
    _, warm_s = timed(lambda: bwt_mod.RefBwt.build(genome, device=dev))
    cpu, cpu_s = timed(lambda: bwt_mod.RefBwt.build(genome, device="cpu"))

    def digests(b):
        return bwt_digests(b.sa_sample.cpu().numpy(), torch.stack([o.words for o in b.occ]).cpu().numpy(),
                           torch.stack([o.cum for o in b.occ]).cpu().numpy(), b.counts, b.sentinel_pos)

    if digests(bwt) != digests(cpu) or digests(bwt) != want["bwt"]:
        raise AssertionError("bwt: the FM-index on the card differs from its CPU copy or from the JAX CPU leg's digests")
    G = len(genome)
    qlen = g.integers(20, 101, BWT_QUERIES)
    start = g.integers(0, G - 100, BWT_QUERIES)
    q = np.zeros((BWT_QUERIES + BWT_ABSENT, 100), np.uint8)
    q[:BWT_QUERIES] = genome[start[:, None] + np.arange(100)]
    q[:BWT_QUERIES] = np.where(np.arange(100)[None, :] < qlen[:, None], q[:BWT_QUERIES], 0)
    q[BWT_QUERIES:, :40] = g.integers(0, 4, (BWT_ABSENT, 40))
    ql = np.concatenate([qlen, np.full(BWT_ABSENT, 40)]).astype(np.int32)
    (lo, hi), find_s = timed(lambda: bwt.find(q, ql))
    clo, chi = cpu.find(q, ql)
    if not (np.array_equal(lo, clo) and np.array_equal(hi, chi)):
        raise AssertionError("bwt: find on the card differs from the CPU copy")
    if (hi[:BWT_QUERIES] <= lo[:BWT_QUERIES]).any():
        raise AssertionError("bwt: a substring of the genome was not found")
    rows = torch.from_numpy(lo[:BWT_QUERIES].copy())
    pos, locate_s = timed(lambda: bwt_mod._bwt_locate(bwt.d, rows.to(dev)).cpu().numpy())
    if not np.array_equal(pos, bwt_mod._bwt_locate(cpu.d, rows).numpy()):
        raise AssertionError("bwt: locate on the card differs from the CPU copy")
    spelled = genome[np.clip(pos[:, None] + np.arange(100), 0, G - 1)]
    ok = (spelled == q[:BWT_QUERIES]) | (np.arange(100)[None, :] >= qlen[:, None])
    if not ok.all():
        raise AssertionError("bwt: a located position does not spell its query")
    absent = int((hi[BWT_QUERIES:] > lo[BWT_QUERIES:]).sum())
    return {"build_cold_s": cold_s, "build_warm_s": warm_s, "cpu_copy_build_s": cpu_s, "find_s": find_s,
            "locate_s": locate_s, "queries": BWT_QUERIES, "absent_queries": BWT_ABSENT, "absent_found": absent}


def main():
    global PROFILE
    profile_to = None
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile_to = sys.argv[2]
    elif len(sys.argv) != 1:
        sys.exit("usage: python3 chip_smoke.py [--profile OUT.json]")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs only on a GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    say(torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    say(phase="build_kernels", built=built, seconds=time.perf_counter() - t0)

    _, seconds = timed(lambda: edge_checks(dev))
    say(phase="edge_checks", ok=True, seconds=seconds)

    genome, codes, lengths, snp, donor, starts = simulate(GENOME, READS, SNPS, READ_LEN)
    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats, (ss, rm, found, ranked, pushed, text, probed) = main_path(dev, genome, codes, lengths)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    missing = [name for name in MAIN_PATH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")
    if ss.n_entries < 1_000_000:
        raise AssertionError(f"n_entries {ss.n_entries} is below the real-size floor of 1M")
    say(phase="main_path", card=card, **stats)

    checks, seconds = timed(lambda: check_results(dev, genome, codes, ss, found, ranked, pushed, text, probed))
    say(phase="checks", ok=True, seconds=seconds, **checks)

    # variant discovery on the store just built and loaded: the counts of its
    # kernels are set to 0 before each call and read after it
    reference = reference_from_numpy(genome, np.zeros(GENOME, bool), [("chr1", 0, GENOME)])
    records, found_by = discover_phase(ss, reference)
    say(phase="discover", card=card, **found_by)
    rm_cpu = rm.to("cpu")  # one CPU copy of the store and the readmap for every region check
    checks, seconds = timed(lambda: discover_checks(dev, ss, rm_cpu.seqset, reference, genome, records, snp, donor, starts, READ_LEN))
    say(phase="discover_checks", ok=True, seconds=seconds, **checks)
    holds, seconds = timed(lambda: discover_kernel_holds(ss, reference, found_by["anchors_found"]))
    say(phase="discover_kernel_holds", ok=True, max_abs_err=0, seconds=seconds, **holds)
    small, seconds = timed(lambda: small_genome_checks(dev))
    say(phase="small_genome_checks", ok=True, seconds=seconds, **small)

    # discovery with the readmap the main path built and loaded, held to the
    # JAX package's CPU leg (its reference names the contig as bench.py does)
    scored_reference = reference_from_numpy(genome, np.zeros(GENOME, bool), [("chr", 0, GENOME)])
    want = read_records_file()
    _, scored_asms, scored = discover_scored_phase(ss, rm, scored_reference, want, stats["build_s"] + stats["readmap_s"], READS)
    say(phase="discover_scored", card=card, **scored)
    (checked, cov_slab, chain_fixed_launches), seconds = timed(lambda: scored_checks(dev, ss, rm, rm_cpu, reference, scored_asms))
    say(phase="scored_checks", ok=True, max_abs_err=0, seconds=seconds, **checked)

    # the scored call by the dense front end and without the trunc tables,
    # each held to the same records; the widen family and the SDK on the
    # full store, each against its CPU copy
    dense = discover_dense_phase(ss, rm, scored_reference, want)
    say(phase="discover_dense", card=card, **dense)
    no_trunc = discover_no_trunc_phase(ss, rm, scored_reference, want, scored["warm"])
    say(phase="discover_no_trunc", card=card, **no_trunc)
    widened, seconds = timed(lambda: widen_checks(ss, rm_cpu.seqset, found))
    say(phase="widen_checks", ok=True, card=card, seconds=seconds, **widened)
    sdk, seconds = timed(lambda: sdk_checks(dev, ss, rm, codes, genome))
    say(phase="sdk_checks", ok=True, seconds=seconds, **sdk)

    # the coverage stage and the classifier: on the scaled leg (the hash
    # route), held to the JAX CPU leg's files; on a trimmed, paired, diploid
    # library (the general route), held to a CPU copy and to its truth
    tmp = tempfile.TemporaryDirectory()
    cov_scored, cov_scored_launches, again_scored = coverage_scored_phase(dev, ss, rm, scored_reference, genome, want, tmp.name)
    say(phase="coverage_scored", card=card, **cov_scored)
    (cov_trimmed, cov_trimmed_launches, again_trimmed), seconds = timed(lambda: coverage_trimmed_phase(dev, genome, tmp.name))
    say(phase="coverage_trimmed_paired", card=card, seconds=seconds, **cov_trimmed)
    if profile_to is None:
        del again_scored, again_trimmed

    # the create stage: the partitioned build of the main path's reads;
    # leg 3 (what users send) through the CLI, held to the JAX CPU leg's
    # file; the merge of the two stores; a whole-genome library past the
    # card's budget
    parted, seconds = timed(lambda: create_partitioned_scaled_phase(dev, codes, lengths, ss))
    say(phase="create_partitioned_scaled", card=card, **parted)
    (corrected, create_launches, leg3_bgt, leg3_reads), seconds = timed(lambda: create_corrected_phase(dev, genome, tmp.name))
    say(phase="create_corrected", card=card, seconds=seconds, **corrected)
    (merged, merge_launches), seconds = timed(lambda: merge_checks(dev, ss, rm, codes, lengths, leg3_bgt, leg3_reads, genome))
    say(phase="merge_checks", ok=True, card=card, seconds=seconds, **merged)
    full, seconds = timed(lambda: create_partitioned_full_phase(dev, parted["in_memory_bytes_per_row"]))
    say(phase="create_partitioned_full", card=card, seconds=seconds, **full)

    # leg 4: the product's pipeline through the port's CLI, then its SV
    # engine by parts and the FM-index, held to the JAX CPU run's file
    want4 = read_pipeline_leg_file()
    (leg4, pipeline_launches, leg4_dir, leg4_fa), seconds = timed(lambda: pipeline_sv_phase(dev, genome, tmp.name, want=want4))
    missing = [k for k in PIPELINE_KERNELS if pipeline_launches[k] == 0]
    if missing:
        raise AssertionError(f"pipeline_sv: the cold run launched no {missing} kernel")
    say(phase="pipeline_sv", card=card, seconds=seconds, launches={k: pipeline_launches[k] for k in PIPELINE_KERNELS}, **leg4)
    sv_checked, seconds = timed(lambda: sv_engine_checks(dev, os.path.join(leg4_dir, "sample.bgt"), leg4_fa, want4))
    say(phase="sv_engine", ok=True, card=card, seconds=seconds, **sv_checked)
    bwt_checked, seconds = timed(lambda: bwt_checks(dev, genome, want4))
    say(phase="bwt", ok=True, card=card, seconds=seconds, **bwt_checked)

    probe_pos = torch.arange(PROBE_CHUNK, device=dev)
    probe_m = torch.full((PROBE_CHUNK,), DEPTH, dtype=torch.int32, device=dev)
    probe_m_mixed = bisection_lengths(ss.d, text, probe_pos, torch.zeros_like(probe_pos), DEPTH, 3)
    breakdown = profile_to is not None
    launches["chain_fixed"] = chain_fixed_launches
    rows = kernel_table(ss, launches, found, text, probe_pos, probe_m, probe_m_mixed, cov_slab, breakdown)
    for r in rows:
        r["launches_discover"] = found_by["warm"]["launches"][r["name"]]
        r["launches_discover_scored"] = scored["warm"]["launches"][r["name"]]
        r["launches_discover_dense"] = dense["warm"]["launches"][r["name"]]
        r["launches_discover_no_trunc"] = no_trunc["warm"]["launches"][r["name"]]
        r["launches_coverage_scored"] = cov_scored_launches[r["name"]]
        r["launches_coverage_trimmed"] = cov_trimmed_launches[r["name"]]
        r["launches_create"] = create_launches[r["name"]]
        r["launches_merge"] = merge_launches[r["name"]]
        r["launches_pipeline"] = pipeline_launches[r["name"]]
    past_l2, seconds = timed(lambda: rank_past_l2(dev, make_stall(dev), breakdown))
    say(phase="rank_past_l2", card=card, seconds=seconds, **past_l2)
    if profile_to is not None:
        # the main path twice more: once as it is, with the allocator and
        # the kernels warm, and once with each stage under torch.profiler:
        # [kernel name, calls, device ms] for the heaviest kernels, and the
        # share of the warm stage time in which the device sat idle
        del found, ranked, pushed, text, probed
        warm, _ = main_path(dev, genome, codes, lengths)
        PROFILE = {}
        main_path(dev, genome, codes, lengths)
        run_discover(ss, reference, stage="discover")
        PROFILE["discover"].update(
            cold_s=found_by["cold"]["seconds"], warm_s=found_by["warm"]["seconds"],
            stage_s_warm=found_by["warm"]["stage_s"], beam_step=beam_step_profile(ss, reference),
        )
        run_discover(ss, scored_reference, stage="discover_scored", readmap=rm)
        PROFILE["discover_scored"].update(
            cold_s=scored["cold"]["seconds"], warm_s=scored["warm"]["seconds"], stage_s_warm=scored["warm"]["stage_s"],
        )
        for stage, constants, calls in (("discover_dense", {"NO_PRESCREEN": True}, dense),
                                        ("discover_no_trunc", {"BUDGET_BYTES": TINY_BUDGET_BYTES}, no_trunc)):
            with discovery_constants(**constants):
                run_discover(ss, scored_reference, stage=stage, readmap=rm)
            PROFILE[stage].update(cold_s=calls["cold"]["seconds"], warm_s=calls["warm"]["seconds"], stage_s_warm=calls["warm"]["stage_s"])
        # the coverage stage of both legs, the warm call again
        timed(again_scored, "coverage_scored")
        PROFILE["coverage_scored"].update(cold_s=cov_scored["cold"]["seconds"], warm_s=cov_scored["warm"]["seconds"])
        _, warm_trimmed = timed(again_trimmed)
        timed(again_trimmed, "coverage_trimmed")
        PROFILE["coverage_trimmed"].update(cold_s=cov_trimmed["coverage_s"], warm_s=warm_trimmed)
        # the score stage's coverage batch alone, on the warm call's
        # assemblies: host- or device-bound
        opt = disc.DiscoverOptions(**DISCOVER_OPT)
        again = [disc.Assembly(a.chunk_start, a.anchor, a.rejoin, a.seq, a.support) for a in scored_asms]
        _, score_s = timed(lambda: disc.score_assemblies(rm, genome, again, opt))
        timed(lambda: disc.score_assemblies(rm, genome, again, opt), "score")
        PROFILE["score"].update(cold_s=scored["warm"]["stage_s"]["score"], warm_s=score_s, assemblies=len(again))
        for stage, seen in PROFILE.items():
            seen.setdefault("cold_s", stats.get(stage + "_s"))
            seen.setdefault("warm_s", warm.get(stage + "_s"))
            seen["device_idle_share"] = max(0.0, 1 - seen["device_busy_s"] / seen["warm_s"])
        with open(profile_to, "w") as f:
            json.dump({"card": card, "stages": PROFILE}, f, indent=1)
        say(phase="profile", written=profile_to, card=card,
            stages={k: {x: v[x] for x in ("cold_s", "warm_s", "device_busy_s", "device_idle_share", "launches")} for k, v in PROFILE.items()},
            beam_step=PROFILE["discover"]["beam_step"])
        PROFILE = None
    tmp.cleanup()
    say(total_s=time.perf_counter() - t_start)
    print(card, flush=True)
    say(kernels=rows)
    say(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
