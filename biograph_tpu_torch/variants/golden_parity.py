"""Golden-parity preset: reproduce golden/final.vcf as closely as the
shipped tree allows (torch).

Counterpart of ``biograph_tpu/variants/golden_parity.py``, kept as it is.
The golden file is the 2012 Spiral pipeline's output; its record set and
per-record DP come from a self-contained procedure:

1. place reads by fewest mismatches with exhaustive 13-mer seeding
   (``variants/align.py``);
2. iterate the classic realignment rule: a read is admitted iff at most
   one of its mismatches lies outside the current call set, and a site is
   called iff its admitted alt basecall depth is at least 35.  The loop
   stops when the call set repeats or after ``max_iter`` rounds; the last
   round's counts then belong to the round before its call set, as in the
   JAX package;
3. write the calls in the golden format: QUAL = 3*DP + 27, DP = AC = alt
   basecalls, per-base DP_A/DP_T/DP_G/DP_C, GT 1/1, KNOWN=unknown.

Placement and the pileup run on ``device``; the fixpoint is host code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np

from biograph_tpu_torch import resolve_device


@dataclass
class GoldenCall:
    chrom: str
    pos: int  # 1-based contig coordinate
    ref: str
    alt: str
    depth: int  # alt basecalls (golden DP == AC)
    counts: np.ndarray  # int32 [4] per-base basecalls at the site


def golden_parity_calls(
    reference,
    codes: np.ndarray,
    lengths: np.ndarray,
    quals: np.ndarray | None = None,
    min_alt_depth: int = 35,
    max_err_mismatches: int = 1,
    max_iter: int = 8,
    device="cuda",
) -> List[GoldenCall]:
    """The fixpoint caller of the module docstring."""
    from biograph_tpu_torch.variants.align import RefKmerIndex, place_reads
    from biograph_tpu_torch.variants.pileup import pileup_counts

    dev = resolve_device(device)
    flat = np.asarray(reference.flat)
    idx = RefKmerIndex.build(reference.flat, 13, reference.is_n, device=dev)
    pl = place_reads(idx, codes, lengths, max_mismatches=8, seeds_per_read=23, max_hits_per_seed=32)
    pos = np.asarray(pl.pos)
    isrc = np.asarray(pl.is_rc)
    lengths = np.asarray(lengths)
    R = len(lengths)
    mmflat = [None] * R
    for r in range(R):
        p = pos[r]
        if p < 0:
            continue
        L = lengths[r]
        c = codes[r, :L]
        if isrc[r]:
            c = (3 - c)[::-1]
        mmflat[r] = p + np.nonzero(c != flat[p : p + L])[0]

    ridx = np.arange(len(flat))
    called: set = set()
    counts = None
    for _ in range(max_iter):
        if called:
            keep = np.array(
                [pos[r] >= 0 and sum(1 for j in mmflat[r] if j not in called) <= max_err_mismatches for r in range(R)]
            )
        else:
            keep = pos >= 0
        pl2 = dataclasses.replace(pl, pos=np.where(keep, pos, -1))
        counts = pileup_counts(len(flat), codes, lengths, pl2, device=dev)
        nonref = counts.copy()
        nonref[flat, ridx] = -1
        ab = nonref.argmax(axis=0)
        ac = nonref[ab, ridx]
        newcalled = set(int(s) for s in np.nonzero(ac >= min_alt_depth)[0])
        if newcalled == called:
            break
        called = newcalled

    nonref = counts.copy()
    nonref[flat, ridx] = -1
    ab = nonref.argmax(axis=0)
    out: List[GoldenCall] = []
    for s in sorted(called):
        contig = next(c for c in reference.contigs if c.start <= s < c.start + c.length)
        out.append(
            GoldenCall(
                chrom=contig.name,
                pos=s - contig.start + 1,
                ref="ACGT"[flat[s]],
                alt="ACGT"[ab[s]],
                depth=int(nonref[ab[s], s]),
                counts=counts[:, s].copy(),
            )
        )
    return out


GOLDEN_HEADER = """##fileformat=VCFv4.0
##source=biograph_tpu_torch golden-parity (2012 Spiral v1.0 format)
##INFO=<ID=DP,Number=1,Type=Integer,Description="Total Depth">
##INFO=<ID=AC,Number=.,Type=Integer,Description="allele count in genotypes for each ALT allele in the same order as listed">
##INFO=<ID=DP_A,Number=1,Type=Integer,Description="depth of A basecalls at position">
##INFO=<ID=DP_C,Number=1,Type=Integer,Description="depth of C basecalls at position">
##INFO=<ID=DP_G,Number=1,Type=Integer,Description="depth of G basecalls at position">
##INFO=<ID=DP_T,Number=1,Type=Integer,Description="depth of T basecalls at position">
##INFO=<ID=KNOWN,Number=1,Type=String,Description="whether the variation is known or allele unknown or variation unknown">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE
"""


def write_golden_parity_vcf(path: str, calls: List[GoldenCall]):
    """final.vcf-formatted output: QUAL = 3*DP + 27, the INFO field order
    and FORMAT of the golden file (golden/final.vcf:23)."""
    with open(path, "w") as f:
        f.write(GOLDEN_HEADER)
        for c in calls:
            qual = 3 * c.depth + 27
            info = (
                f"DP={c.depth};AC={c.depth};DP_A={int(c.counts[0])};"
                f"DP_T={int(c.counts[3])};DP_G={int(c.counts[2])};"
                f"DP_C={int(c.counts[1])};KNOWN=unknown"
            )
            f.write(f"{c.chrom}\t{c.pos}\t.\t{c.ref}\t{c.alt}\t{qual}\tPASS\t{info}\tGT:DP\t1/1:{c.depth}\n")
