"""Pileup SNP caller: placed reads -> per-base counts -> calls (torch).

Counterpart of ``biograph_tpu/variants/pileup.py``: reads are placed on the
reference (``variants/align.py``), every placed base is added to a
``[4, ref_len]`` count matrix with one ``index_add_`` a batch on the
placement index's device, and SNPs are called from the counts in numpy
(per-base depths DP_A..DP_T, QUAL = 3 * alt depth + 27, GT from the allele
fraction).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.index.reference import Reference
from biograph_tpu_torch.io.vcf import VcfRecord, VcfWriter
from biograph_tpu_torch.variants.align import Placements, RefKmerIndex, place_reads


def pileup_counts(
    ref_len: int,
    codes: np.ndarray,
    lengths: np.ndarray,
    pl: Placements,
    batch_rows: int = 1 << 15,
    device="cuda",
) -> np.ndarray:
    """Per-position per-base depths int32 [4, ref_len]: each placed read's
    bases, oriented as placed, added at their reference positions."""
    dev = resolve_device(device)
    counts = torch.zeros(4 * ref_len, dtype=torch.int32, device=dev)
    R, L = codes.shape
    offs = torch.arange(L, dtype=torch.int64, device=dev)
    for lo in range(0, R, batch_rows):
        hi = min(R, lo + batch_rows)
        c = torch.from_numpy(np.ascontiguousarray(codes[lo:hi], np.uint8)).to(dev)
        ln = torch.from_numpy(np.asarray(lengths[lo:hi], np.int32).copy()).to(dev)
        pos = torch.from_numpy(np.asarray(pl.pos[lo:hi], np.int64).copy()).to(dev)
        is_rc = torch.from_numpy(np.asarray(pl.is_rc[lo:hi], bool).copy()).to(dev)
        oriented = torch.where(is_rc[:, None], dna.revcomp_codes(c, ln), c)
        tgt = pos[:, None] + offs[None, :]
        valid = (pos[:, None] >= 0) & (offs[None, :] < ln[:, None]) & (tgt < ref_len)
        flat = oriented.to(torch.int64) * ref_len + tgt
        counts.index_add_(0, flat[valid], torch.ones_like(flat[valid], dtype=torch.int32))
    return counts.reshape(4, ref_len).cpu().numpy()


@dataclass
class PileupCall:
    flat_pos: int  # 0-based flat reference coordinate
    ref_base: int
    alt_base: int
    depth: int
    alt_depth: int
    genotype: str


def call_snps(
    ref_codes: np.ndarray,
    counts: np.ndarray,
    min_depth: int = 8,
    hom_frac: float = 0.8,
    het_frac: float = 0.25,
) -> List[PileupCall]:
    """SNP calls from the pileup matrix: the dominant non-reference base at
    depth >= min_depth; 1/1 at an allele fraction >= hom_frac, 0/1 from
    het_frac up to it."""
    ref_codes = np.asarray(ref_codes, np.int64)
    depth = counts.sum(axis=0)
    G = len(ref_codes)
    nonref = counts.copy()
    nonref[ref_codes, np.arange(G)] = -1
    alt_base = nonref.argmax(axis=0)
    alt_cnt = nonref[alt_base, np.arange(G)]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(depth > 0, alt_cnt / np.maximum(depth, 1), 0.0)
    is_call = (depth >= min_depth) & (alt_cnt > 0) & (frac >= het_frac)
    out: List[PileupCall] = []
    for p in np.nonzero(is_call)[0]:
        gt = "1/1" if frac[p] >= hom_frac else "0/1"
        out.append(
            PileupCall(
                flat_pos=int(p),
                ref_base=int(ref_codes[p]),
                alt_base=int(alt_base[p]),
                depth=int(depth[p]),
                alt_depth=int(alt_cnt[p]),
                genotype=gt,
            )
        )
    return out


def write_pileup_vcf(
    path: str,
    reference: Reference,
    counts: np.ndarray,
    calls: List[PileupCall],
    sample: str = "SAMPLE",
):
    """Pileup VCF: DP/AC/DP_A..DP_T INFO, QUAL = 3 * alt_depth + 27."""
    headers = [
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Total Depth">',
        '##INFO=<ID=AC,Number=.,Type=Integer,Description="allele count in genotypes">',
        '##INFO=<ID=DP_A,Number=1,Type=Integer,Description="depth of A basecalls at position">',
        '##INFO=<ID=DP_C,Number=1,Type=Integer,Description="depth of C basecalls at position">',
        '##INFO=<ID=DP_G,Number=1,Type=Integer,Description="depth of G basecalls at position">',
        '##INFO=<ID=DP_T,Number=1,Type=Integer,Description="depth of T basecalls at position">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">',
    ]
    with VcfWriter(
        path,
        sample=sample,
        contigs=[(c.name, c.length) for c in reference.contigs],
        extra_headers=headers,
    ) as w:
        for call in calls:
            contig = None
            for c in reference.contigs:
                if c.start <= call.flat_pos < c.start + c.length:
                    contig = c
                    break
            if contig is None:
                continue
            cnt = counts[:, call.flat_pos]
            rec = VcfRecord(
                chrom=contig.name,
                pos=call.flat_pos - contig.start + 1,
                ref="ACGT"[call.ref_base],
                alt="ACGT"[call.alt_base],
                qual=3 * call.alt_depth + 27,
                info={
                    "DP": call.depth,
                    "AC": call.alt_depth,
                    "DP_A": int(cnt[0]),
                    "DP_T": int(cnt[3]),
                    "DP_G": int(cnt[2]),
                    "DP_C": int(cnt[1]),
                },
                fmt={"GT": call.genotype, "DP": call.alt_depth},
            )
            w.write(rec)


def run_pileup_pipeline(
    reference: Reference,
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int = 13,
    min_depth: int = 8,
    max_mismatches: int = 5,
    device="cuda",
):
    """reads + reference -> (placements, counts, calls), on ``device``."""
    dev = resolve_device(device)
    index = RefKmerIndex.build(reference.flat, k, reference.is_n, device=dev)
    pl = place_reads(index, codes, lengths, max_mismatches=max_mismatches)
    counts = pileup_counts(reference.total_bases, codes, lengths, pl, device=dev)
    calls = call_snps(reference.flat, counts, min_depth=min_depth)
    return pl, counts, calls
