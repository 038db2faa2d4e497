"""Export aligned reads over VCF regions as SAM/BAM.

Counterpart of ``biograph_tpu/tools/export_aligned.py`` (the reference's
export_aligned tool, python/biograph/tools/export_aligned.py: coverage over
an input VCF, the aligned reads out as BAM).  Reads are rebuilt from the
readmap (``Readmap.forward_reads``, on the store's device), placed
on the reference by ``variants/align.place_reads`` (k-mer seeds of 13, every
candidate verified by packed XOR/popcount) on ``device``, restricted to
windows around the VCF's variants, and written through ``io/bamwrite``
(SAM text or BGZF BAM).  The records, and so the SAM text and the BAM
bytes, equal the JAX tool's on the same store and reference.

Placement is whole-read with a mismatch count (CIGAR ``<len>M``, NM tag)
rather than the reference's per-assembly realignment: the reads,
positions, strands and pairing are the evidence the coverage annotator
consumes.
"""

from __future__ import annotations

from typing import List

import numpy as np

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.bamwrite import SamRecord, write_bam, write_sam

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
SEED_K = 13


def _variant_windows(reference, vcf_path: str, window: int) -> List[tuple]:
    """Flat [lo, hi) windows around the VCF's records, sorted and merged."""
    from biograph_tpu_torch.io.vcf import read_vcf

    iv = []
    for r in read_vcf(vcf_path):
        c = reference.contig_by_name(r.chrom.split(":")[0])
        flat = c.start + r.pos - 1
        iv.append((max(flat - window, 0), flat + len(r.ref) + window))
    iv.sort()
    merged: List[tuple] = []
    for lo, hi in iv:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def export_aligned(
    bg,
    reference,
    out_path: str,
    vcf_path: str | None = None,
    window: int = 400,
    max_mismatches: int = 5,
    include_unplaced: bool = False,
    device="cuda",
) -> int:
    """Place the biograph's reads; write those covering the VCF's variant
    windows (or all placed reads without a VCF) to ``out_path`` (``.bam``
    for BAM, else SAM).  Returns the number of records written."""
    from biograph_tpu_torch.variants.align import RefKmerIndex, place_reads

    dev = resolve_device(device)
    codes, lengths, mate_of = bg.readmap.forward_reads()
    index = RefKmerIndex.build(reference.flat, SEED_K, reference.is_n, device=dev)
    pl = place_reads(index, codes, lengths, max_mismatches=max_mismatches)

    keep = pl.pos >= 0 if not include_unplaced else np.ones(len(pl.pos), bool)
    if vcf_path:
        merged = _variant_windows(reference, vcf_path, window)
        if merged:
            los = np.array([m[0] for m in merged])
            his = np.array([m[1] for m in merged])
            starts = pl.pos
            ends = pl.pos + lengths
            j = np.clip(np.searchsorted(los, ends, side="right") - 1, 0, len(los) - 1)
            keep &= (starts < his[j]) & (ends > los[j])
        else:
            keep &= False

    order = np.argsort(np.where(pl.pos >= 0, pl.pos, np.iinfo(np.int64).max), kind="stable")
    refs = [(c.name, int(c.length)) for c in reference.contigs]

    def contig_of(flat):
        for c in reference.contigs:
            if c.start <= flat < c.start + c.length:
                return c
        return None

    def records():
        for i in map(int, order):
            if not keep[i]:
                continue
            ln = int(lengths[i])
            placed = pl.pos[i] >= 0
            flag = 0
            rname, pos1 = "*", 0
            if placed:
                c = contig_of(int(pl.pos[i]))
                if c is None:
                    continue
                rname, pos1 = c.name, int(pl.pos[i]) - c.start + 1
                if pl.is_rc[i]:
                    flag |= FLAG_REVERSE
            else:
                flag |= FLAG_UNMAPPED
            seq_codes = codes[i, :ln]
            if placed and pl.is_rc[i]:
                # stored in reference orientation, as BAM does
                seq_codes = (3 - seq_codes[::-1]).astype(np.uint8)
            rnext, pnext, tlen = "*", 0, 0
            m = int(mate_of[i])  # an unpaired read's mate is itself
            if m != i:
                flag |= FLAG_PAIRED | (FLAG_READ1 if i < m else FLAG_READ2)
                if pl.pos[m] >= 0:
                    cm = contig_of(int(pl.pos[m]))
                    if cm is not None:
                        rnext = "=" if (placed and cm.name == rname) else cm.name
                        pnext = int(pl.pos[m]) - cm.start + 1
                        if pl.is_rc[m]:
                            flag |= FLAG_MATE_REVERSE
                        if rnext == "=" and placed:
                            lo = min(int(pl.pos[i]), int(pl.pos[m]))
                            hi = max(int(pl.pos[i]) + ln, int(pl.pos[m]) + int(lengths[m]))
                            tlen = (hi - lo) if int(pl.pos[i]) <= int(pl.pos[m]) else -(hi - lo)
                else:
                    flag |= FLAG_MATE_UNMAPPED
            tags = {}
            if placed:
                tags["NM"] = int(pl.mismatches[i])
            yield SamRecord(
                qname=f"read{i}",
                flag=flag,
                rname=rname,
                pos=pos1,
                mapq=60 if placed else 0,
                cigar=[(ln, "M")] if placed else [],
                rnext=rnext,
                pnext=pnext,
                tlen=tlen,
                seq=dna.codes_to_seq(seq_codes),
                tags=tags,
            )

    if out_path.endswith(".bam"):
        return write_bam(out_path, refs, records())
    return write_sam(out_path, refs, records())
