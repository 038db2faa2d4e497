"""Squareoff: joint re-genotyping of a union call set across samples.

Copy of ``biograph_tpu/tools/squareoff.py``; each sample's coverage runs
where its readmap lies.

Counterpart of the reference's squareoff orchestration
(python/biograph/tools/bgbinary_cmds.py squareoff + gt_classifier
re-genotyping): take every variant called in ANY sample, evaluate coverage
evidence for it in EVERY sample's readmap, and emit one multi-sample VCF
where each sample gets its own GT/AD/DP — absent evidence becomes an
explicit 0/0 or ./. instead of a missing row.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from biograph_tpu_torch.io.vcf import VcfRecord, VcfWriter, read_vcf


def union_records(vcf_paths: List[str]) -> List[VcfRecord]:
    """Distinct (chrom,pos,ref,alt) across input VCFs, sorted."""
    seen: Dict[Tuple, VcfRecord] = {}
    for p in vcf_paths:
        for rec in read_vcf(p):
            key = (rec.chrom, rec.pos, rec.ref, rec.alt)
            if key not in seen:
                seen[key] = VcfRecord(
                    chrom=rec.chrom, pos=rec.pos, ref=rec.ref, alt=rec.alt
                )
    return sorted(seen.values(), key=lambda r: (r.chrom, r.pos, r.ref, r.alt))


def squareoff(
    vcf_paths: List[str],
    biographs: List,
    reference,
    vcf_out: str,
    sample_names: List[str],
):
    """Union + per-sample coverage genotyping -> multi-sample VCF."""
    from biograph_tpu_torch.variants.coverage_tool import annotate_coverage

    records = union_records(vcf_paths)
    anns = [
        annotate_coverage(bg.readmap, reference, records) for bg in biographs
    ]
    headers = [
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    ]
    with VcfWriter(
        vcf_out,
        sample=sample_names,
        contigs=[(c.name, c.length) for c in reference.contigs],
        extra_headers=headers,
    ) as w:
        for i, rec in enumerate(records):
            fmts = []
            for ann in anns:
                dp = int(ann.alt_depth[i] + ann.ref_depth[i])
                fmts.append(
                    {
                        "GT": ann.gt[i],
                        "GQ": int(ann.gq[i]),
                        "AD": ann.ad[i],
                        "DP": dp,
                    }
                )
            rec.fmt = fmts
            w.write(rec)
    return records
