"""Read-backed phasing of het variants (torch).

Counterpart of ``biograph_tpu/variants/phase.py``.  Consecutive het
variants close enough for one read to span both are tested for linkage by
pushing the four haplotype combinations (alt+alt, alt+ref, ref+alt, ref+ref)
through ``Readmap.coverage_events`` in one batch; cis or trans evidence joins
them into phase blocks, ambiguity or missing evidence splits them.  Output:
'|'-phased GT strings and PS (phase-set) tags, PS being the position of the
block's first variant.  The events are counted on the readmap's device and
copied to the host once a batch; the rest is numpy.  While a profiler
runs, ``phase_records`` is the span ``coverage.phase``, counting the het
records it links (``het``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.vcf import VcfRecord
from biograph_tpu_torch.runtime import log as _log
from biograph_tpu_torch.variants.coverage_tool import _padded


@dataclass
class PhaseResult:
    gt: List[str]  # phased ('0|1') where linked, the input GT otherwise
    ps: List[Optional[int]]  # phase set of each record (None = unphased)
    n_blocks: int = 0
    n_linked: int = 0


def _is_het(gt: str) -> bool:
    g = gt.replace("|", "/")
    return g in ("0/1", "1/0")


def phase_records(
    readmap,
    reference,
    records: List[VcfRecord],
    gt: List[str],
    min_link: int = 2,
    batch: int = 64,
) -> PhaseResult:
    """Phase het variants by single-read linkage.

    gt: the unphased genotype of each record (from annotate_coverage).  Only
    plain ACGT single-alt records take part; multi-allelic and symbolic ones
    stay unphased."""
    with _log.span("coverage.phase") as sp:
        out = _phase(readmap, reference, records, gt, min_link, batch)
        sp.set(het=out.n_linked)
    return out


def _phase(readmap, reference, records: List[VcfRecord], gt: List[str], min_link: int, batch: int) -> PhaseResult:
    """``phase_records``."""
    N = len(records)
    out_gt = list(gt)
    out_ps: List[Optional[int]] = [None] * N
    if N == 0 or readmap is None:
        return PhaseResult(out_gt, out_ps)
    C = int(readmap.max_read_len) + 2
    max_span = int(readmap.max_read_len)
    ref_flat = np.asarray(reference.flat)

    # candidate links: consecutive het pairs on one contig within a read span
    hets = [
        i
        for i in range(N)
        if _is_het(gt[i])
        and "," not in records[i].alt
        and all(c in "ACGTacgt" for c in records[i].ref + records[i].alt)
    ]
    pairs = []
    for a, b in zip(hets, hets[1:]):
        ra, rb = records[a], records[b]
        if ra.chrom != rb.chrom:
            continue
        span = (rb.pos + len(rb.ref)) - ra.pos
        if 0 < span <= max_span and rb.pos > ra.pos + len(ra.ref) - 1:
            pairs.append((a, b))
    if not pairs:
        return PhaseResult(out_gt, out_ps)

    # four haplotype windows a pair; a link is a read spanning BOTH variant
    # sites whole (start and end events, not the coverage min, which also
    # counts reads that reach one side only)
    link_cis = {}
    for lo0 in range(0, len(pairs), batch):
        chunk = pairs[lo0 : lo0 + batch]
        queries, spans = [], []
        for a, b in chunk:
            ra, rb = records[a], records[b]
            contig = reference.contig_by_name(ra.chrom)
            p1 = contig.start + ra.pos - 1
            p2 = contig.start + rb.pos - 1
            left = ref_flat[max(p1 - C, 0) : p1]
            mid = ref_flat[p1 + len(ra.ref) : p2]
            right = ref_flat[p2 + len(rb.ref) : p2 + len(rb.ref) + C]
            for a1 in (ra.alt, ra.ref):
                for a2 in (rb.alt, rb.ref):
                    queries.append(np.concatenate([left, dna.seq_to_codes(a1), mid, dna.seq_to_codes(a2), right]))
                    # span = [first base of allele 1, last base of allele 2]
                    sa = len(left)
                    sb = len(left) + len(a1) + len(mid) + len(a2) - 1
                    spans.append((sa, sb))
        qc, ql = _padded(queries)
        starts, ends = readmap.coverage_events(qc, ql)
        starts = np.cumsum(starts.cpu().numpy(), axis=1)
        ends = np.cumsum(ends.cpu().numpy(), axis=1)
        for i, (a, b) in enumerate(chunk):
            s = []
            for k in range(4):  # AA, AR, RA, RR
                row = 4 * i + k
                sa, sb = spans[row]
                # reads with start <= sa and end >= sb
                started = int(starts[row, sa])
                ended_before = int(ends[row, sb - 1]) if sb > 0 else 0
                s.append(max(started - ended_before, 0))
            cis = min(s[0], s[3])
            trans = min(s[1], s[2])
            if cis >= min_link and trans == 0:
                link_cis[(a, b)] = True
            elif trans >= min_link and cis == 0:
                link_cis[(a, b)] = False
            # otherwise a conflict or no evidence: the block splits

    # join links into blocks; orientation = parity of trans links from the head
    n_blocks = n_linked = 0
    i = 0
    while i < len(hets):
        j = i
        block = [hets[i]]
        flips = [False]
        while j + 1 < len(hets) and (hets[j], hets[j + 1]) in link_cis:
            nxt = hets[j + 1]
            flips.append(flips[-1] ^ (not link_cis[(hets[j], nxt)]))
            block.append(nxt)
            j += 1
        if len(block) > 1:
            ps = records[block[0]].pos
            n_blocks += 1
            for idx, flip in zip(block, flips):
                out_gt[idx] = "1|0" if flip else "0|1"
                out_ps[idx] = ps
                n_linked += 1
        i = j + 1
    return PhaseResult(out_gt, out_ps, n_blocks=n_blocks, n_linked=n_linked)
