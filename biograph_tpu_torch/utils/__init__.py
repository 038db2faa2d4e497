"""SDK helpers (torch).

Counterpart of ``biograph_tpu/utils/__init__.py``: region- and
breakpoint-scoped variant discovery, an ASCII view of a region and the
Bayesian genotyper over depths, each the one-liner a user of the SDK
reaches for.  The discovery and the coverage run where the sample's store
lies.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class RegionResult:
    """Variants and per-base reference coverage of a region."""

    chrom: str
    start: int  # 0-based
    end: int
    variants: List[dict] = field(default_factory=list)
    coverage: np.ndarray = None  # int32 [end - start]


def find_region_variants(bg, ref, contig: str, start: int, end: int, min_support: int = 5) -> RegionResult:
    """Every variant in [start, end) of ``contig`` with at least min_support
    reads, and the reference's read coverage there."""
    from biograph_tpu_torch.variants.discover import DiscoverOptions, discover_variants

    c = ref.contig_by_name(contig)
    if not (0 <= start < end <= c.length):
        raise ValueError(f"bad region {contig}:{start}-{end}")
    opt = DiscoverOptions(min_alt_support=min_support)
    recs = discover_variants(bg.seqset, ref, region=(c.start + start, c.start + end), opt=opt, readmap=bg.readmap)
    recs = [r for r in recs if r["support"] >= min_support]
    cov = None
    if bg.readmap is not None:
        cov = bg.seq_coverage(np.asarray(ref.flat[c.start + start : c.start + end]))
    return RegionResult(chrom=contig, start=start, end=end, variants=recs, coverage=cov)


def find_breakpoint_variants(bg, ref, contig: str, start: int, end: int, buf_len: int = 300, min_support: int = 3) -> RegionResult:
    """Targeted discovery around approximate breakpoints: events whose ends
    land within buf_len of ``start`` and ``end``, from the split/pair SV
    engine, so a large deletion between distant breakpoints is found
    without assembling the span.  Runs where the sample's readmap lies."""
    from biograph_tpu_torch.variants.pop_tracer import SvOptions, discover_structural

    if start >= end:
        raise ValueError("start must be < end")
    ref.contig_by_name(contig)
    if bg.readmap is None:
        raise ValueError("breakpoint search needs a readmap")
    codes, lens, mate = bg.readmap.forward_reads()
    recs = discover_structural(ref, codes, lens, mate_of=mate, opt=SvOptions(min_sv_reads=min_support), device=bg.readmap.device)
    lo, hi = start - buf_len, end + buf_len
    out = []
    for r in recs:
        if r["chrom"] != contig:
            continue
        p0 = r["pos"] - 1
        p1 = p0 + len(r["ref"])
        if abs(p0 - start) <= buf_len and abs(p1 - end) <= buf_len:
            out.append(r)
        elif lo <= p0 and p1 <= hi and abs(r.get("svlen", 0)) >= 50:
            out.append(r)
    return RegionResult(chrom=contig, start=start, end=end, variants=out)


def visualize(bg, ref, contig: str, start: int, end: int, width: int = 80) -> str:
    """ASCII view of a region: the reference, per-base coverage as log2
    digits, and variant marks (X substitution, I insertion, D deletion)."""
    from biograph_tpu_torch.core import dna

    c = ref.contig_by_name(contig)
    seq = np.asarray(ref.flat[c.start + start : c.start + end])
    cov = bg.seq_coverage(seq) if bg.readmap is not None else np.zeros(len(seq), np.int32)
    res = find_region_variants(bg, ref, contig, start, end)
    marks = [" "] * len(seq)
    for v in res.variants:
        p = v["pos"] - 1 - start
        if 0 <= p < len(seq):
            marks[p] = "X" if len(v["ref"]) == len(v["alt"]) else ("D" if len(v["ref"]) > len(v["alt"]) else "I")
    lines = []
    text = dna.codes_to_seq(seq)
    for off in range(0, len(seq), width):
        hi = min(off + width, len(seq))
        lines.append(f"{contig}:{start+off}")
        lines.append(text[off:hi])
        lines.append("".join(str(min(int(np.log2(max(int(x), 1))), 9)) for x in cov[off:hi]))
        lines.append("".join(marks[off:hi]))
    return "\n".join(lines)


def genotyper(total_depth, alt_depth):
    """Bayesian genotyper over depths: (gt, gq) per element, gt in
    {"0/0", "0/1", "1/1"}, gq the phred-scaled gap to the runner-up."""
    from biograph_tpu_torch.variants.coverage_tool import genotyper_log10

    n = np.atleast_1d(np.asarray(total_depth, np.int64))
    a = np.atleast_1d(np.asarray(alt_depth, np.int64))
    gl = genotyper_log10(np.maximum(n, 1), a)
    order = np.argsort(-gl, axis=1)
    best = order[:, 0]
    gq = np.round(10 * (gl[np.arange(len(n)), best] - gl[np.arange(len(n)), order[:, 1]]))
    names = np.asarray(["0/0", "0/1", "1/1"])
    gts = names[best]
    if np.isscalar(total_depth) or np.ndim(total_depth) == 0:
        return str(gts[0]), int(gq[0])
    return gts, gq.astype(np.int64)
