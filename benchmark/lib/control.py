"""The discovery cells' controls: the plain reference put in the
program's place, each with one guarantee of the configuration broken.

- ``raw_form``: every variant the reference finds due, and the open ones
  it supports, with the reference's support, in the generator's own VCF
  form instead of the left-normalized one: an indel that a repeat lets
  move is reported where it was planted.
- ``overlap_depth``: the same variants, left-normalized, with a support
  that counts every read of a haplotype carrying the bubble over it,
  whether or not the read also holds another variant: the depth without
  the exact match of the alt path."""

from __future__ import annotations

from benchmark.lib import reference


def raw_form(genome, truth, expected: reference.Expected, min_alt_support: int, contig: str = "chr1") -> list:
    out = []
    for p, r, a, _ in truth["small"]:
        v = reference.left_normalize(genome, p, r, a)
        if v in expected.due or (v in expected.open_variants and expected.support.get(v, 0) >= min_alt_support):
            out.append({"chrom": contig, "pos": p + 1, "ref": r, "alt": a, "support": expected.support[v], "ref_support": 0})
    return out


def overlap_depth(genome, truth, expected: reference.Expected, overlap: reference.Expected, min_alt_support: int,
                  contig: str = "chr1") -> list:
    """``overlap``: ``reference.expected_calls(..., exact=False)``."""
    out = []
    for v in sorted(expected.due | {v for v in expected.open_variants if expected.support.get(v, 0) >= min_alt_support}):
        out.append({"chrom": contig, "pos": v[0] + 1, "ref": v[1], "alt": v[2], "support": overlap.support[v], "ref_support": 0})
    return out
