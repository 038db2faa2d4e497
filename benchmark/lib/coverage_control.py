"""The coverage cell's controls: the plain reference put in the program's
place, each with one guarantee of the configuration broken.

- ``overlap_depth``: allele depths from every read that lies on a query by
  its first bases, whatever its other bases: the depth without the exact
  match of the allele's window.
- ``swapped_priors``: the genotyper's het and hom alt shares swapped."""

from __future__ import annotations

from benchmark.lib import coverage_reference


def as_output(ex: coverage_reference.Expected, records: list, contig: str = "chr1") -> list:
    """The records of ``ex`` as the check reads an annotated VCF's."""
    out = []
    for i, (p, r, a) in enumerate(records):
        fmt = {"GT": ex.gt[i], "GQ": str(int(ex.gq[i])), "AD": ex.ad[i], "PL": ex.pl[i], "DP": str(int(ex.dp[i]))}
        if ex.ps[i] is not None:
            fmt["PS"] = str(ex.ps[i])
        out.append({"chrom": contig, "pos": p + 1, "ref": r, "alt": a,
                    "info": {"DP": str(int(ex.dp[i])), "PC": str(int(ex.pc[i]))}, "fmt": fmt})
    return out


def overlap_depth(sample, records, read_len: int, pair_cov: bool = True, phase: bool = True) -> list:
    return as_output(coverage_reference.expected(sample, records, read_len, pair_cov, phase, exact=False), records)


def swapped_priors(sample, records, read_len: int, pair_cov: bool = True, phase: bool = True) -> list:
    p = coverage_reference.PRIORS
    return as_output(coverage_reference.expected(sample, records, read_len, pair_cov, phase, priors=(p[0], p[2], p[1])),
                     records)
