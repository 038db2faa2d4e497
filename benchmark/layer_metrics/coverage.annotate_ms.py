"""The milliseconds a call of the ``coverage.annotate`` span, annotating a
region's records: the donor, the allele queries and their coverage walks,
the genotyper; the mean over the window's ``run_coverage`` calls."""

from benchmark.lib import coverage_spans


def read(ctx):
    return coverage_spans.mean_ms(ctx, "coverage.annotate")
