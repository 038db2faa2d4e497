"""The milliseconds a call of the ``coverage.phase`` span, read-backed
phasing: the four allele queries of each pair of neighbouring het records
walked, the links joined into blocks; the mean over the window's
``run_coverage`` calls."""

from benchmark.lib import coverage_spans


def read(ctx):
    return coverage_spans.mean_ms(ctx, "coverage.phase")
