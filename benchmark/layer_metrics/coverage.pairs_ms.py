"""The milliseconds a call of the ``coverage.pairs`` span, pair coverage:
the library's reads rebuilt from the store, placed on the donor, and the
pairs over each record counted; the mean over the window's ``run_coverage``
calls."""

from benchmark.lib import coverage_spans


def read(ctx):
    return coverage_spans.mean_ms(ctx, "coverage.pairs")
