"""The milliseconds a call of the ``coverage.pairs.place`` span, placing the
rebuilt reads: the donor's k-mer index built, every read seeded and verified
on it; the mean over the window's ``run_coverage`` calls."""

from benchmark.lib import coverage_spans


def read(ctx):
    return coverage_spans.mean_ms(ctx, "coverage.pairs.place")
