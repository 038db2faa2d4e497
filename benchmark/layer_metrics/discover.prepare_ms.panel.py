"""A region call's fixed cost before its first stage, in milliseconds: the
``discover.prepare`` span (the memory plan, the doubled reference built on
the host and uploaded), the mean over the window's calls."""

from benchmark.lib import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    vals = [s[1] - s[0] for s in spans or () if s[2] == "discover.prepare"]
    return sum(vals) / len(vals) / 1e3 if vals else None
