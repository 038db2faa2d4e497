"""The share of the traced window in which no device operation ran."""

from benchmark.lib import trace


def read(ctx):
    return trace.idle_share(ctx)
