"""Device operations a record of annotating: the window's device
operations whose start lies inside a ``coverage.annotate`` span (the
allele queries' coverage walks, each ending in a copy to the host), over
the spans' ``records`` counts.  On mixed read lengths the walk takes the
general route, a restart chain of ``push_front`` launches and the exact
window's ``chain_window`` rounds."""

from benchmark.lib import coverage_spans


def read(ctx):
    got = coverage_spans.ops_inside(ctx, "coverage.annotate")
    if got is None:
        return None
    ops, inside = got
    records = sum(s[3].get("records", 0) for s in inside)
    return ops / records if records else None
