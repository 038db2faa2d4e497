"""The coverage cell's readings of the program's spans (``run_coverage``'s
``coverage.*`` spans, ``runtime/log.span``): a span's mean milliseconds a
call, and the device operations that start inside a span.  A program
without the spans gives None for each.

On first use it prints one line to standard error: the counts of the
window's ``coverage.*`` spans by name, summed, among them the rows each
route of ``Readmap.coverage`` probed (``route_hash``, ``route_chain_fixed``,
``route_general``) under the span it ran in."""

from __future__ import annotations

import json
import sys

from benchmark.lib import program_spans

CALL = "coverage.call"


def spans(ctx):
    got = program_spans.window(ctx)
    if got and not hasattr(ctx, "coverage_counts"):
        counts = {}
        for s in got:
            if s[2].startswith("coverage."):
                row = counts.setdefault(s[2], {})
                for k, v in s[3].items():
                    row[k] = row.get(k, 0) + v
        ctx.coverage_counts = counts
        print("benchmark: coverage span counts " + json.dumps(counts), file=sys.stderr)
    return got


def mean_ms(ctx, name: str):
    """The milliseconds of the spans ``name`` over the window's calls."""
    got = spans(ctx)
    calls = sum(1 for s in got or () if s[2] == CALL)
    if not calls:
        return None
    us = sum(s[1] - s[0] for s in got if s[2] == name)
    return us / calls / 1e3 if any(s[2] == name for s in got) else None


def ops_inside(ctx, name: str):
    """(device operations starting inside the spans ``name``, those spans)."""
    got = spans(ctx)
    if not got or not ctx.spans:
        return None
    starts = program_spans.device_starts(ctx)
    inside = [s for s in got if s[2] == name]
    return sum(program_spans.ops_inside(starts, s[0], s[1]) for s in inside), inside
