"""The program's own spans of a traced window, beside its device operations.

While a profiler runs, the port records spans (``runtime/log.span``:
``discover.call``, ``discover.wavefront.steps``, ...) on the clock the
profiler stamps its events with.  ``window(ctx)`` takes them from the
program once a run, after the window, and keeps them on ``ctx``; a program
that records none (one without the recorder) gives None, and every metric
read from them is then left out.

On first fetch it prints one line to standard error, the window's spans by
name: how many, their self time (duration less their children's), and the
device's idle time put down to the innermost span open at each idle gap's
middle, with the share of idle time where no ``discover.*`` span is open.
"""

from __future__ import annotations

import bisect
import json
import sys

STEPS = "discover.wavefront.steps"
INSIDE_STEPS = ("discover.wavefront.poll", "discover.wavefront.compact")  # the host waits or compacts, not enqueues
OUTSIDE = "(no span)"


def window(ctx):
    """[(start us, end us, name, counts, parent index)] of the window's
    spans in the order the program recorded them; None without any."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = _take()
        if ctx.program_spans:
            print("benchmark: program spans " + json.dumps(summary(ctx.spans, ctx.program_spans)), file=sys.stderr)
    return ctx.program_spans


def _take():
    try:
        from biograph_tpu_torch.runtime import log
    except ImportError:
        return None
    take = getattr(log, "take_spans", None)
    if take is None:
        return None
    got = [(s.start_ns / 1e3, s.end_ns / 1e3, s.name, dict(s.counts), s.parent) for s in take()]
    return got or None


def device_starts(ctx) -> list:
    """The start (us) of every device operation of the window, in order
    (cached on ``ctx``)."""
    if not hasattr(ctx, "device_starts"):
        ctx.device_starts = [s for s, _, _ in ctx.spans]
    return ctx.device_starts


def ops_inside(starts: list, lo: float, hi: float) -> int:
    """Device operations whose start lies in [lo, hi)."""
    return bisect.bisect_left(starts, hi) - bisect.bisect_left(starts, lo)


def beam_steps(spans) -> tuple:
    """(beam steps, the host's enqueue us over them): the ``steps`` counts
    of the ``discover.wavefront.steps`` spans, and their durations less
    those of their poll and compact children."""
    blocks = {i for i, s in enumerate(spans) if s[2] == STEPS}
    steps = sum(spans[i][3].get("steps", 0) for i in blocks)
    host = sum(spans[i][1] - spans[i][0] for i in blocks)
    host -= sum(s[1] - s[0] for s in spans if s[2] in INSIDE_STEPS and s[4] in blocks)
    return steps, host


def self_us(spans) -> list:
    """Each span's duration less its children's (us)."""
    own = [s[1] - s[0] for s in spans]
    for s in spans:
        if s[4] >= 0:
            own[s[4]] -= s[1] - s[0]
    return own


def idle_gaps(device) -> list:
    """(start us, end us) of each gap between the device operations
    ``device`` ((start, end, name) by start) in which none runs."""
    gaps, end = [], None
    for s, e, _ in device:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None or e > end else end
    return gaps


def idle_by_span(gaps, spans) -> dict:
    """Idle us of ``gaps`` ((start, end) by start) by the name of the
    innermost of ``spans`` open at each gap's middle (``OUTSIDE`` where
    none is).  Spans nest in time; one sweep, spans by start, gaps by
    middle, a stack of the spans open."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    by, stack, hi = {}, [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while hi < len(order) and order[hi][0] <= mid:
            while stack and stack[-1][1] < order[hi][0]:
                stack.pop()
            stack.append(order[hi])
            hi += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        k = stack[-1][2] if stack else OUTSIDE
        by[k] = by.get(k, 0.0) + (g1 - g0)
    return by


def summary(device, spans) -> dict:
    """What ``window`` prints: {name: [spans, self s, idle s]} and the
    share of idle time outside every ``discover.*`` span."""
    gaps = idle_gaps(device)
    idle = idle_by_span(gaps, spans)
    table = {}
    for s, own in zip(spans, self_us(spans)):
        row = table.setdefault(s[2], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += own / 1e6
    for k, us in idle.items():
        table.setdefault(k, [0, 0.0, 0.0])[2] += us / 1e6
    total = sum(idle.values())
    outside = idle_by_span(gaps, [s for s in spans if s[2].startswith("discover.")]).get(OUTSIDE, 0.0)
    return {"by_name": dict(sorted(table.items(), key=lambda kv: -kv[1][2])), "idle_s": total / 1e6,
            "idle_outside_discover_share": outside / total if total else None}
