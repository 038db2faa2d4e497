"""Device operations a beam step: the window's device operations whose
start lies inside a ``discover.wavefront.steps`` span, over the spans'
``steps`` counts.  The poll that ends a block drains the device inside the
span, so a block's operations start inside it; its own reduction counts."""

from benchmark.lib import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    if not spans or not ctx.spans:
        return None
    starts = program_spans.device_starts(ctx)
    blocks = [s for s in spans if s[2] == program_spans.STEPS]
    steps = sum(s[3].get("steps", 0) for s in blocks)
    ops = sum(program_spans.ops_inside(starts, s[0], s[1]) for s in blocks)
    return ops / steps if steps else None
