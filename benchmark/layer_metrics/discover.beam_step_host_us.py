"""The host's enqueue microseconds a beam step, a whole-genome or a region
call: over the window's ``discover.wavefront.steps`` spans (a block of up
to 48 beam steps, through the poll that ends it) their durations less
their poll and compact children, over the blocks' ``steps`` counts."""

from benchmark.lib import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    if not spans:
        return None
    steps, host_us = program_spans.beam_steps(spans)
    return host_us / steps if steps else None
