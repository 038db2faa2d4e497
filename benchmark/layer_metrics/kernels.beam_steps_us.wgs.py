"""The mean device microseconds of one ``beam_steps`` launch (the
``__global__`` function ``beam_steps_kernel``, a block of up to 48 beam
steps) over the traced window; nothing where the program has no such
kernel."""

from benchmark.lib import trace


def read(ctx):
    got = trace.kernel_stats(ctx.spans, "beam_steps_kernel")
    return got[1] if got else None
