"""The mean device microseconds of one ``push4`` launch (the ``__global__``
function ``push4_kernel``) over the traced window."""

from benchmark.lib import trace


def read(ctx):
    got = trace.kernel_stats(ctx.spans, "push4_kernel")
    return got[1] if got else None
