"""The mean device microseconds of one ``push_front`` launch (the
``__global__`` function ``push_front_kernel``) over the traced window;
nothing where the program has no such kernel."""

from benchmark.lib import trace


def read(ctx):
    got = trace.kernel_stats(ctx.spans, "push_front_kernel")
    return got[1] if got else None
