"""The mean device microseconds of one ``sequences`` launch (the
``__global__`` function ``sequences_kernel``, pair coverage's rebuild of the
whole library's reads) over the traced window; nothing where the program
has no such kernel.  Prints its launches beside the window's calls to
standard error, one line."""

import sys

from benchmark.lib import trace


def read(ctx):
    got = trace.kernel_stats(ctx.spans, "sequences_kernel")
    if not got:
        return None
    print(f"benchmark: sequences_kernel launches {got[0]} over {len(ctx.calls)} calls", file=sys.stderr)
    return got[1]
