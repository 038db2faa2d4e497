"""Readers of a ``torch.profiler`` trace, in memory (no trace file): the
device's busy time, its heaviest operations, a kernel's mean time, and the
idle gaps named by what the host was doing.

Written after ``chip_smoke.py``'s ``_profiled`` (:304-327, CUDA activity
only over discovery and coverage, whose launches number in the tens of
thousands), ``device_ops`` (:3408) and ``kernels_us`` (:330) at commit
3444720."""

from __future__ import annotations

from contextlib import contextmanager


def records(prof) -> list:
    """(start us, end us, name, on the device) of every event a profiler
    recorded, read from its raw results (building the profiler's event
    tree for a window of launches costs far more)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(), e.device_type() == cuda) for e in prof.profiler.kineto_results.events()]


def short_name(name: str) -> str:
    """A kernel's name cut at its argument list."""
    return name.split("(")[0][:80]


@contextmanager
def profiled(cpu: bool):
    """A profiler over the block: CUDA activity always, CPU activity (the
    host's operators and ranges) only where ``cpu``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        yield prof
        torch.cuda.synchronize()


def device_spans(recs) -> list:
    """(start us, end us, name) of every device operation (kernels, copies,
    sets) among ``records``, by start."""
    spans = [(s, e, name) for s, e, name, dev in recs if dev]
    spans.sort()
    return spans


def busy_us(spans) -> float:
    """Microseconds in which at least one device operation ran."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def top_ops(spans, n: int = 10) -> list:
    """[name, seconds] of the n device operations that took most time."""
    by = {}
    for s, e, name in spans:
        k = short_name(name)
        by[k] = by.get(k, 0.0) + (e - s) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def kernel_stats(spans, prefix: str):
    """(launches, mean device us) of the kernels whose name starts with
    ``prefix`` (the ``__global__`` function's name); None without any."""
    times = [e - s for s, e, name in spans if name.startswith(prefix)]
    if not times:
        return None
    return len(times), sum(times) / len(times)


def idle_gaps(recs, n: int = 10) -> list:
    """[host operation, seconds] of the idle time between device
    operations, each gap named by the innermost host operator or range
    open at its middle ("host" where none is), summed by name: the n
    largest."""
    spans = device_spans(recs)
    host = sorted((s, e, name) for s, e, name, dev in recs if not dev and e > s)
    gaps = []
    end = None
    for s, e, _ in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    # one sweep in time: a stack of the host intervals open, innermost on
    # top (operators and ranges nest)
    by, stack, hi = {}, [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        while hi < len(host) and host[hi][0] <= mid:
            while stack and stack[-1][1] < host[hi][0]:
                stack.pop()
            stack.append(host[hi])
            hi += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        k = stack[-1][2] if stack else "host"
        by[k] = by.get(k, 0.0) + (g1 - g0) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def idle_share(ctx):
    """1 - busy / window of a traced run; None where no device operation
    was seen."""
    if not ctx.spans or ctx.window_s <= 0:
        return None
    return 1.0 - ctx.busy_s / ctx.window_s
