"""The end-to-end arithmetic and the trace readers on synthetic inputs."""

import statistics
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import measure, trace


def test_rate_counts_every_call_over_their_time():
    assert measure.rate([4641.652] * 3, [2.0, 3.0, 5.0]) == pytest.approx(3 * 4641.652 / 10.0)
    with pytest.raises(ValueError):
        measure.rate([], [])


def test_p95_is_over_every_call():
    vals = list(range(1, 201))  # 200 calls
    assert measure.percentile(vals, 95) == 190
    assert measure.percentile([5.0], 95) == 5.0
    # not the median of chunks' p95s
    chunks = [sorted(vals[i : i + 20]) for i in range(0, 200, 20)]
    assert measure.percentile(vals, 95) != statistics.median(measure.percentile(c, 95) for c in chunks)


def test_spread_by_statistics_quantiles():
    vals = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert measure.spread(vals) == pytest.approx((q3 - q1) / q2)


def _event(start, end, name, device=True):
    return (start, end, name, device)


def test_busy_idle_and_top_ops():
    ev = [_event(0, 10, "push4_kernel(a)"), _event(5, 20, "copy"), _event(40, 50, "push4_kernel(b)"),
          _event(0, 100, "aten::x", device=False)]
    spans = trace.device_spans(ev)
    assert len(spans) == 3
    assert trace.busy_us(spans) == 30
    ctx = SimpleNamespace(spans=spans, busy_s=30e-6, window_s=100e-6)
    assert trace.idle_share(ctx) == pytest.approx(0.7)
    assert trace.idle_share(SimpleNamespace(spans=[], busy_s=0, window_s=1)) is None
    assert trace.top_ops(spans)[0] == ["push4_kernel", pytest.approx(20e-6)]
    assert trace.kernel_stats(spans, "push4_kernel") == (2, 10)
    assert trace.kernel_stats(spans, "rank_kernel") is None


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    ev = [_event(0, 10, "k1"), _event(30, 40, "k2"), _event(100, 110, "k3"),
          _event(0, 60, "bgt::push4", device=False), _event(15, 25, "aten::nonzero", device=False)]
    gaps = dict(trace.idle_gaps(ev))
    assert gaps["aten::nonzero"] == pytest.approx(20e-6)
    assert gaps["host"] == pytest.approx(60e-6)


def test_records_of_a_profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).add_(1)
    recs = trace.records(prof)
    assert recs and all(len(r) == 4 and r[1] >= r[0] for r in recs)
    assert any(r[2] == "aten::add_" and not r[3] for r in recs)
