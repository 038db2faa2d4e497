"""The program's spans and the card's trace share one clock, and the
recorder is on in the benchmark's traced window.  Run on the card's
machine with

    python -m pytest benchmark/tests -q -m chip -s

and read the printed margins (PERF.md keeps them)."""

import json

import numpy as np
import pytest
import torch

from benchmark.lib import trace

LANES = 1 << 16


@pytest.fixture(scope="module")
def card_seqset():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    from biograph_tpu_torch.build.seqset_build import build_seqset

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (4000, 100), dtype=np.uint8)
    return build_seqset(codes, np.full(4000, 100, np.int32), device="cuda")


@pytest.mark.chip
def test_the_recorder_is_on_in_the_benchmarks_window(cuda_device):
    """The benchmark's profiler (CUDA activity only) turns the recorder on."""
    from biograph_tpu_torch.runtime import log

    log.take_spans()
    assert not log.tracing()
    with trace.profiled(cpu=False):
        assert log.tracing() and torch.autograd._profiler_enabled()
        with log.span("probe"):
            torch.zeros(1, device=cuda_device).add_(1)
    assert not log.tracing()
    assert [s.name for s in log.take_spans()] == ["probe"]


@pytest.mark.chip
def test_a_span_holds_its_kernel_on_the_trace_clock(card_seqset, cuda_device):
    """A span around one ``push4`` launch and its synchronise holds the
    launch's ``push4_kernel`` device event: the event starts at or after
    the span's start and ends at or before its end."""
    from biograph_tpu_torch.ops import rank4 as rank4_ops
    from biograph_tpu_torch.runtime import log

    d = card_seqset.d
    i64 = dict(dtype=torch.int64, device=cuda_device)
    begin = torch.randint(0, card_seqset.n_entries, (LANES,), **i64)
    end = torch.minimum(begin + 64, torch.tensor(card_seqset.n_entries, **i64))
    size = torch.zeros(LANES, dtype=torch.int32, device=cuda_device)
    args = (d.rank_blocks, d.entry_sizes, d.fixed, begin, end, size)
    rank4_ops.push4(*args)  # the first launch loads the kernel
    torch.cuda.synchronize()
    log.take_spans()
    rows = []
    with trace.profiled(cpu=False) as prof:
        for _ in range(5):
            with log.span("launch_and_sync"):
                rank4_ops.push4(*args)
                torch.cuda.synchronize()
    spans = [s for s in log.take_spans() if s.name == "launch_and_sync"]
    kernels = [k for k in trace.device_spans(trace.records(prof)) if k[2].startswith("push4_kernel")]
    assert len(spans) == len(kernels) == 5
    for s, (k0, k1, _) in zip(spans, kernels):
        s0, s1 = s.start_ns / 1e3, s.end_ns / 1e3
        rows.append({"kernel_after_span_start_us": k0 - s0, "span_end_after_kernel_end_us": s1 - k1})
        assert s0 <= k0 and k1 <= s1, rows[-1]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "margins": rows}), flush=True)
