"""The readers of the program's spans (``lib/program_spans.py`` and the
``discover.beam_step_*``, ``discover.prepare_ms`` metrics) on hand-made
spans and device operations, and the fetch from the port's recorder."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import program_spans, spec

STEPS, POLL, COMPACT = "discover.wavefront.steps", "discover.wavefront.poll", "discover.wavefront.compact"

# (start us, end us, name, counts, parent) in the order the program records
# them: a call, two blocks of beam steps (a poll in each, a compaction in
# the second), and the preparation recorded after it ended
SPANS = [
    (0.0, 1000.0, "discover.call", {}, -1),
    (100.0, 400.0, STEPS, {"steps": 48, "lanes": 4096}, 0),
    (350.0, 400.0, POLL, {}, 1),
    (400.0, 600.0, STEPS, {"steps": 12, "lanes": 4096}, 0),
    (500.0, 550.0, POLL, {}, 3),
    (550.0, 580.0, COMPACT, {"lanes": 512}, 3),
    (10.0, 60.0, "discover.prepare", {"bases": 8}, 0),
]
# device operations (start us, end us, name) by start: one in the
# preparation, three in the first block (one during its poll), one at the
# second block's start (the first block's end), one at the second block's
# end, one after the call and one after a gap with no span open
DEVICE = [(20.0, 30.0, "h2d"), (120.0, 130.0, "a"), (130.0, 140.0, "b"), (360.0, 390.0, "sum"), (400.0, 410.0, "c"),
          (600.0, 610.0, "d"), (1100.0, 1200.0, "e"), (1300.0, 1310.0, "f")]


def ctx_of(spans=SPANS, device=DEVICE):
    return SimpleNamespace(spans=device, program_spans=spans)


def test_host_us_a_step_leaves_out_the_polls_and_compactions():
    # (300 + 200 - 50 - 50 - 30) us over 48 + 12 steps
    want = 370.0 / 60
    assert program_spans.beam_steps(SPANS) == (60, 370.0)
    assert spec.reader("discover.beam_step_host_us.wgs")(ctx_of()) == pytest.approx(want)
    assert spec.reader("discover.beam_step_host_us.panel")(ctx_of()) == pytest.approx(want)


def test_ops_a_step_count_starts_inside_a_block():
    """The operation during the poll counts; the one starting at the first
    block's end counts for the second block; the one starting at the second
    block's end counts for neither."""
    assert spec.reader("discover.beam_step_ops.wgs")(ctx_of()) == pytest.approx(4 / 60)
    starts = program_spans.device_starts(ctx_of())
    assert program_spans.ops_inside(starts, 100.0, 400.0) == 3
    assert program_spans.ops_inside(starts, 400.0, 600.0) == 1


def test_prepare_ms_is_the_mean_a_call():
    second = [(2000.0, 2150.0, "discover.prepare", {"bases": 8}, -1)]
    assert spec.reader("discover.prepare_ms.panel")(ctx_of()) == pytest.approx(0.05)
    assert spec.reader("discover.prepare_ms.panel")(ctx_of(SPANS + second)) == pytest.approx(0.1)


@pytest.mark.parametrize("name", ["discover.beam_step_host_us.wgs", "discover.beam_step_host_us.panel",
                                  "discover.beam_step_ops.wgs", "discover.prepare_ms.panel"])
def test_readers_give_none_without_spans(name):
    """A program that records no span (the recorder absent), or a window
    without beam steps: the metric is left out, and nothing raises."""
    assert spec.reader(name)(ctx_of(spans=None)) is None
    assert spec.reader(name)(ctx_of(spans=[(0.0, 1.0, "discover.call", {}, -1)])) is None


def test_idle_by_span_puts_each_gap_on_the_innermost_span():
    by = program_spans.idle_by_span(program_spans.idle_gaps(DEVICE), SPANS)
    assert by == {
        "discover.call": pytest.approx(90.0 + 490.0),  # 30-120 (past the preparation), 610-1100
        STEPS: pytest.approx(220.0),  # 140-360
        POLL: pytest.approx(10.0 + 190.0),  # 390-400 in the first poll; 410-600's middle in the second
        program_spans.OUTSIDE: pytest.approx(100.0),  # 1200-1300
    }
    assert program_spans.idle_gaps(DEVICE)[0] == (30.0, 120.0)


def test_summary_self_times_and_the_share_outside():
    got = program_spans.summary(DEVICE, SPANS)
    rows = got["by_name"]
    assert rows["discover.call"][:2] == [1, pytest.approx((1000 - 300 - 200 - 50) / 1e6)]
    assert rows[STEPS][:2] == [2, pytest.approx((300 - 50 + 200 - 50 - 30) / 1e6)]
    assert rows[POLL][0] == 2 and rows[program_spans.OUTSIDE][0] == 0
    assert got["idle_s"] == pytest.approx(1100e-6)
    assert got["idle_outside_discover_share"] == pytest.approx(100 / 1100)


def test_a_wrapper_span_is_innermost_but_inside_discovery():
    """A kernel wrapper's span (``push4``) inside a block of steps takes
    the gap at its middle, and that gap is not outside discovery's spans;
    it is not a poll, so the host's enqueue time a step keeps it."""
    spans = SPANS + [(200.0, 300.0, "push4", {}, 1)]
    got = program_spans.summary(DEVICE, spans)
    assert got["by_name"]["push4"] == [1, pytest.approx(100e-6), pytest.approx(220e-6)]
    assert got["by_name"][STEPS][2] == 0.0
    assert got["idle_outside_discover_share"] == pytest.approx(100 / 1100)
    assert program_spans.beam_steps(spans) == (60, 370.0)


def test_window_takes_the_recorders_spans_once(monkeypatch, capsys):
    """Under a profiler the port records; ``window`` takes the recording,
    in microseconds, keeps it on the context and prints its summary once."""
    from biograph_tpu_torch.runtime import log
    from torch.profiler import ProfilerActivity, profile

    log.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with log.span("discover.call"):
            with log.span(STEPS, steps=3, lanes=128):
                torch.ones(8).sum()
    ctx = SimpleNamespace(spans=[])
    got = program_spans.window(ctx)
    assert [(s[2], s[3], s[4]) for s in got] == [("discover.call", {}, -1), (STEPS, {"steps": 3, "lanes": 128}, 0)]
    assert got[0][0] <= got[1][0] <= got[1][1] <= got[0][1]
    assert "benchmark: program spans" in capsys.readouterr().err
    assert program_spans.window(ctx) is got and log.take_spans() == []


def test_window_of_a_program_without_the_recorder(monkeypatch):
    """The parent of the recorder: no ``take_spans``, no spans, no error."""
    from biograph_tpu_torch.runtime import log

    monkeypatch.delattr(log, "take_spans")
    assert program_spans.window(SimpleNamespace(spans=DEVICE)) is None
