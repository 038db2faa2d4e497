"""The port's per-command trace on the CPU: ``runtime/log.maybe_profile``,
the kernel wrappers' ``bgt::<wrapper>`` ranges and the CLI's ``--profile
DIR``, against the JAX CLI's output on the same inputs.

The toy world is ``tests/test_torch_cli_pipeline.py``'s: leg 4's generator
(``chip_smoke.sv_paired_library``) on a 30 kb genome, its store made here by
the port's ``create --paired``.  ``chip_smoke.py``'s trace leg (``trace_phase``
and the checks of ``trace_holds``) is rehearsed at that size; its device-side
checks, which need the card's kernel events, are held on hand-made traces.

Run alone on the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_profile.py -q``.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESS_TIMEOUT_S = 240

from biograph_tpu_torch.runtime import log  # noqa: E402
from biograph_tpu_torch.runtime.log import maybe_profile  # noqa: E402
from test_torch_cli_pipeline import TOY, TOY_GENOME, _chip_smoke  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(tmp, FASTQ, FASTA, the port's store of them, the planted SVs)."""
    from biograph_tpu_torch import cli

    cs = _chip_smoke()
    tmp = str(tmp_path_factory.mktemp("profile"))
    genome = cs.leg_genome(TOY_GENOME)
    codes, lengths, truth = cs.sv_paired_library(genome, **TOY, error_rate=0.0)
    fq, fa = cs.write_leg_inputs(tmp, genome, codes, lengths)
    bgt = os.path.join(tmp, "sample.bgt")
    cli.main(["create", "--reads", fq, "--out", bgt, "--paired", "--device", "cpu"])
    return tmp, fq, fa, bgt, truth["sv"]


def spans(path):
    """The complete events ("ph": "X") of a Chrome trace."""
    return [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]


def ranges(events, name):
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name]


def within(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def vcf_text(path):
    """A VCF's lines but its ##source= line."""
    return [line for line in open(path).read().splitlines() if not line.startswith("##source=")]


# ---------------------------------------------------------------------------
# maybe_profile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["library", "cli"])
def test_nothing_is_traced_without_a_dir(world, tmp_path, monkeypatch, how):
    """maybe_profile(tag, None) and a command without --profile start no
    profiler and write nothing, with BGT_PROFILE and BGT_PROFILE_DIR set."""
    from biograph_tpu_torch import cli

    _, _, _, bgt, _ = world
    monkeypatch.setenv("BGT_PROFILE", str(tmp_path / "env_profile"))
    monkeypatch.setenv("BGT_PROFILE_DIR", str(tmp_path / "env_profile_dir"))
    monkeypatch.chdir(tmp_path)

    def forbidden(*a, **k):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    if how == "library":
        with maybe_profile("block", None):
            assert not log.tracing() and not torch.autograd.profiler._is_profiler_enabled
            torch.ones(4).cumsum(0)
    else:
        cli.main(["stats", bgt, "--device", "cpu"])
        cli.main(["query", "--biograph", bgt, "--query", "ACGTAC", "--device", "cpu"])
    assert os.listdir(tmp_path) == []


def test_maybe_profile_writes_a_chrome_trace(tmp_path):
    """The block is one range named after the tag, with the torch
    operations it ran inside it, in <dir>/<tag>.json."""
    d = tmp_path / "trace"
    with maybe_profile("block", str(d)):
        assert log.tracing() and torch.autograd.profiler._is_profiler_enabled
        torch.arange(10).cumsum(0)
    assert not log.tracing() and not torch.autograd.profiler._is_profiler_enabled
    assert os.listdir(d) == ["block.json"]
    events = spans(d / "block.json")
    (top,) = ranges(events, "block")
    ops = [e for e in events if e["name"] == "aten::cumsum"]
    assert len(ops) == 1 and within(ops[0], top)


def test_nested_call_adds_a_range(tmp_path):
    """Inside an open trace maybe_profile adds a range and no file."""
    d, d2 = tmp_path / "outer", tmp_path / "inner"
    with maybe_profile("outer", str(d)):
        with maybe_profile("inner", str(d2)):
            torch.ones(3).sum()
        assert log.tracing()
    assert os.listdir(d) == ["outer.json"] and not d2.exists()
    events = spans(d / "outer.json")
    (outer,), (inner,) = ranges(events, "outer"), ranges(events, "inner")
    ops = [e for e in events if e["name"] == "aten::sum"]
    assert within(inner, outer) and ops and all(within(op, inner) for op in ops)


def test_raising_block_stops_the_profiler(tmp_path):
    """A block that raises: the error propagates, the profiler is stopped,
    no file is written, and the next trace starts."""
    d = tmp_path / "trace"
    with pytest.raises(ValueError, match="boom"):
        with maybe_profile("bad", str(d)):
            raise ValueError("boom")
    assert not log.tracing() and not torch.autograd.profiler._is_profiler_enabled
    assert not (d / "bad.json").exists()
    with maybe_profile("next", str(d)):
        torch.ones(2).sum()
    assert os.listdir(d) == ["next.json"]


def test_process_id_names_the_file(tmp_path):
    with maybe_profile("discovery", str(tmp_path), process_id=3):
        torch.ones(2).sum()
    assert os.listdir(tmp_path) == ["discovery.p3.json"]
    assert len(ranges(spans(tmp_path / "discovery.p3.json"), "discovery")) == 1


# ---------------------------------------------------------------------------
# the span recorder
# ---------------------------------------------------------------------------


@pytest.fixture
def recording():
    """A fresh recording, left empty."""
    log.take_spans()
    yield
    log.take_spans()


def test_recorder_is_off_without_a_profiler(recording, monkeypatch):
    """No profiler: a span opens no range, records nothing and costs the
    switch's check; a finished span is dropped too."""
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: pytest.fail("a range without a profiler"))
    with log.span("a", n=1) as a:
        a.set(m=2)
        with log.span("b"):
            torch.ones(2).sum()
    log.add_span("c", 1, 2)
    assert not log.tracing() and log.take_spans() == []


@pytest.mark.parametrize("how", ["torch_profiler", "maybe_profile"])
def test_recorder_records_under_a_profiler(recording, tmp_path, how):
    """Under torch.profiler (CPU activity) or maybe_profile the spans are
    recorded with their counts; maybe_profile's file holds each as a range
    bgt::<name> with its counts, inside the block's range."""
    from torch.profiler import ProfilerActivity, profile

    ctx = profile(activities=[ProfilerActivity.CPU]) if how == "torch_profiler" else maybe_profile("block", str(tmp_path))
    with ctx:
        with log.span("a", n=1) as a:
            torch.ones(4).cumsum(0)
            a.set(m=2)
    got = log.take_spans()
    assert [(s.name, s.counts, s.parent) for s in got] == [("a", {"n": 1, "m": 2}, -1)]
    assert 0 < got[0].start_ns <= got[0].end_ns
    if how == "maybe_profile":
        events = spans(tmp_path / "block.json")
        (top,), (a_range,) = ranges(events, "block"), ranges(events, log.RANGE_PREFIX + "a")
        assert within(a_range, top) and a_range["args"] == {"n": 1, "m": 2}
        ops = [e for e in events if e["name"] == "aten::cumsum"]
        assert len(ops) == 1 and within(ops[0], a_range)


def test_count_adds_to_the_innermost_open_span(recording):
    """``count`` adds to the innermost open span, counts of one name adding
    up; with no span open, or no profiler, it records nothing."""
    from torch.profiler import ProfilerActivity, profile

    log.count(n=1)
    with log.span("off"):
        log.count(n=1)
    assert log.take_spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        log.count(n=5)
        with log.span("outer", n=1) as outer:
            log.count(n=2)
            with log.span("inner"):
                log.count(m=3)
                log.count(m=4)
            outer.set(n=10)
    assert [(s.name, s.counts) for s in log.take_spans()] == [("outer", {"n": 13}), ("inner", {"m": 7})]


def test_spans_nest(recording):
    """A span's parent is the innermost span open at its start; a finished
    span added later adopts the spans of its parent recorded inside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with log.span("root"):
            t0 = time.time_ns()
            with log.span("a"):
                with log.span("a1"):
                    pass
            with log.span("b"):
                pass
            log.add_span("stage", t0, time.time_ns())
        with log.span("next"):
            pass
    got = log.take_spans()
    by = {s.name: i for i, s in enumerate(got)}
    parent = {s.name: (got[s.parent].name if s.parent >= 0 else None) for s in got}
    assert parent == {"root": None, "a": "stage", "a1": "a", "b": "stage", "stage": "root", "next": None}
    assert [s.name for s in got] == ["root", "a", "a1", "b", "stage", "next"] and by["stage"] == 4
    for s in got:
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_raising_block_closes_its_span(recording):
    """A block that raises: the error propagates, its spans end, and the
    recording can be taken (nothing stays open)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="boom"):
            with log.span("outer"):
                with log.span("inner"):
                    raise ValueError("boom")
        with log.span("after"):
            pass
    got = log.take_spans()
    assert [(s.name, s.parent) for s in got] == [("outer", -1), ("inner", 0), ("after", -1)]
    assert all(s.end_ns >= s.start_ns > 0 for s in got)


def test_take_spans_refuses_while_a_span_is_open(recording):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with log.span("open"):
            with pytest.raises(RuntimeError, match="still open"):
                log.take_spans()


def test_recording_leaves_nothing_for_the_collector(recording):
    """Spans, their counts and finished spans leave no object that the
    cyclic collector tracks: recording does not set it off in the middle of
    a call (a retained object a span did, in discovery's windows on the
    card)."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        gc.disable()
        try:
            before = gc.get_count()[0]
            for i in range(5000):
                with log.span("discover.wavefront.steps", steps=48, lanes=4096) as s:
                    s.set(hits=i)
                    with log.span("push4"):
                        pass
                log.add_span("discover.anchors", 1, 2)
            grown = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert grown < 100, grown
    assert len(log.take_spans()) == 15000


def test_a_span_lies_inside_a_range_around_it_on_the_profilers_clock(recording):
    """Each span lies inside a record_function range opened around it, the
    range's times as the profiler stamps them: one clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with record_function(f"around{i}"):
                with log.span(f"s{i}"):
                    torch.ones(64).add_(1)
    got = {s.name: s for s in log.take_spans()}
    outer = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("around")}
    assert len(got) == len(outer) == 5
    for i in range(5):
        s, r = got[f"s{i}"], outer[f"around{i}"]
        assert r.start_ns() <= s.start_ns <= s.end_ns <= r.end_ns(), (r.start_ns(), s.start_ns, s.end_ns, r.end_ns())


# ---------------------------------------------------------------------------
# the kernel wrappers' ranges
# ---------------------------------------------------------------------------


def wrapper_args(ss, lanes):
    """Arguments of each kernel wrapper over a seqset on the CPU, with
    ``lanes`` lanes (positions, ranges, windows, words)."""
    from biograph_tpu_torch.ops import rank4 as rank4_ops

    d = ss.d
    blocks, sizes, fixed = d.rank_blocks, d.entry_sizes, d.fixed
    i64 = dict(dtype=torch.int64)
    pos = torch.arange(lanes, **i64)
    b = pos % 4
    begin, end = torch.zeros(lanes, **i64), torch.full((lanes,), ss.n_entries, **i64)
    size = torch.zeros(lanes, dtype=torch.int32)
    depth = 4
    win = (torch.arange(lanes * depth) % 4).to(torch.uint8).view(lanes, depth)
    m = torch.full((lanes,), depth, dtype=torch.int32)
    return {
        "rank4": (blocks, pos),
        "rank": (blocks, b, pos),
        "rank4_tiled": (rank4_ops.build_rank4_tiles(ss.prev_words, ss.prev_cum), pos),
        "gather_sizes": (sizes, pos),
        "push4": (blocks, sizes, fixed, begin, end, size),
        "push_front": (blocks, sizes, fixed, begin, end, size, b),
        "chain_window": (blocks, sizes, fixed, win, m, depth),
        "chain_fixed": (blocks, sizes, fixed, (pos % 4).to(torch.uint8), depth),
        "rank_cum": (ss.prev_words[:, :lanes].contiguous(),),
        "sequences": (d.pop_sel, fixed, pos, depth, (pos % (depth + 1)).to(torch.int32)),
    }


@pytest.fixture(scope="module")
def tiny_seqset():
    import numpy as np

    from biograph_tpu_torch.build.seqset_build import build_seqset

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (40, 24), dtype=np.uint8)
    return build_seqset(codes, np.full(40, 24, np.int32), device="cpu")


WRAPPER_NAMES = ["rank4", "rank", "rank4_tiled", "gather_sizes", "push4", "push_front", "chain_window", "chain_fixed", "rank_cum",
                 "sequences"]


@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_wrapper_call_is_one_range_in_a_trace(tiny_seqset, tmp_path, monkeypatch, name):
    """In a trace a wrapper call with lanes is one range bgt::<wrapper>, a
    call without lanes none; outside a trace no range object is made.  The
    results are the same either way."""
    cs = _chip_smoke()
    fn = cs.WRAPPERS[name]
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", lambda *a, **k: pytest.fail("a range outside a trace"))
        want = fn(*wrapper_args(tiny_seqset, 8)[name])
    with maybe_profile("w", str(tmp_path)):
        got = fn(*wrapper_args(tiny_seqset, 8)[name])
        if name != "chain_fixed":  # its windows of an empty text cannot be formed: callers pass a text
            fn(*wrapper_args(tiny_seqset, 0)[name])
    assert cs.max_abs_err(got, want) == 0
    named = [e["name"] for e in spans(tmp_path / "w.json") if e.get("cat") == "user_annotation" and e["name"].startswith(log.RANGE_PREFIX)]
    assert named == [log.RANGE_PREFIX + name]


# ---------------------------------------------------------------------------
# the CLI's --profile
# ---------------------------------------------------------------------------


def test_discovery_profile(world, tmp_path, monkeypatch):
    """discovery --profile d: d/discovery.json names the command, the
    library call's range inside it and push4's, push_front's and
    chain_window's ranges (their plain versions here); the VCF is the
    untraced run's byte for byte and the JAX CLI's but for ##source=."""
    from biograph_tpu import cli as jcli
    from biograph_tpu.index import probes as jprobes
    from biograph_tpu_torch import cli as tcli

    _, _, fa, bgt, _ = world
    jprobes._TEXT_HASH_CACHE.clear()
    monkeypatch.setenv("BGT_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.delenv("BGT_PROFILE", raising=False)
    monkeypatch.delenv("BGT_PROFILE_DIR", raising=False)
    argv = ["discovery", "--mode", "assemble", "--biograph", bgt, "--ref", fa, "--min-depth", "5"]
    out = {k: str(tmp_path / f"{k}.vcf") for k in ("plain", "traced", "jax")}
    d = tmp_path / "trace"
    tcli.main(argv + ["--out", out["plain"], "--device", "cpu"])
    tcli.main(argv + ["--out", out["traced"], "--device", "cpu", "--profile", str(d)])
    jcli.main(argv + ["--out", out["jax"]])
    assert open(out["traced"], "rb").read() == open(out["plain"], "rb").read()
    assert vcf_text(out["traced"]) == vcf_text(out["jax"])
    assert len([x for x in vcf_text(out["traced"]) if not x.startswith("#")]) > 0
    assert os.listdir(d) == ["discovery.json"]
    events = spans(d / "discovery.json")
    command, call = sorted(ranges(events, "discovery"), key=lambda e: -e["dur"])
    assert within(call, command)
    for name in ("push4", "push_front", "chain_window"):
        found = ranges(events, log.RANGE_PREFIX + name)
        assert found and all(within(e, call) for e in found), name


DISCOVERY_SPANS = ("discover.prepare", "discover.wavefront.seed", "discover.wavefront.steps", "discover.wavefront.poll",
                   "discover.wavefront.harvest", "discover.score.coverage", "discover.score.pair_gate")


def test_discovery_spans_of_one_call(world, recording):
    """A traced discover_variants call: one discover.call root holding every
    other span; a span a stage of stage_s as long as the stage; the blocks'
    steps counts summing to wave_steps; the same records as an untraced
    call, which leaves the recorder empty."""
    from torch.profiler import ProfilerActivity, profile

    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.cli import _load_reference
    from biograph_tpu_torch.variants.discover import DiscoverOptions, discover_variants

    _, _, fa, bgt, _ = world
    bg, ref = BioGraph(bgt, device="cpu"), _load_reference(fa)
    opt = DiscoverOptions(min_alt_support=5)
    plain_stats, traced_stats = {}, {}
    plain = discover_variants(bg.seqset, ref, opt=opt, readmap=bg.readmap, stats=plain_stats)
    assert log.take_spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = discover_variants(bg.seqset, ref, opt=opt, readmap=bg.readmap, stats=traced_stats)
    got = log.take_spans()
    assert traced == plain and len(plain) > 0
    roots = [s for s in got if s.parent < 0]
    assert [s.name for s in roots] == ["discover.call"]
    names = {s.name for s in got}
    assert set(DISCOVERY_SPANS) <= names and all(n.startswith("discover.") or n in WRAPPER_NAMES + ["beam_steps"] for n in names)
    # push4 in the anchor scan and, on CPU tensors, in beam_steps' plain
    # version; every block of beam steps one beam_steps call
    assert {got[s.parent].name for s in got if s.name == "push4"} == {"discover.anchors", "beam_steps"}
    assert {got[s.parent].name for s in got if s.name == "beam_steps"} == {"discover.wavefront.steps"}
    fused = [s.counts.get("fused") for s in got if s.name == "discover.wavefront.steps"]
    assert sum(fused) == traced_stats["wave_fused_steps"] == traced_stats["wave_steps"]
    for s in got:
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    stage = {s.name[len("discover."):]: (s.end_ns - s.start_ns) / 1e9 for s in got if s.parent == 0 and s.name[len("discover."):] in traced_stats["stage_s"]}
    assert stage.keys() == traced_stats["stage_s"].keys()
    for k, v in traced_stats["stage_s"].items():
        assert abs(stage[k] - v) < 1e-3, k
    assert sum(s.counts["steps"] for s in got if s.name == "discover.wavefront.steps") == traced_stats["wave_steps"] > 0
    (prep,) = [s for s in got if s.name == "discover.prepare"]
    assert prep.counts == {"bases": 2 * len(ref.flat)}
    steps = {i for i, s in enumerate(got) if s.name == "discover.wavefront.steps"}
    assert all(got[s.parent].name == "discover.wavefront.steps" for s in got if s.name == "discover.wavefront.poll")
    assert all(got[i].counts["lanes"] > 0 for i in steps)


# each coverage span and the span it lies in
COVERAGE_SPANS = {
    "coverage.call": None,
    "coverage.annotate": "coverage.call",
    "coverage.annotate.walk": "coverage.annotate",
    "coverage.pairs": "coverage.call",
    "coverage.pairs.reads": "coverage.pairs",
    "coverage.pairs.place": "coverage.pairs",
    "coverage.pairs.count": "coverage.pairs",
    "coverage.phase": "coverage.call",
    "coverage.write": "coverage.call",
}


def test_coverage_spans_of_one_call(world, recording, tmp_path, monkeypatch):
    """A traced run_coverage call with pair coverage, phasing and features:
    every coverage span once (the walk once a batch), nested as listed,
    with its counts, the coverage routes counted in the spans they ran in;
    the same VCF as an untraced call, which leaves the recorder empty."""
    from torch.profiler import ProfilerActivity, profile

    from biograph_tpu_torch.api import BioGraph
    from biograph_tpu_torch.cli import _load_reference
    from biograph_tpu_torch.io.vcf import VcfRecord, VcfWriter
    from biograph_tpu_torch.variants import coverage_tool
    from biograph_tpu_torch.variants.coverage_tool import BATCH, run_coverage

    spans, count_pairs = [], coverage_tool._spanning_pairs

    def keep_spans(*arg):  # the pair count's inputs, to count the entries it should keep
        spans.append(arg)
        return count_pairs(*arg)

    monkeypatch.setattr(coverage_tool, "_spanning_pairs", keep_spans)

    cs = _chip_smoke()
    _, _, fa, bgt, _ = world
    genome = cs.leg_genome(TOY_GENOME)
    _, lengths, truth = cs.sv_paired_library(genome, **TOY, error_rate=0.0)
    bg, ref = BioGraph(bgt, device="cpu"), _load_reference(fa)
    vin = str(tmp_path / "in.vcf")
    small = sorted(truth["small"])
    with VcfWriter(vin, sample="S", contigs=[(c.name, c.length) for c in ref.contigs]) as w:
        for p, r, a in small:
            w.write(VcfRecord(chrom=ref.contigs[0].name, pos=p + 1, ref=r, alt=a))

    def call(name):
        run_coverage(vin, str(tmp_path / f"{name}.vcf"), bg, ref, sample="S", features_out=str(tmp_path / f"{name}.npz"))
        return vcf_text(tmp_path / f"{name}.vcf")

    plain = call("plain")
    assert log.take_spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = call("traced")
    got = log.take_spans()
    assert traced == plain
    names = [s.name for s in got if s.name.startswith("coverage.")]
    batches = -(-len(small) // BATCH)
    assert sorted(names) == sorted(list(COVERAGE_SPANS) + ["coverage.annotate.walk"] * (batches - 1))
    for s in got:
        if s.name in COVERAGE_SPANS:
            parent = got[s.parent].name if s.parent >= 0 else None
            assert parent == COVERAGE_SPANS[s.name], (s.name, parent)
            if s.parent >= 0:
                p = got[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    one = {s.name: s.counts for s in got if s.name.startswith("coverage.") and s.name != "coverage.annotate.walk"}
    walks = [s.counts for s in got if s.name == "coverage.annotate.walk"]
    reads = int(bg.readmap.read_count)
    assert len(lengths) == reads
    assert one["coverage.annotate"]["records"] == len(small)
    assert one["coverage.annotate"]["queries"] == sum(w["queries"] for w in walks) == 2 * len(small)
    # mixed read lengths: every coverage probe takes the general route
    assert sum(w["route_general"] for w in walks) == 2 * len(small)
    assert not any(k.startswith("route_") and k != "route_general" for w in walks for k in w)
    assert one["coverage.pairs.reads"] == {"reads": reads} and one["coverage.pairs.place"] == {"reads": reads}
    # pairs: the proper entries that can reach a record; scanned: those in the records' windows
    a, b, dlo, dhi, valid = spans[-1]
    kept = int(((b >= dhi[valid].min()) & (a <= dlo[valid].max())).sum())
    counted = one["coverage.pairs.count"]
    assert set(counted) == {"records", "pairs", "scanned"} and counted["records"] == len(small)
    assert counted["pairs"] == kept and 0 < kept <= len(a)
    assert 0 <= counted["scanned"] <= len(small) * kept
    assert set(one["coverage.phase"]) <= {"het", "route_general"} and one["coverage.phase"]["het"] >= 0
    assert one["coverage.call"] == {} and one["coverage.write"] == {}


def test_discovery_profile_holds_the_calls_spans(world, tmp_path):
    """discovery --profile d: the call's spans are ranges bgt::discover.*
    inside the command's range, one bgt::discover.call holding the rest."""
    from biograph_tpu_torch import cli

    _, _, fa, bgt, _ = world
    d = tmp_path / "trace"
    cli.main(["discovery", "--mode", "assemble", "--no-sv", "--biograph", bgt, "--ref", fa, "--min-depth", "5",
              "--out", str(tmp_path / "d.vcf"), "--device", "cpu", "--profile", str(d)])
    events = spans(d / "discovery.json")
    command = max(ranges(events, "discovery"), key=lambda e: e["dur"])
    own = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(log.RANGE_PREFIX + "discover.")]
    (call,) = [e for e in own if e["name"] == log.RANGE_PREFIX + "discover.call"]
    assert within(call, command)
    assert {e["name"][len(log.RANGE_PREFIX):] for e in own} >= set(DISCOVERY_SPANS) - {"discover.score.coverage", "discover.score.pair_gate"}
    assert all(within(e, call) for e in own)
    steps = [e for e in own if e["name"] == log.RANGE_PREFIX + "discover.wavefront.steps"]
    assert steps and all(e["args"]["steps"] > 0 and e["pid"] == command["pid"] and e["tid"] == command["tid"] for e in steps)


def test_chip_smoke_trace_phase_at_toy_size_on_the_cpu(world, tmp_path, monkeypatch):
    """chip_smoke.py's trace leg on CPU tensors: the region around the
    smallest planted SV, the VCFs byte-equal, the command's range spanning
    every event, each of push4, push_front and chain_window named."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _, _, fa, bgt, sv = world
    out = cs.trace_phase(torch.device("cpu"), str(tmp_path), bgt, fa, sv)
    kind, left, svlen = min(sv, key=lambda e: (abs(e[2]), e[1]))
    assert out["sv"] == [kind, left, svlen] and out["region"][0] <= left < out["region"][1]
    assert out["records"] > 0 and out["launches"] == {}
    assert all(out["ranges"][k] >= 1 for k in cs.TRACE_KERNELS)
    assert out["bytes"] > 0 and out["events"] > 0 and out["overhang_us"] <= cs.TRACE_SLACK_US


def test_full_pipeline_profile(world, tmp_path):
    """full_pipeline --profile d writes one file with a range for each
    stage that ran, inside the command's."""
    from biograph_tpu_torch import cli

    cs = _chip_smoke()
    _, fq, fa, _, _ = world
    d = tmp_path / "trace"
    cli.main(["full_pipeline", "--reads", fq, "--ref", fa, "--out", str(tmp_path / "run"), "--paired",
              "--classifier-model", cs.MODEL_FILE, "--device", "cpu", "--profile", str(d)])
    assert os.listdir(d) == ["full_pipeline.json"]
    events = spans(d / "full_pipeline.json")
    (top,) = ranges(events, "full_pipeline")
    for stage in cs.PIPELINE_STAGES:
        found = ranges(events, stage)
        assert found and all(within(e, top) for e in found), stage


@pytest.mark.parametrize("command", ["stats", "query"])
def test_store_command_profile(world, tmp_path, command):
    """stats and query --profile d each write d/<command>.json naming the
    command; query's find is push_front's range."""
    from biograph_tpu_torch import cli

    _, _, _, bgt, _ = world
    d = tmp_path / "trace"
    argv = {"stats": ["stats", bgt], "query": ["query", "--biograph", bgt, "--query", "ACGTAC"]}[command]
    cli.main(argv + ["--device", "cpu", "--profile", str(d)])
    assert os.listdir(d) == [f"{command}.json"]
    events = spans(d / f"{command}.json")
    (top,) = ranges(events, command)
    if command == "query":
        found = ranges(events, log.RANGE_PREFIX + "push_front")
        assert found and all(within(e, top) for e in found)


def test_distributed_discovery_writes_a_file_a_process(world, tmp_path):
    """discovery --dist-dir on two gloo processes with --profile d: each
    process writes d/discovery.p<process-id>.json, and only those."""
    _, _, fa, bgt, _ = world
    d = tmp_path / "trace"
    argv = [sys.executable, "-m", "biograph_tpu_torch", "discovery", "--mode", "assemble", "--no-sv", "--biograph", bgt,
            "--ref", fa, "--min-depth", "5", "--out", str(tmp_path / "d.vcf"), "--dist-dir", str(tmp_path / "run"),
            "--coordinator", f"file://{tmp_path}/rendezvous", "--num-processes", "2", "--device", "cpu", "--profile", str(d)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(argv + ["--process-id", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=PROCESS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} exited {p.returncode}:\n{text[-4000:]}"
    assert sorted(os.listdir(d)) == ["discovery.p0.json", "discovery.p1.json"]
    for r in range(2):
        assert ranges(spans(d / f"discovery.p{r}.json"), "discovery")


# ---------------------------------------------------------------------------
# chip_smoke.py's device-side checks, on hand-made traces
# ---------------------------------------------------------------------------


def hand_trace(path, case):
    """A trace of one discovery call: a push4 launch inside its range, a
    PyTorch kernel launched inside aten::add; ``case`` breaks one thing."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "discovery", "pid": 1, "tid": 1, "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "bgt::push4", "pid": 1, "tid": 1, "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 150.0, "dur": 10.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "push4_kernel(ulonglong2 const*, int const*)", "pid": 0, "tid": 7, "ts": 300.0, "dur": 10.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1, "ts": 400.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 410.0, "dur": 10.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)",
         "pid": 0, "tid": 7, "ts": 500.0, "dur": 10.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": 1, "tid": 1, "ts": -50.0, "dur": 2000.0},
    ]
    if case == "event_outside":
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1, "tid": 1, "ts": 1500.0, "dur": 1.0})
    elif case == "torch_kernel_outside_ops":
        ev[5]["ts"] = 460.0
    elif case == "port_kernel_outside_range":
        ev[2]["ts"] = 250.0
    elif case == "kernel_without_launch":
        ev[6]["args"]["correlation"] = 9
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


@pytest.mark.parametrize("case", ["good", "event_outside", "torch_kernel_outside_ops", "port_kernel_outside_range",
                                  "kernel_without_launch", "launches_differ", "kernels_differ"])
def test_trace_holds_on_hand_made_traces(tmp_path, case):
    """chip_smoke.trace_holds passes the good trace and names what is wrong
    in each broken one."""
    cs = _chip_smoke()
    path = tmp_path / "t.json"
    hand_trace(path, case)
    launches = {k: 0 for k in cs.WRAPPERS}
    launches["push4"] = 1
    wrong = {
        "event_outside": "outside the discovery range",
        "torch_kernel_outside_ops": "launched outside PyTorch's operators",
        "port_kernel_outside_range": "outside its wrapper's range",
        "kernel_without_launch": "has no host launch",
        "launches_differ": "ranges against launches differ",
        "kernels_differ": "device events of push4",
    }
    if case == "launches_differ":
        launches["push_front"] = 1
    elif case == "kernels_differ":
        # two launches' ranges, one kernel
        ev = json.load(open(path))
        ev["traceEvents"].append({**ev["traceEvents"][1], "ts": 600.0, "dur": 10.0})
        json.dump(ev, open(path, "w"))
        launches["push4"] = 2
    if case == "good":
        out = cs.trace_holds(str(path), "discovery", launches, on_card=True)
        assert out["kernel_events"] == 2 and out["port_kernel_events"] == 1 and out["ranges"] == {"push4": 1}
    else:
        with pytest.raises(AssertionError, match=wrong[case]):
            cs.trace_holds(str(path), "discovery", launches, on_card=True)


def test_kernels_a_launch_reads_the_sources():
    """Each of the traced wrappers' C entry points launches one kernel, of
    the __global__ function named after it."""
    cs = _chip_smoke()
    assert {k: cs.kernels_a_launch(k) for k in cs.TRACE_KERNELS} == {
        "push4": ({"push4_kernel"}, 1), "push_front": ({"push_front_kernel"}, 1), "chain_window": ({"chain_window_kernel"}, 1),
        "beam_steps": ({"beam_steps_kernel"}, 1),
    }
    assert cs.kernels_a_launch("chain_fixed") == cs.kernels_a_launch("chain_window")
    assert cs.kernel_function("void chain_window_kernel<true>(ulonglong2 const*, int)", {"chain_window_kernel"}) == "chain_window_kernel"
    assert cs.kernel_function("void at::native::push4_kernel(int)", {"push4_kernel"}) is None
