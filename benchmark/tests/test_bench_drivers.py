"""Every driver at a tiny size on the CPU, through the harness's run (the
look for a chip skipped, the port's kernels on their plain versions), and
the check seeing the control and each fault a discovery cell can have come
out not correct."""

import importlib.util
import os
import sys
import types

import pytest
import torch

from benchmark.lib import control, discovery_check, generator, reference, spec
from benchmark.tests.test_bench_generator import tiny

SEED = 2**31 + 17


def _run_module():
    path = os.path.join(spec.HERE, "run.py")
    s = importlib.util.spec_from_file_location("benchmark_run", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


RUN = _run_module()


def tiny_cell(name):
    cell = spec.Cell(spec.load_benchmark(), name)
    cell.config = tiny(cell.config["name"])
    if "regions" in cell.mix:
        cell.mix = dict(cell.mix, regions={"count": 2, "min_bases": 3000, "max_bases": 5500}, warm_up_calls=1)
    return cell


def run(cell, seconds=0.5):
    return RUN.run(cell, SEED, seconds, False, torch.device("cpu"))


@pytest.fixture(params=["ecoli_k12_30x.wgs_call_1mb", "hg002_35x.panel_call"])
def cell(request):
    return tiny_cell(request.param)


@pytest.mark.parametrize("sample_seed", [0, 1])
def test_a_sound_run_is_correct(cell, sample_seed, monkeypatch):
    """On the benchmark's sample and on another draw of it (``--sample-seed``)."""
    monkeypatch.setattr(generator, "SAMPLE_SEED", sample_seed)
    res, lines = run(cell)
    assert res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks" and set(res["checks"]) == {"missed", "extra", "support_off"}
    names = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == names
    assert all(res["metrics"][k]["value"] > 0 for k in names)
    assert lines == [f"check {k}: {v['value']} (limit {v['limit']})" for k, v in res["checks"].items()]


def _with_call(cell, monkeypatch, alter):
    driver = cell.driver()
    real = driver.call

    def broken(state, i):
        got = real(state, i)
        records = [{"pos": p, "ref": r, "alt": a, "support": n} for p, r, a, n in state.outputs[got["out"]]]
        got["out"] = state.keep(alter(state, dict(got, out=records)))
        return got

    monkeypatch.setattr(driver, "call", broken)
    return run(cell)


def _inner_snv(state, got, recs):
    """A reported SNV well inside the call's judged span."""
    lo, hi = got.get("region", (0, len(state.genome)))
    lo, hi = max(lo, reference.END_MARGIN) + 200, min(hi, len(state.genome) - reference.END_MARGIN) - 200
    return next(r for r in recs if len(r["ref"]) == len(r["alt"]) == 1 and lo < r["pos"] < hi)


def test_half_the_work_left_out_is_not_correct(cell, monkeypatch):
    def half(state, got):
        lo, hi = got.get("region", (0, len(state.genome)))
        return [r for r in got["out"] if r["pos"] - 1 < (lo + hi) // 2]

    res, _ = _with_call(cell, monkeypatch, half)
    assert not res["correct"] and res["checks"]["missed"]["value"] > 0


def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    def alter(state, got):
        recs = [dict(r) for r in got["out"]]
        snv = _inner_snv(state, got, recs)
        snv["alt"] = next(b for b in "ACGT" if b not in (snv["ref"], snv["alt"]))
        return recs

    res, _ = _with_call(cell, monkeypatch, alter)
    assert not res["correct"] and res["checks"]["extra"]["value"] > 0


def test_a_support_altered_is_not_correct(cell, monkeypatch):
    def alter(state, got):
        recs = [dict(r) for r in got["out"]]
        snv = _inner_snv(state, got, recs)
        snv["support"] += 1
        return recs

    res, _ = _with_call(cell, monkeypatch, alter)
    assert not res["correct"] and res["checks"]["support_off"]["value"] > 0


def test_a_call_that_returns_nothing_is_not_correct(cell, monkeypatch):
    res, _ = _with_call(cell, monkeypatch, lambda state, got: [])
    assert not res["correct"]


def test_a_run_that_loads_the_jax_package_fails(cell, monkeypatch):
    def load(state, got):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return got["out"]

    with pytest.raises(ImportError):
        _with_call(cell, monkeypatch, load)


def test_the_controls_are_not_correct():
    """The reference in the program's place, its records not left-normalized
    (indels that a repeat lets move read as missed and extra), or with
    overlap depth for support (SNVs beside other variants read as support
    off)."""
    cell = tiny_cell("ecoli_k12_30x.wgs_call_1mb")
    cfg = dict(cell.config, genome_length=60000)
    cfg["variants"] = dict(cfg["variants"], hom_snvs=100, indels=60)
    from benchmark.lib import store

    g, codes, lengths, _, truth = store.library(cfg, SEED)
    ex = reference.expected_calls(g, truth, codes, lengths, cfg["library"]["read_len"])
    got = reference.judge(control.raw_form(g, truth, ex, 3), ex)
    assert got["extra"] > 0 and got["missed"] > 0 and got["support_off"] == 0
    normalized = [dict(r, pos=reference.left_normalize(g, r["pos"] - 1, r["ref"], r["alt"])[0] + 1,
                       ref=reference.left_normalize(g, r["pos"] - 1, r["ref"], r["alt"])[1],
                       alt=reference.left_normalize(g, r["pos"] - 1, r["ref"], r["alt"])[2])
                  for r in control.raw_form(g, truth, ex, 3)]
    assert reference.judge(normalized, ex) == {"missed": 0, "extra": 0, "support_off": 0}
    # the depth without the exact match of the alt path
    overlap = reference.expected_calls(g, truth, codes, lengths, cfg["library"]["read_len"], exact=False)
    got = reference.judge(control.overlap_depth(g, truth, ex, overlap, 3), ex)
    assert got["support_off"] > 0 and got["missed"] == got["extra"] == 0


def test_one_panel_in_rounds_for_every_run():
    mix = {"regions": {"count": 40, "min_bases": 2000, "max_bases": 50000}}
    a = discovery_check.region_list(mix, 4_000_000)
    assert len(set(a)) == 40 and a == discovery_check.region_list(mix, 4_000_000)
    assert all(0 <= lo < hi <= 4_000_000 for lo, hi in a)
    assert min(hi - lo for lo, hi in a) >= 2000 and max(hi - lo for lo, hi in a) <= 50000
    # one region to a bin of the genome: none overlaps another
    panel = sorted(set(a))
    assert all(p[1] <= q[0] for p, q in zip(panel, panel[1:]))
    # every round of forty calls is the whole panel, each round in its own order
    rounds = [a[r0 : r0 + 40] for r0 in range(0, len(a), 40)]
    assert all(sorted(r) == panel for r in rounds) and rounds[0] != rounds[1]
    with pytest.raises(ValueError):
        discovery_check.region_list(mix, 1_000_000)
