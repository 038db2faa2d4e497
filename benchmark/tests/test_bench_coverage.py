"""The coverage cell at a tiny size on the CPU: its regions, its VCFs, its
readers, and a run through the harness, sound and with a fault."""

import json
import shutil
import types

import pytest
import torch

from benchmark.lib import coverage_check, coverage_reference, spec, store
from benchmark.tests.test_bench_drivers import RUN, SEED

CELL = "hg002_35x.coverage"
NEW_READERS = ("coverage.annotate_ms.cov", "coverage.pairs_ms.cov", "coverage.place_ms.cov", "coverage.phase_ms.cov",
               "coverage.walk_ops_per_record.cov", "kernels.push_front_us.cov", "device.idle_share.cov")


def tiny_cell(length=40_000):
    cell = spec.Cell(spec.load_benchmark(), CELL)
    c = json.loads(json.dumps(cell.config))
    scale = length / c["genome_length"]
    c["genome_length"] = length
    v = c["variants"]
    for k in ("het_snvs", "hom_snvs", "indels"):
        v[k] = round(v[k] * scale)
    v.update(hom_dels=1, het_dels=1, insertions=1)
    cell.config = c
    cell.mix = dict(cell.mix, region_bases=length // 2)
    return cell


@pytest.mark.parametrize("length, step",
                         [(4_000_000, 500_000), (4_000_123, 500_000), (60_000, 20_000), (10_000, 20_000)])
def test_regions_cover_the_slice_once(length, step):
    regions = coverage_check.regions(length, step)
    assert regions[0][0] == 0 and regions[-1][1] == length
    assert all(a[1] == b[0] for a, b in zip(regions, regions[1:]))
    assert all(lo < hi for lo, hi in regions)
    assert len(regions) == max(length // step, 1)


def test_the_mixs_regions():
    cell = spec.Cell(spec.load_benchmark(), CELL)
    regions = coverage_check.regions(cell.config["genome_length"], cell.mix["region_bases"])
    assert regions == [(k * 500_000, (k + 1) * 500_000) for k in range(8)]


def test_each_regions_vcf_holds_its_records_and_decoys(monkeypatch):
    cell = tiny_cell(60_000)
    monkeypatch.setattr(store, "build", lambda *a: (None, None))
    state = coverage_check.State(cell, SEED, torch.device("cpu"))
    try:
        g, truth = state.genome, state.truth
        truths = coverage_check.true_records(g, truth)
        decoys = sorted(set(state.records) - set(truths))
        assert len(truths) == len(truth["small"]) + len(truth["sv"])
        assert len(decoys) == len(truths) // cell.config["vcf"]["decoy_every"] > 0
        gap = cell.config["vcf"]["decoy_gap"]
        for p, r, _ in decoys:
            assert all(p + len(r) + gap <= q or q + len(s) + gap <= p for q, s, _ in state.records if (q, s) != (p, r))
        # the sample carries none of them: no haplotype holds the decoy's allele
        for p, r, a in decoys:
            for hap in truth["haps"]:
                text = "".join("ACGT"[c] for c in hap)
                left = "".join("ACGT"[c] for c in g[p - 40 : p])
                right = "".join("ACGT"[c] for c in g[p + len(r) : p + len(r) + 40])
                assert left + a + right not in text
        seen = []
        for (lo, hi), path in zip(state.regions, state.vcfs):
            with open(path) as f:
                got = [(r["pos"] - 1, r["ref"], r["alt"]) for r in coverage_reference.parse_vcf(f.read())]
            assert got == [x for x in state.records if lo <= x[0] < hi]
            assert {x for x in decoys if lo <= x[0] < hi} <= set(got)
            seen += got
        assert seen == state.records
    finally:
        shutil.rmtree(state.dir, ignore_errors=True)


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_reader_without_its_span_gives_none(name):
    from biograph_tpu_torch.runtime import log

    log.take_spans()
    ctx = types.SimpleNamespace(cell=None, calls=[], spans=[], busy_s=0.0, window_s=1.0)
    assert spec.reader(name)(ctx) is None
    # spans of another program part, and device operations, but not its own
    ctx = types.SimpleNamespace(cell=None, calls=[], spans=[(0.0, 1.0, "other_kernel")], busy_s=1e-6, window_s=1.0,
                                program_spans=[(0.0, 5.0, "discover.call", {}, -1)])
    got = spec.reader(name)(ctx)
    assert got is None or name == "device.idle_share.cov"


def test_a_sound_run_is_correct():
    res, lines = RUN.run(tiny_cell(), SEED, 0.5, False, torch.device("cpu"))
    assert res["correct"], res
    assert set(res["checks"]) == {"ad_off", "pc_off", "gt_off", "ps_off", "lost"}
    assert all(v["value"] == 0 for v in res["checks"].values())
    assert set(res["metrics"]) == {"call_kbp_per_s", "setup_s"} and res["metrics"]["call_kbp_per_s"]["value"] > 0


def test_an_altered_depth_is_not_correct(monkeypatch):
    cell = tiny_cell()
    driver = cell.driver()
    real = driver.call

    def broken(state, i):
        got = real(state, i)
        text, rows = state.outputs[got["out"]]
        lines = text.splitlines(True)
        k = next(i for i, ln in enumerate(lines) if not ln.startswith("#"))
        cols = lines[k].split("\t")
        keys, vals = cols[8].split(":"), cols[9].rstrip("\n").split(":")
        ad = vals[keys.index("AD")].split(",")
        vals[keys.index("AD")] = f"{ad[0]},{int(ad[1]) + 1}"
        cols[9] = ":".join(vals) + "\n"
        lines[k] = "\t".join(cols)
        key = ("altered", i)
        state.outputs[key] = ("".join(lines), rows)
        return dict(got, out=key)

    monkeypatch.setattr(driver, "call", broken)
    res, _ = RUN.run(cell, SEED, 0.5, False, torch.device("cpu"))
    assert not res["correct"] and res["checks"]["ad_off"]["value"] > 0
