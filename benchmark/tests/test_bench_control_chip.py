"""The controls at each cell's own size, on three seeds, on the card's
machine: each has to come out not correct.  Run there with

    python -m pytest benchmark/tests -q -m chip -s

and read the printed readings (PERF.md keeps them beside the limits)."""

import json

import pytest

from benchmark.lib import control, discovery_check, generator, reference, spec, store

SEEDS = (901, 902, 903)


def _calls(cell, genome_length):
    """The spans a run's calls judge: the whole genome, or each region."""
    if "regions" in cell.mix:
        return [(r, cell.mix["edge_bases"]) for r in sorted(set(discovery_check.region_list(cell.mix, genome_length)))]
    return [(None, 0)]


@pytest.mark.chip
@pytest.mark.parametrize("sample_seed", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_controls_fail_at_the_cells_size(name, sample_seed, cuda_device, monkeypatch):
    """On the benchmark's sample (0) and on another draw of it (1)."""
    monkeypatch.setattr(generator, "SAMPLE_SEED", sample_seed)
    cell = spec.Cell(spec.load_benchmark(), name)
    limits = cell.mix["limits"]
    L = cell.config["library"]["read_len"]
    for seed in SEEDS:
        g, codes, lengths, _, truth = store.library(cell.config, seed)
        ex = reference.expected_calls(g, truth, codes, lengths, L)
        overlap = reference.expected_calls(g, truth, codes, lengths, L, exact=False)
        readings = {}
        for kind, recs in (("raw_form", control.raw_form(g, truth, ex, 3)),
                           ("overlap_depth", control.overlap_depth(g, truth, ex, overlap, 3))):
            worst = dict.fromkeys(limits, 0)
            for span, edge in _calls(cell, len(g)):
                got = reference.judge(recs, ex, span, edge)
                worst = {k: max(worst[k], got[k]) for k in worst}
            readings[kind] = worst
        print(json.dumps({"cell": name, "sample_seed": sample_seed, "seed": seed, **readings}), flush=True)
        assert any(readings["raw_form"][k] > limits[k] for k in ("missed", "extra"))
        assert readings["overlap_depth"]["support_off"] > limits["support_off"]
