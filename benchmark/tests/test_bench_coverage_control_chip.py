"""The coverage cell's controls at the cell's own size, on three seeds, on
the card's machine: each has to come out not correct in every region.  Run
there with

    python -m pytest benchmark/tests/test_bench_coverage_control_chip.py -q -m chip -s

and read the printed readings (PERF.md keeps them beside the limits)."""

import json

import pytest

from benchmark.lib import coverage_check, coverage_control, coverage_reference, spec, store

SEEDS = (911, 912, 913)


@pytest.mark.chip
def test_coverage_controls_fail_at_the_cells_size(cuda_device):
    cell = spec.Cell(spec.load_benchmark(), "hg002_35x.coverage")
    limits = cell.mix["limits"]
    L = cell.config["library"]["read_len"]
    for seed in SEEDS:
        g, codes, lengths, _, truth = store.library(cell.config, seed)
        truths = coverage_check.true_records(g, truth)
        records = sorted(truths + coverage_check.decoy_records(g, truths, cell.config["vcf"], L))
        sample = coverage_reference.Sample(g, codes, lengths, truth)
        for k, region in enumerate(coverage_check.regions(len(g), cell.mix["region_bases"])):
            recs = coverage_check.in_region(records, region)
            ex = coverage_reference.expected(sample, recs, L)
            rows = {"features": len(recs)}
            readings = {kind: coverage_reference.compare(ex, recs, control(sample, recs, L), rows)
                        for kind, control in (("overlap_depth", coverage_control.overlap_depth),
                                              ("swapped_priors", coverage_control.swapped_priors))}
            print(json.dumps({"seed": seed, "region": k, "records": len(recs), "open": int(ex.open.sum()), **readings}),
                  flush=True)
            assert readings["overlap_depth"]["ad_off"] > limits["ad_off"]
            assert readings["swapped_priors"]["gt_off"] > limits["gt_off"]
