"""The port's coverage stage against its plain reference: ``run_coverage``
(``variants/coverage_tool.py``) on the VCF of a small diploid sample, held
to ``tests/plain_coverage.py`` record by record, AD, DP, PC, GT, GQ, PL and
PS exactly; the comparison seeing each kind of fault; the benchmark's copy
of the reference the same code.

The sample is the coverage benchmark's (``benchmark/configs/hg002_35x_vcf
.json``) at 60 kb: 35x of 2x150 pairs, half of the reads trimmed, a few
structural variants, every variant a record in left-normalized form, one
decoy in 11.  Run alone on the CPU: ``python -m pytest
tests/test_torch_coverage_plain.py -q``.
"""

import copy
import functools
import json
import os

import numpy as np
import pytest
import torch

import plain_coverage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (2**31 + 7, 11, -5)
GENOME = 60_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    with open(os.path.join(REPO, "benchmark", "configs", "hg002_35x_vcf.json")) as f:
        c = json.load(f)
    scale = GENOME / c["genome_length"]
    c["genome_length"] = GENOME
    v = c["variants"]
    for k in ("het_snvs", "hom_snvs", "indels"):
        v[k] = round(v[k] * scale)
    v.update(hom_dels=2, het_dels=2, insertions=1)
    return c


@functools.lru_cache(maxsize=None)
def _sample(seed):
    """(config, genome, reads, truth, records, the port's store) of a seed."""
    from benchmark.lib import coverage_check, store

    c = _config()
    g, codes, lengths, mate_of, truth = store.library(c, seed)
    truths = coverage_check.true_records(g, truth)
    records = sorted(truths + coverage_check.decoy_records(g, truths, c["vcf"], c["library"]["read_len"]))
    ss, rm = store.build(codes, lengths, mate_of, torch.device("cpu"))
    return c, g, codes, lengths, truth, records, ss, rm


@functools.lru_cache(maxsize=None)
def _run(seed, extras, tmp):
    """run_coverage's annotated VCF (as the reference's dicts) and feature
    rows, with pair coverage and phasing on or off."""
    from types import SimpleNamespace

    from benchmark.lib import coverage_check, store
    from biograph_tpu_torch.variants.coverage_tool import run_coverage

    c, g, _, _, _, records, ss, rm = _sample(seed)
    vin, vout, feats = (os.path.join(tmp, f"{seed}.{extras}.{x}") for x in ("in.vcf", "out.vcf", "f.npz"))
    coverage_check.write_vcf(vin, "chr1", len(g), records)
    run_coverage(vin, vout, SimpleNamespace(seqset=ss, readmap=rm), store.reference(g, "chr1"), sample="S",
                 features_out=feats, pair_cov=extras, phase=extras)
    with open(vout) as f:
        got = plain_coverage.parse_vcf(f.read())
    with np.load(feats) as z:
        rows = {k: len(z[k]) for k in z.files}
    return got, rows


@functools.lru_cache(maxsize=None)
def _expected(seed, extras):
    c, g, codes, lengths, truth, records, _, _ = _sample(seed)
    sample = plain_coverage.Sample(g, codes, lengths, truth)
    return sample, plain_coverage.expected(sample, records, c["library"]["read_len"], extras, extras)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("coverage_plain"))


@pytest.mark.parametrize("extras", [True, False], ids=["pairs_phase", "depths_alone"])
@pytest.mark.parametrize("seed", SEEDS)
def test_run_coverage_equals_the_plain_reference(seed, extras, tmp):
    """Every record back in order with a feature row; AD, DP, PC, GT, GQ,
    PL and PS equal to the reference's; none left open; the sample holds
    what the comparison needs to mean something (hets, homs, decoys at
    0/0, breakpoint windows, pairs, phase blocks)."""
    got, rows = _run(seed, extras, tmp)
    _, ex = _expected(seed, extras)
    records = _sample(seed)[5]
    shown = {}
    assert plain_coverage.compare(ex, records, got, rows, examples=shown) == {
        "lost": 0, "ad_off": 0, "pc_off": 0, "gt_off": 0, "ps_off": 0, "open": 0}, shown
    assert len(got) == len(records) > 100 and set(rows.values()) == {len(records)}
    gts = {g["fmt"]["GT"] for g in got}
    assert {"0/0", "1/1"} <= gts and ({"0|1", "1|0"} & gts if extras else "0/1" in gts)
    assert max(len(r) for _, r, _ in records) > 2 * plain_coverage.WIN_CAP + 152
    if extras:
        assert all(int(g["info"]["PC"]) > 0 for g in got)
        assert sum("PS" in g["fmt"] for g in got) >= 2
    else:
        assert all(int(g["info"]["PC"]) == 0 and "PS" not in g["fmt"] for g in got)


def _altered(got, how):
    got = copy.deepcopy(got)
    i = next(i for i, g in enumerate(got) if "PS" in g["fmt"])
    if how == "depth":
        r, a = got[i]["fmt"]["AD"].split(",")
        got[i]["fmt"]["AD"] = f"{r},{int(a) + 1}"
    elif how == "genotype":
        got[i]["fmt"]["GT"] = "1/1"
    elif how == "pair_coverage":
        got[i]["info"]["PC"] = str(int(got[i]["info"]["PC"]) - 1)
    elif how == "dropped":
        del got[i]
    return got


@pytest.mark.parametrize("how, count", [("depth", "ad_off"), ("genotype", "gt_off"), ("pair_coverage", "pc_off"),
                                        ("dropped", "lost")])
def test_the_comparison_sees_a_fault(how, count, tmp):
    got, rows = _run(SEEDS[0], True, tmp)
    _, ex = _expected(SEEDS[0], True)
    records = _sample(SEEDS[0])[5]
    found = plain_coverage.compare(ex, records, _altered(got, how), rows)
    assert found[count] > 0, found
    assert plain_coverage.compare(ex, records, got, rows)[count] == 0


def test_the_controls_are_not_correct():
    """The reference in the program's place with a guarantee broken: depths
    from every read on a query by its first bases, or the genotyper's het
    and hom priors swapped."""
    from benchmark.lib import coverage_control

    c, *_, records, _, _ = _sample(SEEDS[0])
    sample, ex = _expected(SEEDS[0], True)
    L = c["library"]["read_len"]
    rows = {"c": len(records)}
    sound = plain_coverage.compare(ex, records, coverage_control.as_output(ex, records), rows)
    assert all(v == 0 for v in sound.values()), sound
    overlap = plain_coverage.compare(ex, records, coverage_control.overlap_depth(sample, records, L), rows)
    assert overlap["ad_off"] > 0
    swapped = plain_coverage.compare(ex, records, coverage_control.swapped_priors(sample, records, L), rows)
    assert swapped["gt_off"] > 0 and swapped["ad_off"] == 0


def test_the_benchmarks_copy_is_the_same_code():
    with open(os.path.join(REPO, "tests", "plain_coverage.py")) as a, \
            open(os.path.join(REPO, "benchmark", "lib", "coverage_reference.py")) as b:
        assert a.read() == b.read()
