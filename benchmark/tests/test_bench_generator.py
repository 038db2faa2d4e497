"""The frozen generator: the same inputs for the same seed, and the counts
and densities that the configurations state."""

import json
import os

import numpy as np
import pytest

from benchmark.lib import store

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def tiny(name, length=12000):
    c = config(name)
    scale = length / c["genome_length"]
    c["genome_length"] = length
    v = c["variants"]
    for k in ("het_snvs", "hom_snvs", "indels"):
        v[k] = max(round(v[k] * scale), 1 if v[k] else 0)
    v.update(hom_dels=0, het_dels=min(v["het_dels"], 1), insertions=1, big_del=0, long_insertions=0)
    return c


@pytest.mark.parametrize("name", ["ecoli_k12_30x", "hg002_35x"])
@pytest.mark.parametrize("seed", [7, 2**31 + 5, -3])
def test_same_seed_same_inputs(name, seed):
    c = tiny(name)
    a, b = store.library(c, seed), store.library(c, seed)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert a[4]["small"] == b[4]["small"] and a[4]["sv"] == b[4]["sv"]
    other = store.library(c, seed + 1)
    # one sample for every seed; the seed is a sequencing run: its reads
    assert np.array_equal(a[0], other[0]) and a[4]["small"] == other[4]["small"] and a[4]["sv"] == other[4]["sv"]
    assert all(np.array_equal(x, y) for x, y in zip(a[4]["haps"], other[4]["haps"]))
    assert not np.array_equal(a[1], other[1]) and not np.array_equal(a[4]["start"], other[4]["start"])


@pytest.mark.parametrize("name", ["ecoli_k12_30x", "hg002_35x"])
def test_counts_as_configured(name):
    c = tiny(name)
    g, codes, lengths, mate_of, truth = store.library(c, 11)
    lib, v = c["library"], c["variants"]
    n_pairs = round(c["genome_length"] * lib["depth"] / (2 * lib["read_len"]))
    assert codes.shape == (2 * n_pairs, lib["read_len"]) and len(g) == c["genome_length"]
    assert len(truth["small"]) == v["het_snvs"] + v["hom_snvs"] + v["indels"]
    assert len(truth["sv"]) == v["hom_dels"] + v["het_dels"] + v["insertions"]
    assert (mate_of[mate_of] == np.arange(len(mate_of))).all()
    full = lengths == lib["read_len"]
    if lib["trimmed_share"] == 0:
        assert full.all()
    else:
        assert abs((~full).mean() - lib["trimmed_share"]) < 0.05
        assert lengths.min() >= lib["read_len"] - 30


def test_haploid_puts_every_variant_on_both_haplotypes():
    g, codes, lengths, _, truth = store.library(tiny("ecoli_k12_30x"), 5)
    assert {v[3] for v in truth["small"]} == {2}
    assert np.array_equal(truth["haps"][0], truth["haps"][1])


def test_diploid_has_het_and_hom():
    _, _, _, _, truth = store.library(tiny("hg002_35x", 50000), 5)
    haps = [v[3] for v in truth["small"]]
    assert 0 in haps and 1 in haps and 2 in haps


def test_reads_come_from_their_haplotypes():
    c = tiny("hg002_35x")
    _, codes, lengths, _, truth = store.library(c, 9)
    L = c["library"]["read_len"]
    for i in range(0, 200, 2):
        p = i // 2
        hap = truth["haps"][truth["hap_of"][p]]
        s, f = truth["start"][p], truth["frag"][p]
        n1, n2 = lengths[i], lengths[i + 1]
        assert np.array_equal(codes[i, :n1], hap[s : s + n1])
        assert np.array_equal(codes[i + 1, :n2], (3 - hap[s + f - L : s + f])[::-1][:n2])


def test_configured_scale_and_densities():
    e = config("ecoli_k12_30x")
    assert e["genome_length"] == 4_641_652 and e["variants"]["hom_snvs"] == 10_000 and e["ploidy"] == 1
    assert round(e["genome_length"] * 30 / 300) == 464_165
    h = config("hg002_35x")
    kb = h["genome_length"] / 1e3
    v = h["variants"]
    assert abs((v["het_snvs"] + v["hom_snvs"]) / kb - 1.3) < 0.05 and v["het_snvs"] / v["hom_snvs"] == 800 / 500
    assert abs(v["indels"] / kb - 0.2) < 0.01
    assert v["hom_dels"] + v["het_dels"] + v["insertions"] == round(4 * kb / 1e3)
    assert round(h["genome_length"] * 35 / 300) == 466_667
