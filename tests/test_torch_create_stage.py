"""The create-stage phases of ``chip_smoke.py`` rehearsed on CPU tensors at a
toy size (the kernel wrappers take their plain versions there): the
partitioned build of the main path's reads, leg 3 through the port's CLI
held to the JAX package's digests of the same toy leg, the merge checks and
the whole-genome build under a budget of the test's choosing.  A phase
given a wrong answer must fail."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_create_phases_at_toy_size_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.syspath_prepend(os.path.join(REPO, "tests"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    import chip_smoke as cs
    from test_torch_cli import jax_create_leg

    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.build.seqset_build import build_seqset

    monkeypatch.setattr(cs, "GENOME", 20_000)
    monkeypatch.setattr(cs, "READS", 1000)
    monkeypatch.setattr(cs, "SNPS", 16)
    monkeypatch.setattr(cs, "TRIMMED", dict(n_pairs=1500, n_het=30, n_hom=10, n_indel=4))
    monkeypatch.setattr(cs, "SAMPLED", 64)
    dev = torch.device("cpu")
    genome, codes, lengths = cs.simulate(cs.GENOME, cs.READS, cs.SNPS, cs.READ_LEN)[:3]
    ss = build_seqset(codes, lengths, device="cpu")
    rm = build_readmap(ss, codes, lengths, device="cpu")

    parted = cs.create_partitioned_scaled_phase(dev, codes, lengths, ss)
    assert parted["passes"] >= cs.SCALED_PASSES and parted["rows"] == 200_000
    other = build_seqset(codes[1:], lengths[1:], device="cpu")
    with pytest.raises(AssertionError, match="differs|entries"):
        cs.create_partitioned_scaled_phase(dev, codes, lengths, other)

    os.makedirs(tmp_path / "jax")
    want = jax_create_leg(str(tmp_path / "jax"))
    monkeypatch.setattr(cs, "read_create_leg_file", lambda: want)
    os.makedirs(tmp_path / "torch")
    corrected, launches, bgt, reads3 = cs.create_corrected_phase(dev, genome, str(tmp_path / "torch"))
    assert corrected["reads"] == 3000 and corrected["corrected"] == want["correction"]["corrected"] > 0
    assert set(corrected["runs"]) == {"cold", "warm"} and set(launches) == set(cs.WRAPPERS)
    assert set(corrected["runs"]["cold"]["stages"]) == {"import", "kmerize", "read_correction", "seqset", "readmap"}
    assert len(reads3[1]) == 3000 - want["correction"]["dropped"]
    bad = dict(want, kmers=dict(want["kmers"], distinct=1))
    monkeypatch.setattr(cs, "read_create_leg_file", lambda: bad)
    os.makedirs(tmp_path / "bad")
    with pytest.raises(AssertionError, match="kmers differ"):
        cs.create_corrected_phase(dev, genome, str(tmp_path / "bad"))

    merged, merge_launches = cs.merge_checks(dev, ss, rm, codes, lengths, bgt, reads3, genome)
    assert merged["merged_entries"] >= max(merged["entries"]) and min(merged["coverage_reads_summed"]) > 0
    assert merged["scaled_windows_differing"] == 0
    with pytest.raises(AssertionError, match="both read sets"):
        cs.merge_checks(dev, ss, rm, codes, lengths, bgt, (reads3[0][1:], reads3[1][1:]), genome)

    full = cs.create_partitioned_full_phase(dev, None, budget=10 << 20)
    assert full["reads"] == -(-2 * (10 << 20) // (2 * 100 * 240))
    assert [b["budget"] for b in full["builds"]] == [10 << 20, 5 << 20]
    assert all(b["passes"] >= 2 for b in full["builds"]) and full["found"] == 64
    assert full["builds"][1]["passes"] > full["builds"][0]["passes"]
