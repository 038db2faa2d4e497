"""The port's donor-patching discovery (``variants/iterate.py``) and the
golden-parity preset (``variants/golden_parity.py``) against the JAX
package's, on the CPU.

The JAX package's own gates for these read data this repo does not hold,
so the worlds are synthetic: a genome whose donor carries dense SNP
clusters that one round of anchored discovery cannot cross, for
``discover_variants_iterative``; reads of a donor with SNPs at a depth past
the preset's 35 alt basecalls, with read errors, for
``golden_parity_calls``, also stopped at ``max_iter`` before its fixpoint
(the JAX package's exit there is kept as it is).  Tolerance: exact
equality; the golden VCF equal but for its ``##source=`` line.
"""

import os

import numpy as np
import pytest
import torch

from biograph_tpu_torch import convert


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_jax_text_hashes():
    from biograph_tpu.index import probes as _jprobes

    _jprobes._TEXT_HASH_CACHE.clear()


def _references(flat, name="chr1"):
    from biograph_tpu.index.reference import Contig, Reference

    G = len(flat)
    return Reference(flat=flat, is_n=np.zeros(G, bool), contigs=[Contig(name, 0, G)]), convert.reference_from_numpy(flat, np.zeros(G, bool), [(name, 0, G)])


def _reads(rng, donor, n, L):
    starts = rng.integers(0, len(donor) - L, n)
    codes = donor[starts[:, None] + np.arange(L)].astype(np.uint8)
    codes[1::2] = (3 - codes[1::2])[:, ::-1]
    return codes, np.full(n, L, np.int32)


@pytest.fixture(scope="module")
def divergent():
    """A 5000-base genome; the donor has 14 clusters of 3-5 SNPs within 10
    bases (no exact 12-mer anchor inside a cluster's window) and 20 lone
    SNPs; 60-base reads at about 24x, half reverse-complemented."""
    from biograph_tpu.build.readmap_build import build_readmap
    from biograph_tpu.build.seqset_build import build_seqset

    rng = np.random.default_rng(77)
    G = 5000
    flat = rng.integers(0, 4, G).astype(np.uint8)
    donor = flat.copy()
    centers = np.arange(150, G - 150, 320)[:14]
    snps = []
    for c in centers:
        snps += sorted(c + rng.choice(10, rng.integers(3, 6), replace=False))
    lone = rng.choice(np.setdiff1d(np.arange(100, G - 100), np.concatenate([np.arange(c - 40, c + 50) for c in centers])), 20, replace=False)
    snps = np.array(sorted(snps + list(lone)))
    donor[snps] = (donor[snps] + 1 + rng.integers(0, 3, len(snps))) % 4
    codes, lens = _reads(rng, donor, 2000, 60)
    js = build_seqset(codes, lens)
    jr = build_readmap(js, codes, lens)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    return (js, jr), (ts, tr), _references(flat), snps


@pytest.mark.parametrize("with_readmap", [True, False])
def test_iterative_discovery_equals_jax(divergent, with_readmap):
    from biograph_tpu.variants.discover import DiscoverOptions as JOpt
    from biograph_tpu.variants.iterate import discover_variants_iterative as jiter
    from biograph_tpu_torch.variants.discover import DiscoverOptions, discover_variants
    from biograph_tpu_torch.variants.iterate import discover_variants_iterative

    (js, jr), (ts, tr), (jref, tref), snps = divergent
    jstats, tstats = {}, {}
    want = jiter(js, jref, opt=JOpt(min_alt_support=3), readmap=jr if with_readmap else None, max_rounds=4, stats=jstats)
    got = discover_variants_iterative(ts, tref, opt=DiscoverOptions(min_alt_support=3), readmap=tr if with_readmap else None, max_rounds=4, stats=tstats)
    assert got == want
    assert tstats["rounds"] == jstats["rounds"] >= 1
    assert [tstats[f"round{r}"]["n_records"] for r in range(tstats["rounds"])] == [jstats[f"round{r}"]["n_records"] for r in range(jstats["rounds"])]
    if not with_readmap:
        return
    assert tstats["rounds"] >= 2
    one_round = discover_variants(ts, tref, opt=DiscoverOptions(min_alt_support=3), readmap=tr)
    called = {r["pos"] - 1 for r in got if len(r["ref"]) == len(r["alt"]) == 1}
    assert len(called & set(snps.tolist())) > len({r["pos"] - 1 for r in one_round} & set(snps.tolist()))


def test_iterate_helpers_equal_jax():
    """_diff_records over a donor with an insertion, a deletion and SNPs,
    and _remap_contigs over two contigs."""
    from biograph_tpu.index.reference import Contig, Reference
    from biograph_tpu.variants import iterate as jit
    from biograph_tpu_torch.variants import iterate as tit
    from biograph_tpu_torch.variants.coverage_tool import build_donor

    rng = np.random.default_rng(3)
    flat = rng.integers(0, 4, 600).astype(np.uint8)
    recs = [(50, flat[50:51], np.array([(flat[50] + 1) % 4], np.uint8)), (200, flat[200:201], np.concatenate([flat[200:201], [1, 2, 3]]).astype(np.uint8)),
            (400, flat[400:405], flat[400:401]), (401 + 100, flat[501:502], np.array([(flat[501] + 2) % 4], np.uint8))]
    donor, comp, applied = build_donor(flat, recs)
    assert applied.all()
    jref = Reference(flat=flat, is_n=np.zeros(600, bool), contigs=[Contig("a", 0, 300), Contig("b", 300, 300)])
    tref = convert.reference_from_numpy(flat, np.zeros(600, bool), [("a", 0, 300), ("b", 300, 300)])
    want = jit._diff_records(jref, flat, donor, comp)
    assert tit._diff_records(tref, flat, donor, comp, "cpu") == want and len(want) == 4
    assert [(c.name, c.start, c.length) for c in tit._remap_contigs(tref, comp)] == [(c.name, c.start, c.length) for c in jit._remap_contigs(jref, comp)]


@pytest.fixture(scope="module")
def golden_world():
    """A 2500-base genome, a donor with 12 SNPs, 50-base reads at about 80x
    with 0.3 % substitutions."""
    rng = np.random.default_rng(11)
    G = 2500
    flat = rng.integers(0, 4, G).astype(np.uint8)
    donor = flat.copy()
    snps = rng.choice(np.arange(60, G - 60), 12, replace=False)
    donor[snps] = (donor[snps] + 1 + rng.integers(0, 3, 12)) % 4
    codes, lens = _reads(rng, donor, 4000, 50)
    hit = rng.random(codes.shape) < 0.003
    codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return _references(flat), codes, lens, snps


@pytest.mark.parametrize("max_iter", [8, 1])
def test_golden_parity_calls_equal_jax(golden_world, max_iter, tmp_path):
    from biograph_tpu.variants.golden_parity import golden_parity_calls as jcalls, write_golden_parity_vcf as jwrite
    from biograph_tpu_torch.variants.golden_parity import golden_parity_calls, write_golden_parity_vcf

    (jref, tref), codes, lens, snps = golden_world
    want = jcalls(jref, codes, lens, max_iter=max_iter)
    got = golden_parity_calls(tref, codes, lens, max_iter=max_iter, device="cpu")
    assert [(c.chrom, c.pos, c.ref, c.alt, c.depth, c.counts.tolist()) for c in got] == [(c.chrom, c.pos, c.ref, c.alt, c.depth, c.counts.tolist()) for c in want]
    assert {c.pos - 1 for c in got} == set(snps.tolist())
    jwrite(str(tmp_path / "jax.vcf"), want)
    write_golden_parity_vcf(str(tmp_path / "torch.vcf"), got)
    a, b = (open(tmp_path / f).read().splitlines() for f in ("jax.vcf", "torch.vcf"))
    assert [x for x in a if not x.startswith("##source=")] == [x for x in b if not x.startswith("##source=")]
    assert os.path.getsize(tmp_path / "torch.vcf") > 0
