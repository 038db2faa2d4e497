"""The SDK helpers of the PyTorch port (``biograph_tpu_torch/utils``)
against the JAX package's, on ``tests/test_sdk_helpers.py``'s world (a
3000-base genome with a hom SNP at 1500, reads of 60 bases every 4 bases,
odd rows reverse-complemented): ``find_region_variants`` (records and
coverage), ``visualize`` (the text) and ``genotyper``, through the port's
``BioGraph`` on a ``.bgt`` of the same store.  Tolerance: exact equality.
"""

import os

import numpy as np
import pytest
import torch

import biograph_tpu.utils as jutils
import biograph_tpu_torch.utils as tutils
from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index.reference import Contig as JContig, Reference as JReference
from biograph_tpu_torch import convert
from biograph_tpu_torch.api import BioGraph


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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(99)
    G = 3000
    flat = rng.integers(0, 4, G).astype(np.uint8)
    donor = flat.copy()
    donor[1500] = (donor[1500] + 1) % 4
    codes = np.stack([donor[s : s + 60] for s in range(0, G - 60, 4)]).astype(np.uint8)
    codes[1::2] = (3 - codes[1::2])[:, ::-1]
    lens = np.full(len(codes), 60, np.int32)
    js = jax_build_seqset(codes, lens)
    jr = jax_build_readmap(js, codes, lens)

    class JBG:
        seqset, readmap = js, jr

        @staticmethod
        def seq_coverage(seq):
            import jax.numpy as jnp

            f, r = jr.coverage(jnp.asarray(np.asarray(seq)[None, :]), jnp.asarray([len(seq)], np.int32))
            return np.asarray(f + r)[0]

    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    path = str(tmp_path_factory.mktemp("sdk") / "sample.bgt")
    os.makedirs(path)
    ts.save(os.path.join(path, "seqset"))
    tr.save(os.path.join(path, "readmap"))
    jref = JReference(flat=flat, is_n=np.zeros(G, bool), contigs=[JContig("chr1", 0, G)])
    tref = convert.reference_from_numpy(flat, np.zeros(G, bool), [("chr1", 0, G)])
    return JBG, BioGraph(path, device="cpu"), jref, tref, donor


@pytest.mark.parametrize("span,min_support", [((1300, 1700), 5), ((0, 3000), 1), ((100, 900), 5)])
def test_find_region_variants(world, span, min_support):
    jbg, bg, jref, tref, donor = world
    want = jutils.find_region_variants(jbg, jref, "chr1", *span, min_support=min_support)
    got = tutils.find_region_variants(bg, tref, "chr1", *span, min_support=min_support)
    assert (got.chrom, got.start, got.end) == (want.chrom, want.start, want.end)
    assert got.variants == want.variants
    np.testing.assert_array_equal(got.coverage, want.coverage)
    assert got.coverage.max() > 5
    if span[0] <= 1500 < span[1]:
        assert (1501, "ACGT"[tref.flat[1500]], "ACGT"[donor[1500]]) in {(v["pos"], v["ref"], v["alt"]) for v in got.variants}
    with pytest.raises(ValueError, match="bad region"):
        tutils.find_region_variants(bg, tref, "chr1", 10, 10)


def test_visualize_and_genotyper(world):
    jbg, bg, jref, tref, _ = world
    got = tutils.visualize(bg, tref, "chr1", 1480, 1620, width=50)
    assert got == jutils.visualize(jbg, jref, "chr1", 1480, 1620, width=50)
    assert "X" in got and "chr1:1480" in got and "chr1:1580" in got
    tot, alt = np.array([0, 10, 30, 30, 7]), np.array([0, 1, 15, 30, 9])
    gts, gq = tutils.genotyper(tot, alt)
    jgts, jgq = jutils.genotyper(tot, alt)
    assert list(gts) == list(jgts) and gq.tolist() == jgq.tolist()
    assert tutils.genotyper(30, 15) == jutils.genotyper(30, 15) == ("0/1", tutils.genotyper(30, 15)[1])
