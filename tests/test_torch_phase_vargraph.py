"""Phasing and the variant graph of the PyTorch port against the JAX
package.

``phase_records`` on ``tests/test_phase.py``'s cases (a cis pair and a trans
pair, each its own block; two hets farther apart than a read, unphased; hom
and multi-allelic records left out), on a library of one read length and on
one of mixed lengths, where ``coverage_events`` takes the general route; a
conflict (reads for both cis and trans) that splits a block.
``evaluate_vargraph`` on ``tests/test_vargraph.py``'s cases (a cis het pair,
a trans multi-allelic site, a hom deletion beside an unsupported edge, a
symbolic record, a het beside junk), every field held to the JAX package's,
with the port's clusters in one coverage call or several.  The port's store
is carried across from the JAX package's arrays.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index.reference import Contig as JContig, Reference as JReference
from biograph_tpu.io import vcf as jvcf
from biograph_tpu.variants.phase import phase_records as jax_phase
from biograph_tpu.variants.vargraph import evaluate_vargraph as jax_vargraph
from biograph_tpu_torch import convert
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io import vcf as tvcf
from biograph_tpu_torch.variants import vargraph as tvargraph
from biograph_tpu_torch.variants.phase import phase_records


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(genome, codes, lens):
    js = jax_build_seqset(codes, lens)
    jr = jax_build_readmap(js, codes, lens)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    G = len(genome)
    jref = JReference(flat=genome, is_n=np.zeros(G, bool), contigs=[JContig("chr1", 0, G)])
    tref = convert.reference_from_numpy(genome, np.zeros(G, bool), [("chr1", 0, G)])
    return jr, tr, jref, tref


def _tiled_reads(haps, read_len, step, trim_rng=None):
    """``tests/test_phase.py``'s reads: every step bases along each
    haplotype; with trim_rng, every third read loses 1-15 bases at its end."""
    rows = [h[s : s + read_len] for h in haps for s in range(0, len(h) - read_len + 1, step)]
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), read_len, np.int32)
    if trim_rng is not None:
        lens[::3] -= trim_rng.integers(1, 16, len(lens[::3])).astype(np.int32)
        codes = np.where(np.arange(read_len)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    return codes, lens


def _snp(hap, pos, flat, k=1):
    hap[pos] = (flat[pos] + k) % 4
    return "ACGT"[flat[pos]], "ACGT"[hap[pos]]


def _phase_case(name, mixed):
    rng = np.random.default_rng(12345)
    G = 800 if name == "far" else 600
    flat = rng.integers(0, 4, G).astype(np.uint8)
    hap1, hap2 = flat.copy(), flat.copy()
    if name == "cis_trans":
        alleles = [_snp(hap1, 200, flat), _snp(hap1, 240, flat), _snp(hap1, 400, flat), _snp(hap2, 430, flat)]
        where, gt = (200, 240, 400, 430), ["0/1"] * 4
        haps = [hap1, hap2]
    elif name == "far":
        alleles = [_snp(hap1, 200, flat), _snp(hap1, 500, flat)]
        where, gt = (200, 500), ["0/1", "0/1"]
        haps = [hap1, flat.copy()]
    elif name == "conflict":
        # hap1 and hap2 carry one of the alts at 200 and 240 each, a third
        # haplotype both and a fourth neither: cis and trans evidence, so
        # 200-240 splits; 240-300 is trans
        hap3 = flat.copy()
        alleles = [_snp(hap1, 200, flat), _snp(hap2, 240, flat), _snp(hap1, 300, flat)]
        _snp(hap3, 200, flat)
        _snp(hap3, 240, flat)
        where, gt = (200, 240, 300), ["0/1", "1/0", "0/1"]
        haps = [hap1, hap2, hap3, flat.copy()]
    else:  # hom and multi-allelic records are left out
        alleles = [_snp(hap1, 200, flat), ("A", "C,G"), ("A", "C")]
        where, gt = (200, 220, 240), ["0/1", "1/2", "1/1"]
        haps = [hap1, flat.copy()]
    codes, lens = _tiled_reads(haps, 100, 7, np.random.default_rng(3) if mixed else None)
    recs = [("chr1", p + 1, r, a) for p, (r, a) in zip(where, alleles)]
    return flat, codes, lens, recs, gt


@pytest.mark.parametrize(
    "name,mixed",
    [("cis_trans", False), ("cis_trans", True), ("far", False), ("conflict", False), ("conflict", True), ("hom_and_multiallelic", False)],
)
def test_phase_records(name, mixed):
    flat, codes, lens, recs, gt = _phase_case(name, mixed)
    jr, tr, jref, tref = _both(flat, codes, lens)
    if mixed:
        assert tr.min_read_len < tr.max_read_len  # coverage_events on the general route
    want = jax_phase(jr, jref, [jvcf.VcfRecord(*r) for r in recs], gt)
    got = phase_records(tr, tref, [tvcf.VcfRecord(*r) for r in recs], gt)
    assert (got.gt, got.ps, got.n_blocks, got.n_linked) == (want.gt, want.ps, want.n_blocks, want.n_linked)
    if name == "cis_trans":
        assert got.n_blocks == 2 and got.gt[0] == got.gt[1] and got.gt[2] != got.gt[3] and got.ps == [201, 201, 401, 401]
    elif name == "far":
        assert got.n_blocks == 0 and got.ps == [None, None]
    elif name == "conflict":
        assert got.ps[0] is None and got.ps[1] == got.ps[2] == 241  # 200-240 split, 240-300 linked
    else:
        assert got.gt == gt and got.n_blocks == 0
    assert phase_records(None, tref, [tvcf.VcfRecord(*r) for r in recs], gt).gt == gt


def _vargraph_case(name):
    """``tests/test_vargraph.py``'s worlds: a 900-base reference, reads of
    40 every 2 bases along each haplotype, half reverse-complemented."""
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 900).astype(np.uint8)
    b = dna.codes_to_seq
    hap1, hap2 = ref.copy(), ref.copy()
    if name == "cis_het_pair":
        hap1[400], hap1[420] = (ref[400] + 1) % 4, (ref[420] + 2) % 4
        haps, records = [hap1, ref], [("chr1", 401, b(ref[400:401]), b(hap1[400:401])), ("chr1", 421, b(ref[420:421]), b(hap1[420:421]))]
    elif name == "trans_multiallelic":
        hap1[500], hap2[500] = (ref[500] + 1) % 4, (ref[500] + 2) % 4
        haps, records = [hap1, hap2], [("chr1", 501, b(ref[500:501]), b(hap1[500:501]) + "," + b(hap2[500:501]))]
    elif name == "hom_and_unsupported":
        hap = np.concatenate([ref[:600], ref[610:]])
        haps = [hap, hap]
        records = [("chr1", 600, b(ref[599:610]), b(ref[599:600])), ("chr1", 640, b(ref[639:640]), b((ref[639:640] + 1) % 4))]
    elif name == "symbolic":
        haps, records = [ref], [("chr1", 100, "A", "<DEL>")]
    else:  # a het beside junk, and records in many clusters
        hap1[700] = (ref[700] + 1) % 4
        haps = [hap1, ref]
        records = [("chr1", p + 1, b(ref[p : p + 1]), b((ref[p : p + 1] + 1) % 4)) for p in range(40, 680, 50)]
        records += [("chr1", 701, b(ref[700:701]), b(hap1[700:701])), ("chr1", 705, b(ref[704:705]), b((ref[704:705] + 3) % 4))]
    rows = []
    flip = np.random.default_rng(9)
    for h in haps:
        for s in range(0, len(h) - 40 + 1, 2):
            r = h[s : s + 40].copy()
            if flip.random() < 0.5:
                r = (3 - r)[::-1].copy()
            rows.append(r)
    codes = np.stack(rows).astype(np.uint8)
    return ref, codes, np.full(len(rows), 40, np.int32), records


@pytest.fixture(scope="module")
def vargraph_worlds():
    """Each case's port readmap and reference, records and the JAX
    package's result, made once."""
    made = {}

    def get(name):
        if name not in made:
            ref, codes, lens, records = _vargraph_case(name)
            jr, tr, jref, tref = _both(ref, codes, lens)
            made[name] = (tr, tref, records, jax_vargraph(jr, jref, [jvcf.VcfRecord(*r) for r in records]))
        return made[name]

    return get


@pytest.mark.parametrize("path_rows", [1, 256])
@pytest.mark.parametrize("name", ["cis_het_pair", "trans_multiallelic", "hom_and_unsupported", "symbolic", "junk_and_many"])
def test_evaluate_vargraph(vargraph_worlds, name, path_rows, monkeypatch):
    tr, tref, records, want = vargraph_worlds(name)
    calls = []
    real = tr.coverage
    monkeypatch.setattr(tr, "coverage", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tvargraph, "PATH_ROWS", path_rows)
    got = tvargraph.evaluate_vargraph(tr, tref, [tvcf.VcfRecord(*r) for r in records])
    assert got.gt == want.gt
    assert [e.tolist() for e in got.edge_reads] == [np.asarray(e).tolist() for e in want.edge_reads]
    for field in ("ref_reads", "cluster_of", "n_paths"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=field)
    clusters = len({c for c in got.cluster_of if c >= 0})
    assert len(calls) == (clusters if path_rows == 1 else min(clusters, 1))
    if name == "trans_multiallelic":
        assert got.gt == ["1/2"] and got.ref_reads[0] == 0
    elif name == "symbolic":
        assert got.gt == ["./."] and got.cluster_of[0] == -1
    elif name == "junk_and_many":
        assert got.gt[-2] == "0/1" and got.gt[-1] in ("0/0", "./.") and clusters > 10
