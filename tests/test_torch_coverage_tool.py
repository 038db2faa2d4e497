"""The coverage stage of the PyTorch port against the JAX package.

The same numpy-seeded genomes and reads go through both packages (the
port's store and readmap carried across from the JAX package's arrays):
``genotyper_log10`` and ``build_donor``; ``annotate_coverage`` on hom,
absent, het, multi-allelic, symbolic and giant-deletion records, on a
library of one read length (coverage's hash route) and on one of mixed
lengths (its general route); ``annotate_pair_coverage`` on a paired library;
``run_coverage`` as a whole (the VCF, byte for byte but for the
``##source=`` line, and the features ``.npz``), with and without the joint
graph; ``run_coverage_parallel`` against ``run_coverage``; and a small
version of ``chip_smoke.py``'s trimmed, paired, diploid library, annotated.
Everything compared is integer, text or float32 computed in numpy on both
sides, so the tolerance is exact equality throughout.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_coverage_tool.py -q``.

The JAX CPU leg's coverage of the scaled workload (the 2299 records of
``tests/data/torch_scaled_leg_records.tsv``), its features and the
probabilities of a classifier it trained are kept in
``tests/data/torch_scaled_leg_coverage.tsv`` and the model in
``tests/data/torch_scaled_leg_qual_model.npz``; ``chip_smoke.py`` holds the
port on the card to both.  The slow test at the end rebuilds them from the
JAX package and compares; to write them anew:
``JAX_PLATFORMS=cpu python tests/test_torch_coverage_tool.py --write
tests/data/torch_scaled_leg_coverage.tsv
tests/data/torch_scaled_leg_qual_model.npz``.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # run as a script: the packages lie at the repo root
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index.reference import Contig as JContig, Reference as JReference
from biograph_tpu.io import vcf as jvcf
from biograph_tpu.variants import coverage_tool as jcov
from biograph_tpu_torch import convert
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io import vcf as tvcf
from biograph_tpu_torch.variants import coverage_tool as tcov

MODEL_FILE = os.path.join(REPO, "tests", "data", "torch_scaled_leg_qual_model.npz")
COVERAGE_COMMAND = (
    "JAX_PLATFORMS=cpu python tests/test_torch_coverage_tool.py --write "
    "tests/data/torch_scaled_leg_coverage.tsv tests/data/torch_scaled_leg_qual_model.npz"
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor operations: beside other test workers, more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_jax_text_hashes():
    """The JAX package caches a text's rolling-hash prefix sums under the
    text's id(), which a later array of the same length can reuse.  Every
    test starts without them."""
    from biograph_tpu.index import probes as _jprobes

    _jprobes._TEXT_HASH_CACHE.clear()


class World:
    """One read set's store and readmap in both packages (the port's carried
    across from the JAX package's arrays, on the CPU) and the reference in
    both, one contig "chr1"."""

    def __init__(self, genome, codes, lens, mate_of=None):
        self.genome = genome
        self.js = jax_build_seqset(codes, lens)
        self.jr = jax_build_readmap(self.js, codes, lens, mate_of)
        arrays = {k: np.asarray(getattr(self.js, k)) for k in convert.SEQSET_DTYPES}
        arrays.update(n_entries=self.js.n_entries, max_entry_len=self.js.max_entry_len)
        self.ts = convert.seqset_from_numpy(arrays, "cpu")
        self.tr = convert.readmap_from_numpy({k: np.asarray(getattr(self.jr, k)) for k in convert.READMAP_DTYPES}, self.ts, "cpu")
        G = len(genome)
        self.jref = JReference(flat=genome, is_n=np.zeros(G, bool), contigs=[JContig("chr1", 0, G)])
        self.tref = convert.reference_from_numpy(genome, np.zeros(G, bool), [("chr1", 0, G)])


def _reads(rng, haps, L, coverage, trim=0):
    """Reads of length L at ``coverage`` from each haplotype, half
    reverse-complemented; with ``trim``, every other read is cut at its 3'
    end by 1..trim bases."""
    rows = []
    for h in haps:
        n = int(len(h) * coverage / L)
        for s in rng.integers(0, len(h) - L, n):
            rows.append(h[s : s + L])
    codes = np.stack(rows).astype(np.uint8)
    codes[::2] = (3 - codes[::2])[:, ::-1]
    lens = np.full(len(rows), L, np.int32)
    if trim:
        lens[1::2] -= rng.integers(1, trim + 1, len(lens[1::2])).astype(np.int32)
        codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    return codes, lens


def _b(codes):
    return dna.codes_to_seq(np.atleast_1d(codes))


def _variant_world_and_records(route):
    """A 5000-base genome, two haplotypes at 15x each: a hom SNP at 1000, a
    het SNP at 1500, a multi-allelic site at 2000 (a different alt on each
    haplotype), a hom 500-base deletion at 3000 (past 2 * WIN_CAP + C, so
    its windows split at the breakpoints); reads of 40 bases ("uniform") or
    of 40 less 0-12 ("mixed").  Records: those, a wrong alt at the hom SNP,
    an absent SNP, a symbolic one and a het-alt with a third allele."""
    rng = np.random.default_rng(31)
    G = 5000
    g = rng.integers(0, 4, G).astype(np.uint8)
    h1, h2 = g.copy(), g.copy()
    for h in (h1, h2):
        h[1000] = (g[1000] + 1) % 4
    h1[1500] = (g[1500] + 2) % 4
    h1[2000], h2[2000] = (g[2000] + 1) % 4, (g[2000] + 3) % 4
    h1 = np.concatenate([h1[:3001], h1[3501:]])
    h2 = np.concatenate([h2[:3001], h2[3501:]])
    codes, lens = _reads(rng, [h1, h2], 40, 15, trim=12 if route == "mixed" else 0)
    w = World(g, codes, lens)
    recs = [
        ("chr1", 1001, _b(g[1000]), _b(h1[1000])),
        ("chr1", 1001, _b(g[1000]), _b((g[1000] + 2) % 4)),
        ("chr1", 1501, _b(g[1500]), _b(h1[1500])),
        ("chr1", 2001, _b(g[2000]), _b(h1[2000]) + "," + _b(h2[2000])),
        ("chr1", 2001, _b(g[2000]), _b(h2[2000]) + "," + _b((g[2000] + 2) % 4) + "," + _b(h1[2000])),
        ("chr1", 2501, _b(g[2500]), _b((g[2500] + 1) % 4)),
        ("chr1", 2601, _b(g[2600]), "<DEL>"),
        ("chr1", 3001, _b(g[3000 : 3501]), _b(g[3000])),
        ("chr1", 4201, "N", "A"),
    ]
    return w, recs


def _records(module, recs):
    return [module.VcfRecord(chrom=c, pos=p, ref=r, alt=a, qual=float(i)) for i, (c, p, r, a) in enumerate(recs)]


ANNOTATION_FIELDS = (
    "alt_depth", "ref_depth", "gq", "pl", "us_alt", "ds_alt", "us_ref", "ds_ref",
    "xc_alt", "mc_alt", "ec_alt", "xc_ref", "mc_ref", "ec_ref", "gc_alt", "gc_ref",
)


def _same_annotation(got, want):
    assert got.gt == want.gt and got.ad == want.ad
    for name in ANNOTATION_FIELDS:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_genotyper_and_build_donor():
    tot = np.array([0, 1, 30, 30, 30, 7, 200, 5])
    alt = np.array([0, 1, 0, 15, 30, 9, 101, 2])
    got, want = tcov.genotyper_log10(tot, alt), jcov.genotyper_log10(tot, alt)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert [int(x) for x in got.argmax(axis=1)[2:5]] == [0, 1, 2]
    np.testing.assert_array_equal(tcov.genotyper_log10(tot, alt, priors=(0.1, 0.4, 0.9)), jcov.genotyper_log10(tot, alt, priors=(0.1, 0.4, 0.9)))
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 4, 300).astype(np.uint8)
    flat = [
        (10, ref[10:11], np.array([2], np.uint8)),
        (10, ref[10:12], ref[10:11]),  # overlaps the first: skipped
        (40, ref[40:50], ref[40:41]),
        (60, ref[60:61], np.concatenate([ref[60:61], rng.integers(0, 4, 7).astype(np.uint8)])),
        (298, ref[298:300], ref[298:299]),
        (299, ref[299:300], np.zeros(0, np.uint8)),  # overlaps the one before
        (299, ref[299:301], ref[299:300]),  # runs past the genome
    ]
    got, want = tcov.build_donor(ref, flat), jcov.build_donor(ref, flat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(got[2]) == [True, False, True, True, True, False, False]


@pytest.mark.parametrize("route", ["uniform", "mixed"])
def test_annotate_coverage(route, monkeypatch):
    w, recs = _variant_world_and_records(route)
    if route == "uniform":
        assert w.tr.min_read_len == w.tr.max_read_len == w.ts.max_entry_len  # the hash route
    else:
        assert w.tr.min_read_len < w.tr.max_read_len  # the general route
    want = jcov.annotate_coverage(w.jr, w.jref, _records(jvcf, recs))
    got = tcov.annotate_coverage(w.tr, w.tref, _records(tvcf, recs))
    _same_annotation(got, want)
    assert got.gt[0] == "1/1" and got.gt[2] == "0/1" and got.gt[3] == "1/2" and got.gt[5] == "0/0"
    assert got.gt[6] == got.gt[8] == "./." and got.ad[6] == "0,0" and got.alt_depth[7] > 0
    # in batches of two records: the same
    monkeypatch.setattr(tcov, "BATCH", 2)
    _same_annotation(tcov.annotate_coverage(w.tr, w.tref, _records(tvcf, recs), batch=2), want)
    empty = tcov.annotate_coverage(w.tr, w.tref, [])
    assert empty.gt == [] and empty.pl.shape == (0, 3)


def _pair_world(seed=12345, G=4000, L=40, frag=200, n=600):
    """``tests/test_coverage_tool.py``'s paired world: a hom SNP at 2000,
    mates at fragment 200, the second reverse-complemented."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    donor = genome.copy()
    donor[2000] = (donor[2000] + 1) % 4
    starts = rng.integers(0, G - frag, n)
    codes = np.empty((2 * n, L), np.uint8)
    codes[0::2] = donor[starts[:, None] + np.arange(L)]
    codes[1::2] = (3 - donor[(starts + frag - L)[:, None] + np.arange(L)])[:, ::-1]
    mate_of = np.arange(2 * n) ^ 1
    return World(genome, codes, np.full(2 * n, L, np.int32), mate_of), donor


def test_annotate_pair_coverage():
    w, donor = _pair_world()
    g = w.genome
    recs = [
        ("chr1", 1, _b(g[0]), _b((g[0] + 1) % 4)),
        ("chr1", 1201, _b(g[1200 : 1210]), _b(g[1200])),
        ("chr1", 2001, _b(g[2000]), _b(donor[2000])),
        ("chr1", 2501, _b(g[2500]), "<INS>"),
        ("chr1", 3001, _b(g[3000]), _b(g[3000]) + "ACGTACGT"),
    ]
    want = jcov.annotate_pair_coverage(w.jr, w.jref, _records(jvcf, recs))
    got = tcov.annotate_pair_coverage(w.tr, w.tref, _records(tvcf, recs))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[2] >= 10 and got[0] <= 2 and got[3] == 0
    assert tcov.annotate_pair_coverage(w.tr, w.tref, []).shape == (0,)
    assert tcov.annotate_pair_coverage(None, w.tref, _records(tvcf, recs[:1])).tolist() == [0]
    codes, lens, mate_of = w.tr.forward_reads()
    assert len(mate_of) == codes.shape[0] == w.tr.read_count and (lens == 40).all()
    assert (mate_of[mate_of] == np.arange(len(mate_of))).all() and (mate_of != np.arange(len(mate_of))).all()


def _spanning_pairs_plain(a, b, dlo, dhi, valid):
    """Pair coverage's count as a pass over every entry per record: the plain
    reference ``_spanning_pairs`` is held to."""
    pc = np.zeros(len(valid), np.int32)
    for i in np.flatnonzero(valid):
        pc[i] = int(((a <= dlo[i]) & (b >= dhi[i])).sum()) // 2
    return pc


def _trimmed_spans(rng, n, G=60_000, L=100, frag=400):
    """n pairs at fragment 400 +- 40, half the reads trimmed by 1-30 bases:
    each mate's entry [a, b), b adding the mate's own length, so the two
    entries of a pair can end apart."""
    s1 = rng.integers(0, G, n)
    s2 = s1 + rng.integers(frag - 40, frag + 41, n) - L
    lens = np.where(rng.random(2 * n) < 0.5, L - rng.integers(1, 31, 2 * n), L)
    a = np.repeat(np.minimum(s1, s2), 2)
    b = np.repeat(np.maximum(s1, s2), 2) + lens
    return a.astype(np.int64), b.astype(np.int64)


def _pair_count_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    a, b = _trimmed_spans(rng, 3000)
    dlo = rng.integers(0, 61_000, 300)
    dhi = dlo + rng.integers(0, 40, 300)
    valid = np.ones(len(dlo), bool)
    if name == "edges":  # a record from an entry's start to its end, or one past its start
        j = rng.choice(len(a), 300, replace=False)
        dlo = a[j]
        dhi = np.where(np.arange(300) % 2 == 0, b[j], a[j] + 1)
    elif name == "long_insertion":  # an allele longer than every span
        S = int((b - a).max())
        dhi[::3] = dlo[::3] + S + rng.integers(1, 50, len(dhi[::3]))
    elif name == "outside":  # records before and after every span
        dlo = np.concatenate([rng.integers(-500, int(a.min()), 50), rng.integers(int(b.max()) + 1, int(b.max()) + 500, 50)])
        dhi = dlo + 1
        valid = np.ones(100, bool)
    elif name == "odd":  # one mate's entry ends short of the record, the other's past it
        a = np.array([10, 10, 20, 20], np.int64)
        b = np.array([100, 95, 120, 120], np.int64)
        dlo = np.array([50, 50, 50, 15, 15, 25], np.int64)
        dhi = np.array([98, 101, 96, 96, 95, 121], np.int64)
        valid = np.ones(6, bool)
    elif name == "no_pairs":
        a, b = a[:0], b[:0]
    elif name == "invalid":  # symbolic alleles inside spans get 0
        valid = rng.random(len(dlo)) < 0.5
        dlo[~valid] = a[: (~valid).sum()] + 5
        dhi[~valid] = dlo[~valid] + 1
    return a, b, dlo.astype(np.int64), dhi.astype(np.int64), valid


@pytest.mark.parametrize("case", ["trimmed", "edges", "long_insertion", "outside", "odd", "no_pairs", "invalid"])
def test_spanning_pairs_matches_the_pass_over_every_entry(case):
    """Pair coverage's windowed count (spans sorted once, each record
    scanning the entries that start within the longest span before it)
    gives the per-record pass's counts exactly."""
    a, b, dlo, dhi, valid = _pair_count_case(case)
    got, kept, scanned = tcov._spanning_pairs(a, b, dlo, dhi, valid)
    want = _spanning_pairs_plain(a, b, dlo, dhi, valid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert 0 <= kept <= len(a) and 0 <= scanned <= valid.sum() * kept
    assert (got[~valid] == 0).all()
    if case == "trimmed":
        assert want.max() >= 3 and (b[0::2] != b[1::2]).any() and scanned < valid.sum() * len(a) // 10
    elif case == "edges":
        assert want.max() > 0
    elif case == "long_insertion":
        assert (got[::3] == 0).all() and got.max() > 0
    elif case == "odd":
        assert want.tolist() == [1, 1, 1, 0, 1, 0]  # of 3, 2, 3, 1, 2 and 0 entries
    elif case in ("outside", "no_pairs"):
        assert (got == 0).all() and (case == "outside" or kept == scanned == 0)
    elif case == "invalid":
        assert (~valid).any() and _spanning_pairs_plain(a, b, dlo, dhi, np.ones_like(valid))[~valid].max() > 0


@pytest.fixture(scope="module")
def diploid_paired():
    return _diploid_paired()


def _diploid_paired(seed=7):
    """A 4000-base genome, two haplotypes read as trimmed pairs at 25x: het
    SNPs close enough to be read together, in cis and in trans, a hom SNP,
    a het insertion and a het deletion."""
    rng = np.random.default_rng(seed)
    G = 4000
    g = rng.integers(0, 4, G).astype(np.uint8)
    h1, h2 = g.copy(), g.copy()
    for p in (1000, 1040, 1500, 2200, 2240):
        h1[p] = (g[p] + 1) % 4
    for p in (1530, 2250):
        h2[p] = (g[p] + 2) % 4
    for h in (h1, h2):
        h[2600] = (g[2600] + 3) % 4
    ins = rng.integers(0, 4, 6).astype(np.uint8)
    h1 = np.concatenate([h1[:3001], ins, h1[3001:]])
    h2 = np.concatenate([h2[:3401], h2[3406:]])
    haps = [h1, h2]
    rows, mates = [], []
    for i in range(1600):
        h = haps[i % 2]
        f = int(rng.integers(180, 260))
        s = int(rng.integers(0, len(h) - f))
        rows.append(h[s : s + 60])
        rows.append((3 - h[s + f - 60 : s + f])[::-1])
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), 60, np.int32)
    lens[1::4] -= rng.integers(1, 15, len(lens[1::4])).astype(np.int32)
    codes = np.where(np.arange(60)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    w = World(g, codes, lens, np.arange(len(rows)) ^ 1)
    recs = [("chr1", p + 1, _b(g[p]), _b(h1[p] if h1[p] != g[p] else h2[p])) for p in (1000, 1040, 1500, 1530, 2200, 2240, 2250, 2600)]
    recs.insert(7, ("chr1", 2251, _b(g[2250]), _b((g[2250] + 1) % 4) + "," + _b(h2[2250])))
    recs += [("chr1", 3001, _b(g[3000]), _b(g[3000]) + _b(ins)), ("chr1", 3401, _b(g[3400:3406]), _b(g[3400]))]
    return w, recs


def _write_input(module, path, recs, contigs):
    with module.VcfWriter(str(path), contigs=contigs) as wr:
        for r in _records(module, recs):
            wr.write(r)


def _run_both(w, recs, tmp_path, **kw):
    """run_coverage of both packages on the same input VCF: (port VCF text,
    JAX VCF text, port features, JAX features, port annotation)."""

    class JBG:
        readmap = w.jr

    class TBG:
        readmap = w.tr

    contigs = [("chr1", len(w.genome))]
    _write_input(jvcf, tmp_path / "in.vcf", recs, contigs)
    jcov.run_coverage(str(tmp_path / "in.vcf"), str(tmp_path / "j.vcf"), JBG, w.jref, sample="S1", features_out=str(tmp_path / "j.npz"), **kw)
    ann = tcov.run_coverage(str(tmp_path / "in.vcf"), str(tmp_path / "t.vcf"), TBG, w.tref, sample="S1", features_out=str(tmp_path / "t.npz"), **kw)
    return (
        (tmp_path / "t.vcf").read_text(), (tmp_path / "j.vcf").read_text(),
        dict(np.load(tmp_path / "t.npz")), dict(np.load(tmp_path / "j.npz")), ann,
    )


def _same_features(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("joint_graph", [False, True])
def test_run_coverage_vcf_and_features(diploid_paired, tmp_path, joint_graph):
    w, recs = diploid_paired
    got, want, gf, wf, ann = _run_both(w, recs, tmp_path, joint_graph=joint_graph)
    assert "##source=biograph_tpu\n" in want
    assert got.replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == want
    _same_features(gf, wf)
    body = [ln.split("\t") for ln in got.splitlines() if not ln.startswith("#")]
    assert len(body) == len(recs) and ("VG=" in body[0][7]) == joint_graph
    assert any("|" in f[9] for f in body) and all("PC=" in f[7] for f in body)
    assert gf["pair_cov"].max() > 0 and "ad_ratio" in gf


def test_run_coverage_without_pairs_or_phase(diploid_paired, tmp_path):
    w, recs = diploid_paired
    got, want, gf, wf, _ = _run_both(w, recs, tmp_path, pair_cov=False, phase=False)
    assert got.replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == want
    _same_features(gf, wf)
    assert "|" not in got and (gf["pair_cov"] == 0).all()


def _far_records(g):
    """Records in three groups 1500 bases apart, for region chunks."""
    out = []
    for base in (200, 1700, 3200):
        for p in (base, base + 30, base + 70):
            out.append(("chr1", p + 1, _b(g[p]), _b((g[p] + 1) % 4)))
    return out


def test_region_chunks_and_parallel_equals_serial(diploid_paired, tmp_path):
    w, _ = diploid_paired
    recs = _far_records(w.genome)
    chunks = tcov._region_chunks(_records(tvcf, recs), 2, safe_gap=1000)
    assert chunks == jcov._region_chunks(_records(jvcf, recs), 2, safe_gap=1000) == [(0, 3), (3, 6), (6, 9)]
    assert tcov._region_chunks([], 2) == []
    bgt = tmp_path / "sample.bgt"
    os.makedirs(bgt)
    w.ts.save(str(bgt / "seqset"))
    w.tr.save(str(bgt / "readmap"))
    refdir = tmp_path / "ref"
    os.makedirs(refdir)
    with open(refdir / "source.fasta", "w") as f:
        f.write(">chr1\n" + dna.codes_to_seq(w.genome) + "\n")
    _write_input(tvcf, tmp_path / "in.vcf", recs, [("chr1", len(w.genome))])
    args = (str(tmp_path / "in.vcf"),)
    tcov.run_coverage_parallel(*args, str(tmp_path / "serial.vcf"), str(bgt), str(refdir), n_workers=1, sample="S1",
                               features_out=str(tmp_path / "serial.npz"), device="cpu")
    tcov.run_coverage_parallel(*args, str(tmp_path / "parallel.vcf"), str(bgt), str(refdir), n_workers=2, sample="S1",
                               features_out=str(tmp_path / "parallel.npz"), safe_gap=1000, device="cpu")
    serial, parallel = (tmp_path / "serial.vcf").read_text(), (tmp_path / "parallel.vcf").read_text()
    assert serial == parallel and serial.count("\nchr1\t") == len(recs)
    _same_features(dict(np.load(tmp_path / "parallel.npz")), dict(np.load(tmp_path / "serial.npz")))
    # the reference of a worker: an artifact dir, a FASTA dir or a FASTA file
    w.tref.save(str(tmp_path / "ref.art"))
    for path in (str(tmp_path / "ref.art"), str(refdir), str(refdir / "source.fasta")):
        np.testing.assert_array_equal(tcov._load_ref_any(path).flat, w.genome)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcov.run_coverage_parallel(*args, str(tmp_path / "x.vcf"), str(bgt), str(refdir))


def test_small_trimmed_paired_library_annotated(tmp_path, monkeypatch):
    """chip_smoke.py's trimmed, paired, diploid library at a small size
    (12 000 bases, 800 pairs), its planted variants as the input VCF:
    run_coverage with pairs and phasing, identical in both packages; and
    the genotypes of well-read SNPs right."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    genome = np.random.default_rng(chip_smoke.SEED).integers(0, 4, 12_000).astype(np.uint8)
    codes, lens, mate_of, truth = chip_smoke.trimmed_paired_library(genome, 800, 30, 8, 4)
    assert len(np.unique(lens)) > 8  # the counting of many read lengths, kmax-capped
    w = World(genome, codes, lens, mate_of)
    recs = chip_smoke.truth_records(truth, "chr1")
    got, want, gf, wf, ann = _run_both(w, recs, tmp_path)
    assert got.replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == want
    _same_features(gf, wf)
    shares = chip_smoke.genotype_shares(tvcf.read_vcf(str(tmp_path / "t.vcf")), truth, "chr1")
    assert shares["het_right"] >= chip_smoke.HET_FLOOR and shares["hom_right"] >= chip_smoke.HOM_FLOOR, shares
    assert shares["phase_blocks"] > 0 and shares["pc_positive"] > 0.5


# ---------------------------------------------------------------------------
# the scaled leg's coverage and classifier, kept as data
# ---------------------------------------------------------------------------


def jax_scaled_leg_coverage(model_path):
    """The JAX package, on the CPU, on the scaled leg of ``bench.py`` (seed
    12345: a 2 Mb genome with 4000 planted SNPs, 120 000 reads of 100 bases,
    half reverse-complemented, unpaired): the 2299 records of
    ``tests/data/torch_scaled_leg_records.tsv`` written with
    ``write_discovery_vcf`` (no genotype filter), annotated by
    ``run_coverage(pair_cov=True, phase=True)``; a ``train_classifier``
    (2000 steps, seed 0) fitted on the features against the planted SNPs,
    saved to model_path, and its probabilities.  Returns the coverage file's
    (column names, rows), as ``chip_smoke.coverage_rows`` makes them."""
    from biograph_tpu.classifier.model import train_classifier
    from biograph_tpu.variants.discover import DiscoverOptions, write_discovery_vcf
    from test_torch_scoring import RECORD_COLUMNS, read_records_file
    import tempfile

    rng = np.random.default_rng(12345)
    G, L, R = 2_000_000, 100, 120_000
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    donor = genome.copy()
    snp = rng.choice(np.arange(200, G - 200), 4000, replace=False)
    donor[snp] = (donor[snp] + 1 + rng.integers(0, 3, 4000)) % 4
    starts = rng.integers(0, G - L, R)
    codes = donor[starts[:, None] + np.arange(L)]
    codes[: R // 2] = (3 - codes[: R // 2])[:, ::-1]
    lengths = np.full(R, L, np.int32)
    ref = JReference(flat=genome, is_n=np.zeros(G, bool), contigs=[JContig("chr", 0, G)])
    ss = jax_build_seqset(codes, lengths)

    class BG:
        readmap = jax_build_readmap(ss, codes, lengths)

    records = [dict(zip(RECORD_COLUMNS, r)) for r in read_records_file()]
    with tempfile.TemporaryDirectory() as tmp:
        write_discovery_vcf(tmp + "/in.vcf", ref, records, opt=DiscoverOptions(min_alt_support=5, simple_genotype_filter=False))
        jcov.run_coverage(tmp + "/in.vcf", tmp + "/out.vcf", BG, ref, features_out=tmp + "/f.npz", pair_cov=True, phase=True)
        annotated = jvcf.read_vcf(tmp + "/out.vcf")
        feats = dict(np.load(tmp + "/f.npz"))
    labels = scaled_leg_labels(annotated, genome, donor, snp)
    clf = train_classifier(feats, labels)
    clf.save(model_path)
    return _chip_smoke().coverage_rows(annotated, feats, clf.predict_proba(feats))


def scaled_leg_labels(records, genome, donor, snp):
    """True where a record is one of the planted SNPs."""
    planted = {(int(p) + 1, "ACGT"[genome[p]], "ACGT"[donor[p]]) for p in snp}
    return np.array([(r.pos, r.ref, r.alt) in planted for r in records])


def _chip_smoke():
    """``chip_smoke.py``, which holds the coverage file's format, imported
    from the repo root."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def write_coverage_file(path, names, rows):
    with open(path, "w") as f:
        f.write(
            "## The JAX package on the CPU, scaled leg of bench.py (seed 12345): run_coverage(pair_cov=True, "
            "phase=True) of the 2299 records of torch_scaled_leg_records.tsv, the feature_matrix columns, and "
            "the probabilities of train_classifier (2000 steps, seed 0; torch_scaled_leg_qual_model.npz) "
            "fitted against the planted SNPs\n"
        )
        f.write(f"## made by: {COVERAGE_COMMAND}\n")
        f.write("# " + "\t".join(names) + "\n")
        for row in rows:
            f.write("\t".join(row) + "\n")


@pytest.mark.slow
def test_scaled_leg_coverage_file_is_the_jax_packages(tmp_path):
    assert jax_scaled_leg_coverage(str(tmp_path / "model.npz")) == _chip_smoke().read_coverage_file()
    got, want = np.load(tmp_path / "model.npz"), np.load(MODEL_FILE)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "--write":
        sys.exit("usage: python tests/test_torch_coverage_tool.py --write COVERAGE.tsv MODEL.npz")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_coverage_file(sys.argv[2], *jax_scaled_leg_coverage(sys.argv[3]))
