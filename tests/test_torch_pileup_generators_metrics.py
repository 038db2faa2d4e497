"""The pileup caller, the generator chain and the call-set metrics of the
PyTorch port against the JAX package.

``pileup_counts`` (one ``index_add_`` a batch) and ``call_snps`` on reads
placed on a genome with planted SNPs, both strands, several lengths and
reads from nowhere; ``write_pileup_vcf`` and ``run_pileup_pipeline``; the
generator chain (``parse_region`` -> ``trim_ref`` -> ``add_ref_assemblies``
-> ``generate_read_cov`` inside ``par_pipeline`` -> ``generate_pair_cov`` ->
``split_phases`` -> ``verify_order`` -> ``dedup_cov_reads`` ->
``vcf_export``) on a small paired, diploid world; ``par_pipeline``'s error
propagation, ``trim_ref`` and ``verify_order`` on ``tests/test_generators.py``'s
cases; the ``metrics`` functions on ``tests/test_metrics.py``'s cases.
Everything compared is integer or text: exact equality.
"""

import numpy as np
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index.reference import Contig as JContig, Reference as JReference
from biograph_tpu.variants import generators as jgen
from biograph_tpu.variants import metrics as jmetrics
from biograph_tpu.variants import pileup as jpileup
from biograph_tpu.variants.discover import DiscoverOptions as JOptions
from biograph_tpu_torch import convert
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.index.reference import Contig, Reference
from biograph_tpu_torch.io import vcf as tvcf
from biograph_tpu_torch.variants import align as talign
from biograph_tpu_torch.variants import generators as tgen
from biograph_tpu_torch.variants import metrics as tmetrics
from biograph_tpu_torch.variants import pileup as tpileup
from biograph_tpu_torch.variants.discover import DiscoverOptions as TOptions


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_jax_text_hashes():
    """The JAX package caches a text's rolling-hash prefix sums under the
    text's id(); every test starts without them."""
    from biograph_tpu.index import probes as _jprobes

    _jprobes._TEXT_HASH_CACHE.clear()


def _pileup_world(seed=23, G=5000, R=1500):
    """Two contigs, SNPs hom and het, reads of 40-60 bases from both
    strands, a few from nowhere."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    hap1, hap2 = genome.copy(), genome.copy()
    for p in (300, 1200, 2600, 4100):
        hap1[p] = hap2[p] = (genome[p] + 1) % 4
    for p in (700, 3300):
        hap1[p] = (genome[p] + 2) % 4
    L = 60
    codes = np.zeros((R, L), np.uint8)
    lens = rng.integers(40, L + 1, R).astype(np.int32)
    for i in range(R):
        h = hap1 if i % 2 else hap2
        n = int(lens[i])
        s = int(rng.integers(0, G - n))
        read = h[s : s + n]
        if i % 3 == 1:
            read = (3 - read)[::-1]
        if i % 97 == 5:
            read = rng.integers(0, 4, n).astype(np.uint8)
        codes[i, :n] = read
    contigs = [("chr1", 0, 3000), ("chr2", 3000, G - 3000)]
    jref = JReference(flat=genome, is_n=np.zeros(G, bool), contigs=[JContig(*c) for c in contigs])
    tref = Reference(flat=genome, is_n=np.zeros(G, bool), contigs=[Contig(*c) for c in contigs])
    return genome, codes, lens, jref, tref


def test_pileup_counts_calls_and_vcf(tmp_path):
    genome, codes, lens, jref, tref = _pileup_world()
    G = len(genome)
    pl = talign.place_reads(talign.RefKmerIndex.build(genome, 13, device="cpu"), codes, lens)
    want = jpileup.pileup_counts(G, codes, lens, pl, batch_rows=512)
    got = tpileup.pileup_counts(G, codes, lens, pl, batch_rows=512, device="cpu")
    assert got.dtype == want.dtype and got.shape == (4, G)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpileup.pileup_counts(G, codes, lens, pl, device="cpu"), want)  # one batch
    for kw in ({}, dict(min_depth=3, hom_frac=0.9, het_frac=0.1)):
        tc, jc = tpileup.call_snps(genome, got, **kw), jpileup.call_snps(genome, want, **kw)
        assert [vars(c) for c in tc] == [vars(c) for c in jc] and tc
    calls = tpileup.call_snps(genome, got)
    assert {c.genotype for c in calls} == {"0/1", "1/1"}
    tpileup.write_pileup_vcf(str(tmp_path / "t.vcf"), tref, got, calls, sample="S1")
    jpileup.write_pileup_vcf(str(tmp_path / "j.vcf"), jref, want, jpileup.call_snps(genome, want), sample="S1")
    assert (tmp_path / "t.vcf").read_text().replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == (tmp_path / "j.vcf").read_text()
    assert "chr2\t" in (tmp_path / "t.vcf").read_text()
    tpl, tcounts, tcalls = tpileup.run_pileup_pipeline(tref, codes, lens, min_depth=5, device="cpu")
    jpl, jcounts, jcalls = jpileup.run_pileup_pipeline(jref, codes, lens, min_depth=5)
    np.testing.assert_array_equal(tpl.pos, jpl.pos)
    np.testing.assert_array_equal(tcounts, jcounts)
    assert [vars(c) for c in tcalls] == [vars(c) for c in jcalls]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpileup.run_pileup_pipeline(tref, codes, lens)


def _chain_world():
    """A 6000-base genome: two haplotypes read as pairs of 60 bases at
    fragment 250, the second reverse-complemented, 20x each; het and hom
    SNPs, two het SNPs on one haplotype 45 bases apart."""
    rng = np.random.default_rng(41)
    G = 6000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    h1, h2 = genome.copy(), genome.copy()
    for p in (800, 2100, 4300):
        h1[p] = h2[p] = (genome[p] + 1) % 4
    for p in (1500, 1545, 3600):
        h1[p] = (genome[p] + 3) % 4
    rows = []
    for i in range(2 * G * 20 // 120):
        h = (h1, h2)[i % 2]
        s = int(rng.integers(0, G - 250))
        rows += [h[s : s + 60], (3 - h[s + 190 : s + 250])[::-1]]
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), 60, np.int32)
    mate_of = np.arange(len(rows)) ^ 1
    js = jax_build_seqset(codes, lens)
    jr = jax_build_readmap(js, codes, lens, mate_of)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")

    class JBG:
        seqset, readmap = js, jr

    class TBG:
        seqset, readmap = ts, tr

    jref = JReference(flat=genome, is_n=np.zeros(G, bool), contigs=[JContig("chr1", 0, G)])
    tref = Reference(flat=genome, is_n=np.zeros(G, bool), contigs=[Contig("chr1", 0, G)])
    return JBG, TBG, jref, tref


def _chain(gen, bg, ref, opt, region):
    recs = gen.parse_region(bg, ref, region, opt=opt)
    recs = gen.trim_ref(recs, ref)
    recs = gen.add_ref_assemblies(recs, ref, region)
    recs = gen.par_pipeline(lambda it: gen.generate_read_cov(bg.readmap, ref, it, chunk=4), recs)
    recs = gen.generate_pair_cov(bg.readmap, ref, recs, chunk=5)
    recs = gen.split_phases(bg.readmap, ref, recs)
    recs = gen.verify_order(recs, "post-phase")
    return list(gen.dedup_cov_reads(recs))


def _rows(records):
    return [(r.chrom, r.pos, r.ref, r.alt, dict(r.info), dict(r.fmt)) for r in records]


def test_generator_chain(tmp_path):
    JBG, TBG, jref, tref = _chain_world()
    region = "chr1:0-6000"
    want = _chain(jgen, JBG, jref, JOptions(min_alt_support=5), region)
    got = _chain(tgen, TBG, tref, TOptions(min_alt_support=5), region)
    assert _rows(got) == _rows(want)
    variants = [r for r in got if not r.info.get("REFBLOCK")]
    assert len(variants) >= 5 and got[0].info.get("REFBLOCK") and got[0].pos == 1
    assert all("PC" in r.info and int(r.fmt["DP"]) > 0 for r in variants)
    assert any("|" in str(r.fmt["GT"]) for r in variants) and any(r.fmt["GT"] == "1/1" for r in variants)
    n = tgen.vcf_export(got, str(tmp_path / "t.vcf"), tref, sample="S1")
    assert n == jgen.vcf_export(want, str(tmp_path / "j.vcf"), jref, sample="S1") == len(variants)
    assert (tmp_path / "t.vcf").read_text().replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == (tmp_path / "j.vcf").read_text()
    dup = [tvcf.VcfRecord("c", 1, "A", "T", info={"SUP": 2}), tvcf.VcfRecord("c", 1, "A", "T", info={"SUP": 5}), tvcf.VcfRecord("c", 2, "A", "T")]
    assert [r.info.get("SUP") for r in tgen.dedup_cov_reads(dup)] == [5, None]
    with pytest.raises(KeyError, match="chrX"):  # as in the JAX package: the reference raises
        list(tgen.parse_region(TBG, tref, "chrX:0-10"))


def test_par_pipeline_propagates_errors():
    def boom(it):
        for i, x in enumerate(it):
            if i == 3:
                raise RuntimeError("stage failed")
            yield x

    out = []
    with pytest.raises(RuntimeError, match="stage failed"):
        for x in tgen.par_pipeline(boom, range(10)):
            out.append(x)
    assert out == [0, 1, 2]
    assert list(tgen.par_pipeline(lambda it: (2 * x for x in it), range(5000), queue_size=3)) == [2 * x for x in range(5000)]


def test_trim_ref_and_verify_order():
    flat = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.uint8)  # ACGTACGT
    ref = Reference(flat=flat, is_n=np.zeros(8, bool), contigs=[Contig("c", 0, 8)])
    ok, bad, same = tvcf.VcfRecord("c", 2, "C", "T"), tvcf.VcfRecord("c", 2, "G", "T"), tvcf.VcfRecord("c", 3, "G", "G")
    assert list(tgen.trim_ref([ok, same], ref)) == [ok]
    with pytest.raises(ValueError, match="!= reference"):
        list(tgen.trim_ref([bad], ref))
    good = [tvcf.VcfRecord("c", 1, "A", "T"), tvcf.VcfRecord("c", 5, "A", "T"), tvcf.VcfRecord("d", 2, "A", "T")]
    assert len(list(tgen.verify_order(iter(good)))) == 3
    with pytest.raises(AssertionError, match="verify_order"):
        list(tgen.verify_order(iter([good[1], good[0]])))


def test_metrics_keys_and_stage_metrics(tmp_path):
    cases = [("c", 5070, "CTTTTTT", "CTTTTTTT"), ("c", 5070, "C", "CT"), ("c", 8029, "TA", "TAA"), ("c", 10, "A", "G"), ("c", 10, "AC", "AT")]
    for k in cases:
        assert tmetrics.normalize_key(k) == jmetrics.normalize_key(k)
    assert tmetrics.normalize_key(cases[0]) == tmetrics.normalize_key(cases[1]) and tmetrics.normalize_key(cases[4]) == ("c", 11, "C", "T")
    calls = {("c", 5070, "C", "CT"), ("c", 1, "A", "G"), ("c", 9, "T", "C")}
    truth = {("c", 5070, "CTTTTTT", "CTTTTTTT"), ("c", 1, "A", "G"), ("c", 2, "G", "T")}
    m = tmetrics.stage_metrics(calls, truth)
    assert m == jmetrics.stage_metrics(calls, truth) and (m["TP"], m["FP"], m["FN"]) == (2, 1, 1)
    assert tmetrics.record_key({"chrom": "c", "pos": "3", "ref": "A", "alt": "G"}) == ("c", 3, "A", "G") == tmetrics.record_key(("c", 3, "A", "G"))
    with open(tmp_path / "t.vcf", "w") as f:
        f.write("##x\n#CHROM\tPOS\n1:0\t5\t.\tA\tG,T\t.\tPASS\t.\n1\t50\t.\tC\tA\t.\tPASS\t.\n")
    assert tmetrics.vcf_keys(str(tmp_path / "t.vcf"), max_pos=10) == jmetrics.vcf_keys(str(tmp_path / "t.vcf"), max_pos=10) == {("1", 5, "A", "G")}


class _Ref:
    def __init__(self, codes):
        self.flat = np.asarray(codes, np.uint8)
        self.contigs = [Contig(name="c", start=0, length=len(codes))]

    def contig_by_name(self, name):
        return self.contigs[0]


def _fastq(tmp_path):
    """``tests/test_metrics.py``'s reads: two nearby hom SNPs, 15 reads of
    35 bases carrying both."""
    rng = np.random.default_rng(3)
    ref_codes = rng.integers(0, 4, 120).astype(np.uint8)
    donor = ref_codes.copy()
    donor[50] = (donor[50] + 1) % 4
    donor[55] = (donor[55] + 1) % 4
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for s in range(30, 60, 2):
            f.write(f"@r{s}\n{dna.codes_to_seq(donor[s : s + 35])}\n+\n{'I' * 35}\n")
    b = dna.codes_to_seq(ref_codes)
    calls = [
        {"chrom": "c", "pos": 51, "ref": b[50], "alt": dna.codes_to_seq(donor[50:51])},
        {"chrom": "c", "pos": 56, "ref": b[55], "alt": dna.codes_to_seq(donor[55:56])},
    ]
    return _Ref(ref_codes), str(fq), calls, b


def test_raw_read_support_and_pileup_channel(tmp_path):
    ref, fq, calls, b = _fastq(tmp_path)
    for args, kw in (((ref, fq, calls), {}), ((ref, fq, [calls[0]]), {}), ((ref, fq, [calls[0]]), {"context_calls": calls})):
        assert tmetrics.raw_read_support(*args, **kw) == jmetrics.raw_read_support(*args, **kw)
    sup = tmetrics.raw_read_support(ref, fq, calls)
    assert all(s["alt_reads"] >= 3 and s["ref_reads"] == 0 for s in sup)
    assert tmetrics.raw_read_support(ref, fq, [calls[0]])[0]["alt_reads"] == 0
    pile, n = tmetrics.alignment_pileup(ref, fq, "c", 0, 120)
    jpile, jn = jmetrics.alignment_pileup(ref, fq, "c", 0, 120)
    np.testing.assert_array_equal(pile, jpile)
    assert n == jn > 0
    indel = {"chrom": "c", "pos": 80, "ref": b[79:81], "alt": b[79]}
    conf = tmetrics.pileup_confirm(pile, 0, calls + [indel])
    assert conf == jmetrics.pileup_confirm(jpile, 0, calls + [indel]) and conf[0]["confirmed"] and conf[2]["confirmed"] is None
    with open(tmp_path / "truth.vcf", "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\n" + "".join(f"c\t{c['pos']}\t.\t{c['ref']}\t{c['alt']}\n" for c in calls[:1]))
    stages = {"raw": calls, "final": calls + [indel]}
    got = tmetrics.parity_report(ref, fq, stages, {"truth": str(tmp_path / "truth.vcf")})
    assert got == jmetrics.parity_report(ref, fq, stages, {"truth": str(tmp_path / "truth.vcf")})
    assert got["extras_validation"]["n_extras"] == 2 and got["stages"]["raw"]["truth"]["TP"] == 1
