"""Scoring, the pair gate and VCF output of the PyTorch port against the JAX
package.

The same numpy-seeded genomes and reads go through both packages: the k-mer
helpers, ``RefKmerIndex`` and ``place_reads`` (``variants/align.py``),
``score_assemblies`` (read coverage of each alt path and its reference
span; the port's one padded batch against the JAX package's batch a size
bucket on the CPU), ``pair_gate_assemblies`` on ``tests/test_pair_gate.py``'s
cases, ``discover_variants(readmap=...)`` as a whole (records, stats and the
scored assemblies) on ``tests/test_torch_discover.py``'s four genomes and a
paired library, and ``write_discovery_vcf`` / ``write_assembly_csv``.
Everything compared is integer or text, so the tolerance is exact equality
throughout; the VCFs differ only in the ``##source=`` line, which names the
package that wrote them.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scoring.py -q``.

The JAX CPU leg's records at the scaled workload of ``bench.py`` are kept in
``tests/data/torch_scaled_leg_records.tsv``; ``chip_smoke.py`` holds the
port's records on the card to that file.  The slow test at the end rebuilds
the file's content from the JAX package and compares; to write it anew:
``JAX_PLATFORMS=cpu python tests/test_torch_scoring.py --write
tests/data/torch_scaled_leg_records.tsv``.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # run as a script: the packages lie at the repo root
    sys.path.insert(0, REPO)

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.core import dna as jdna
from biograph_tpu.io import vcf as jvcf
from biograph_tpu.variants import align as jalign
from biograph_tpu.variants import discover as jdisc
from biograph_tpu_torch import convert
from biograph_tpu_torch.core import dna as tdna
from biograph_tpu_torch.io import vcf as tvcf
from biograph_tpu_torch.variants import align as talign
from biograph_tpu_torch.variants import discover as tdisc

RECORDS_FILE = os.path.join(REPO, "tests", "data", "torch_scaled_leg_records.tsv")
RECORD_COLUMNS = ("chrom", "pos", "ref", "alt", "support", "ref_support")
RECORDS_COMMAND = (
    "JAX_PLATFORMS=cpu python tests/test_torch_scoring.py --write "
    "tests/data/torch_scaled_leg_records.tsv"
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
    text's id(), which a later array of the same length can reuse: its CPU
    discovery would then filter with another genome's hashes.  Every test
    starts without them."""
    from biograph_tpu.index import probes as _jprobes

    _jprobes._TEXT_HASH_CACHE.clear()


# ---------------------------------------------------------------------------
# k-mers and read placement
# ---------------------------------------------------------------------------


def test_kmers_from_codes():
    codes = jdna.seq_to_codes("ACGTA")[None, :]
    kmers, valid = tdna.kmers_from_codes(torch.from_numpy(codes), torch.tensor([5]), 3)
    assert valid.all() and kmers.dtype == torch.int64
    assert kmers[0].tolist() == [6, 27, 44]  # ACG, CGT, GTA
    assert [tdna.kmer_mask(k) for k in (1, 13, 31)] == [jdna.kmer_mask(k) for k in (1, 13, 31)]
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (9, 40)).astype(np.uint8)
    lens = rng.integers(0, 41, 9)
    for k in (1, 13, 31):
        want_k, want_v = jdna.kmers_from_codes(codes, lens, k)
        got_k, got_v = tdna.kmers_from_codes(torch.from_numpy(codes), torch.from_numpy(lens), k)
        np.testing.assert_array_equal(got_k.numpy(), want_k.astype(np.int64))
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert tdna.kmers_from_codes(torch.from_numpy(codes[:, :20]), torch.from_numpy(lens), 25)[0].shape == (9, 0)
    with pytest.raises(ValueError, match="k <= 31"):
        tdna.kmers_from_codes(torch.from_numpy(codes), torch.from_numpy(lens), 32)


@pytest.mark.parametrize("k", [3, 23, 31])
def test_revcomp_and_canonical_kmers(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(50, k), dtype=np.uint8)
    codes[0] = jdna.revcomp_codes(codes[0])[::-1][::-1]
    kmers, _ = jdna.kmers_from_codes(codes, np.full(50, k), k)
    tk = torch.from_numpy(kmers[:, 0].astype(np.int64))
    np.testing.assert_array_equal(tdna.revcomp_kmer(tk, k).numpy(), jdna.revcomp_kmer(kmers[:, 0], k).astype(np.int64))
    canon, fwd = tdna.canonicalize_kmers(tk, k)
    jcanon, jfwd = jdna.canonicalize_kmers(kmers[:, 0], k)
    np.testing.assert_array_equal(canon.numpy(), jcanon.astype(np.int64))
    np.testing.assert_array_equal(fwd.numpy(), jfwd)
    for i in range(5):
        assert tdna.kmer_to_seq(int(tdna.revcomp_kmer(tk, k)[i]), k) == jdna.codes_to_seq(jdna.revcomp_codes(codes[i]))
        assert tdna.kmer_to_seq(int(tk[i]), k) == jdna.kmer_to_seq(int(kmers[i, 0]), k)
    palindrome = torch.tensor([int(jdna.kmers_from_codes(jdna.seq_to_codes("ACGT")[None], np.array([4]), 4)[0][0, 0])])
    assert tdna.canonicalize_kmers(palindrome, 4)[1].all()  # a palindrome counts as forward


def _placement_world(seed=5, G=3000):
    """A genome with a repeated stretch (placement ties), reads from both
    strands with 0-5 mismatches, reads of several lengths and reads from
    nowhere."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[2000:2200] = genome[500:700]  # two equal placements
    is_n = np.zeros(G, bool)
    is_n[1200:1205] = True
    R, L = 300, 60
    codes = np.zeros((R, L), np.uint8)
    lens = rng.integers(30, L + 1, R).astype(np.int32)
    lens[:40] = L
    for i in range(R):
        n = lens[i]
        s = 500 + rng.integers(0, 140) if i < 40 else rng.integers(0, G - n)
        read = genome[s : s + n].copy()
        flips = rng.choice(n, rng.integers(0, 6), replace=False)
        read[flips] = (read[flips] + 1) % 4
        if i % 3 == 1:
            read = (3 - read)[::-1]
        if i % 50 == 7:
            read = rng.integers(0, 4, n).astype(np.uint8)
        codes[i, :n] = read
    return genome, is_n, codes, lens


@pytest.mark.parametrize("k", [9, 13, 16, 20])
def test_ref_kmer_index_build_and_lookup(k):
    genome, is_n, codes, lens = _placement_world()
    want = jalign.RefKmerIndex.build(genome, k, is_n=is_n)
    got = talign.RefKmerIndex.build(genome, k, is_n=is_n, device="cpu")
    np.testing.assert_array_equal(got.kmers.numpy(), np.asarray(want.kmers).astype(np.int64))
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_array_equal(got.ref_phases.numpy(), np.asarray(want.ref_phases).astype(np.int64))
    q, _ = jdna.kmers_from_codes(codes, lens, k)
    q = q[:, :7]
    if k <= 16:
        q = q.astype(np.uint32)
    wpos, whit = want.lookup(jnp.asarray(q), 4)
    gpos, ghit = got.lookup(torch.from_numpy(q.astype(np.int64)), 4)
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(ghit.numpy(), np.asarray(whit))
    assert np.asarray(whit).sum(axis=-1).max() > 1  # the repeat gives a k-mer two places


@pytest.mark.parametrize("max_mm,seeds,hits", [(3, 3, 8), (5, 2, 1), (0, 4, 4)])
def test_place_reads(max_mm, seeds, hits):
    genome, is_n, codes, lens = _placement_world()
    jidx = jalign.RefKmerIndex.build(genome, 13)
    tidx = talign.RefKmerIndex.build(genome, 13, device="cpu")
    want = jalign.place_reads(jidx, codes, lens, max_mm, seeds, hits, batch_rows=128)
    got = talign.place_reads(tidx, codes, lens, max_mm, seeds, hits, batch_rows=128)
    np.testing.assert_array_equal(got.pos, want.pos)
    np.testing.assert_array_equal(got.is_rc, want.is_rc)
    np.testing.assert_array_equal(got.mismatches, want.mismatches)
    assert (want.pos >= 0).any() and (want.pos < 0).any() and want.is_rc.any()


# ---------------------------------------------------------------------------
# the discovery worlds, with readmaps
# ---------------------------------------------------------------------------

from test_torch_discover import GENOMES, G, _JaxRef, _keyed, _reads_from, _sim  # noqa: E402


def _paired_library(rng, donor, n_pairs=600, L=60, frag=260):
    """``tests/test_pair_gate.py``'s paired library: mates at fragment
    260, the second reverse-complemented."""
    codes = np.zeros((2 * n_pairs, L), np.uint8)
    lens = np.full(2 * n_pairs, L, np.int32)
    for i in range(n_pairs):
        s = rng.integers(0, len(donor) - frag)
        codes[2 * i] = donor[s : s + L]
        codes[2 * i + 1] = (3 - donor[s + frag - L : s + frag])[::-1]
    mate = np.arange(2 * n_pairs)
    mate[0::2] += 1
    mate[1::2] -= 1
    return codes, lens, mate


def _both(ref, codes, lens, mate_of=None):
    """The store and readmap in both packages (the port's carried across
    from the JAX package's arrays), and the reference for both."""
    js = jax_build_seqset(codes, lens)
    jr = jax_build_readmap(js, codes, lens, mate_of)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    tref = convert.reference_from_numpy(ref, np.zeros(len(ref), bool), [("chr1", 0, len(ref))])
    return dict(js=js, jr=jr, ts=ts, tr=tr, jref=_JaxRef(ref), tref=tref, ref=ref)


def _insertion_genome(rng):
    """``test_pair_gate_keeps_supported_culls_unsupported``'s genome: 6000
    bases and a donor with a novel 400-base insertion at 3000."""
    genome = rng.integers(0, 4, 6000, dtype=np.uint8)
    ins = rng.integers(0, 4, 400, dtype=np.uint8)
    return genome, ins, np.concatenate([genome[:3000], ins, genome[3000:]])


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(name):
        if name not in made:
            if name == "paired":  # 1500 pairs: 28x, enough support over the insertion
                rng = np.random.default_rng(12345)
                genome, ins, donor = _insertion_genome(rng)
                made[name] = _both(genome, *_paired_library(rng, donor, n_pairs=1500))
                made[name]["ins"] = ins
            elif name == "paired_without_insertion":
                rng = np.random.default_rng(12345)
                genome, ins, donor = _insertion_genome(rng)
                _paired_library(rng, donor)
                made[name] = _both(genome, *_paired_library(rng, genome))
                made[name]["ins"] = ins
            else:
                rng = np.random.default_rng(sorted(GENOMES).index(name) + 99)
                ref, donor = _sim(rng, G, **GENOMES[name])
                made[name] = _both(ref, *_reads_from(donor, rng))
        return made[name]

    return get


def _asm_key(a):
    return (a.chunk_start, a.anchor, a.rejoin, np.asarray(a.seq).tobytes(), a.support, a.ref_support)


def _copies(asms, cls):
    return [cls(a.chunk_start, a.anchor, a.rejoin, np.asarray(a.seq, np.uint8).copy(), a.support, a.ref_support) for a in asms]


STATS = ("anchors_found", "anchors_truncated", "assemblies_truncated", "prescreen_probed", "pair_gated")
# the paired library's 400-base insertion fits a path of 480 bases; a gate
# that asks for more pairs than exist culls it
PAIRED = dict(max_path=480)
PAIRED_STRICT = dict(max_path=480, min_pair_evidence=10**6)


@pytest.mark.parametrize("name,opt_kw", [(name, {}) for name in sorted(GENOMES)] + [("paired", PAIRED), ("paired", PAIRED_STRICT)])
def test_discover_with_a_readmap_identical(worlds, name, opt_kw):
    w = worlds(name)
    opt = dict(min_alt_support=5, **opt_kw)
    jstats, tstats, jasms, tasms = {}, {}, [], []
    want = jdisc.discover_variants(w["js"], w["jref"], opt=jdisc.DiscoverOptions(**opt), readmap=w["jr"], stats=jstats, out_assemblies=jasms)
    got = tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(**opt), readmap=w["tr"], stats=tstats, out_assemblies=tasms)
    assert _keyed(got) == _keyed(want)
    assert [r["aid"] for r in got] == [r["aid"] for r in want]
    assert [_asm_key(a) for a in tasms] == [_asm_key(a) for a in jasms]
    for k in STATS:
        assert tstats.get(k) == jstats.get(k), k
    assert set(tstats["stage_s"]) == {"probe_filter", "probe_exact", "anchors", "wavefront", "score", "extract"}
    assert all(a.support >= 5 for a in tasms)
    assert all(r["support"] >= 5 for r in got)
    if opt_kw is PAIRED_STRICT:  # the one long path, culled
        assert tstats["pair_gated"] == 1 and got == []
    elif name != "clean":
        assert got and tstats.get("pair_gated") in (None, 0)
    if opt_kw is PAIRED:  # the insertion's 400 novel bases are assembled whole and kept
        assert [len(r["alt"]) - len(r["ref"]) for r in got] == [400]
    # without the readmap: range-width support, no score stage
    bare = tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(**opt), stats=(bstats := {}))
    assert "score" not in bstats["stage_s"] and all(r["ref_support"] == 0 for r in bare)


def test_discover_with_a_readmap_on_another_device_raises(worlds):
    w = worlds("snps")
    other = dataclasses.replace(w["tr"], offsets=w["tr"].offsets.to("meta"))
    with pytest.raises(ValueError, match="readmap lies on meta"):
        tdisc.discover_variants(w["ts"], w["tref"], readmap=other)


def _synthetic_assemblies(ref, cls):
    """Assemblies of every row kind: SNPs (one size bucket), a 100-base
    insertion (another), a 30-base deletion, and a 600-base deletion whose
    reference span is scored as two breakpoint windows; on both strands'
    coordinates of a 6000-base genome."""
    rng = np.random.default_rng(17)
    out = []
    for p in (900, 2500, 4200, 5900):
        alt = ref[p - 5 : p + 5].copy()
        alt[5] = (alt[5] + 1) % 4
        out.append(cls(chunk_start=0, anchor=p - 6, rejoin=p + 5, seq=alt, support=3))
    out.append(cls(chunk_start=0, anchor=1500, rejoin=1501, seq=rng.integers(0, 4, 100).astype(np.uint8), support=2))
    out.append(cls(chunk_start=0, anchor=3199, rejoin=3230, seq=np.zeros(0, np.uint8), support=4))
    out.append(cls(chunk_start=0, anchor=1000, rejoin=1601, seq=ref[1001:1004].copy(), support=1))
    return out


@pytest.mark.parametrize("name", ["mixed", "paired"])
def test_score_assemblies_both_batch_forms(worlds, name):
    """The JAX package on the CPU scores a batch per bubble-size bucket; the
    port scores one padded batch on every device; per-bucket batches of the
    port give the same values again."""
    w = worlds(name)

    def made(cls):
        out = _synthetic_assemblies(w["ref"], cls)
        if name == "paired":  # the planted insertion: read support along it
            out.append(cls(chunk_start=0, anchor=2999, rejoin=3000, seq=w["ins"].copy(), support=1))
        return out

    jasms, tasms = made(jdisc.Assembly), made(tdisc.Assembly)
    jdisc.score_assemblies(w["jr"], w["ref"], jasms, jdisc.DiscoverOptions())
    assert tdisc.score_assemblies(w["tr"], w["ref"], tasms, tdisc.DiscoverOptions()) is tasms
    assert [(a.support, a.ref_support) for a in tasms] == [(a.support, a.ref_support) for a in jasms]
    assert any(a.ref_support > 0 for a in tasms)
    if name == "paired":
        assert tasms[-1].support > 0
    buckets = {}
    for a in made(tdisc.Assembly):
        span = max(len(a.seq), min(a.rejoin - a.anchor - 1, 2 * tdisc.MID_CAP))
        buckets.setdefault(1 << max((span - 1).bit_length(), 6), []).append(a)
    assert len(buckets) >= 3
    for group in buckets.values():
        tdisc.score_assemblies(w["tr"], w["ref"], group, tdisc.DiscoverOptions())
    by_bucket = sorted((a.anchor, a.rejoin, a.support, a.ref_support) for g in buckets.values() for a in g)
    assert by_bucket == sorted((a.anchor, a.rejoin, a.support, a.ref_support) for a in tasms)
    plain = tdisc.DiscoverOptions(penalize_directional_coverage=False, read_cov_max_reads_per_entry=3)
    jplain = jdisc.DiscoverOptions(penalize_directional_coverage=False, read_cov_max_reads_per_entry=3)
    jdisc.score_assemblies(w["jr"], w["ref"], jasms, jplain)
    tdisc.score_assemblies(w["tr"], w["ref"], tasms, plain)
    assert [(a.support, a.ref_support) for a in tasms] == [(a.support, a.ref_support) for a in jasms]
    assert tdisc.score_assemblies(w["tr"], w["ref"], [], plain) == []


def test_pair_gate_keeps_supported_culls_unsupported(worlds):
    """``tests/test_pair_gate.py``'s first case on both packages: the real
    insertion is kept, a far bubble that no fragment reaches is culled, a
    short path is never gated."""
    w, w2 = worlds("paired"), worlds("paired_without_insertion")
    ins = w["ins"]
    opt_j, opt_t = jdisc.DiscoverOptions(), tdisc.DiscoverOptions()
    cases = [
        (w, dict(chunk_start=0, anchor=2995, rejoin=3004, seq=ins.copy(), support=9), 1),
        (w2, dict(chunk_start=0, anchor=2995, rejoin=3004, seq=ins.copy(), support=9), 1),
        (w2, dict(chunk_start=0, anchor=6000 + 5000, rejoin=6000 + 5010, seq=ins.copy(), support=9), 0),
        (w2, dict(chunk_start=0, anchor=6000 + 5000, rejoin=6000 + 5010, seq=ins[:20].copy(), support=9), 1),
    ]
    for world, kw, n_kept in cases:
        jstats, tstats = {}, {}
        want = jdisc.pair_gate_assemblies(world["jr"], world["ref"], [jdisc.Assembly(**kw)], opt_j, jstats)
        got = tdisc.pair_gate_assemblies(world["tr"], world["ref"], [tdisc.Assembly(**kw)], opt_t, tstats)
        assert len(got) == len(want) == n_kept and tstats == jstats
    assert tstats == {} and jdisc.pair_gate_assemblies(w2["jr"], w2["ref"], [], opt_j) == []
    for world in (w, w2):
        spans_t = tdisc._ref_pair_spans(world["tr"], world["ref"], opt_t.max_pair_distance)
        spans_j = jdisc._ref_pair_spans(world["jr"], world["ref"], opt_j.max_pair_distance)
        for a, b in zip(spans_t, spans_j):
            np.testing.assert_array_equal(a, b)
        assert len(spans_t[0]) > 100
        assert tdisc._ref_pair_spans(world["tr"], world["ref"], opt_t.max_pair_distance) is spans_t  # cached
    assert len(tdisc._ref_pair_spans(w["tr"], w["ref"], 1000)[2]) > 0  # mates on the novel path: half-placed


def test_pair_gate_vacuous_single_end_and_off(worlds):
    w = worlds("snps")
    long_asm = dict(chunk_start=0, anchor=100, rejoin=110, seq=np.random.default_rng(1).integers(0, 4, 500).astype(np.uint8), support=5)
    assert w["tr"].get_pair_stats()["paired_reads"] == 0
    for world, opt in ((w, tdisc.DiscoverOptions()), (worlds("paired_without_insertion"), tdisc.DiscoverOptions(pair_gate=False))):
        stats = {}
        assert len(tdisc.pair_gate_assemblies(world["tr"], world["ref"], [tdisc.Assembly(**long_asm)], opt, stats)) == 1
        assert stats == {}


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------


def _records_for_vcf(worlds):
    w = worlds("mixed")
    recs = jdisc.discover_variants(w["js"], w["jref"], readmap=w["jr"], opt=jdisc.DiscoverOptions(min_alt_support=1))
    extra = [
        dict(chrom="chr1", pos=5999, ref="A", alt="A" + "C" * 60, support=7, ref_support=0, aid=3),
        dict(chrom="chr1", pos=6000, ref="A" * 55, alt="A", support=9, ref_support=40, aid=4, pair_support=2),
        dict(chrom="chr1", pos=6000, ref="G", alt="T", support=2, ref_support=1, aid=5),
    ]
    return w, recs + extra


@pytest.mark.parametrize("opt_kw", [{}, dict(output_assembly_ids=True, simple_genotype_filter=False, min_alt_support=1), dict(min_pair_depth=3, hom_frac=0.5, vcf_sv_size_threshold=10)])
@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
def test_write_discovery_vcf_bytes(worlds, tmp_path, opt_kw, suffix):
    w, recs = _records_for_vcf(worlds)
    jp, tp = str(tmp_path / ("j" + suffix)), str(tmp_path / ("t" + suffix))
    jdisc.write_discovery_vcf(jp, w["jref"], recs, sample="S1", opt=jdisc.DiscoverOptions(**opt_kw))
    tdisc.write_discovery_vcf(tp, w["tref"], recs, sample="S1", opt=tdisc.DiscoverOptions(**opt_kw))
    opener = __import__("gzip").open if suffix.endswith(".gz") else open
    with opener(jp, "rt") as f:
        want = f.read()
    with opener(tp, "rt") as f:
        got = f.read()
    assert "##source=biograph_tpu\n" in want and "##source=biograph_tpu_torch\n" in got
    assert got.replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == want
    read_t, read_j = tvcf.read_vcf(tp), jvcf.read_vcf(jp)
    assert [vars(r) for r in read_t] == [vars(r) for r in read_j] and read_t


def test_vcf_writer_order_canary(tmp_path):
    for module in (tvcf, jvcf):
        with module.VcfWriter(str(tmp_path / "o.vcf"), contigs=[("a", 10), ("b", 10)]) as w:
            w.write(module.VcfRecord("a", 5, "A", "C"))
            with pytest.raises(ValueError, match="order violation"):
                w.write(module.VcfRecord("a", 4, "A", "C"))
            w.write(module.VcfRecord("b", 1, "A", "C", qual=3.5, info={"X": True, "N": 2}, fmt={"GT": "0/1"}))
            with pytest.raises(ValueError, match="re-entered"):
                w.write(module.VcfRecord("a", 9, "A", "C"))


def test_write_assembly_csv_bytes(worlds, tmp_path):
    w = worlds("paired")
    jasms, tasms = [], []
    jdisc.discover_variants(w["js"], w["jref"], readmap=w["jr"], opt=jdisc.DiscoverOptions(**PAIRED), out_assemblies=jasms)
    tdisc.discover_variants(w["ts"], w["tref"], readmap=w["tr"], opt=tdisc.DiscoverOptions(**PAIRED), out_assemblies=tasms)
    far = dict(chunk_start=0, anchor=10**6, rejoin=10**6 + 3, seq=np.zeros(2, np.uint8), support=1)
    jasms.append(jdisc.Assembly(**far))
    tasms.append(tdisc.Assembly(**far))  # outside every contig: no row, still counted
    jp, tp = tmp_path / "j.csv", tmp_path / "t.csv"
    assert tdisc.write_assembly_csv(str(tp), w["tref"], tasms) == jdisc.write_assembly_csv(str(jp), w["jref"], jasms) == len(tasms)
    assert tp.read_bytes() == jp.read_bytes() and tp.read_text().count("\n") == len(tasms)


# ---------------------------------------------------------------------------
# the scaled leg's records, kept as data
# ---------------------------------------------------------------------------

def jax_scaled_leg_records():
    """The JAX package's records, on the CPU, of the scaled leg of
    ``bench.py`` (``_scaled_pipeline_rate``): a 2 Mb genome with 4000 planted
    SNPs, 120 000 reads of 100 bases, half reverse-complemented, seed 12345;
    ``discover_variants(ss, ref, readmap=rm,
    opt=DiscoverOptions(min_alt_support=5))``.  As (chrom, pos, ref, alt,
    support, ref_support) tuples."""
    from biograph_tpu.build.readmap_build import build_readmap
    from biograph_tpu.build.seqset_build import build_seqset
    from biograph_tpu.index.reference import Contig
    from biograph_tpu.variants.discover import DiscoverOptions, discover_variants

    rng = np.random.default_rng(12345)
    G, L, R = 2_000_000, 100, 120_000
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    donor = genome.copy()
    snp = rng.choice(np.arange(200, G - 200), 4000, replace=False)
    donor[snp] = (donor[snp] + 1 + rng.integers(0, 3, 4000)) % 4
    starts = rng.integers(0, G - L, R)
    codes = donor[starts[:, None] + np.arange(L)]
    half = R // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    lengths = np.full(R, L, np.int32)

    class Ref:
        flat = genome
        is_n = np.zeros(G, bool)
        contigs = [Contig(name="chr", start=0, length=G)]

    ss = build_seqset(codes, lengths)
    rm = build_readmap(ss, codes, lengths)
    recs = discover_variants(
        ss, Ref(), opt=DiscoverOptions(min_alt_support=5), readmap=rm
    )
    return [tuple(r[k] for k in RECORD_COLUMNS) for r in recs]


def read_records_file(path=RECORDS_FILE):
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            chrom, pos, ref, alt, sup, rsup = line.rstrip("\n").split("\t")
            out.append((chrom, int(pos), ref, alt, int(sup), int(rsup)))
    return out


def write_records_file(path, records):
    with open(path, "w") as f:
        f.write(
            "# The JAX package's discover_variants(ss, ref, readmap=rm, "
            "opt=DiscoverOptions(min_alt_support=5)) on the CPU, scaled leg of "
            "bench.py (seed 12345)\n"
        )
        f.write(f"# made by: {RECORDS_COMMAND}\n")
        f.write("# " + "\t".join(RECORD_COLUMNS) + "\n")
        for rec in records:
            f.write("\t".join(str(x) for x in rec) + "\n")


@pytest.mark.slow
def test_scaled_leg_records_file_is_the_jax_packages():
    assert jax_scaled_leg_records() == read_records_file()


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--write":
        sys.exit("usage: python tests/test_torch_scoring.py --write PATH")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_records_file(sys.argv[2], jax_scaled_leg_records())
