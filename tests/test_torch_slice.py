"""The first slice of the PyTorch port as a whole, against the JAX package:
FASTQ file -> reads -> build_seqset -> build_readmap -> save -> load ->
queries; artifacts saved by one package load in the other; and the port
imports neither jax nor biograph_tpu.  Tolerance: exact equality."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index import probes as jprobes
from biograph_tpu.index.readmap import Readmap as JReadmap
from biograph_tpu.index.seqset import Seqset as JSeqset
from biograph_tpu.io.fastq import read_fastq as jax_read_fastq
from biograph_tpu_torch.build.readmap_build import build_readmap
from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.convert import READMAP_DTYPES, SEQSET_DTYPES, seqset_to_numpy
from biograph_tpu_torch.core.dna import revcomp_codes
from biograph_tpu_torch.index import probes as tprobes
from biograph_tpu_torch.index.readmap import Readmap
from biograph_tpu_torch.index.seqset import Seqset
from biograph_tpu_torch.io.fastq import read_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, R, DEPTH = 1000, 220, 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is many small tensor operations; run
    beside other test workers, more threads only contend for the cores."""
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


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Both packages run the slice on the same FASTQ file and save."""
    tmp = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    with open(tmp / "reads.fq", "w") as f:
        for i in range(R):
            n = int(rng.integers(30, 61))
            s = int(rng.integers(0, G - n))
            seq = genome[s : s + n]
            if i % 2:
                seq = (3 - seq)[::-1]
            f.write(f"@r{i}\n{''.join('ACGT'[c] for c in seq)}\n+\n{'I' * n}\n")
    fq = str(tmp / "reads.fq")
    jb, tb = jax_read_fastq(fq, use_native=False), read_fastq(fq)
    np.testing.assert_array_equal(tb.codes, jb.codes)
    np.testing.assert_array_equal(tb.lengths, jb.lengths)
    mate_of = np.arange(R, dtype=np.int64) ^ 1

    js = jax_build_seqset(jb.codes, jb.lengths)
    jr = jax_build_readmap(js, jb.codes, jb.lengths, mate_of)
    js.save(str(tmp / "jax_seqset.bgt"))
    jr.save(str(tmp / "jax_readmap.bgt"))

    ts = build_seqset(tb.codes, tb.lengths, device="cpu")
    tr = build_readmap(ts, tb.codes, tb.lengths, mate_of, device="cpu")
    ts.save(str(tmp / "torch_seqset.bgt"))
    tr.save(str(tmp / "torch_readmap.bgt"))
    return dict(tmp=tmp, genome=genome, batch=tb, js=js, jr=jr, ts=ts, tr=tr)


def test_cross_load_seqset_and_readmap(slice_run):
    tmp = slice_run["tmp"]
    # saved by the port, loaded by the JAX package
    js2 = JSeqset.load(str(tmp / "torch_seqset.bgt"))
    jr2 = JReadmap.load(str(tmp / "torch_readmap.bgt"), js2)
    # saved by the JAX package, loaded by the port
    ts2 = Seqset.load(str(tmp / "jax_seqset.bgt"), device="cpu")
    tr2 = Readmap.load(str(tmp / "jax_readmap.bgt"), ts2, device="cpu")
    got = seqset_to_numpy(ts2)
    for name, dtype in SEQSET_DTYPES.items():
        want = np.asarray(getattr(slice_run["js"], name))
        loaded = np.asarray(getattr(js2, name))
        assert loaded.dtype == want.dtype == got[name].dtype == dtype, name
        np.testing.assert_array_equal(loaded, want, err_msg=name)
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert (js2.n_entries, js2.max_entry_len) == (ts2.n_entries, ts2.max_entry_len)
    assert (js2.n_entries, js2.max_entry_len) == (slice_run["js"].n_entries, slice_run["js"].max_entry_len)
    for name, dtype in READMAP_DTYPES.items():
        want = np.asarray(getattr(slice_run["jr"], name))
        assert np.asarray(getattr(jr2, name)).dtype == dtype, name
        np.testing.assert_array_equal(np.asarray(getattr(jr2, name)), want, err_msg=name)
        np.testing.assert_array_equal(getattr(tr2, name).numpy(), want, err_msg=name)
    assert ts2.uuid == slice_run["js"].uuid and js2.uuid == slice_run["ts"].uuid
    assert tr2.uuid == slice_run["jr"].uuid


def test_slice_queries_after_load(slice_run):
    """The port's loaded store answers as the JAX package's loaded store."""
    tmp, batch, genome = slice_run["tmp"], slice_run["batch"], slice_run["genome"]
    ts = Seqset.load(str(tmp / "torch_seqset.bgt"), device="cpu")
    tr = Readmap.load(str(tmp / "torch_readmap.bgt"), ts, device="cpu")
    js = JSeqset.load(str(tmp / "jax_seqset.bgt"))
    codes, lengths = torch.from_numpy(batch.codes), torch.from_numpy(batch.lengths)
    oriented = torch.cat([codes, revcomp_codes(codes, lengths)])
    olens = torch.cat([lengths, lengths])
    found = ts.d.find(oriented, olens)
    assert bool(found.valid.all())  # every read and reverse complement is found
    assert torch.equal(found.size, olens)
    want = js.d.find(jnp.asarray(oriented.numpy()), jnp.asarray(olens.numpy()))
    for g, w in zip(found, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # each read's range contains the entry its readmap entry hangs on
    oriented_id = tr.read_ids + (~tr.is_forward).to(torch.int64) * R
    entry_of = torch.empty(2 * R, dtype=torch.int64)
    entry_of[oriented_id] = tr.entry_of_rm
    assert bool(((found.begin <= entry_of) & (entry_of < found.end)).all())
    nb, ne = ts.d.push4(found)
    jnb, jne = js.d.push4(want)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
    text = np.concatenate([genome, (3 - genome)[::-1]]).astype(np.uint8)
    pos = np.arange(len(text), dtype=np.int64)
    seg_lo = np.where(pos >= G, G, 0)
    got = tprobes.probe_exact_kernel(ts.d, torch.from_numpy(text), torch.from_numpy(pos), torch.from_numpy(seg_lo), DEPTH)
    ref = jprobes.probe_exact(js.d, jnp.asarray(text), jnp.asarray(pos), jnp.asarray(seg_lo), DEPTH)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_to_device_and_engine(slice_run):
    ts = slice_run["ts"]
    moved = ts.to("cpu")
    assert moved is not ts and moved.device.type == "cpu" and moved.uuid == ts.uuid
    for name in SEQSET_DTYPES:
        assert torch.equal(getattr(moved, name), getattr(ts, name))
    assert ts.d is ts.d and ts.d.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Seqset.load(str(slice_run["tmp"] / "torch_seqset.bgt"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Readmap.load(str(slice_run["tmp"] / "torch_readmap.bgt"), ts)


def _port_modules():
    root = os.path.join(REPO, "biograph_tpu_torch")
    mods = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    for required in ("biograph_tpu_torch.build.seqset_build", "biograph_tpu_torch.ops.rank4", "biograph_tpu_torch.index.probes",
                     "biograph_tpu_torch.variants.discover", "biograph_tpu_torch.ops.align_dp", "biograph_tpu_torch.index.reference"):
        assert required in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'biograph_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


def test_chip_smoke_names_neither_and_needs_the_card():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped, stripped
            assert "biograph_tpu." not in stripped and not stripped.endswith("biograph_tpu"), stripped
    assert "import jax" not in src and "from biograph_tpu " not in src and "from biograph_tpu." not in src
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_chip_smoke_path_at_toy_size_on_the_cpu(monkeypatch):
    """The phases chip_smoke.py drives on the card, rehearsed on CPU tensors
    (where the wrappers take the plain versions)."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    import chip_smoke

    dev = torch.device("cpu")
    genome, codes, lengths, snp, donor, starts = chip_smoke.simulate(8000, 600, 16, 100)
    assert all(np.array_equal(a, b) for a, b in zip(chip_smoke.make_workload(8000, 600, 16, 100), (genome, codes, lengths)))
    stats, (ss, rm, found, ranked, pushed, text, probed) = chip_smoke.main_path(dev, genome, codes, lengths, depth=16)
    assert stats["n_entries"] == ss.n_entries > 8000 and stats["probe_positions"] == 16000
    out = chip_smoke.check_results(dev, genome, codes, ss, found, ranked, pushed, text, probed, depth=16, sample=200, host_sample=60)
    assert out == {"sampled_lanes": 200, "host_checked_windows": 60}
    # discovery on the same store, held to the genome, the planted SNPs and a region
    reference = chip_smoke.reference_from_numpy(genome, np.zeros(8000, bool), [("chr1", 0, 8000)])
    monkeypatch.setattr(chip_smoke, "REGION", (0, 4096))
    records, dstats, _, launches = chip_smoke.run_discover(ss, reference)
    assert set(launches) == set(chip_smoke.WRAPPERS) and not any(launches.values())  # CPU tensors: the plain versions
    assert set(dstats["stage_s"]) == {"probe_filter", "probe_exact", "anchors", "wavefront", "extract"}
    rm_cpu = rm.to("cpu")
    checked = chip_smoke.discover_checks(dev, ss, rm_cpu.seqset, reference, genome, records, snp, donor, starts, 100)
    assert checked["planted"] == 16 and checked["share"] == 1.0 and checked["well_covered"] > 0 and checked["region_records"] > 0
    bad = [dict(records[0], ref="ACGT"[("ACGT".index(records[0]["ref"][0]) + 1) % 4] + records[0]["ref"][1:])] + records[1:]
    with pytest.raises(AssertionError, match="not the genome's"):
        chip_smoke.discover_checks(dev, ss, rm_cpu.seqset, reference, genome, bad, snp, donor, starts, 100)
    with pytest.raises(AssertionError, match="well-covered planted SNPs"):
        chip_smoke.discover_checks(dev, ss, rm_cpu.seqset, reference, genome, records[:1], snp, donor, starts, 100)
    holds = chip_smoke.discover_kernel_holds(ss, reference, dstats["anchors_found"])
    assert holds["anchors"] == dstats["anchors_found"] > 0 and len(holds["chain_window_mean_m"]) == 4
    assert holds["rank_calls_by_lanes"] and sum(holds["push4_calls_by_lanes"].values()) == 1 + holds["beam_steps"]
    with pytest.raises(AssertionError, match="the replayed front end found"):
        chip_smoke.discover_kernel_holds(ss, reference, dstats["anchors_found"] + 1)
    small = chip_smoke.small_genome_checks(dev)
    assert {0, 5, -7} <= set(small["length_changes"]) and small["records_in_the_block"] >= 2  # the block went through the aligner
    # discovery with the readmap, held to the JAX package's records of the
    # same reads (at the real size, the committed records file)
    from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
    from biograph_tpu.index.reference import Contig
    from biograph_tpu.variants.discover import DiscoverOptions, discover_variants as jax_discover

    class JRef:
        flat, is_n, contigs = genome, np.zeros(8000, bool), [Contig(name="chr", start=0, length=8000)]

    js = jax_build_seqset(codes, lengths)
    want = [chip_smoke.key_of(r) for r in jax_discover(js, JRef(), readmap=jax_build_readmap(js, codes, lengths), opt=DiscoverOptions(min_alt_support=5))]
    assert want and all(len(k) == 6 for k in chip_smoke.read_records_file()[:3])
    scored_reference = chip_smoke.reference_from_numpy(genome, np.zeros(8000, bool), [("chr", 0, 8000)])
    with pytest.raises(AssertionError, match="launched no"):  # CPU tensors launch nothing
        chip_smoke.discover_scored_phase(ss, rm, scored_reference, want, 1.0, 600)
    monkeypatch.setattr(chip_smoke, "DISCOVER_KERNELS", ())
    _, asms, scored = chip_smoke.discover_scored_phase(ss, rm, scored_reference, want, 1.0, 600)
    assert scored["records"] == len(want) and scored["vcf_records_passing_genotype_filter"] > 0
    assert "score" in scored["warm"]["stage_s"] and scored["pair_gated"] == 0
    with pytest.raises(AssertionError, match="the JAX CPU leg"):
        chip_smoke.discover_scored_phase(ss, rm, scored_reference, want[1:], 1.0, 600)
    assert chip_smoke.region_check(ss, rm, rm_cpu, reference) > 0
    with pytest.raises(AssertionError, match="launched no chain_fixed"):
        chip_smoke.chain_fixed_check(dev, ss, rm, reference, asms)
    real = chip_smoke.rank4_ops.chain_fixed

    def counted(*args):
        counted.launches += 1
        return real(*args)

    counted.launches = 0
    monkeypatch.setattr(chip_smoke.rank4_ops, "chain_fixed", counted)
    chained, (cov_text, cov_depth) = chip_smoke.chain_fixed_check(dev, ss, rm, reference, asms)
    assert chained["launches"] == 1 and cov_depth == 100 and chained["lanes"] == cov_text.shape[0] and chained["read_ends_counted"] > 0
    paired = chip_smoke.paired_check(dev)
    assert paired["strict_gate_pair_gated"] >= 1 and paired["proper_pairs"] > 0
    with pytest.raises(AssertionError, match="no rank or no chain_window"):  # CPU tensors launch nothing
        chip_smoke.mixed_lengths_check(dev)
    # the dense front end and the wavefront without trunc tables give the same records
    dense = chip_smoke.discover_dense_phase(ss, rm, scored_reference, want)
    assert dense["records"] == len(want) and "probe_dispatch" in dense["warm"]["stage_s"]
    assert dense["holds"]["rank_calls_by_lanes"] == {8192: 25} and sum(dense["holds"]["push4_calls_by_lanes"].values()) == 1
    with pytest.raises(AssertionError, match="the JAX CPU leg"):
        chip_smoke.discover_dense_phase(ss, rm, scored_reference, want[1:])
    assert not chip_smoke.disc.NO_PRESCREEN  # restored after a failure too
    no_trunc = chip_smoke.discover_no_trunc_phase(ss, rm, scored_reference, want, scored["warm"])
    assert not no_trunc["memory_plan"]["use_trunc_tables"] and chip_smoke.disc.BUDGET_BYTES is None
    # the widen family and the SDK, against a CPU copy (here: another)
    monkeypatch.setattr(chip_smoke, "LT_QUERIES", 5000)
    widened = chip_smoke.widen_checks(ss, rm_cpu.seqset, found)
    assert widened["ranges"] == 1200 and widened["truncate_ranges_to_25_valid"] == 1200
    sdk = chip_smoke.sdk_checks(dev, ss, rm, codes, genome)
    assert sdk["answers"] == 16 * 7 and sdk["reads_containing"] > 0 and sdk["overlap_reads"] > 0


def test_reads_to_records_each_package_on_its_own_store():
    """The slice as a whole: each package builds its own store from the same
    reads and discovers, without a readmap, the same records."""
    from biograph_tpu.index.reference import Contig
    from biograph_tpu.variants.discover import discover_variants as jax_discover
    from biograph_tpu_torch.convert import reference_from_numpy
    from biograph_tpu_torch.variants.discover import discover_variants

    rng = np.random.default_rng(33)
    n = 3000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    donor = np.concatenate([ref[:800], [(ref[800] + 1) % 4], ref[801:1500], rng.integers(0, 4, 6).astype(np.uint8), ref[1500:2200], ref[2209:]]).astype(np.uint8)
    starts = rng.integers(0, len(donor) - 40, 1800)
    codes = donor[starts[:, None] + np.arange(40)]
    codes[:900] = (3 - codes[:900])[:, ::-1]
    lengths = np.full(1800, 40, np.int32)

    class JRef:
        flat, is_n, contigs = ref, np.zeros(n, bool), [Contig(name="chr1", start=0, length=n)]

    want = jax_discover(jax_build_seqset(codes, lengths), JRef())
    got = discover_variants(build_seqset(codes, lengths, device="cpu"), reference_from_numpy(ref, np.zeros(n, bool), [("chr1", 0, n)]))
    keys = ("chrom", "pos", "ref", "alt", "support", "ref_support")
    assert [tuple(r[k] for k in keys) for r in got] == [tuple(r[k] for k in keys) for r in want]
    assert {len(r["alt"]) - len(r["ref"]) for r in got} == {0, 6, -9}


def test_reads_to_scored_records_and_vcf_each_package_on_its_own_store(tmp_path):
    """The slice as a whole with the readmap: each package builds its own
    store and readmap from the same paired reads, discovers with scoring and
    the pair gate, and writes the same VCF (but for the ``##source=`` line)."""
    from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
    from biograph_tpu.index.reference import Contig
    from biograph_tpu.variants import discover as jdisc
    from biograph_tpu_torch.convert import reference_from_numpy
    from biograph_tpu_torch.variants import discover as tdisc

    rng = np.random.default_rng(34)
    n = 3000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    donor = ref.copy()
    donor[[700, 1700, 2300]] = (donor[[700, 1700, 2300]] + 1) % 4
    starts = rng.integers(0, n - 200, 900)
    codes = np.concatenate([donor[starts[:, None] + np.arange(40)], (3 - donor[(starts + 160)[:, None] + np.arange(40)])[:, ::-1]])
    lengths = np.full(1800, 40, np.int32)
    lengths[::5] = 33  # mixed lengths: coverage's general route
    codes = np.where(np.arange(40)[None, :] < lengths[:, None], codes, 0).astype(np.uint8)
    mate = np.concatenate([np.arange(900, 1800), np.arange(900)])

    class JRef:
        flat, is_n, contigs = ref, np.zeros(n, bool), [Contig(name="chr1", start=0, length=n)]

    js = jax_build_seqset(codes, lengths)
    jstats, tstats = {}, {}
    want = jdisc.discover_variants(js, JRef(), readmap=jax_build_readmap(js, codes, lengths, mate), stats=jstats)
    ts = build_seqset(codes, lengths, device="cpu")
    tref = reference_from_numpy(ref, np.zeros(n, bool), [("chr1", 0, n)])
    got = tdisc.discover_variants(ts, tref, readmap=build_readmap(ts, codes, lengths, mate, device="cpu"), stats=tstats)
    keys = ("chrom", "pos", "ref", "alt", "support", "ref_support")
    assert [tuple(r[k] for k in keys) for r in got] == [tuple(r[k] for k in keys) for r in want]
    assert {r["pos"] for r in got} == {701, 1701, 2301} and all(r["support"] >= 3 for r in got)
    jdisc.write_discovery_vcf(str(tmp_path / "j.vcf"), JRef(), want)
    tdisc.write_discovery_vcf(str(tmp_path / "t.vcf"), tref, got)
    jv, tv = (tmp_path / "j.vcf").read_text(), (tmp_path / "t.vcf").read_text()
    assert tv.replace("##source=biograph_tpu_torch\n", "##source=biograph_tpu\n") == jv and tv.count("\nchr1\t") == 3


def test_chip_smoke_coverage_legs_at_toy_size_on_the_cpu(monkeypatch, tmp_path):
    """The coverage legs of chip_smoke.py rehearsed on CPU tensors: leg 1 on
    the scaled leg's generator at 8000 bases, held to files the JAX package
    writes here as the slow test of tests/test_torch_coverage_tool.py writes
    the committed ones (a file that differs in one genotype fails the leg);
    leg 2 on the trimmed, paired, diploid generator at 12 000 bases."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.syspath_prepend(os.path.join(REPO, "tests"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    import chip_smoke
    import test_torch_coverage_tool as tct
    from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
    from biograph_tpu.classifier.model import train_classifier as jax_train
    from biograph_tpu.index.reference import Contig as JContig, Reference as JReference
    from biograph_tpu.io.vcf import read_vcf as jax_read_vcf
    from biograph_tpu.variants import coverage_tool as jcov
    from biograph_tpu.variants.discover import DiscoverOptions, discover_variants as jax_discover, write_discovery_vcf

    dev = torch.device("cpu")
    G = 8000
    genome, codes, lengths, snp, donor, starts = chip_smoke.simulate(G, 600, 16, 100)
    js = jax_build_seqset(codes, lengths)
    jr = jax_build_readmap(js, codes, lengths)
    jref = JReference(flat=genome, is_n=np.zeros(G, bool), contigs=[JContig("chr", 0, G)])
    records = jax_discover(js, jref, readmap=jr, opt=DiscoverOptions(min_alt_support=5))
    want = [chip_smoke.key_of(r) for r in records]
    write_discovery_vcf(str(tmp_path / "in.vcf"), jref, records, opt=DiscoverOptions(min_alt_support=5, simple_genotype_filter=False))

    class JBG:
        readmap = jr

    jcov.run_coverage(str(tmp_path / "in.vcf"), str(tmp_path / "out.vcf"), JBG, jref, features_out=str(tmp_path / "f.npz"))
    annotated, feats = jax_read_vcf(str(tmp_path / "out.vcf")), dict(np.load(tmp_path / "f.npz"))
    clf = jax_train(feats, tct.scaled_leg_labels(annotated, genome, donor, snp), steps=50)
    clf.save(str(tmp_path / "model.npz"))
    names, rows = chip_smoke.coverage_rows(annotated, feats, clf.predict_proba(feats))
    tct.write_coverage_file(str(tmp_path / "cov.tsv"), names, rows)
    monkeypatch.setattr(chip_smoke, "COVERAGE_FILE", str(tmp_path / "cov.tsv"))
    monkeypatch.setattr(chip_smoke, "MODEL_FILE", str(tmp_path / "model.npz"))
    ss = build_seqset(codes, lengths, device="cpu")
    rm = build_readmap(ss, codes, lengths, device="cpu")
    reference = chip_smoke.reference_from_numpy(genome, np.zeros(G, bool), [("chr", 0, G)])
    os.makedirs(tmp_path / "leg1")
    out, launches, again = chip_smoke.coverage_scored_phase(dev, ss, rm, reference, genome, want, str(tmp_path / "leg1"))
    assert out["records"] == len(want) > 5 and out["classifier_max_abs_err"] <= chip_smoke.PROB_TOL and out["parallel_chunks"] >= 2
    assert set(out["warm"]["steps_s"]) == {"annotate_coverage", "annotate_pair_coverage", "phase_records"} and not any(launches.values())
    assert len(again().gt) == len(want)
    rows[0][4] = "0/1" if rows[0][4] != "0/1" else "1/1"
    tct.write_coverage_file(str(tmp_path / "cov.tsv"), names, rows)
    os.makedirs(tmp_path / "leg1b")
    with pytest.raises(AssertionError, match="first difference at row 0"):
        chip_smoke.coverage_scored_phase(dev, ss, rm, reference, genome, want, str(tmp_path / "leg1b"))
    # leg 2: CPU tensors launch no kernel, so the general route's count is not asked for here
    monkeypatch.setattr(chip_smoke, "COVERAGE_KERNELS", ())
    genome2 = np.random.default_rng(chip_smoke.SEED + 41).integers(0, 4, 12_000).astype(np.uint8)
    os.makedirs(tmp_path / "leg2")
    small = dict(n_pairs=800, n_het=30, n_hom=8, n_indel=4)
    out, launches, again = chip_smoke.coverage_trimmed_phase(dev, genome2, str(tmp_path / "leg2"), trimmed=small, region_records=10, min_entries=1000)
    assert out["records"] == out["vcf_records"] > 20 and out["region"]["records"] == 10 and not any(launches.values())
    assert out["truth"]["het_right"] >= chip_smoke.HET_FLOOR and out["truth"]["hom_right"] >= chip_smoke.HOM_FLOOR
    assert out["truth"]["pc_positive"] > 0.9 and out["classifier"]["max_abs_err_card_vs_cpu"] <= chip_smoke.TRAIN_TOL
    assert set(out["steps_s"]) == {"annotate_coverage", "annotate_pair_coverage", "phase_records", "evaluate_vargraph"}
    assert out["kernel_holds"]["rank"] and out["kernel_holds"]["chain_window"]
    assert chip_smoke.rank4_ops.rank is chip_smoke.WRAPPERS["rank"] and chip_smoke.probes.chain_window is chip_smoke.WRAPPERS["chain_window"]
    assert len(again().gt) == out["vcf_records"]
    with pytest.raises(AssertionError, match="real-size floor"):
        chip_smoke.coverage_trimmed_phase(dev, genome2, str(tmp_path / "leg2b"), trimmed=small)
