"""The port's pipeline subcommands against the JAX package's CLI.

``reference``, ``ref2bwt``/``bwtquery``, ``discovery`` (assemble with the SV
pass, ``--no-sv``, ``--iterate``, ``--exclude``, ``pileup``,
``golden-parity``), ``coverage``, ``grm``, ``qual_classifier``,
``gt_classifier`` and ``full_pipeline`` with ``--resume``, ``--stop`` and
``--rerun``: both CLIs run in this process on the CPU (the port with
``--device cpu``) on the same small inputs, and every artifact must be the
JAX package's but for the ``##source=`` line of a VCF and the uuids of an
artifact; the classifiers' probabilities within ``PROB_TOL``.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cli_pipeline.py -q``.

``tests/data/torch_pipeline_sv_leg.json`` holds the digests of the JAX
package's CPU run of ``full_pipeline --paired --correct`` on leg 4 of
``chip_smoke.py`` (``sv_paired_library``: a diploid sample with structural
variants over the 2 Mb genome); ``chip_smoke.py`` holds the port's run on
the card to it.  The slow test makes it anew from the JAX package and
compares; to write it: ``JAX_PLATFORMS=cpu python
tests/test_torch_cli_pipeline.py --write tests/data/torch_pipeline_sv_leg.json``.
"""

import contextlib
import glob
import io
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # run as a script: the packages lie at the repo root
    sys.path.insert(0, REPO)

import numpy as np
import pytest

PIPELINE_LEG_COMMAND = "JAX_PLATFORMS=cpu python tests/test_torch_cli_pipeline.py --write tests/data/torch_pipeline_sv_leg.json"
DISCOVERY_LINE = re.compile(r"discovery: (\d+) assembled \+ (\d+) SV records")
PROB_TOL = 1e-6  # the classifier's probabilities: float32 in the port, float64 in the JAX package (tests/test_torch_classifier.py)


def _chip_smoke():
    """``chip_smoke.py``, which makes leg 4 and holds the file's format."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def run_printed(main, argv):
    """main(argv), and what it printed (echoed as well)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    sys.stdout.write(buf.getvalue())
    return buf.getvalue()


def pipeline_stages_argv(fq, fa, out, flags):
    """``full_pipeline``'s stages as the CLI's own commands, with the
    arguments full_pipeline gives them, for ``full_pipeline --reads fq
    --ref fa --out out`` with ``flags`` (any of --paired, --correct and
    --classifier-model M).  The JAX package's ``full_pipeline --correct``
    stops in its create stage (its namespace lacks the k-mer filter's
    arguments), so the committed file comes from these commands."""
    bgt = os.path.join(out, "sample.bgt")
    analysis = os.path.join(out, "analysis")
    os.makedirs(analysis, exist_ok=True)
    vcf = {name: os.path.join(analysis, name + ".vcf") for name in ("discovery", "coverage", "grm", "results")}
    feats = os.path.join(analysis, "features.npz")
    create = [f for f in flags if f in ("--paired", "--correct")]
    argv = [
        ["create", "--reads", fq, "--out", bgt, *create],
        ["discovery", "--mode", "assemble", "--biograph", bgt, "--ref", fa, "--out", vcf["discovery"], "--min-depth", "5"],
        ["coverage", "--vcf", vcf["discovery"], "--biograph", bgt, "--ref", fa, "--out", vcf["coverage"], "--features", feats],
        ["grm", "--vcf", vcf["coverage"], "--ref", fa, "--out", vcf["grm"]],
    ]
    if "--classifier-model" in flags:
        model = flags[flags.index("--classifier-model") + 1]
        argv.append(["qual_classifier", "--vcf", vcf["grm"], "--features", feats, "--model", model, "--out", vcf["results"]])
    return argv


def jax_sv_engine(bgt, fa):
    """The JAX package's SV pass on a store, as the discovery stage runs it,
    and its two halves: the split-read events alone and the breakend walks
    alone.  Returns the counts and digests the committed file holds."""
    from biograph_tpu.api import BioGraph
    from biograph_tpu.index.reference import Reference
    from biograph_tpu.variants import pop_tracer as jp
    from biograph_tpu.variants.align import RefKmerIndex

    cs = _chip_smoke()
    bg = BioGraph(bgt)
    ref = Reference.from_fasta(fa)
    codes, lens, mate = jp.reads_from_readmap(bg.readmap)
    opt = jp.SvOptions()
    index = RefKmerIndex.build(np.asarray(ref.flat), opt.k, is_n=ref.is_n)
    pl, raw, clips, ek, ec = jp._sv_scan_reads(index, codes, lens, opt)
    out = {
        "reads": int(len(lens)),
        "codes_sha256": cs.sha256(codes),
        "unplaced_reads": int((pl.pos < 0).sum()),
        "split_events": len(raw),
        "clip_candidates": len(clips),
        "edge_keys": int(len(ek)),
    }
    for name, events, cands in (("sv", raw, clips), ("sv_split", raw, []), ("sv_breakend", [], clips)):
        recs = jp._sv_finalize(ref, index, events, cands, ek, ec, pl.pos, pl.is_rc, lens, mate, opt)
        out[name] = {"records": len(recs), "sha256": cs.sv_record_digest(recs)}
    return out


def jax_pipeline_sv_leg(tmp, library=None, genome_len=None, error_rate=None):
    """The JAX package's ``full_pipeline`` of leg 4 on the CPU, as digests:
    every stage's artifact, the records by engine, the classifier's
    probabilities, the SV pass and its halves, the FM-index."""
    from biograph_tpu import cli as jcli
    from biograph_tpu.classifier.model import Classifier
    from biograph_tpu.index.bwt import RefBwt
    from biograph_tpu.io.vcf import read_vcf

    cs = _chip_smoke()
    library = library or cs.SV_LIBRARY
    genome = cs.leg_genome(genome_len or cs.GENOME)
    extra = {} if error_rate is None else {"error_rate": error_rate}
    codes, lengths, truth = cs.sv_paired_library(genome, **library, **extra)
    fq, fa = cs.write_leg_inputs(tmp, genome, codes, lengths)
    out = os.path.join(tmp, "run")
    cache = os.path.join(tmp, "cache")
    old = os.environ.get("BGT_CACHE")
    os.environ["BGT_CACHE"] = cache  # the JAX package's FM-index cache
    try:
        flags = [*cs.PIPELINE_FLAGS, "--classifier-model", cs.MODEL_FILE]
        printed = "".join(run_printed(jcli.main, argv) for argv in pipeline_stages_argv(fq, fa, out, flags))
    finally:
        if old is None:
            os.environ.pop("BGT_CACHE")
        else:
            os.environ["BGT_CACHE"] = old
    n_wave, n_sv = (int(x) for x in DISCOVERY_LINE.search(printed).groups())
    analysis = os.path.join(out, "analysis")
    feats = dict(np.load(os.path.join(analysis, "features.npz")))
    prob = np.asarray(Classifier.load(cs.MODEL_FILE).predict_proba(feats), np.float64)
    (bwt_dir,) = glob.glob(os.path.join(cache, "refbwt_*"))
    bwt = RefBwt.load(bwt_dir)
    occ_words = np.stack([o.words for o in bwt.occ])
    occ_cum = np.stack([o.cum for o in bwt.occ])
    return {
        "made_by": PIPELINE_LEG_COMMAND,
        "source": "the JAX package on the CPU",
        "leg": {
            "genome": {"length": len(genome), "seed": cs.SEED},
            "library": {"generator": "chip_smoke.py::sv_paired_library", "seed": cs.SV_SEED, **library},
            "reads": int(len(lengths)),
            "command": ["full_pipeline", *cs.PIPELINE_ARGS],
        },
        "stages": cs.pipeline_digests(out),
        "records_by_engine": {"wavefront": n_wave, "sv": n_sv},
        "classifier_prob": [float(p) for p in prob],
        "sv_engine": jax_sv_engine(os.path.join(out, "sample.bgt"), fa),
        "bwt": cs.bwt_digests(bwt.sa_sample, occ_words, occ_cum, bwt.counts, bwt.sentinel_pos),
        "recall": cs.sv_recall(read_vcf(os.path.join(analysis, "results.vcf")), truth),
    }


# ---------------------------------------------------------------------------
# the tests, on a toy library: 2250 pairs over 30 kb with a 3 kb deletion
# and a novel insertion of 1-2 kb, no read errors (the uncorrected run's
# plain coverage on the CPU grows with the errors' entries)
# ---------------------------------------------------------------------------

TOY_GENOME = 30_000
TOY = dict(n_pairs=2250, n_het=10, n_hom=10, n_indel=2, hom_dels=0, het_dels=0, big_del=3000, ins=0, long_ins=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_jax_text_hashes(monkeypatch, tmp_path):
    from biograph_tpu.index import probes as _jprobes

    _jprobes._TEXT_HASH_CACHE.clear()
    monkeypatch.setenv("BGT_CACHE", str(tmp_path / "jax_cache"))  # the JAX package's FM-index cache


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(tmp, FASTQ, FASTA, truth, the JAX package's stage commands run with
    --paired --correct and the classifier: their digests, in tmp/run)."""
    cs = _chip_smoke()
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    want = jax_pipeline_sv_leg(tmp, TOY, TOY_GENOME, error_rate=0.0)
    genome = cs.leg_genome(TOY_GENOME)
    _, _, truth = cs.sv_paired_library(genome, **TOY, error_rate=0.0)
    return tmp, os.path.join(tmp, "leg4.fq"), os.path.join(tmp, "leg4.fa"), truth, want


def _text(path, drop_qual=False):
    """A VCF's lines but its ##source= line (and QUAL, with drop_qual)."""
    out = []
    for line in open(path).read().splitlines():
        if line.startswith("##source="):
            continue
        if drop_qual and not line.startswith("#"):
            cols = line.split("\t")
            line = "\t".join(cols[:5] + cols[6:])
        out.append(line)
    return out


def test_pipeline_sv_rehearsal_at_toy_size(toy, monkeypatch):
    """chip_smoke.py's leg 4 on CPU tensors: full_pipeline --paired
    --correct through the port's CLI, equal at every stage to the JAX
    package's stage commands, --resume running nothing, --rerun of each
    stage giving the same artifacts; the SV engine by parts; the FM-index
    against its CPU copy and the JAX digests.  A wrong file must fail."""
    import torch

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "BWT_QUERIES", 512)
    monkeypatch.setattr(cs, "BWT_ABSENT", 64)
    tmp, fq, fa, truth, want = toy
    dev = torch.device("cpu")
    genome = cs.leg_genome(TOY_GENOME)
    os.makedirs(os.path.join(tmp, "port"))
    out, launches, out_dir, fa2, sv_events = cs.pipeline_sv_phase(dev, genome, os.path.join(tmp, "port"), library={**TOY, "error_rate": 0.0}, want=want)
    assert sv_events == truth["sv"]
    assert not any(launches.values())  # CPU tensors: the plain versions
    assert set(out["cold_stage_s"]) == set(out["warm_stage_s"]) == set(cs.PIPELINE_STAGES)
    assert out["sv_pass"]["breakend_lanes"] >= 1 and out["sv_pass"]["walk_steps"] >= 1000
    assert out["recall"] == {"big_del": {"planted": 1, "found": 1}, "long_ins": {"planted": 1, "found": 1}} == want["recall"]
    holds = out["kernel_holds"]
    assert all(set(names) <= set(holds[stage]) for stage, names in cs.PIPELINE_HOLDS.items())
    assert all(h["widest_lanes"] >= h["first_lanes"] > 0 and h["calls"] >= 1 for kernels in holds.values() for h in kernels.values())
    sv = cs.sv_engine_checks(dev, os.path.join(out_dir, "sample.bgt"), fa2, want)
    assert sv["clusters"] >= 1 and sv["walk_steps"] == out["sv_pass"]["walk_steps"] and sv["walk_device_ops"] is None
    bwt = cs.bwt_checks(dev, genome, want)
    assert bwt["absent_found"] == 0
    bad = json.loads(json.dumps(want))
    bad["stages"]["grm"]["sha256"] = "0" * 64
    with pytest.raises(AssertionError, match="grm differs"):
        cs.require_pipeline("bad", out_dir, bad)
    bad = json.loads(json.dumps(want))
    bad["classifier_prob"] = [1 - p for p in bad["classifier_prob"]]
    with pytest.raises(AssertionError, match="QUAL|FILTER"):
        cs.require_pipeline("bad", out_dir, bad)
    bad = json.loads(json.dumps(want))
    bad["sv_engine"]["sv_breakend"]["records"] += 1
    with pytest.raises(AssertionError, match="sv_engine"):
        cs.sv_engine_checks(dev, os.path.join(out_dir, "sample.bgt"), fa2, bad)
    bad["bwt"]["sentinel_pos"] += 1
    with pytest.raises(AssertionError, match="bwt"):
        cs.bwt_checks(dev, genome, bad)


def test_full_pipeline_through_both_clis(toy):
    """full_pipeline --paired with the classifier through both CLIs (the
    JAX package's full_pipeline stops in create with --correct): every
    artifact equal but for ##source= and the uuids; results.vcf's QUAL the
    phred of probabilities within PROB_TOL of the JAX package's."""
    from biograph_tpu import cli as jcli
    from biograph_tpu.classifier.model import Classifier
    from biograph_tpu_torch import cli as tcli
    from test_torch_cli import assert_same_bgt

    cs = _chip_smoke()
    tmp, fq, fa, _, _ = toy
    runs = {}
    for pkg, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        runs[pkg] = os.path.join(tmp, "both", pkg)
        printed = run_printed(main, ["full_pipeline", "--reads", fq, "--ref", fa, "--out", runs[pkg], "--paired", "--classifier-model", cs.MODEL_FILE, *extra])
        assert "full_pipeline: done" in printed
    jrun, trun = runs["jax"], runs["torch"]
    assert_same_bgt(os.path.join(jrun, "sample.bgt"), os.path.join(trun, "sample.bgt"))
    for name in ("discovery", "coverage", "grm"):
        assert _text(os.path.join(trun, "analysis", name + ".vcf")) == _text(os.path.join(jrun, "analysis", name + ".vcf")), name
    assert _text(os.path.join(trun, "analysis", "results.vcf"), True) == _text(os.path.join(jrun, "analysis", "results.vcf"), True)
    jf, tf = (dict(np.load(os.path.join(r, "analysis", "features.npz"))) for r in (jrun, trun))
    # QUAL: the JAX package's is the phred of its float64 probabilities; the
    # port's, of float32 ones, within PROB_TOL of them
    jprob = np.asarray(Classifier.load(cs.MODEL_FILE).predict_proba(jf), np.float64)
    cs.require_qual("the JAX package's results.vcf", os.path.join(jrun, "analysis", "results.vcf"), jprob, 0.0)
    cs.require_qual("the port's results.vcf", os.path.join(trun, "analysis", "results.vcf"), jprob, PROB_TOL)
    assert sorted(jf) == sorted(tf) and all(np.array_equal(jf[k], tf[k]) and jf[k].dtype == tf[k].dtype for k in jf)
    for name in ("timings.json",):
        assert json.load(open(os.path.join(trun, "qc", name))).keys() == json.load(open(os.path.join(jrun, "qc", name))).keys()
    jm, tm = (json.load(open(os.path.join(r, "run_manifest.json"))) for r in (jrun, trun))
    assert list(tm["stages"]) == list(jm["stages"]) == list(cs.PIPELINE_STAGES)
    stats = json.load(open(os.path.join(trun, "qc", "discovery_stats.json")))
    assert stats["n_sv"] >= 1 and stats["sv"]["records"] >= 2


def test_stop_resume_rerun(toy):
    """--stop after discovery halts there; --resume runs the rest, and
    again runs nothing; --resume --rerun grm runs grm alone, to the same
    VCF, and keeps the other stages' manifest records."""
    from biograph_tpu_torch import cli as tcli

    cs = _chip_smoke()
    tmp, fq, fa, _, want = toy
    run = os.path.join(tmp, "stops")
    argv = ["full_pipeline", "--reads", fq, "--ref", fa, "--out", run, *cs.PIPELINE_FLAGS, "--classifier-model", cs.MODEL_FILE, "--device", "cpu"]
    with pytest.raises(SystemExit) as stop:
        run_printed(tcli.main, argv + ["--stop", "discovery"])
    assert stop.value.code == 0
    assert list(json.load(open(os.path.join(run, "qc", "timings.json")))) == ["create", "discovery"]
    assert not os.path.exists(os.path.join(run, "analysis", "coverage.vcf"))
    printed = run_printed(tcli.main, argv + ["--resume"])
    assert printed.count("exists, skipping") == 2 and "full_pipeline: done" in printed
    assert cs.pipeline_digests(run) == want["stages"]

    def manifest():
        with open(os.path.join(run, "run_manifest.json")) as f:
            return json.load(f)["stages"]

    before = manifest()
    printed = run_printed(tcli.main, argv + ["--resume"])
    assert printed.count("exists, skipping") == 5 and manifest() == before
    printed = run_printed(tcli.main, argv + ["--resume", "--rerun", "grm"])
    after = manifest()
    assert printed.count("skipping (--rerun grm)") == 4 and after["grm"]["finished"] >= before["grm"]["finished"]
    assert {k: v for k, v in after.items() if k != "grm"} == {k: v for k, v in before.items() if k != "grm"}
    assert cs.pipeline_digests(run) == want["stages"]


def _bed(path, rows):
    with open(path, "w") as f:
        f.write("# known sites\n")
        for c, lo, hi in rows:
            f.write(f"{c}\t{lo}\t{hi}\n")
    return path


DISCOVERY_CASES = {
    "assemble": ["--mode", "assemble", "--min-depth", "5"],
    "assemble_exclude_iterate": ["--mode", "assemble", "--min-depth", "5", "--exclude", "{bed}", "--iterate", "2"],
    "assemble_no_sv_region_opt": ["--mode", "assemble", "--no-sv", "--region", "chr1:2000-20000", "--opt", "max_path=300"],
    "pileup_reads": ["--mode", "pileup", "--reads", "{fq}", "--min-depth", "4", "--exclude", "{bed}"],
    "pileup_biograph": ["--mode", "pileup", "--min-depth", "4"],
    "golden_parity": ["--mode", "golden-parity", "--reads", "{fq}"],
}


@pytest.mark.parametrize("case", sorted(DISCOVERY_CASES))
def test_discovery_modes(toy, case):
    """discovery in each mode through both CLIs on the JAX package's store:
    the same VCF but for ##source=, the same printed counts."""
    from biograph_tpu import cli as jcli
    from biograph_tpu_torch import cli as tcli

    tmp, fq, fa, truth, _ = toy
    bgt = os.path.join(tmp, "run", "sample.bgt")
    bed = _bed(os.path.join(tmp, "exclude.bed"), [("chr1", 1000, 6000), ("chr1", 5000, 7000), ("chr1", 25000, 25010)])
    args = [a.format(fq=fq, bed=bed) for a in DISCOVERY_CASES[case]]
    outs, printed = {}, {}
    for pkg, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        outs[pkg] = os.path.join(tmp, "modes", f"{case}.{pkg}.vcf")
        os.makedirs(os.path.dirname(outs[pkg]), exist_ok=True)
        more = [] if "--reads" in args else ["--biograph", bgt]
        if case == "assemble":
            more += ["--assemblies-out", outs[pkg] + ".csv", "--stats", outs[pkg] + ".json"]
        lines = run_printed(main, ["discovery", "--ref", fa, "--out", outs[pkg], *more, *args, *extra]).splitlines()
        printed[pkg] = [re.sub(r" \(\d+\.\ds\)", "", x) for x in lines if not x.startswith(("vcf ->", "assemblies:", "options:"))]
    assert _text(outs["torch"]) == _text(outs["jax"])
    assert printed["torch"] == printed["jax"]
    n = len([x for x in _text(outs["torch"]) if not x.startswith("#")])
    assert n > 0 or case == "golden_parity"
    if case == "assemble":
        assert open(outs["torch"] + ".csv").read() == open(outs["jax"] + ".csv").read()
        stats = json.load(open(outs["torch"] + ".json"))
        assert stats["n_sv"] >= 1 and stats["sv"]["breakend_lanes"] >= 1 and "sv" in stats["stage_s"]


def test_discovery_inputs_not_ported_raise(toy, tmp_path):
    from biograph_tpu_torch import cli as tcli

    tmp, fq, fa, _, _ = toy
    bgt = os.path.join(tmp, "run", "sample.bgt")
    # --dist-dir is ported (parallel/discovery.py): at one process it is the plain call
    base = ["discovery", "--mode", "assemble", "--biograph", bgt, "--ref", fa, "--no-sv", "--region", "chr1:0-6000", "--device", "cpu"]
    tcli.main(base + ["--out", str(tmp_path / "plain.vcf")])
    tcli.main(base + ["--out", str(tmp_path / "o.vcf"), "--dist-dir", str(tmp_path / "run")])
    assert (tmp_path / "o.vcf").read_text() == (tmp_path / "plain.vcf").read_text()
    pac = tmp_path / "bwa_ref"
    pac.mkdir()
    (pac / "genome.pac").write_bytes(b"\0")  # no .ann beside it, under no name io/pac.py reads
    with pytest.raises(FileNotFoundError, match="no FASTA or BWA pac index"):
        tcli.main(["discovery", "--mode", "assemble", "--biograph", bgt, "--ref", str(pac), "--out", str(tmp_path / "o.vcf"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--biograph"):
        tcli.main(["discovery", "--mode", "assemble", "--ref", fa, "--out", str(tmp_path / "o.vcf"), "--device", "cpu"])


def test_reference_ref2bwt_bwtquery_grm(toy, tmp_path):
    """reference and ref2bwt artifacts equal to the JAX package's;
    bwtquery's answers; grm with a prebuilt FM-index and with one built
    (JAX: BGT_CACHE; the port: --cache-dir), the same VCF."""
    from biograph_tpu import cli as jcli
    from biograph_tpu_torch import cli as tcli
    from test_torch_cli import assert_artifacts_identical

    tmp, fq, fa, _, _ = toy
    out = {}
    for pkg, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        out[pkg] = d
        main(["reference", "--in", fa, "--out", str(d / "ref")])
        main(["ref2bwt", "--ref", str(d / "ref"), "--out", str(d / "bwt"), *extra])
        printed = "".join(run_printed(main, ["bwtquery", "--bwt", str(d / "bwt"), "--seq", s, *extra])
                          for s in (open(fa).read().split("\n")[1][1000:1040], "ACGT" * 12, "A"))
        (d / "bwtquery.txt").write_text(printed)
        vcf = os.path.join(tmp, "run", "analysis", "coverage.vcf")
        main(["grm", "--vcf", vcf, "--ref", fa, "--bwt", str(d / "bwt"), "--out", str(d / "grm_prebuilt.vcf"), *extra])
        cache = ["--cache-dir", str(d / "cache")] if pkg == "torch" else []
        main(["grm", "--vcf", vcf, "--ref", str(d / "ref"), "--out", str(d / "grm.vcf"), "--k", "30", *cache, *extra])
    j, t = out["jax"], out["torch"]
    assert_artifacts_identical(str(j / "ref"), str(t / "ref"))
    assert_artifacts_identical(str(j / "bwt"), str(t / "bwt"))
    assert (t / "bwtquery.txt").read_text() == (j / "bwtquery.txt").read_text()
    assert "1 occurrence(s)" in (t / "bwtquery.txt").read_text()
    for name in ("grm_prebuilt.vcf", "grm.vcf"):
        assert _text(t / name) == _text(j / name)
    assert any("GRM_UP=" in x for x in _text(t / "grm.vcf")) and len(os.listdir(t / "cache")) == 1


def test_classifiers_train_and_apply(toy, tmp_path):
    """qual_classifier and gt_classifier through both CLIs on the toy run's
    coverage VCF and features: the same labels and records trained on; a
    model trained by either package applied by the other's CLI writes the
    same VCF but for ##source=."""
    from biograph_tpu import cli as jcli
    from biograph_tpu.classifier import model as jmodel
    from biograph_tpu_torch import cli as tcli
    from biograph_tpu_torch.classifier import model as tmodel

    tmp, fq, fa, truth, _ = toy
    analysis = os.path.join(tmp, "run", "analysis")
    vcf, feats = os.path.join(analysis, "coverage.vcf"), os.path.join(analysis, "features.npz")
    with open(tmp_path / "truth.vcf", "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
        for p, r, a in truth["small"][::2]:
            f.write(f"chr1\t{p + 1}\t.\t{r}\t{a}\t.\tPASS\t.\tGT\t1/1\n")
    clis = {"jax": (jcli.main, []), "torch": (tcli.main, ["--device", "cpu"])}
    trained = {}
    for pkg, (main, extra) in clis.items():
        q = run_printed(main, ["qual_classifier", "--train", "--vcf", vcf, "--features", feats, "--truth-vcf", str(tmp_path / "truth.vcf"), "--model", str(tmp_path / f"q_{pkg}.npz"), *extra])
        g = run_printed(main, ["gt_classifier", "--train", "--vcf", vcf, "--features", feats, "--model", str(tmp_path / f"g_{pkg}.npz"), *extra])
        trained[pkg] = (q.split(", train acc")[0], g.split(", train acc")[0])
    assert trained["torch"] == trained["jax"] and "true)" in trained["torch"][0]
    for model in ("jax", "torch"):
        for pkg, (main, extra) in clis.items():
            main(["qual_classifier", "--vcf", vcf, "--features", feats, "--model", str(tmp_path / f"q_{model}.npz"), "--out", str(tmp_path / f"q_{model}_{pkg}.vcf"), *extra])
            main(["gt_classifier", "--vcf", vcf, "--features", feats, "--model", str(tmp_path / f"g_{model}.npz"), "--out", str(tmp_path / f"g_{model}_{pkg}.vcf"), *extra])
        # QUAL is the phred of 1 - p: float32 against float64 moves it by a
        # tenth near p = 1, so it is held through the probabilities
        assert _text(tmp_path / f"q_{model}_torch.vcf", True) == _text(tmp_path / f"q_{model}_jax.vcf", True), model
        assert _text(tmp_path / f"g_{model}_torch.vcf") == _text(tmp_path / f"g_{model}_jax.vcf"), model
        f = dict(np.load(feats))
        tq, jq = tmodel.Classifier.load(str(tmp_path / f"q_{model}.npz"), "cpu"), jmodel.Classifier.load(str(tmp_path / f"q_{model}.npz"))
        np.testing.assert_allclose(tq.predict_proba(f), jq.predict_proba(f), rtol=0, atol=PROB_TOL)


def test_pipeline_kernel_holds_catch_a_wrong_call(monkeypatch):
    """chip_smoke.py's hold of the kernel calls a full_pipeline run kept:
    a stage that never called its kernel fails, and so does a kept output
    that is not the plain version's on the kept inputs."""
    import torch

    from biograph_tpu_torch.ops.rank_cum import rank_cum_plain

    cs = _chip_smoke()
    words = torch.from_numpy(np.random.default_rng(7).integers(-(1 << 31), 1 << 31, (4, 40), dtype=np.int64).astype(np.int32))
    right = rank_cum_plain(words)
    wrong = right.clone()
    wrong[2, 5] += 1
    call, bad_call = (160, [words], right), (160, [words], wrong)
    good = {("create", "rank_cum"): {"calls": 1, "first": call, "widest": call}}
    with pytest.raises(AssertionError, match="never called"):
        cs.hold_kept_calls(good)
    monkeypatch.setattr(cs, "PIPELINE_HOLDS", {"create": ("rank_cum",)})
    assert cs.hold_kept_calls(good) == {"create": {"rank_cum": {"calls": 1, "first_lanes": 160, "widest_lanes": 160}}}
    with pytest.raises(AssertionError, match="rank_cum in the pipeline's create stage, widest call"):
        cs.hold_kept_calls({("create", "rank_cum"): {"calls": 1, "first": call, "widest": bad_call}})


@pytest.mark.slow
def test_pipeline_sv_leg_file_is_the_jax_packages(tmp_path):
    assert jax_pipeline_sv_leg(str(tmp_path)) == _chip_smoke().read_pipeline_leg_file()


if __name__ == "__main__":
    if len(sys.argv) not in (3, 5) or sys.argv[1] != "--write" or (len(sys.argv) == 5 and sys.argv[3] != "--keep"):
        sys.exit("usage: python tests/test_torch_cli_pipeline.py --write OUT.json [--keep DIR]")
    import tempfile
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    if len(sys.argv) == 5:
        os.makedirs(sys.argv[4], exist_ok=True)
        got = jax_pipeline_sv_leg(sys.argv[4])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            got = jax_pipeline_sv_leg(tmp)
    with open(sys.argv[2], "w") as f:
        json.dump(got, f, indent=1)
        f.write("\n")
    print(f"wrote {sys.argv[2]} in {time.time() - t0:.0f} s")
