"""The port's ``create``, ``kmers`` and ``merge`` commands against the JAX
package's, on the same small FASTQ files.

Both CLIs run in this process on the CPU (the port with ``--device cpu``).
The stored arrays of every ``.bgt`` must be byte for byte the JAX
package's (``core/container`` is byte-compatible; a manifest differs only
in its uuid and time stamp), ``metadata.json`` equal but for
``biograph_version``, the k-mer text and ``qc/kmer_quality_report.html``
identical, ``qc/create_stats.json`` with the same keys.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cli.py -q``.

``tests/data/torch_create_leg.json`` holds the digests of the JAX package's
CPU run of ``create --paired --correct`` on leg 3 of ``chip_smoke.py`` (leg
2's trimmed, paired, diploid library with 0.5 % substitutions);
``chip_smoke.py`` holds the port's ``create`` on the card to it.  The slow
test at the end makes it anew from the JAX package and compares; to write
it: ``JAX_PLATFORMS=cpu python tests/test_torch_cli.py --write
tests/data/torch_create_leg.json``.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # run as a script: the packages lie at the repo root
    sys.path.insert(0, REPO)

import numpy as np
import pytest
import torch

CREATE_LEG_COMMAND = "JAX_PLATFORMS=cpu python tests/test_torch_cli.py --write tests/data/torch_create_leg.json"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test workers at once: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    """``chip_smoke.py``, which makes leg 3 and holds the file's format."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def small_fastq(path, seed=7, n_pairs=300, L=60, G=3000, error_rate=0.01):
    """An interleaved paired FASTQ over a small genome, with substitutions
    and half the reads trimmed."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    starts = rng.integers(0, G - 300, n_pairs)
    r1 = genome[starts[:, None] + np.arange(L)]
    r2 = (3 - genome[(starts + 300 - L)[:, None] + np.arange(L)])[:, ::-1]
    codes = np.stack([r1, r2], axis=1).reshape(2 * n_pairs, L)
    hit = rng.random(codes.shape) < error_rate
    codes = np.where(hit, (codes + rng.integers(1, 4, codes.shape)) % 4, codes).astype(np.uint8)
    lengths = np.where(rng.random(2 * n_pairs) < 0.5, L - rng.integers(1, 20, 2 * n_pairs), L).astype(np.int32)
    return _chip_smoke().write_fastq(path, codes, lengths)


def both(tmp, name, argv):
    """Run the JAX package's CLI and the port's (on the CPU) on the same
    arguments, each writing ``<tmp>/<package>/<name>``; returns the two
    output paths."""
    from biograph_tpu import cli as jcli
    from biograph_tpu_torch import cli as tcli

    outs = []
    for pkg, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        out = os.path.join(tmp, pkg, name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        main([a.replace("{pkg}", pkg) for a in argv] + ["--out", out] + extra)
        outs.append(out)
    return outs


def assert_artifacts_identical(jax_dir, torch_dir):
    """Every stored array byte for byte; the manifests equal but for the
    uuids and the time stamp."""
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(torch_dir)) and "manifest.json" in names
    for name in names:
        a = open(os.path.join(jax_dir, name), "rb").read()
        b = open(os.path.join(torch_dir, name), "rb").read()
        if name != "manifest.json":
            assert a == b, name
            continue
        a, b = json.loads(a), json.loads(b)
        for m in (a, b):
            del m["uuid"], m["created"]
            m["scalars"].pop("seqset_uuid", None)
        assert a == b


def assert_same_bgt(jax_dir, torch_dir):
    for part in ("seqset", "readmap"):
        assert_artifacts_identical(os.path.join(jax_dir, part), os.path.join(torch_dir, part))
    ja, ta = (json.load(open(os.path.join(d, "metadata.json"))) for d in (jax_dir, torch_dir))
    assert ja.pop("biograph_version") == "biograph_tpu-0.1" and ta.pop("biograph_version") == "biograph_tpu_torch-0.1"
    assert ja == ta
    report = "qc/kmer_quality_report.html"
    assert open(os.path.join(jax_dir, report)).read() == open(os.path.join(torch_dir, report)).read()
    js, ts = (json.load(open(os.path.join(d, "qc", "create_stats.json"))) for d in (jax_dir, torch_dir))
    assert js.keys() == ts.keys() and js["timings"].keys() == ts["timings"].keys()
    assert [s["name"] for s in js["stages"]] == [s["name"] for s in ts["stages"]]
    assert js["counters"] == ts["counters"] and js["kmer_quality"] == ts["kmer_quality"]
    return ta


CREATE_CASES = {
    "plain": [],
    "correct_paired": ["--correct", "--paired"],
    "cut_sample_correct": ["--correct", "--paired", "--cut-reads", "3-52", "--sample-reads", "0.6"],
}


@pytest.fixture(scope="module")
def created(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    fq = small_fastq(os.path.join(tmp, "reads.fq"))
    return tmp, fq, {name: both(tmp, name + ".bgt", ["create", "--reads", fq, *flags]) for name, flags in CREATE_CASES.items()}


@pytest.mark.parametrize("case", sorted(CREATE_CASES))
def test_create(created, case):
    jax_dir, torch_dir = created[2][case]
    meta = assert_same_bgt(jax_dir, torch_dir)
    stats = json.load(open(os.path.join(torch_dir, "qc", "create_stats.json")))
    assert meta["num_seqset_entries"] > 1000
    assert meta["paired"] == ("--paired" in CREATE_CASES[case])
    assert (stats["counters"]["num_corrected"] > 0) == ("--correct" in CREATE_CASES[case])
    assert meta["num_reads"] == (360 if "--sample-reads" in CREATE_CASES[case] else 600)


def test_kmers(created):
    tmp, fq, _ = created
    a, b = both(tmp, "kmers.txt", ["kmers", "--reads", fq, "--kmer-size", "19"])
    text = open(b, "rb").read()
    assert text == open(a, "rb").read() and text.count(b"\n") > 1000


def test_merge(created):
    tmp, _, outs = created
    argv = ["merge", "--biographs"] + [os.path.join(tmp, "{pkg}", n + ".bgt") for n in ("plain", "correct_paired")]
    a, b = both(tmp, "merged", argv)
    assert_artifacts_identical(os.path.join(a, "seqset"), os.path.join(b, "seqset"))
    for name in ("plain.bgt", "correct_paired.bgt"):
        assert_artifacts_identical(os.path.join(a, "readmap_" + name), os.path.join(b, "readmap_" + name))
    ja, ta = (json.load(open(os.path.join(d, "metadata.json"))) for d in (a, b))
    assert ja.pop("biograph_version") != ta.pop("biograph_version") and ja == ta


def test_inputs_not_ported_yet_raise(tmp_path):
    from biograph_tpu_torch import cli as tcli

    for name, module in (("r.bam", "io/bam.py"), ("r.sam", "io/bam.py"), ("r.cram", "io/cram.py"), ("r.qseq.gz", "io/qseq.py")):
        with pytest.raises(NotImplementedError, match=module):
            tcli.main(["create", "--reads", str(tmp_path / name), "--out", str(tmp_path / "o.bgt"), "--device", "cpu"])


def test_help_lists_what_exists(capsys):
    from biograph_tpu_torch import cli as tcli

    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    out = capsys.readouterr().out
    assert "{version,create,kmers,merge,reference,ref2bwt,bwtquery,discovery,coverage,full_pipeline,grm,qual_classifier,gt_classifier}" in out
    assert "squareoff" not in out and "vdb" not in out
    tcli.main(["version"])
    assert capsys.readouterr().out.startswith("biograph_tpu_torch version ")
    with pytest.raises(SystemExit):
        tcli.main(["discovery"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["kmers", "--reads", "x.fq", "--out", "y.txt"])


def test_qc_helpers(created, tmp_path):
    """``tools/qc.py``'s fingerprint and aggregation are the JAX package's
    on the same inputs; the k-mer histogram and threshold too."""
    from biograph_tpu.tools import qc as jqc
    from biograph_tpu_torch.convert import reference_from_numpy
    from biograph_tpu_torch.tools import qc as tqc

    rng = np.random.default_rng(3)
    ref = reference_from_numpy(rng.integers(0, 4, 900).astype(np.uint8), np.zeros(900, bool), [("b", 0, 500), ("a", 500, 400)])
    assert tqc.refhash(ref) == jqc.refhash(ref)
    dirs = [os.path.join(created[0], "torch", n + ".bgt") for n in sorted(CREATE_CASES)]
    assert tqc.aggregate_qc(dirs) == jqc.aggregate_qc(dirs) and len(tqc.aggregate_qc(dirs)) == 3
    totals = rng.integers(0, 150, 5000)
    np.testing.assert_array_equal(tqc.kmer_histogram(totals), jqc.kmer_histogram(totals))
    assert tqc.error_threshold(tqc.kmer_histogram(totals)) == jqc.error_threshold(jqc.kmer_histogram(totals))


def jax_create_leg(tmp):
    """The JAX package's ``create`` of leg 3 on the CPU, and the k-mer
    counts, filter and correction its ``create`` makes, as digests."""
    from biograph_tpu import cli as jcli
    from biograph_tpu.build.correct import correct_reads
    from biograph_tpu.io.fastq import read_fastq
    from biograph_tpu.kmers.count import count_kmers
    from biograph_tpu.kmers.kmer_set import KmerSet

    cs = _chip_smoke()
    genome = cs.simulate(cs.GENOME, cs.READS, cs.SNPS, cs.READ_LEN)[0]
    codes, lengths = cs.corrected_leg_reads(genome)
    fq = cs.write_fastq(os.path.join(tmp, "leg3.fq"), codes, lengths)
    out = os.path.join(tmp, "leg3.bgt")
    jcli.main(["create", "--reads", fq, "--out", out, *cs.CREATE_ARGS])
    batch = read_fastq(fq)
    kc = count_kmers(batch.codes, batch.lengths, k=23)
    text = os.path.join(tmp, "kmers.txt")
    kc.write_text(text)
    stats = {}
    ks = KmerSet.from_counts(kc, min_count=2, stats_out=stats)
    res = correct_reads(ks, batch.codes, batch.lengths, max_corrections=8, min_good_run=2)
    digests = cs.create_leg_digests(out, text, len(kc.kmers), stats, res.codes, res.lengths, res.corrections)
    library = {
        "genome": {"length": cs.GENOME, "seed": cs.SEED},
        "library": {"generator": "chip_smoke.py::trimmed_paired_library", "seed": cs.SEED + 31, **cs.TRIMMED},
        "errors": {"model": "uniform substitutions, each base of a read independently, "
                            "the new base one of the other three at random",
                   "rate": cs.ERROR_RATE, "seed": cs.ERROR_SEED},
        "reads": int(len(lengths)),
        "create": ["create", *cs.CREATE_ARGS],
    }
    return {"made_by": CREATE_LEG_COMMAND, "source": "the JAX package on the CPU", "leg": library, **digests}


@pytest.mark.slow
def test_create_leg_file_is_the_jax_packages(tmp_path):
    assert jax_create_leg(str(tmp_path)) == _chip_smoke().read_create_leg_file()


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--write":
        sys.exit("usage: python tests/test_torch_cli.py --write OUT.json")
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        got = jax_create_leg(tmp)
    with open(sys.argv[2], "w") as f:
        json.dump(got, f, indent=1)
        f.write("\n")
