"""The port's CLI on every read and archive format, against the JAX
package's CLI on the same inputs (the port with ``--device cpu``), exact
equality: ``create`` from BAM, SAM, CRAM and QSEQ (artifacts byte for
byte, and BAM and CRAM equal to FASTQ for the same reads), ``reference``
from a BWA ``.pac`` dir, ``query``, ``dump_flat``, ``metadata``,
``export_fastq``, ``refhash`` and ``stats`` (equal text), ``ref2seqset`` and
``upgrade`` (equal stores), and ``export_aligned`` (equal SAM text, equal
BAM bytes and records read back).  Also the cases of the JAX package's
tests/test_export_aligned.py that need no reference data, on the port."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from biograph_tpu import cli as jcli
from biograph_tpu.io import bam as jbam
from biograph_tpu_torch import cli as tcli
from biograph_tpu_torch.io import bam as tbam
from biograph_tpu_torch.io.bamwrite import SamRecord, write_bam, write_sam
from test_torch_cli import _chip_smoke as _cs
from test_torch_cli import assert_artifacts_identical, assert_same_bgt, both
from test_torch_qseq_pac import write_pac_dir

G, L, PAIRS, FRAG = 4000, 60, 300, 260
COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def library(seed=17):
    """A paired library over a genome of G bases: read 1 from the fragment's
    start, read 2 the reverse complement of its end, 1 % substitutions.
    Returns (genome text, reads in original orientation, [(pos0, reverse)]
    of each read on the genome)."""
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, G))
    reads, where = [], []
    for s in rng.integers(0, G - FRAG, PAIRS):
        for pos0, reverse in ((int(s), False), (int(s) + FRAG - L, True)):
            seg = list(genome[pos0 : pos0 + L])
            for k in np.nonzero(rng.random(L) < 0.01)[0]:
                seg[k] = "ACGT"[("ACGT".index(seg[k]) + int(rng.integers(1, 4))) % 4]
            seg = "".join(seg)
            reads.append(seg[::-1].translate(COMP) if reverse else seg)
            where.append((pos0, reverse))
    return genome, reads, where


def records(reads, where, mapped):
    """The reads as SAM records r<pair>, FLAG 0x1 | 0x40/0x80: read 2 on
    the reverse strand (stored in genome orientation); with ``mapped`` each
    at its place on chr1 (every 23rd unmapped), else all unmapped; a
    secondary and a supplementary copy every 37th read."""
    out = []
    for i, (seq, (pos0, reverse)) in enumerate(zip(reads, where)):
        flag = 0x1 | (0x40 if i % 2 == 0 else 0x80) | (0x10 if reverse else 0)
        stored = seq[::-1].translate(COMP) if reverse else seq
        on = mapped and i % 23 != 5
        rec = SamRecord(qname=f"r{i // 2}", flag=flag | (0 if on else 0x4), rname="chr1" if on else "*", pos=pos0 + 1 if on else 0,
                        mapq=60 if on else 0, cigar=[(L, "M")] if on else [], seq=stored, qual="I" * L)
        out.append(rec)
        if i % 37 == 0:
            out += [SamRecord(**{**rec.__dict__, "flag": rec.flag | extra}) for extra in (0x100, 0x800)]
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("formats"))
    genome, reads, where = library()
    fa = os.path.join(tmp, "genome.fa")
    with open(fa, "w") as f:
        f.write(f">chr1\n{genome}\n")
    codes = np.array([[("ACGT".index(c)) for c in r] for r in reads], np.uint8)
    paths = {"fq": _cs().write_fastq(os.path.join(tmp, "reads.fq"), codes, np.full(len(reads), L, np.int32)), "fa": fa}
    recs = records(reads, where, mapped=True)
    paths["bam"] = os.path.join(tmp, "reads.bam")
    write_bam(paths["bam"], [("chr1", G)], recs)
    paths["sam"] = os.path.join(tmp, "reads.sam")
    write_sam(paths["sam"], [("chr1", G)], records(reads, where, mapped=False))
    paths["cram"] = os.path.join(tmp, "reads.cram")
    _cs().write_cram(paths["cram"], [("chr1", G)], {"chr1": genome}, recs, slice_records=100, container_slices=2,
                     methods={4: "rans0", 22: "gzip", 23: "rans1", 6: "rans1"})
    paths["qseq"] = os.path.join(tmp, "reads.qseq")
    with open(paths["qseq"], "w") as f:
        for i, r in enumerate(reads):
            f.write(f"M1\t7\t1\t1\t{i}\t{i}\t0\t{i % 2 + 1}\t{r}\t{'h' * L}\t1\n")
    paths["vcf"] = os.path.join(tmp, "calls.vcf")
    with open(paths["vcf"], "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos in (700, 1500, 3100):
            f.write(f"chr1\t{pos}\t.\t{genome[pos - 1]}\tN\t50\tPASS\t.\n")
    created = {}
    for fmt in ("bam", "sam", "cram", "qseq"):
        argv = ["create", "--reads", paths[fmt]] + (["--ref", fa] if fmt == "cram" else [])
        created[fmt] = both(tmp, f"{fmt}.bgt", argv)
    created["fq"] = both(tmp, "fq.bgt", ["create", "--reads", paths["fq"], "--paired"])
    return tmp, paths, created


@pytest.mark.parametrize("fmt", ["bam", "sam", "cram", "qseq"])
def test_create_from_each_format(inputs, fmt):
    _, _, created = inputs
    meta = assert_same_bgt(*created[fmt])
    assert meta["num_reads"] == 2 * PAIRS and meta["num_seqset_entries"] > 1000


@pytest.mark.parametrize("fmt", ["bam", "cram"])
def test_bam_and_cram_equal_fastq(inputs, fmt):
    """Pairing by name and FLAG gives the store that interleaved FASTQ
    with --paired gives."""
    _, _, created = inputs
    for part in ("seqset", "readmap"):
        assert_artifacts_identical(os.path.join(created["fq"][1], part), os.path.join(created[fmt][1], part))


def test_create_cram_needs_ref(inputs, tmp_path):
    _, paths, _ = inputs
    with pytest.raises(SystemExit, match="CRAM import needs --ref"):
        tcli.main(["create", "--reads", paths["cram"], "--out", str(tmp_path / "x.bgt"), "--device", "cpu"])


def test_reference_from_pac(inputs, tmp_path):
    tmp, paths, _ = inputs
    genome = open(paths["fa"]).read().split("\n")[1]
    pac = write_pac_dir(tmp_path / "bwa", [("chr1", genome[:2500]), ("chr2", genome[2500:3000] + "N" * 20 + genome[3000:])])
    a, b = str(tmp_path / "jax_ref"), str(tmp_path / "torch_ref")
    jcli.main(["reference", "--in", pac, "--out", a])
    tcli.main(["reference", "--in", pac, "--out", b])
    assert_artifacts_identical(a, b)
    from biograph_tpu_torch.index.reference import Reference

    ref = Reference.load(b)
    assert [c.name for c in ref.contigs] == ["chr1", "chr2"] and int(ref.is_n.sum()) == 20


def run_text(capsys, argv, device=True):
    """Standard output of the JAX CLI and of the port's on one argv."""
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + (["--device", "cpu"] if device else []))
    return capsys.readouterr().out, want


def test_query_stats_refhash_metadata_text(inputs, capsys):
    tmp, paths, created = inputs
    bgt = created["bam"][0]  # the JAX package's store: one metadata for both
    genome = open(paths["fa"]).read().split("\n")[1]
    for q, extra in ((genome[100:140], []), (genome[1000:1003], []), (genome[1000:1003], ["--verbose"]),
                     (genome[5:25], ["--quiet"]), ("ACGT" * 20, [])):
        got, want = run_text(capsys, ["query", "--biograph", bgt, "--query", q, *extra])
        assert got == want and got
    got, want = run_text(capsys, ["stats", bgt])
    assert got == want and "readmap entries" in got
    got, want = run_text(capsys, ["refhash", "--ref", paths["fa"]], device=False)
    assert got == want and len(got.strip()) == 40
    copies = []
    for pkg in ("jax", "torch"):
        copies.append(os.path.join(tmp, f"meta_{pkg}.bgt"))
        shutil.copytree(bgt, copies[-1])
    jcli.main(["metadata", copies[0], "--set-sample-id", "S1", "--set-accession-id", "A1"])
    want = capsys.readouterr().out
    tcli.main(["metadata", copies[1], "--set-sample-id", "S1", "--set-accession-id", "A1"])
    got = capsys.readouterr().out
    assert got.replace("meta_torch", "meta_jax") == want and '"sample_id": "S1"' in got
    assert json.load(open(os.path.join(copies[1], "metadata.json"))) == json.load(open(os.path.join(copies[0], "metadata.json")))


def test_dump_flat_and_export_fastq(inputs, tmp_path, capsys):
    _, _, created = inputs
    bgt = created["bam"][0]
    a, b = both(str(tmp_path), "flat.txt", ["dump_flat", "--biograph", bgt])
    text = open(b).read()
    assert text == open(a).read() and text.count("\n") > 1000
    capsys.readouterr()
    got, want = run_text(capsys, ["dump_flat", "--biograph", bgt])
    assert got == want == text
    a, b = both(str(tmp_path), "reads.fq", ["export_fastq", "--biograph", bgt])
    text = open(b).read()
    assert text == open(a).read() and text.count("\n") == 4 * 2 * PAIRS


def test_ref2seqset_and_upgrade(inputs, tmp_path):
    _, paths, created = inputs
    a, b = both(str(tmp_path), "tiles.bgt", ["ref2seqset", "--ref", paths["fa"], "--read-size", "50"])
    assert_artifacts_identical(os.path.join(a, "seqset"), os.path.join(b, "seqset"))
    ja, ta = (json.load(open(os.path.join(d, "metadata.json"))) for d in (a, b))
    assert ja.pop("biograph_version") != ta.pop("biograph_version") and ja == ta and ta["num_reads"] == G // 50
    # a .bg of the BAM store, in the v1.1 form, upgraded by both CLIs
    from biograph_tpu_torch.convert import seqset_to_numpy
    from biograph_tpu_torch.index.readmap import Readmap
    from biograph_tpu_torch.index.seqset import Seqset

    bgt = created["bam"][1]
    ss = Seqset.load(os.path.join(bgt, "seqset"), "cpu")
    rm = Readmap.load(os.path.join(bgt, "readmap"), ss, "cpu")
    bg = _cs().write_bg_dir(str(tmp_path / "sample.bg"), seqset_to_numpy(ss),
                            {f: getattr(rm, f).numpy() for f in ("offsets", "read_lengths", "is_forward", "mate_pair_ptr")},
                            bits={"entry_sizes": 7, "shared": 7, "read_lengths": 7, "mate_loop_ptr": 11})
    a, b = both(str(tmp_path), "up.bgt", ["upgrade", "--in", bg])
    for part in ("seqset", "readmap"):
        assert_artifacts_identical(os.path.join(a, part), os.path.join(b, part))
    assert_artifacts_identical(os.path.join(bgt, "seqset"), os.path.join(b, "seqset"))
    up = Readmap.load(os.path.join(b, "readmap"), ss, "cpu")
    for f in ("offsets", "read_lengths", "is_forward", "mate_pair_ptr"):
        assert torch.equal(getattr(up, f), getattr(rm, f)), f
    ja, ta = (json.load(open(os.path.join(d, "metadata.json"))) for d in (a, b))
    assert ja.pop("biograph_version") != ta.pop("biograph_version") and ja == ta


@pytest.mark.parametrize("out", ["aligned.sam", "aligned.bam", "all.sam", "unplaced.bam"])
def test_export_aligned(inputs, tmp_path, out):
    _, paths, created = inputs
    bgt = created["bam"][0]
    argv = ["export_aligned", "--biograph", bgt, "--ref", paths["fa"]]
    if out.startswith("aligned"):
        argv += ["--vcf", paths["vcf"], "--window", "150"]
    elif out.startswith("unplaced"):  # a VCF's windows keep placed reads only
        argv += ["--include-unplaced", "--max-mismatches", "0"]
    a, b = both(str(tmp_path), out, argv)
    assert open(a, "rb").read() == open(b, "rb").read()
    if out.endswith(".bam"):
        got, want = tbam.read_bam(b), jbam.read_bam(a)
        for name in ("codes", "lengths", "quals", "flags"):
            np.testing.assert_array_equal(getattr(got[0], name), getattr(want[0], name))
        assert got[0].names == want[0].names and got[1]["refs"] == want[1]["refs"] == [("chr1", G)]
        assert got[0].num_reads > 0 and ((got[0].flags & 0x4) > 0).any() == out.startswith("unplaced")
    else:
        body = [line for line in open(b) if not line.startswith("@")]
        assert 0 < len(body) < 2 * PAIRS if out.startswith("aligned") else len(body) <= 2 * PAIRS


def _recs():
    return [
        SamRecord(qname="r0", flag=0, rname="chr1", pos=10, mapq=60, cigar=[(8, "M")], seq="ACGTACGT", qual="IIIIIIII", tags={"NM": 1}),
        SamRecord(qname="r1", flag=16, rname="chr1", pos=30, mapq=60, cigar=[(4, "M")], seq="TTGG", tags={"NM": 0}),
        SamRecord(qname="r2", flag=4, rname="*", pos=0, mapq=0, cigar=[], seq="CCCC"),
    ]


def test_bam_roundtrip_own_reader(tmp_path):
    """tests/test_export_aligned.py::test_bam_roundtrip_own_reader on the
    port."""
    p = str(tmp_path / "w.bam")
    assert write_bam(p, [("chr1", 1000)], _recs()) == 3
    batch, hdr = tbam.read_bam(p, with_names=True, keep_unmapped=True)
    assert batch.num_reads == 3
    assert [n.decode() for n in batch.names] == ["r0", "r1", "r2"]
    # reverse-strand reads come back in original orientation: r1 stored as
    # TTGG with FLAG_REVERSE -> CCAA
    assert batch.sequence(0) == "ACGTACGT" and batch.sequence(1) == "CCAA" and batch.sequence(2) == "CCCC"
    assert list(hdr["flags"]) == [0, 16, 4]
    assert batch.quals[0, :8].tolist() == [40] * 8


def test_sam_text(tmp_path):
    """tests/test_export_aligned.py::test_sam_text on the port."""
    p = str(tmp_path / "w.sam")
    assert write_sam(p, [("chr1", 1000)], _recs()) == 3
    lines = open(p).read().splitlines()
    assert lines[0].startswith("@HD") and "@SQ\tSN:chr1\tLN:1000" in lines[1]
    body = [line for line in lines if not line.startswith("@")]
    f = body[0].split("\t")
    assert f[:6] == ["r0", "0", "chr1", "10", "60", "8M"] and "NM:i:1" in f


def test_chip_smoke_formats_leg_at_toy_size_on_the_cpu(tmp_path, monkeypatch):
    """Leg 5 of ``chip_smoke.py`` rehearsed on CPU tensors at a toy size
    (the kernel wrappers take their plain versions there): leg 3's reads as
    BAM through create, held to the JAX package's digests of the same toy
    leg; CRAM against BAM; the .bg round trip; export_aligned; the store
    subcommands.  A part given a wrong answer must fail."""
    from test_torch_cli import jax_create_leg

    cs = _cs()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "GENOME", 20_000)
    monkeypatch.setattr(cs, "READS", 1000)
    monkeypatch.setattr(cs, "SNPS", 16)
    monkeypatch.setattr(cs, "TRIMMED", dict(n_pairs=1500, n_het=30, n_hom=10, n_indel=4))
    monkeypatch.setattr(cs, "CRAM_PAIRS", 300)
    monkeypatch.setattr(cs, "BG_QUERIES", 2048)
    monkeypatch.setattr(cs, "EXPORT_REGION", (0, 6000))
    os.makedirs(tmp_path / "jax")
    want = jax_create_leg(str(tmp_path / "jax"))
    monkeypatch.setattr(cs, "read_create_leg_file", lambda: want)
    genome = cs.simulate(cs.GENOME, cs.READS, cs.SNPS, cs.READ_LEN)[0]
    codes, lengths = cs.corrected_leg_reads(genome)
    fq = cs.write_fastq(str(tmp_path / "leg3.fq"), codes, lengths)
    leg3 = str(tmp_path / "leg3.bgt")
    tcli.main(["create", "--reads", fq, "--out", leg3, *cs.CREATE_ARGS, "--device", "cpu"])
    work = tmp_path / "leg5"
    work.mkdir()
    dev = torch.device("cpu")
    out, launches = cs.formats_phase(dev, genome, str(work), leg3)
    assert out["bam"]["reads"] == 3000 and out["bam"]["records"] > 3000 and 0 < out["bam"]["placed"] < 3000
    assert out["cram"]["reads"] == 600 and out["cram"]["n_entries"] > 0
    assert out["bg"]["queries"] == 2048 and out["bg"]["found"] > 1024 and out["bg"]["read_ids_differ"]
    assert out["bg"]["import_launches"]["rank_cum"] == 0  # the CPU: the plain version, no launch
    assert 0 < out["export"]["region_records"] < out["export"]["records"]
    assert out["store"]["export_fastq_reads"] == 3000 - want["correction"]["dropped"]
    assert out["holds"]["import"]["rank_cum_import"]["calls"] == 2  # BioGraph, then upgrade
    assert set(launches) == set(cs.WRAPPERS) and not any(launches.values())
    bad = dict(want, seqset=dict(want["seqset"], shared="0" * 64))
    with pytest.raises(AssertionError, match="create from BAM differs"):
        cs.formats_bam_part(dev, genome, str(tmp_path / "jax"), bad, codes, lengths)
