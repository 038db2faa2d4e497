"""The port's squareoff and pvcf_pipe against the JAX package's, on a
synthetic trio standing in for tests/test_grm_squareoff.py's lambda trio
(which needs the reference's data).

The trio lives on a genome of 6000 bases.  Father: a hom SNP at 3001 on
both haplotypes, and a het SNP on each.  Mother: a 400-base het deletion
over 2801-3200 on the haplotype she passes on (a symbolic ``<DEL>`` in the
VCFs), and a het SNP on each haplotype.  The proband inherits the father's first haplotype and the
mother's first, so at 3001 only the father's allele is left to read: the
father-only SNP is 1/1 in father and proband, 0/0 in mother, as the lambda
trio's 5897 G>A is.  Each haplotype is read at 20x in 60-base reads, half
reverse-complemented; the proband's reads are trimmed to 40-60 bases, so
coverage takes its general route there (``probe_ranges`` with ``rank``,
then ``chain_window``), and the hash route in the parents.

Each package builds its own stores from the same reads: the father a
``.bgt`` whose metadata names him, the mother a ``.bgt`` without metadata
(her name is the directory's), the proband a reference ``.bg`` whose
bg_info names him.  Both take the truth VCFs as input.  The outputs must be
equal but for the ``##source=`` line, which names each package.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_squareoff.py -q``.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from biograph_tpu.tools import squareoff as jsq
from biograph_tpu_torch.tools import squareoff as tsq
from test_torch_cli import _chip_smoke as _cs

G, L, COVERAGE, SEED = 6000, 60, 20, 29
SNP_F = 3001  # the father-only hom SNP, 1-based
DEL = (2800, 3200)  # the mother's deletion: the record's anchor base, and the last base deleted (1-based)
SAMPLES = ["father", "mother", "proband"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trio(seed=SEED):
    """(genome, {sample: (codes, lengths)}, {sample: [(pos, ref, alt, gt)]})."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G).astype(np.uint8)

    def snp(pos):
        return pos, int(genome[pos - 1]), int((genome[pos - 1] + rng.integers(1, 4)) % 4)

    snp_f, fa1, fa2, mo1, mo2 = snp(SNP_F), snp(1200), snp(4500), snp(800), snp(5200)

    def haplotype(snps, deletion=False):
        h = genome.copy()
        for pos, _, alt in snps:
            h[pos - 1] = alt
        return np.delete(h, np.arange(DEL[0], DEL[1])) if deletion else h

    f1, f2 = haplotype([snp_f, fa1]), haplotype([snp_f, fa2])
    m1, m2 = haplotype([mo1], deletion=True), haplotype([mo2])
    haps = {"father": (f1, f2), "mother": (m1, m2), "proband": (f1, m1)}
    reads = {}
    for si, (name, pair) in enumerate(haps.items()):
        r = np.random.default_rng(seed + 1 + si)
        codes, lengths = [], []
        for h in pair:
            n = COVERAGE * len(h) // L
            for s, flip in zip(r.integers(0, len(h) - L, n), r.random(n) < 0.5):
                read = h[s : s + L]
                codes.append((3 - read)[::-1] if flip else read)
            lengths += [L] * n
        codes, lengths = np.stack(codes).astype(np.uint8), np.array(lengths, np.int32)
        if name == "proband":  # trimmed: mixed read lengths, coverage's general route
            lengths = r.integers(40, L + 1, len(lengths)).astype(np.int32)
            for i, n in enumerate(lengths):
                codes[i, n:] = 0
        reads[name] = (codes, lengths)
    acgt = "ACGT"
    rec = lambda s, gt: (s[0], acgt[s[1]], acgt[s[2]], gt)
    deletion = (DEL[0], acgt[genome[DEL[0] - 1]], "<DEL>", "0/1")  # symbolic: coverage leaves it ./. and the donor without it
    truth = {
        "father": [rec(snp_f, "1/1"), rec(fa1, "0/1"), rec(fa2, "0/1")],
        "mother": [rec(mo1, "0/1"), deletion, rec(mo2, "0/1")],
        "proband": [rec(mo1, "0/1"), rec(fa1, "0/1"), deletion, rec(snp_f, "1/1")],
    }
    return genome, reads, truth


def write_vcf(path, records):
    lines = ["##fileformat=VCFv4.2", f"##contig=<ID=chr1,length={G}>", '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE"]
    sv = f"SVTYPE=DEL;SVLEN={DEL[0] - DEL[1]};END={DEL[1]}"
    lines += [f"chr1\t{p}\t.\t{r}\t{a}\t50\tPASS\t{sv if a == '<DEL>' else '.'}\tGT\t{gt}" for p, r, a, gt in sorted(records)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def jax_store(codes, lengths):
    from biograph_tpu.build.readmap_build import build_readmap
    from biograph_tpu.build.seqset_build import build_seqset

    ss = build_seqset(codes, lengths)
    return ss, build_readmap(ss, codes, lengths)


def torch_store(codes, lengths):
    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.build.seqset_build import build_seqset

    ss = build_seqset(codes, lengths, device="cpu")
    return ss, build_readmap(ss, codes, lengths, device="cpu")


def write_stores(root, build, numpy_fields):
    """The trio's stores as one package builds them: {sample: path}."""
    _, reads, _ = trio()
    paths = {}
    for name in SAMPLES:
        ss, rm = build(*reads[name])
        if name == "proband":
            ssn, rmn = numpy_fields(ss, rm)
            paths[name] = _cs().write_bg_dir(os.path.join(root, "proband_sample.bg"), ssn, rmn, meta={"accession_id": "proband"})
            continue
        path = os.path.join(root, f"{name}.bgt" if name == "mother" else "dad_store.bgt")
        os.makedirs(path)
        ss.save(os.path.join(path, "seqset"))
        rm.save(os.path.join(path, "readmap"))
        if name == "father":
            with open(os.path.join(path, "metadata.json"), "w") as f:
                json.dump({"accession_id": "father"}, f)
        paths[name] = path
    return paths


READMAP_FIELDS = ("offsets", "read_lengths", "is_forward", "mate_pair_ptr")


def jax_numpy(ss, rm):
    out = {f: np.asarray(getattr(ss, f)) for f in ("fixed", "prev_words", "entry_sizes", "shared")}
    out.update(n_entries=int(ss.n_entries), max_entry_len=int(ss.max_entry_len))
    return out, {f: np.asarray(getattr(rm, f)) for f in READMAP_FIELDS}


def torch_numpy(ss, rm):
    from biograph_tpu_torch.convert import seqset_to_numpy

    return seqset_to_numpy(ss), {f: getattr(rm, f).numpy() for f in READMAP_FIELDS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trio"))
    genome, _, truth = trio()
    fa = os.path.join(root, "genome.fa")
    with open(fa, "w") as f:
        f.write(">chr1\n" + "".join("ACGT"[b] for b in genome) + "\n")
    vcfs = [write_vcf(os.path.join(root, f"{s}.vcf"), truth[s]) for s in SAMPLES]
    ped = os.path.join(root, "trio.ped")
    with open(ped, "w") as f:
        f.write("fam\tproband\tfather\tmother\t1\t2\nfam\tfather\t0\t0\t1\t1\nfam\tmother\t0\t0\t2\t1\n")
    stores = {}
    for pkg, build, fields in (("jax", jax_store, jax_numpy), ("torch", torch_store, torch_numpy)):
        os.makedirs(os.path.join(root, pkg))
        stores[pkg] = write_stores(os.path.join(root, pkg), build, fields)
    return dict(root=root, fa=fa, vcfs=vcfs, ped=ped, stores=stores, truth=truth)


def body_and_source(path):
    lines = open(path).read().splitlines()
    return [ln for ln in lines if not ln.startswith("##source=")], [ln for ln in lines if ln.startswith("##source=")]


def genotypes(path, pos):
    """{sample: GT} of the record at pos."""
    lines = open(path).read().splitlines()
    names = [ln for ln in lines if ln.startswith("#CHROM")][0].split("\t")[9:]
    row = [ln.split("\t") for ln in lines if not ln.startswith("#") and ln.split("\t")[1] == str(pos)][0]
    gi = row[8].split(":").index("GT")
    return {n: c.split(":")[gi] for n, c in zip(names, row[9:])}


def assert_father_only_snp(path):
    """tests/test_grm_squareoff.py::test_squareoff_trio's biological check."""
    gts = genotypes(path, SNP_F)
    assert gts["father"] == "1/1" and gts["proband"] == "1/1", gts
    assert gts["mother"] in ("0/0", "./."), gts


def test_union_records(world, tmp_path):
    vcfs = world["vcfs"]
    for paths in (vcfs, vcfs[::-1], [vcfs[2], vcfs[2], vcfs[0]], vcfs[:1]):
        got = [(r.chrom, r.pos, r.ref, r.alt, r.fmt, r.info) for r in tsq.union_records(paths)]
        assert got == [(r.chrom, r.pos, r.ref, r.alt, r.fmt, r.info) for r in jsq.union_records(paths)]
    assert [r.pos for r in tsq.union_records(vcfs)] == [800, 1200, DEL[0], SNP_F, 4500, 5200]


def test_squareoff_synthetic_trio(world, tmp_path):
    """squareoff() in each package on its own stores (``BioGraph`` on the
    CPU for the port): the same VCF but for ##source=, the father-only SNP
    as the lambda trio has it, and each readmap's route as planned."""
    from biograph_tpu.api import BioGraph as JBioGraph
    from biograph_tpu.index.reference import Reference as JReference
    from biograph_tpu_torch.api import BioGraph as TBioGraph
    from biograph_tpu_torch.index.reference import Reference as TReference

    outs = {}
    for pkg, sq, bgcls, refcls, kw in (("jax", jsq, JBioGraph, JReference, {}), ("torch", tsq, TBioGraph, TReference, {"device": "cpu"})):
        bgs = [bgcls(world["stores"][pkg][s], **kw) for s in SAMPLES]
        out = str(tmp_path / f"{pkg}.vcf")
        recs = sq.squareoff(world["vcfs"], bgs, refcls.from_fasta(world["fa"]), out, SAMPLES)
        assert len(recs) == 6
        outs[pkg] = out
        if pkg == "torch":
            assert all(bg.readmap.device.type == "cpu" for bg in bgs)
            rms = {s: bg.readmap for s, bg in zip(SAMPLES, bgs)}
            assert rms["father"].min_read_len == rms["father"].max_read_len == L  # the hash route
            assert rms["proband"].min_read_len < rms["proband"].max_read_len  # the general route
    (jbody, jsrc), (tbody, tsrc) = body_and_source(outs["jax"]), body_and_source(outs["torch"])
    assert jsrc == ["##source=biograph_tpu"] and tsrc == ["##source=biograph_tpu_torch"]
    assert tbody == jbody
    assert [ln for ln in tbody if ln.startswith("#CHROM")][0].endswith("FORMAT\tfather\tmother\tproband")
    assert [ln for ln in tbody if not ln.startswith("#")][0].split("\t")[8] == "GT:GQ:AD:DP"
    for out in outs.values():
        assert_father_only_snp(out)
    assert set(genotypes(outs["torch"], DEL[0]).values()) == {"./."}  # a symbolic allele has no sequence to read
    het = genotypes(outs["torch"], 1200)
    assert het["father"] == het["proband"] == "0/1" and het["mother"] in ("0/0", "./."), het


def run_both_clis(world, tmp_path, capsys, argv, out_flag):
    """One subcommand through both CLIs in this process (the port with
    --device cpu): {pkg: (output path, printed text with the seconds
    masked)}."""
    from biograph_tpu import cli as jcli
    from biograph_tpu_torch import cli as tcli

    seen = {}
    for pkg, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir(parents=True, exist_ok=True)
        out = str(d / "project.vcf")
        main([a.format(**world["stores"][pkg]) for a in argv] + [out_flag, out] + extra)
        printed = capsys.readouterr().out.replace(str(d), "<out>")
        seen[pkg] = (out, re.sub(r"\(\d+\.\ds\)", "(<s>)", printed))
    assert seen["torch"][1] == seen["jax"][1]
    return seen


def test_squareoff_through_both_clis(world, tmp_path, capsys):
    """No --samples: the names come from the father's metadata, the
    mother's directory and the proband's bg_info."""
    argv = ["squareoff", "--vcfs", *world["vcfs"], "--biographs", "{father}", "{mother}", "{proband}", "--ref", world["fa"]]
    seen = run_both_clis(world, tmp_path, capsys, argv, "--out")
    (jbody, _), (tbody, tsrc) = (body_and_source(seen[p][0]) for p in ("jax", "torch"))
    assert tbody == jbody and tsrc == ["##source=biograph_tpu_torch"]
    assert [ln for ln in tbody if ln.startswith("#CHROM")][0].endswith("FORMAT\tfather\tmother.bgt\tproband")
    assert seen["torch"][1] == "squareoff: 6 union records x 3 samples (<s>) -> <out>/project.vcf\n"


def test_pvcf_pipe_through_both_clis(world, tmp_path, capsys):
    """Squareoff, then the Mendelian annotation against the PED; the
    annotated VCF copies the squareoff's header, so it too differs in the
    ##source= line only; the reports are equal byte for byte."""
    argv = ["pvcf_pipe", "--biographs", "{father}", "{mother}", "{proband}", "--vcfs", *world["vcfs"], "-r", world["fa"],
            "-p", world["ped"], "--samples", *SAMPLES]
    seen = run_both_clis(world, tmp_path, capsys, argv, "-o")
    (jbody, _), (tbody, tsrc) = (body_and_source(seen[p][0]) for p in ("jax", "torch"))
    assert tbody == jbody and tsrc == ["##source=biograph_tpu_torch"]
    for suffix in ("_stats.json", "_stats.txt"):
        a, b = (open(seen[p][0].replace(".vcf", suffix)).read() for p in ("jax", "torch"))
        assert a == b
    assert sorted(os.listdir(tmp_path / "torch")) == ["project.vcf", "project_stats.json", "project_stats.txt"]
    body = [ln for ln in tbody if not ln.startswith("#")]
    assert len(body) == 6 and all("sizeCat=" in ln for ln in body)
    assert seen["torch"][1] == ("pvcf: 6 union records x 3 samples (<s>)\n"
                               "pvcf: mendelian-annotated -> <out>/project.vcf (+_stats.json/_stats.txt)\n")
    assert_father_only_snp(seen["torch"][0])
    # without a pedigree: the squareoff alone
    argv = [a for a in argv if a not in ("-p", world["ped"])]
    seen = run_both_clis(world, tmp_path / "noped", capsys, argv, "-o")
    assert body_and_source(seen["torch"][0])[0] == body_and_source(seen["jax"][0])[0]
    assert seen["torch"][1].endswith("pvcf: -> <out>/project.vcf\n")


def test_pvcf_pipe_rejects_a_sample_not_in_the_pedigree(world, tmp_path):
    from biograph_tpu import cli as jcli
    from biograph_tpu_torch import cli as tcli

    for pkg, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        argv = ["pvcf_pipe", "--biographs", world["stores"][pkg]["father"], "--vcfs", world["vcfs"][0], "-r", world["fa"],
                "-p", world["ped"], "--samples", "nobody", "-o", str(tmp_path / f"{pkg}.vcf")]
        with pytest.raises(SystemExit, match="not in pedigree"):
            main(argv + extra)
        assert not os.path.exists(tmp_path / f"{pkg}.vcf")


def test_store_subcommands_default_to_cuda(world, tmp_path, monkeypatch):
    """squareoff and pvcf_pipe open their stores on --device, cuda unless
    told otherwise: without CUDA (made unavailable here, so that a host
    with a card checks the same) they raise before they write."""
    from biograph_tpu_torch import cli as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd, out_flag in (("squareoff", "--out"), ("pvcf_pipe", "-o")):
        out = str(tmp_path / f"{cmd}.vcf")
        argv = [cmd, "--biographs", world["stores"]["torch"]["father"], "--vcfs", world["vcfs"][0], "--ref", world["fa"], out_flag, out]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(argv)
        assert not os.path.exists(out)


def test_chip_smoke_tools_leg_at_toy_size_on_the_cpu(world, tmp_path, monkeypatch):
    """Leg 6 of ``chip_smoke.py`` rehearsed on CPU tensors on the trio's
    port stores (the kernel wrappers take their plain versions there, and
    the kept calls are held all the same): pvcf_pipe through the CLI, the
    kept push_front and chain_window calls of the general route, the union and
    the PED's columns, a region across a seam of coverage batches of 2
    records against the CPU copy (the trio has no SV, so any walkable
    record stands for one), the tools and vdb through the CLI.  A card VCF
    that differs in one genotype inside the region must fail."""
    cs = _cs()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs.cov.annotate_coverage, "__defaults__", (2,))  # batches of 2 records, so the region has a seam
    stores = [world["stores"]["torch"][s] for s in SAMPLES]  # named proband, father, mother by the leg's PED
    out, launches = cs.tools_phase(torch.device("cpu"), str(tmp_path), stores, world["vcfs"], world["fa"], batch=2, seam=1, sv_bases=1)
    assert out["union_records"] == 6 and not any(launches.values())
    assert {s: v["route"] for s, v in out["samples"].items()} == {"proband": "hash", "father": "hash", "mother": "general"}
    assert all(v["records"] == 6 for v in out["samples"].values())
    assert set(out["kernel_holds"]) == {"mother"} and set(out["kernel_holds"]["mother"]) == {"push_front", "chain_window"}
    # the union: 800, 1200, 2800 (<DEL>, not walked), 3001, 4500, 5200; batches of its walkable records 800 1200 | 3001 4500 | 5200
    region = {k: out["region"][k] for k in ("chrom", "from", "to", "seam_pos", "records", "widened_from", "widened_to", "widened_records")}
    assert region == {"chrom": "chr1", "from": 4500, "to": 5200, "seam_pos": 5200, "records": 2,
                      "widened_from": 1200, "widened_to": 5200 + cs.TOOLS_WIDEN, "widened_records": 5}
    assert out["cli"]["exported_records"] == 6
    card = str(tmp_path / "leg6_project.vcf")
    bad = str(tmp_path / "bad.vcf")
    with open(card) as f, open(bad, "w") as g:
        for line in f:
            cols = line.split("\t")
            if not line.startswith("#") and int(cols[1]) == 4500:
                gt = cols[9].split(":", 1)
                cols[9] = ":".join(["1/1" if gt[0] != "1/1" else "0/0", *gt[1:]])
            g.write("\t".join(cols))
    from biograph_tpu_torch.tools.squareoff import union_records

    window, widened = cs.tools_window(union_records(world["vcfs"]), batch=2, seam=1, sv_bases=1)
    assert all(window[k] == out["region"][k] for k in window)
    with pytest.raises(AssertionError, match="differs from the CPU copy"):
        cs.tools_region_check(str(tmp_path), stores, world["fa"], str(tmp_path / "leg6.ped"), list(cs.TOOLS_SAMPLES), bad, window, widened)
