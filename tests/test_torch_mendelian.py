"""The port's pedigree and Mendelian annotator against the JAX package's, on
the inputs of tests/test_mendelian.py's first four tests: the pedigree's
views, ``me_check`` over every genotype triple, ``classify_allele`` and
``size_cat``, and ``mendelian`` through both CLIs (the annotated VCF and the
two reports byte for byte, the printed summary the same), from a file and
from stdin ('-').

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mendelian.py -q``.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

from biograph_tpu.tools import mendelian as jmend
from biograph_tpu.utils.pedigree import Pedigree as JPedigree
from biograph_tpu_torch.tools import mendelian as tmend
from biograph_tpu_torch.utils.pedigree import Pedigree as TPedigree
from test_mendelian import PED, VCF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MORE_PED = PED + "fam3\tkid3\tdad3\tmom3\t2\t1\nfam3\tdad3\t0\t0\t1\t2\n"


def views(ped):
    """Every view of a pedigree as plain values (trios: KeyError where a
    filter dropped a proband's parent)."""
    ids = lambda it: sorted(s.ind_id for s in it)
    try:
        trios = sorted((p.ind_id, f.ind_id, m.ind_id) for p, f, m in ped.trios())
    except KeyError as e:
        trios = ("KeyError", str(e))
    return {
        "samples": {i: (s.fam_id, s.pat_id, s.mat_id, s.sex, s.pheno, s.is_proband, ids(s.offspring),
                        s.father.ind_id if s.father else None, s.mother.ind_id if s.mother else None) for i, s in ped.items()},
        "families": {f: [s.ind_id for s in m] for f, m in ped.families.items()},
        "male": ids(ped.all_male()), "female": ids(ped.all_female()),
        "affected": ids(ped.all_affected()), "unaffected": ids(ped.all_unaffected()),
        "probands": ids(ped.get_trio_probands()),
        "trios": trios,
        "siblings": {i: ids(ped.get_siblings(i)) for i in ped},
    }


@pytest.mark.parametrize("filt", [None, {"inc_fam": ["fam1"]}, {"exc_fam": ["fam2"]}, {"inc_indiv": ["kid1", "dad2", "kid3"]},
                                  {"exc_indiv": ["mom1"]}])
def test_pedigree_views(tmp_path, filt):
    p = tmp_path / "fam.ped"
    p.write_text(MORE_PED)
    jped, tped = JPedigree(str(p)), TPedigree(str(p))
    if filt:
        jped.filter(**filt)
        tped.filter(**filt)
    assert views(tped) == views(jped)
    if filt == {"inc_fam": ["fam1"]}:
        assert sorted(tped) == ["dad1", "kid1", "mom1"]


def test_pedigree_rejects_what_the_jax_one_rejects(tmp_path):
    for text, exc in (("f\ta\t0\t0\n", ValueError), ("f\ta\t0\t0\t1\nf\ta\t0\t0\t1\n", KeyError)):
        p = tmp_path / "bad.ped"
        p.write_text(text)
        for cls in (JPedigree, TPedigree):
            with pytest.raises(exc):
                cls(str(p))


GTS = ["0/0", "0/1", "1/0", "1/1", "0|1", "1|1", "1/2", "./.", ".", "2/2", "0/1:12"]


def test_me_check_every_triple():
    for trio in itertools.product(GTS, repeat=3):
        for ref_count in (False, True):
            assert tmend.me_check(*trio, ref_count=ref_count) == jmend.me_check(*trio, ref_count=ref_count), trio
    assert tmend.me_check("0/1", "1/1", "0/0") == 0 and tmend.me_check("0/1", "0/0", "0/0") == 1
    assert tmend.me_check("0/0", "0/0", "0/0") == -1 and tmend.me_check("0/0", "0/0", "0/0", ref_count=True) == 0


def test_classify_and_sizecat():
    rng = np.random.default_rng(3)
    for _ in range(500):
        ref = "A" * int(rng.integers(1, 40))
        alt = "C" * int(rng.integers(1, 40))
        assert tmend.classify_allele(ref, alt) == jmend.classify_allele(ref, alt)
    for n in list(range(0, 1200)) + [5000, 10**6]:
        assert tmend.size_cat(n) == jmend.size_cat(n)
    assert tmend.classify_allele("ACGTACGT", "ACG") == ("SUBSDEL", 5) and tmend.size_cat(75) == "50-99"
    fmt = ["GT", "DP"]
    for cols in (["0/1:20", "0/1:9", "1/1:15"], ["0/1:.", "0/0:3", "0/1:30"], ["0/1", "1/1", "0/0"]):
        assert tmend.depth_category(fmt, cols) == jmend.depth_category(fmt, cols)
    assert tmend.depth_category(["GT"], ["0/1"]) == 0


FAMILY_VCF = VCF + (
    # a deletion, a multi-allelic site, a big SV and an INFO to extend; one trio incomplete in the VCF (fam3)
    "1\t400\t.\tACGTACGTACGT\tA\t20\tPASS\tSVLEN=-11;\tGT:DP\t0/1:14\t0/1:16\t0/0:3\t1/1:20\t0/1:30\t0/1:25\n"
    "1\t500\t.\tA\tT,TTT\t20\tPASS\t.\tGT:DP\t1/2:14\t0/1:16\t0/2:13\t1/1:20\t0/1:30\t1/1:25\n"
    "2\t10\t.\tA\t" + "T" * 1500 + "\t20\tPASS\t.\tGT:DP\t0/0:14\t0/0:16\t0/0:13\t0/0:20\t0/0:30\t0/0:25\n"
)


def test_annotate_vcf_cli_same_in_both(tmp_path):
    """tests/test_mendelian.py::test_annotate_vcf_cli through both CLIs, from
    a file (with -r) and from stdin."""
    (tmp_path / "fam.ped").write_text(MORE_PED)
    (tmp_path / "fam.vcf").write_text(FAMILY_VCF)
    seen = {}
    for pkg, cli in (("jax", [sys.executable, "-m", "biograph_tpu", "--platform", "cpu"]), ("torch", [sys.executable, "-m", "biograph_tpu_torch"])):
        d = tmp_path / pkg
        d.mkdir()
        procs = [
            subprocess.Popen([*cli, "mendelian", "-v", "../fam.vcf", "-p", "../fam.ped", "-o", "anno.vcf"], cwd=d, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}),
            subprocess.Popen([*cli, "mendelian", "-v", "-", "-p", "../fam.ped", "-r", "-o", "stdin.vcf.gz"], cwd=d, stdin=open(tmp_path / "fam.vcf"),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}),
        ]
        outs = [p.communicate(timeout=300) for p in procs]
        assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
        seen[pkg] = ([o[0] for o in outs], [o[1].splitlines()[-1:] for o in outs], {f: open(d / f, "rb").read() for f in sorted(os.listdir(d))})
    assert seen["torch"] == seen["jax"]
    stdout, stderr, files = seen["torch"]
    assert sorted(files) == ["anno.vcf", "anno_stats.json", "anno_stats.txt", "stdin.vcf.gz", "stdin_stats.json", "stdin_stats.txt"]
    assert stdout[0] == "mendelian: 6 variants, 2 with a family error -> anno.vcf (+_stats.json/_stats.txt)\n"
    assert stderr[0] == ["mendelian: trios missing VCF samples skipped: ['kid3']"]
    info = {ln.split("\t")[1]: ln.split("\t")[7] for ln in files["anno.vcf"].decode().splitlines() if not ln.startswith("#")}
    assert "MEF" not in info["100"] and "MEF=fam1" in info["200"] and "MEF=fam2" in info["300"]
    assert info["400"].startswith("SVLEN=-11;sizeCat=10-49")


def test_annotate_vcf_and_reports(tmp_path):
    """annotate_vcf and MendelReport called directly, both packages."""
    (tmp_path / "fam.ped").write_text(PED)
    (tmp_path / "fam.vcf").write_text(FAMILY_VCF)
    seen = {}
    for pkg, mend, ped in (("jax", jmend, JPedigree), ("torch", tmend, TPedigree)):
        out = tmp_path / f"{pkg}.vcf"
        rep = mend.annotate_vcf(str(tmp_path / "fam.vcf"), str(out), ped(str(tmp_path / "fam.ped")))
        rep.write_json(str(tmp_path / f"{pkg}.json"))
        rep.write_text(str(tmp_path / f"{pkg}.txt"))
        seen[pkg] = (rep.var_count, rep.finalize(), *(open(tmp_path / f"{pkg}{x}").read() for x in (".vcf", ".json", ".txt")))
    assert seen["torch"] == seen["jax"]
    final = seen["torch"][1]
    assert final["fam1"]["type_counts"]["INS"]["tot"] == 1 and final["fam2"]["type_counts"]["REPL"] == {"tot": 2, "err": 1, "pct": 0.5}
