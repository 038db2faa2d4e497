"""The port's cohort VCF utilities against the JAX package's, on the inputs
of tests/test_vcf_tools.py: ``hwe_exact`` (the same values, both against the
brute-force distribution), ``sample_paste``, ``freq_filter``,
``vcf_to_ml_table`` and ``rvg_cleaner`` (the same files, byte for byte, and
the same returns), and their subcommands through both CLIs as processes,
their stdin and stdout defaults included.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vcf_tools.py -q``.
"""

import os
import subprocess
import sys

import pytest

from biograph_tpu.tools import vcf_tools as jtools
from biograph_tpu_torch.tools import vcf_tools as ttools
from test_vcf_tools import SITES, _brute_hwe, _single_sample_vcf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"jax": [sys.executable, "-m", "biograph_tpu", "--platform", "cpu"], "torch": [sys.executable, "-m", "biograph_tpu_torch"]}


@pytest.mark.parametrize(
    "het,hom_r,hom_c",
    [(57, 14, 50), (20, 0, 80), (0, 10, 90), (3, 1, 2), (100, 0, 0), (1, 0, 1)],
)
def test_hwe_exact_same_in_both_packages(het, hom_r, hom_c):
    got = ttools.hwe_exact(het, hom_r, hom_c)
    assert got == jtools.hwe_exact(het, hom_r, hom_c)
    want = _brute_hwe(het, hom_r, hom_c)
    assert got[0] == pytest.approx(want[0], rel=1e-9)
    assert got[1] == pytest.approx(want[1], rel=1e-9)


@pytest.fixture
def cohort(tmp_path):
    """tests/test_vcf_tools.py's inputs: two single-sample VCFs on the same
    loci, a third on other loci, the four-sample site of the ML table and
    the lines of the rvg_cleaner test."""
    d = tmp_path / "in"
    d.mkdir()
    v1 = _single_sample_vcf(d / "s1.vcf", "S1", [(c, p, r, a, "0/1", "8,5") for c, p, r, a in SITES])
    v2 = _single_sample_vcf(d / "s2.vcf", "S2", [SITES[0] + ("1/1", "0,9"), SITES[1] + ("./.", "."), SITES[2] + ("0/0", "12,0")])
    v3 = _single_sample_vcf(d / "s3.vcf", "S3", [("1", 101, "A", "T", "0/1", "1,1")] * 3)
    ml = d / "cohort.vcf"
    ml.write_text("\n".join([
        "##fileformat=VCFv4.2",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="AD">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB\tC\tD",
        "1\t100\t.\tA\tT\t50\tPASS\t.\tGT:AD\t1/1:0,9\t0/1:5,4\t0/1:6,3\t0/0:11,0",
        # a multi-allelic site, a haploid call and a missing one; a site whose INFO carries the stats
        "1\t150\t.\tA\tT,G\t50\tPASS\t.\tGT:AD\t1/2:0,4,5\t0/1:5,4,0\t1:0,3,0\t./.:.",
        "2\t7\t.\tC\tG\t50\tPASS\tAF=0.25;AC=2;HWE=0.5\tGT:AD\t0/1:3,3\t0/0:8,0\t0/1:2,2\t0/0:9,0",
    ]) + "\n")
    rvg = d / "rvg.vcf"
    rvg.write_text("\n".join([
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS",
        "1\t50\t.\tA\tT\t9\tPASS\tPC=0\tGT:PS\t0|1:7",
        "1\t60\t.\tG\tC\t9\tPASS\tPC=0\tGT\t0/1",
        "1\t70\t.\tT\tG\t9\tPASS\tPC=4\tGT\t0/1",
        "1\t100\t.\t" + "A" * 60 + "\tA\t50\tPASS\tSVLEN=-59;PC=9\tGT:PS\t1|1:7",
        "1\t200\t.\tC\tA\t9\tPASS\tPC=0\tGT:PS\t1|0:7",
        "2\t10\t.\tA\tG\t9\tPASS\tPC=0\tGT:PS\t0|1:7",
        "2\t20\t.\tA\tG\t9\tPASS\tPC=0\tGT:PS\t0|1:8",
    ]) + "\n")
    return {"v1": v1, "v2": v2, "v3": v3, "ml": str(ml), "rvg": str(rvg)}


def both(tmp_path, fn, *args, **kw):
    """fn's result and output file in each package, equal: (return, text)."""
    out = {}
    for pkg, mod in (("jax", jtools), ("torch", ttools)):
        path = str(tmp_path / f"{pkg}_{fn}.out")
        ret = getattr(mod, fn)(*args, path, **kw)
        out[pkg] = (ret, open(path).read())
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_sample_paste_and_freq_filter(tmp_path, cohort):
    n, text = both(tmp_path, "sample_paste", [cohort["v1"], cohort["v2"]])
    assert n == 3 and text.splitlines()[[ln.startswith("#CHROM") for ln in text.splitlines()].index(True)].endswith("S1\tS2")
    for mod in (jtools, ttools):
        with pytest.raises(ValueError, match="loci mismatch"):
            mod.sample_paste([cohort["v1"], cohort["v3"]], str(tmp_path / "x.vcf"))
        with pytest.raises(ValueError, match="duplicate sample names"):
            mod.sample_paste([cohort["v1"], cohort["v1"]], str(tmp_path / "x.vcf"))
    pasted = str(tmp_path / "torch_sample_paste.out")
    for kw in ({"min_observations": 6, "min_individuals": 2}, {}, {"min_observations": 20, "min_individuals": 3},
               {"depth_field": "XX"}):
        stats, text = both(tmp_path, "freq_filter", pasted, **kw)
        kept = sum(1 for ln in text.splitlines() if not ln.startswith("#"))
        # a record without the depth field passes through uncounted
        assert (stats["pass"], kept) == ((0, 3) if kw.get("depth_field") else (kept, kept))
    for mod in (jtools, ttools):  # a field that holds no depth
        with pytest.raises(ValueError, match="invalid literal"):
            mod.freq_filter(pasted, str(tmp_path / "x.vcf"), depth_field="GT")
    stats, text = both(tmp_path, "freq_filter", pasted, min_observations=6, min_individuals=2)
    poss = {ln.split("\t")[1] for ln in text.splitlines() if not ln.startswith("#")}
    assert "200" not in poss and "100" in poss


def test_vcf_to_ml_table(tmp_path, cohort):
    n, text = both(tmp_path, "vcf_to_ml_table", cohort["ml"])
    assert n == 2 + 3 + 2
    alt_row = text.splitlines()[2].split("\t")
    stats = dict(zip(["AF", "MAF", "AC", "AC_Het", "AC_Hom", "AC_Hemi", "HWE", "ExcHet"], alt_row[1:9]))
    assert stats["AF"] == "0.5" and stats["AC"] == "4" and stats["AC_Het"] == "2" and stats["AC_Hom"] == "2"
    assert float(stats["HWE"]) == pytest.approx(_brute_hwe(2, 1, 1)[0], rel=1e-6)


def test_rvg_cleaner(tmp_path, cohort):
    stats, text = both(tmp_path, "rvg_cleaner", cohort["rvg"])
    assert [ln.split("\t")[1] for ln in text.splitlines() if not ln.startswith("#")] == ["70", "100", "50", "200"]
    assert stats == {"sv": 1, "paired": 1, "inphase": 2, "dropped": 3}


def test_subcommands_through_both_clis(tmp_path, cohort):
    """Each tool's subcommand with its defaults, through both CLIs as
    processes (each package's run at once): vcf_sample_paste to /dev/stdout,
    piped into freq_filter reading '-', piped into rvg_cleaner reading
    /dev/stdin; vcf_to_ml_table to /dev/stdout; each summary on stderr."""
    runs = {}
    for pkg, cli in CLIS.items():
        d = tmp_path / pkg
        d.mkdir()
        x = " ".join(cli)
        script = (f"set -o pipefail; {x} vcf_sample_paste {cohort['v1']} {cohort['v2']} 2> paste.err"
                  f" | tee paste.vcf | {x} freq_filter -v - -m 6 -i 2 2> freq.err | tee freq.vcf | {x} rvg_cleaner 2> rvg.err > rvg.vcf & a=$!;"
                  f" {x} rvg_cleaner < {cohort['rvg']} > rvg_own.vcf 2> rvg_own.err & b=$!;"
                  f" {x} vcf_to_ml_table {cohort['ml']} > ml.tsv 2> ml.err & c=$!; wait $a && wait $b && wait $c")
        runs[pkg] = subprocess.Popen(["bash", "-c", script], cwd=d, env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    outs = {}
    for pkg, r in runs.items():
        assert r.wait(timeout=300) == 0, pkg
        d = tmp_path / pkg
        outs[pkg] = {f: open(d / f).read() for f in sorted(os.listdir(d))}
    assert outs["torch"] == outs["jax"]
    got = outs["torch"]
    assert got["paste.err"].splitlines()[-1] == "vcf_sample_paste: 3 records -> /dev/stdout"
    assert got["freq.err"].splitlines()[-1] == "freq_filter: {'pass': 1, 'low_obs': 1, 'low_indiv': 0, 'both': 1}"
    assert got["rvg_own.err"].splitlines()[-1] == "rvg_cleaner: {'sv': 1, 'paired': 1, 'inphase': 2, 'dropped': 3}"
    assert got["ml.err"].splitlines()[-1] == "vcf_to_ml_table: 7 allele rows -> /dev/stdout"
    assert got["paste.vcf"] == both(tmp_path, "sample_paste", [cohort["v1"], cohort["v2"]])[1]
    assert got["ml.tsv"] == both(tmp_path, "vcf_to_ml_table", cohort["ml"])[1]
    assert got["rvg_own.vcf"] == both(tmp_path, "rvg_cleaner", cohort["rvg"])[1]
