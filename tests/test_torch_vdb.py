"""The port's VDB warehouse and filter language against the JAX package's,
on the inputs of tests/test_vdb.py and tests/test_tools.py's VDB round trip.

Each scenario runs the same operations on a warehouse of each package, over
the same input files: what every call returns, every file it writes (but for
the ``##source=`` line, which names each package) and every table's rows
must be equal.  The columns that hold a wall-clock time (``imported_on``,
study_meta's ``created_on`` value) are masked by name; a ``uuid4`` id, in an
``aid`` column or wherever a call returns or prints it, is replaced by the
order in which it first appeared, so rows that link tables by aid still
compare.  The filter fuzz holds the two packages' ``translate``
to the same string over the same 300 seeded expressions.  The CLI's ``vdb``
groups run through both CLIs.

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vdb.py -q``.
"""

import os
import random
import re
import sqlite3
import subprocess
import sys

import pytest

from biograph_tpu.tools import vdb as jvdb
from biograph_tpu.tools import vdb_filter as jfilter
from biograph_tpu_torch.tools import vdb as tvdb
from biograph_tpu_torch.tools import vdb_filter as tfilter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jvdb, jfilter), "torch": (tvdb, tfilter)}
MASKED = ("imported_on",)


def _vcf(path, sample, records, refname="e_coli"):
    """records: (chrom, pos1, ref, alt, qual, filt, info, gt); tests/test_vdb.py's writer."""
    lines = [
        "##fileformat=VCFv4.2",
        f"##reference={refname}",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="DP">',
        f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}",
    ]
    for chrom, pos, ref, alt, qual, filt, info, gt in records:
        lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t{qual}\t{filt}\t{info}\tGT:DP\t{gt}:9")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


A_RECORDS = [
    ("1", 100, "A", "T", 50, "PASS", "SVTYPE=SNP", "0/1"),
    ("1", 200, "G", "C", 9, "lowq", ".", "1/1"),
    ("2", 5, "T", "TA", 99, "PASS", "SVLEN=1", "0/1"),
]
B_RECORDS = [("1", 100, "A", "T", 77, "PASS", "SVTYPE=SNP", "1/1"), ("2", 300, "C", "G", 31, "PASS", ".", "0/1")]


@pytest.fixture
def inputs(tmp_path):
    """The input VCFs of tests/test_vdb.py, shared by both packages."""
    d = tmp_path / "in"
    d.mkdir()
    return {
        "a": _vcf(d / "a.vcf", "HG002", A_RECORDS),
        "b": _vcf(d / "b.vcf", "HG003", B_RECORDS),
        "anno": _vcf(d / "anno.vcf", "ANNO", [("1", 100, "A", "T", 1, ".", "GENE=thrA;DB=1", "0/0")]),
        "r1": _vcf(d / "r1.vcf", "S1", [("1", 1, "A", "T", 9, "PASS", ".", "0/1")]),
        "r2": _vcf(d / "r2.vcf", "S2", [("1", 2, "C", "G", 9, "PASS", ".", "0/1")], refname="grch38"),
        "u": _vcf(d / "u.vcf", "S", [("chr10", 5, "A", "T", 9, "PASS", ".", "0/1"), ("chr2", 9, "C", "G", 9, "PASS", ".", "0/1")]),
        "dir": str(d),
    }


class Transcript(list):
    """What a scenario saw: values, with aids replaced by their order of
    appearance, files by their text without the ##source= line, and
    exceptions by their type."""

    def __init__(self):
        super().__init__()
        self.aids = {}

    def aid(self, a):
        return self.aids.setdefault(a, f"<aid{len(self.aids)}>")

    def unaid(self, x):
        if isinstance(x, str):
            for a, name in self.aids.items():
                x = x.replace(a, name)
            return x
        if isinstance(x, (list, tuple)):
            return type(x)(self.unaid(y) for y in x)
        if isinstance(x, dict):
            return {k: self.field(k, v) for k, v in x.items()}
        return x

    def field(self, column, v):
        """A column's value: masked if it holds a time, an aid's alias if it
        holds an aid."""
        if column in MASKED:
            return "<masked>"
        if column == "aid" and isinstance(v, str):
            return self.aid(v)
        return self.unaid(v)

    def value(self, x):
        self.append(self.unaid(x))
        return x

    def file(self, path):
        self.append([ln for ln in open(path).read().splitlines() if not ln.startswith("##source=")])

    def raises(self, exc, fn, *args, **kw):
        with pytest.raises(exc) as e:
            fn(*args, **kw)
        self.append(type(e.value).__name__)


def tables(db_dir, t):
    """Every table's rows, sorted: the time columns masked by name, and each
    aid replaced by its alias in the transcript ``t`` (new aids get theirs
    in the order the tables give them)."""
    conn = sqlite3.connect(os.path.join(db_dir, "vdb.sqlite"))
    out = {}
    for (name,) in conn.execute("SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name"):
        cur = conn.execute(f"SELECT * FROM {name}")
        cols = [c[0] for c in cur.description]
        rows = []
        for row in cur:
            row = [t.field(c, v) for c, v in zip(cols, row)]
            if name == "study_meta" and row[1] == "created_on":
                row[2] = "<masked>"
            rows.append(tuple(row))
        out[name] = (cols, sorted(rows, key=repr))
    conn.close()
    return out


def load_two_samples(t, db, inputs):
    a1, n1 = db.import_vcf(inputs["a"])
    a2, n2 = db.import_vcf(inputs["b"])
    t.aid(a1), t.aid(a2)
    t.value((a1, n1, a2, n2))
    assert (n1, n2) == (3, 2)
    return a1, a2


def vcf_group(t, mod, db, inputs, tmp):
    a1, _ = load_two_samples(t, db, inputs)
    lst = t.value(db.list_vcfs())
    assert [r["sample_name"] for r in lst] == ["HG002", "HG003"] and lst[0]["refname"] == "e_coli"
    out = os.path.join(tmp, "x.vcf")
    assert t.value(db.export_vcf(a1, out)) == 3
    t.file(out)
    assert t.value(db.delete_vcf(a1)) == 1
    t.value(db.list_vcfs())


def study_lifecycle(t, mod, db, inputs, tmp):
    load_two_samples(t, db, inputs)
    db.create_study("fam")
    t.raises(ValueError, db.create_study, "fam")
    assert t.value(db.add_to_study("fam", ["HG00*"])) == 1
    assert t.value(db.show_study("fam"))["samples"] == [("HG002", 3), ("HG003", 2)]
    assert t.value(db.filter_study("fam", "filter != PASS", exclude=True)) == (2, 4)
    assert t.value(db.filter_study("fam", "qual > 40")) == (3, 3)
    assert t.value(db.revert_study("fam")) == 2
    t.value(db.current_checkpoint("fam"))
    db.freeze_study("fam")
    t.raises(ValueError, db.add_to_study, "fam", ["HG002"])
    db.freeze_study("fam", frozen=False)
    db.create_study("fam2")
    t.value(db.copy_from_study("fam", 1, "fam2", ["HG003"]))
    t.value(db.show_study("fam2"))
    t.value([name for name, _ in db.list_studies()])
    db.delete_study("fam2")
    t.value(db._study_exists("fam2"))


def study_export_multisample(t, mod, db, inputs, tmp):
    load_two_samples(t, db, inputs)
    db.create_study("s")
    db.add_to_study("s", ["HG002", "HG003"])
    for name, kw in (("m.vcf", {}), ("sq.vcf", {"square_off": "HG003"}), ("c.vcf", {"chromosomal": True, "fields": ["GT"]}),
                     ("nh.vcf", {"no_header": True, "checkpoint": 1})):
        out = os.path.join(tmp, name)
        t.value(db.export_study("s", out, **kw))
        t.file(out)
    t.raises(ValueError, db.export_study, "s", os.path.join(tmp, "bad.vcf"), square_off="nobody")


def study_missingness_filter(t, mod, db, inputs, tmp):
    load_two_samples(t, db, inputs)
    db.create_study("m")
    db.add_to_study("m", ["HG002", "HG003"])
    assert t.value(db.filter_study("m", "F_MISS > 0.4", exclude=True))[1] == 2
    t.value(db.filter_study("m", "SAMPLE_MISS < 0.5"))


def anno_join(t, mod, db, inputs, tmp):
    load_two_samples(t, db, inputs)
    imported = db.import_anno(inputs["anno"], name="genes")
    t.aid(imported[0])
    t.value(imported)
    assert t.value(db.list_annos())[0]["anno_name"] == "genes"
    aout = os.path.join(tmp, "anno_out.vcf")
    assert t.value(db.export_anno("genes", aout)) == 1
    t.file(aout)
    db.create_study("a")
    db.add_to_study("a", ["HG002"])
    out = os.path.join(tmp, "a.vcf")
    db.export_study("a", out, anno="genes")
    t.file(out)
    t.value(db.delete_anno(*[r["aid"] for r in db.list_annos()]))


def mixed_reference_rejected(t, mod, db, inputs, tmp):
    t.aid(db.import_vcf(inputs["r1"])[0])
    t.aid(db.import_vcf(inputs["r2"])[0])
    db.create_study("x")
    t.raises(ValueError, db.add_to_study, "x", ["S1", "S2"])


def raw_query_and_sort(t, mod, db, inputs, tmp):
    load_two_samples(t, db, inputs)
    t.value(db.query("SELECT sample_name, COUNT(*) FROM variants GROUP BY sample_name ORDER BY sample_name"))
    t.raises(ValueError, db.query, "DELETE FROM variants")
    for chromosomal in (True, False):
        out = os.path.join(tmp, f"sorted_{chromosomal}.vcf")
        t.value(mod.sort_vcf(inputs["u"], out, chromosomal=chromosomal))
        t.file(out)


SCENARIOS = {f.__name__: f for f in (vcf_group, study_lifecycle, study_export_multisample, study_missingness_filter, anno_join,
                                     mixed_reference_rejected, raw_query_and_sort)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_warehouse_same_in_both_packages(tmp_path, inputs, scenario):
    seen = {}
    for pkg, (mod, _) in PACKAGES.items():
        tmp = str(tmp_path / pkg)
        os.makedirs(tmp)
        t = Transcript()
        db = mod.VDB(os.path.join(tmp, "vdb"))
        try:
            SCENARIOS[scenario](t, mod, db, inputs, tmp)
        finally:
            db.close()
        seen[pkg] = (list(t), tables(os.path.join(tmp, "vdb"), t))
    assert seen["torch"][0] == seen["jax"][0]
    assert seen["torch"][1] == seen["jax"][1]


def test_flat_api_roundtrip(tmp_path):
    """tests/test_tools.py::test_vdb_roundtrip on both packages."""
    from biograph_tpu_torch.io.vcf import VcfRecord, VcfWriter, read_vcf

    vcf = str(tmp_path / "in.vcf")
    with VcfWriter(vcf, sample="s1") as w:
        w.write(VcfRecord("chr1", 100, "A", "T", qual=50, fmt={"GT": "0/1"}))
        w.write(VcfRecord("chr1", 200, "G", "C", qual=9, filter="lowq", fmt={"GT": "1/1"}))
        w.write(VcfRecord("chr2", 5, "T", "TA", qual=99, fmt={"GT": "1/1"}))
    seen = {}
    for pkg, (mod, _) in PACKAGES.items():
        db = str(tmp_path / pkg / "db")
        t = Transcript()
        assert t.value(mod.ingest(db, vcf, "s1")) == 3
        assert list(t.value(mod.list_samples(db))) == ["s1"]
        t.append(sorted(mod.list_samples(db)["s1"]))
        assert len(t.value(mod.query(db, chrom="chr1"))) == 2
        rows = t.value(mod.query(db, passing=True, min_qual=40))
        assert {r["pos"] for r in rows} == {100, 5}
        t.value(mod.query(db, sample="s1", pos_min=150, pos_max=250))
        out = str(tmp_path / pkg / "out.vcf")
        assert t.value(mod.export(db, "s1", out)) == 3
        t.file(out)
        assert [(r.chrom, r.pos, r.ref, r.alt) for r in read_vcf(out)] == [("chr1", 100, "A", "T"), ("chr1", 200, "G", "C"), ("chr2", 5, "T", "TA")]
        t.raises(ValueError, mod.export, db, "nobody", out)
        seen[pkg] = (list(t), tables(db, t))
    assert seen["torch"] == seen["jax"]


# ---------------- filter language ----------------

EXPRESSIONS = [
    # tests/test_vdb.py::test_translate_basics
    "qual > 50", "chrom == '1'", "pos >= 100", "chrom = chr1", "filter != PASS", "id = 'rs42'",
    # ::test_translate_fields_and_logic
    "GT = 0/1 && qual > 9", "DP >= 10", "SVLEN < -49", "info/FOO = 'x'", "fmt/GT != 1/1", "qual > 1, qual < 0",
    "id = '.'", "qual != '.'", "reflen > 3", "STRLEN ( alt ) > 5",
    # ::test_translate_rejects_typos
    "qualz > 50", "fmt/NOTAFIELD = 1",
    # the missingness columns, inside and outside a study filter, and the rest of the grammar
    "F_MISS > 0.4", "sample_miss < 0.5", "NOT (qual < 3) OR ! (pos <= 2)", "MEAN(DP) > 2", "qual > '.'", "",
    "spans > 10 AND study_name = fam", "pos = 1.5", "chrom ~ 1",
]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_translate_same_in_both_packages(expr):
    got = {}
    for pkg, (_, filt) in PACKAGES.items():
        try:
            got[pkg] = (filt.translate(expr), filt.uses_missingness(expr))
        except filt.FilterError as e:
            got[pkg] = ("FilterError", str(e))
        try:
            got[pkg] += (filt.translate(expr, allow_missingness=False),)
        except filt.FilterError as e:
            got[pkg] += ("FilterError", str(e))
    assert got["torch"] == got["jax"]
    assert issubclass(tfilter.FilterError, ValueError)


def fuzz_expressions(seed=11, n=300):
    """tests/test_vdb.py::test_filter_fuzz_translates_to_valid_sql's
    expressions, from the same seed."""
    rng = random.Random(seed)
    fields = ["chrom", "pos", "ref", "alt", "qual", "filter", "id", "varid", "varend", "reflen", "spans", "sample_name", "aid",
              "GT", "DP", "GQ", "PL", "SVLEN", "SVTYPE", "info/FOO", "fmt/DP"]
    cmps = ["=", "==", "!=", ">", ">=", "<", "<="]
    strings = ["'PASS'", '"chr1"', "'.'", "'1'"]
    logicals = ["AND", "OR", "&&", "||", ","]

    def atom():
        f = rng.choice(fields)
        c = rng.choice(cmps)
        r = rng.random()
        if f in ("GT", "fmt/GT"):
            rhs = rng.choice(["0/1", "1/1", "0|1", "'./.'"])
            c = rng.choice(["=", "!="])
        elif r < 0.4:
            rhs = str(rng.randint(0, 500))
        elif r < 0.7:
            rhs = rng.choice(strings)
            c = rng.choice(["=", "!="]) if rhs == "'.'" else c
        else:
            rhs = f"{rng.randint(1, 50)} + {rng.randint(1, 9)}"
        return f"{f} {c} {rhs}"

    out = []
    for _ in range(n):
        parts = [atom()]
        for _ in range(rng.randint(1, 4) - 1):
            parts.append(rng.choice(logicals))
            parts.append(atom())
        expr = " ".join(parts)
        if rng.random() < 0.3:
            expr = f"( {expr} )"
        out.append(expr)
    return out


def test_filter_fuzz_same_in_both_packages(tmp_path, inputs):
    db = tvdb.VDB(str(tmp_path / "vdb"))
    db.import_vcf(inputs["a"])
    db.import_vcf(inputs["b"])
    n_ok = 0
    for expr in fuzz_expressions():
        got = []
        for _, filt in PACKAGES.values():
            try:
                got.append(filt.translate(expr))
            except filt.FilterError as e:
                got.append(("FilterError", str(e)))
        assert got[1] == got[0], expr
        if isinstance(got[1], str):
            db.conn.execute(f"SELECT COUNT(*) FROM variants WHERE {got[1]}")  # sqlite accepts it
            n_ok += 1
    db.close()
    assert n_ok > 200


# ---------------- the CLI ----------------


def cli_transcript(main, tmp, inputs, capsys):
    """tests/test_vdb.py::test_cli_groups and every other vdb subcommand,
    in-process, each command's printed text."""
    t = Transcript()
    d = os.path.join(tmp, "clidb")
    vcf = inputs["a"]

    def run(*argv):
        main(["vdb", *argv])
        out = capsys.readouterr().out
        for a in re.findall(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}", out):
            t.aid(a)
        t.append(re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ?", "<time>", t.unaid(out)).replace(tmp, "<tmp>"))
        return out

    aid = run("vcf", "import", "--db", d, vcf).split("\t")[0]
    run("vcf", "import", "--db", d, inputs["b"], "-s", "other", "-d", "second", "-r", "grc", "--aid", "fixed-aid")
    run("vcf", "list", "--db", d)
    run("vcf", "list", "--db", d, "-s", "HG")
    run("study", "create", "--db", d, "fam")
    run("study", "add", "--db", d, "fam", "HG00*")
    run("study", "filter", "--db", d, "fam", "-e", "filter != PASS")
    run("study", "show", "--db", d, "fam")
    run("study", "list", "--db", d)
    out = os.path.join(tmp, "cli_out.vcf")
    run("study", "export", "--db", d, "fam", "-o", out)
    t.file(out)
    run("study", "export", "--db", d, "fam", "-o", out, "--checkpoint", "1", "--fields", "GT", "-c", "--no-header")
    t.file(out)
    run("study", "create", "--db", d, "fam2")
    run("study", "add", "--db", d, "fam2", "HG002", "--from", "fam", "--checkpoint", "1")
    run("study", "revert", "--db", d, "fam")
    run("study", "freeze", "--db", d, "fam")
    run("study", "unfreeze", "--db", d, "fam")
    run("study", "delete", "--db", d, "fam2")
    run("query", "--db", d, "SELECT COUNT(*) FROM variants")
    run("query", "--db", d, "--sample", "HG002", "--chrom", "1", "--pos-min", "50", "--pos-max", "500", "--min-qual", "1", "--limit", "1")
    run("query", "--db", d, "--passing")
    run("vcf", "export", "--db", d, "-a", aid, "-o", out)
    t.file(out)
    run("anno", "import", "--db", d, inputs["anno"], "-n", "genes", "-V", "2")
    run("anno", "list", "--db", d)
    run("anno", "export", "--db", d, "-a", "genes", "-o", out)
    t.file(out)
    run("anno", "delete", "--db", d, "nothing-here")
    run("vcf", "sort", "-i", inputs["u"], "-o", out, "-c")
    t.file(out)
    run("vcf", "delete", "--db", d, aid)
    flat = os.path.join(tmp, "flatdb")
    run("ingest", "--db", flat, "--vcf", vcf, "--sample", "s1")
    run("list", "--db", flat)
    run("query", "--db", flat, "--chrom", "1")
    run("export", "--db", flat, "--sample", "s1", "--out", out)
    t.file(out)
    return list(t), tables(d, t)


def test_cli_groups_same_in_both_clis(tmp_path, inputs, capsys):
    from biograph_tpu import cli as jcli
    from biograph_tpu_torch import cli as tcli

    seen = {}
    for pkg, main in (("jax", jcli.main), ("torch", tcli.main)):
        tmp = str(tmp_path / pkg)
        os.makedirs(tmp)
        seen[pkg] = cli_transcript(main, tmp, inputs, capsys)
    assert seen["torch"][0] == seen["jax"][0]
    assert seen["torch"][1] == seen["jax"][1]
    assert "checkpoint: 2" in "".join(x for x in seen["torch"][0] if isinstance(x, str))


def test_vcf_sort_between_stdin_and_stdout(inputs):
    """``vdb vcf sort``'s defaults, /dev/stdin and /dev/stdout, through both
    CLIs as processes."""
    text = open(inputs["u"]).read()
    outs = []
    for argv in ([sys.executable, "-m", "biograph_tpu", "--platform", "cpu"], [sys.executable, "-m", "biograph_tpu_torch"]):
        r = subprocess.run([*argv, "vdb", "vcf", "sort", "-c"], input=text, capture_output=True, text=True, cwd=REPO,
                           env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    assert outs[1] == outs[0]
    body = [ln.split("\t")[0] for ln in outs[1].splitlines() if "\t" in ln and not ln.startswith("#")]
    assert body == ["chr2", "chr10"] and outs[1].endswith("sorted 2 records -> /dev/stdout\n")
