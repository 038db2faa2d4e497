"""Mendelian-consistency annotation of multi-sample (family) VCFs (pure
Python).

Copy of ``biograph_tpu/tools/mendelian.py``.

Counterpart of the reference's mendelian annotator
(python/biograph/tools/mendelian_annotator.py): for every trio in a
pedigree, each variant's genotypes are checked for Mendelian consistency;
the VCF INFO gains `sizeCat` (variant size category) and `MEF` (families
with a Mendelian error), and a per-family + overall report (counts broken
down by variant type, size category, and trio depth) is written as JSON and
a tab-delimited summary.

The transmission check matches me_check (mendelian_annotator.py:314): a
proband GT is consistent iff one allele can come from the father and the
other from the mother; sites with any missing GT — or all-hom-ref trios
unless ref_count — are skipped.
"""

from __future__ import annotations

import gzip
import json
import sys
from typing import Dict, List, Tuple

from biograph_tpu_torch.utils.pedigree import Pedigree

SV_TYPES = ("DEL", "INS", "SUBSDEL", "SUBSINS", "REPL")
SIZE_CATS = ("1-9", "10-49", "50-99", "100-299", "300-999", "gt1000")
DEPTH_CATS = (0, 1, 10, 15)


def classify_allele(ref: str, alt: str) -> Tuple[str, int]:
    """(sv_type, sv_len) of one REF>ALT pair (get_type_lens analog)."""
    if len(ref) == len(alt):
        return "REPL", len(ref)
    if len(ref) == 1:
        return "INS", len(alt) - 1
    if len(alt) == 1:
        return "DEL", len(ref) - 1
    if len(ref) > len(alt):
        return "SUBSDEL", len(ref) - len(alt)
    return "SUBSINS", len(alt) - len(ref)


def size_cat(sv_len: int) -> str:
    for cap, cat in ((10, "1-9"), (50, "10-49"), (100, "50-99"),
                     (300, "100-299"), (1000, "300-999")):
        if sv_len < cap:
            return cat
    return "gt1000"


def me_check(pr: str, fa: str, ma: str, ref_count: bool = False) -> int:
    """-1 skip (missing GT / all-hom-ref), 0 consistent, 1 inconsistent."""
    gts = [g.split(":")[0].replace("|", "/").split("/") for g in (pr, fa, ma)]
    pr_a, fa_a, ma_a = gts
    if any("." in g for g in gts):
        return -1
    if not ref_count and all(g == ["0", "0"] for g in gts):
        return -1
    if (pr_a[0] in fa_a and pr_a[1] in ma_a) or (pr_a[1] in fa_a and pr_a[0] in ma_a):
        return 0
    return 1


def depth_category(fmt_keys: List[str], cols: List[str]) -> int:
    """Largest depth threshold every trio member meets (min-DP bucketing,
    get_coverage_category analog)."""
    try:
        di = fmt_keys.index("DP")
    except ValueError:
        return 0
    depths = []
    for c in cols:
        parts = c.split(":")
        if di < len(parts) and parts[di] not in (".", ""):
            depths.append(int(parts[di]))
    lo = min(depths) if depths else None
    cat = 0
    for d in DEPTH_CATS:
        if lo is None or lo >= d:
            cat = d
    return cat


class _Cell(dict):
    def __init__(self):
        super().__init__(tot=0, err=0, pct=0.0)

    def hit(self, is_err: bool):
        self["tot"] += 1
        self["err"] += int(bool(is_err))


class MendelReport:
    """Per-family (and overall) Mendelian-error tallies."""

    def __init__(self, groups: List[str]):
        self.var_count = 0
        self.groups: Dict[str, dict] = {}
        for g in list(groups) + ["overall"]:
            self.groups[g] = {
                "var_count": 0,
                "type_counts": {t: _Cell() for t in SV_TYPES},
                "size_type_counts": {
                    s: {t: _Cell() for t in SV_TYPES}
                    for s in ("All",) + SIZE_CATS
                },
                "cov_size_me": {
                    str(d): {s: _Cell() for s in ("All",) + SIZE_CATS}
                    for d in ("All",) + DEPTH_CATS
                },
            }

    def tally(self, group: str, sv_type: str, cat: str, depth: int, is_err: bool):
        g = self.groups[group]
        g["var_count"] += 1
        g["type_counts"][sv_type].hit(is_err)
        for s in ("All", cat):
            g["size_type_counts"][s][sv_type].hit(is_err)
            for d in ("All", str(depth)):
                g["cov_size_me"][d][s].hit(is_err)

    def finalize(self) -> dict:
        def pct(cell):
            cell["pct"] = round(cell["err"] / cell["tot"], 4) if cell["tot"] else 0.0

        for g in self.groups.values():
            for c in g["type_counts"].values():
                pct(c)
            for row in g["size_type_counts"].values():
                for c in row.values():
                    pct(c)
            for row in g["cov_size_me"].values():
                for c in row.values():
                    pct(c)
        return {"var_count": self.var_count, **self.groups}

    def write_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.finalize(), f, indent=1)

    def write_text(self, path: str):
        rep = self.finalize()
        with open(path, "w") as f:
            f.write(f"var_count\t{self.var_count}\n")
            for name in ["overall"] + [g for g in self.groups if g != "overall"]:
                g = rep[name]
                f.write(f"========\n{name}\n========\n")
                f.write("Type\tTot\tErr\tPct\n")
                for t in SV_TYPES:
                    c = g["type_counts"][t]
                    f.write(f"{t}\t{c['tot']}\t{c['err']}\t{c['pct']:.2f}\n")
                f.write("\nMendelian Error Table\nCov\tSize\tTotal\tErrors\tPct\n")
                for d, row in g["cov_size_me"].items():
                    for s, c in row.items():
                        f.write(f"{d}\t{s}\t{c['tot']}\t{c['err']}\t{c['pct']:.4f}\n")


def annotate_vcf(
    vcf_path: str, out_path: str, ped: Pedigree, ref_count: bool = False
) -> MendelReport:
    """Annotate a family VCF with sizeCat/MEF INFO; return the report."""
    opener = gzip.open if vcf_path.endswith(".gz") else open
    fin = sys.stdin if vcf_path == "-" else opener(vcf_path, "rt")
    out = open(out_path, "w")
    sample_col: Dict[str, int] = {}
    for line in fin:
        if line.startswith("##"):
            out.write(line)
            continue
        if line.startswith("#CHROM"):
            out.write(
                '##INFO=<ID=sizeCat,Number=A,Type=String,'
                'Description="Size category of variant">\n'
                '##INFO=<ID=MEF,Number=.,Type=String,'
                'Description="Families that contain a mendelian error">\n'
            )
            out.write(line)
            for i, name in enumerate(line.rstrip("\n").split("\t")[9:]):
                sample_col[name] = 9 + i
            break
    # trio -> VCF columns; incomplete trios are reported and skipped
    trios = []
    skipped = []
    for pr, fa, ma in ped.trios():
        if all(s.ind_id in sample_col for s in (pr, fa, ma)):
            trios.append(
                (pr.fam_id, sample_col[pr.ind_id], sample_col[fa.ind_id],
                 sample_col[ma.ind_id])
            )
        else:
            skipped.append(pr.ind_id)
    if skipped:
        print(f"mendelian: trios missing VCF samples skipped: {skipped}",
              file=sys.stderr)
    report = MendelReport([t[0] for t in trios])
    for line in fin:
        if not line.strip():
            continue
        cols = line.rstrip("\n").split("\t")
        report.var_count += 1
        alleles = [classify_allele(cols[3], a) for a in cols[4].split(",")]
        cats = [size_cat(ln) for _, ln in alleles]
        cols[7] = (cols[7].rstrip(";") if cols[7] != "." else "")
        add = f"sizeCat={','.join(cats)}"
        cols[7] = f"{cols[7]};{add}" if cols[7] else add
        fmt_keys = cols[8].split(":") if len(cols) > 8 else []
        err_fams = []
        for fam, pc, fc, mc in trios:
            trio_cols = [cols[pc], cols[fc], cols[mc]]
            res = me_check(*trio_cols, ref_count=ref_count)
            if res < 0:
                continue
            depth = depth_category(fmt_keys, trio_cols)
            report.tally(fam, alleles[0][0], cats[0], depth, bool(res))
            if res:
                err_fams.append(fam)
        report.tally("overall", alleles[0][0], cats[0], 0, bool(err_fams))
        if err_fams:
            cols[7] += f";MEF={','.join(err_fams)}"
        out.write("\t".join(cols) + "\n")
    out.close()
    if fin is not sys.stdin:
        fin.close()
    return report
