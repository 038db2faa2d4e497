"""Small VCF cohort utilities: sample paste, frequency filter, ML table
(pure Python).

Copy of ``biograph_tpu/tools/vcf_tools.py``.

Counterparts of the reference's tools (python/biograph/tools/):
  * vcf_sample_paste.py — paste single-sample VCFs with identical loci into
    one multi-sample VCF.
  * freq_filter.py — drop records with too few supporting observations or
    individuals (depth taken from a FORMAT field's alt column).
  * vcf_to_ml_table.py — per-allele table of cohort stats + per-sample
    allele depths.  The reference extracts AF/MAF/AC/HWE/ExcHet INFO that an
    external tool (bcftools +fill-tags) computed upstream; offline we
    compute them from the genotypes directly — allele counts, frequencies,
    and the Wigginton exact Hardy-Weinberg / excess-het p-values.
"""

from __future__ import annotations

import gzip
import sys
from typing import List


def _open(path, mode="rt"):
    if path == "-":
        return sys.stdin if "r" in mode else sys.stdout
    return gzip.open(path, mode) if path.endswith(".gz") else open(path, mode)


# ---------------- vcf_sample_paste ----------------


def sample_paste(vcf_paths: List[str], out_path: str) -> int:
    """Paste sample columns (vcf_sample_paste.py behavior and assumptions:
    single sample per input, identical loci in identical order, headers from
    the first file)."""
    fhs = [_open(p) for p in vcf_paths]
    out = _open(out_path, "wt")
    names: List[str] = []
    # headers: emit the first file's ##-lines; collect every sample name
    heads = []
    for fh in fhs:
        for line in fh:
            if line.startswith("##"):
                if fh is fhs[0]:
                    out.write(line)
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 10:
                    raise ValueError("vcf_sample_paste wants sample columns")
                names.extend(cols[9:])
                heads.append(cols)
                break
    out.write(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        + "\t".join(names)
        + "\n"
    )
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate sample names: {names}")
    n = 0
    for lines in zip(*fhs):
        rows = [l.rstrip("\n").split("\t") for l in lines]
        first = rows[0]
        for r in rows[1:]:
            if (r[0], r[1], r[3], r[4]) != (first[0], first[1], first[3], first[4]):
                raise ValueError(
                    f"loci mismatch at {first[0]}:{first[1]}: {r[0]}:{r[1]}"
                )
        out.write("\t".join(first[:9] + [c for r in rows for c in r[9:]]) + "\n")
        n += 1
    # all inputs must be exhausted together
    for fh in fhs:
        if fh.readline().strip():
            raise ValueError("input VCFs have different record counts")
        if fh is not sys.stdin:
            fh.close()
    if out is not sys.stdout:
        out.close()
    return n


# ---------------- freq_filter ----------------


def freq_filter(
    vcf_in: str,
    out_path: str,
    min_observations: int = 1,
    min_individuals: int = 1,
    depth_field: str = "AD",
) -> dict:
    """Keep records with >= min_observations alt reads summed over samples
    and >= min_individuals non-missing samples (freq_filter.py:33
    filter_entry; depth = the field's second comma entry, i.e. the alt
    column)."""
    stats = {"pass": 0, "low_obs": 0, "low_indiv": 0, "both": 0}
    fh = _open(vcf_in)
    out = _open(out_path, "wt")
    for line in fh:
        if line.startswith("#"):
            out.write(line)
            continue
        data = line.rstrip("\n").split("\t")
        fmt = data[8].split(":")
        try:
            di = fmt.index(depth_field)
        except ValueError:
            out.write(line)
            continue
        obs = 0
        n_indiv = 0
        for col in data[9:]:
            if col in (".", "./."):
                continue
            parts = col.split(":")
            if di >= len(parts) or parts[di] in (".", ""):
                continue
            vals = parts[di].split(",")
            alt = vals[1] if len(vals) > 1 else vals[0]
            if alt != ".":
                obs += int(alt)
            n_indiv += 1
        flag = (obs < min_observations) + 2 * (n_indiv < min_individuals)
        if flag == 0:
            stats["pass"] += 1
            out.write(line)
        else:
            stats[{1: "low_obs", 2: "low_indiv", 3: "both"}[flag]] += 1
    if fh is not sys.stdin:
        fh.close()
    if out is not sys.stdout:
        out.close()
    return stats


# ---------------- vcf_to_ml_table ----------------


def hwe_exact(n_het: int, n_hom1: int, n_hom2: int) -> tuple:
    """(p_hwe, p_exc_het): Wigginton et al. 2005 exact Hardy-Weinberg test
    and the one-sided excess-heterozygosity test (bcftools HWE/ExcHet
    semantics, which the reference's table extracts)."""
    n_rare = 2 * min(n_hom1, n_hom2) + n_het
    n = n_het + n_hom1 + n_hom2
    if n == 0:
        return 1.0, 1.0
    # probability of each possible het count given n_rare minor alleles
    probs = [0.0] * (n_rare + 1)
    # start at the midpoint with the right parity and recurse outward
    mid = n_rare * (2 * n - n_rare) // (2 * n)
    if mid % 2 != n_rare % 2:
        mid += 1
    probs[mid] = 1.0
    total = 1.0
    het = mid
    hom_r = (n_rare - mid) // 2
    hom_c = n - het - hom_r
    while het >= 2:
        probs[het - 2] = (
            probs[het] * het * (het - 1) / (4.0 * (hom_r + 1) * (hom_c + 1))
        )
        total += probs[het - 2]
        het -= 2
        hom_r += 1
        hom_c += 1
    het = mid
    hom_r = (n_rare - mid) // 2
    hom_c = n - het - hom_r
    while het <= n_rare - 2:
        probs[het + 2] = (
            probs[het] * 4.0 * hom_r * hom_c / ((het + 2.0) * (het + 1.0))
        )
        total += probs[het + 2]
        het += 2
        hom_r -= 1
        hom_c -= 1
    obs = probs[n_het] / total
    p_hwe = min(1.0, sum(p for p in probs if p / total <= obs * (1 + 1e-12)) / total)
    p_exc = min(
        1.0, sum(probs[h] for h in range(n_het, n_rare + 1, 2)) / total
    )
    return p_hwe, p_exc


# ---------------- rvg_cleaner ----------------


def rvg_cleaner(vcf_in: str, out_path: str) -> dict:
    """Graph-noise cleaner (rvg_cleaner.py): keep SVs; keep small variants
    with pair evidence or phased with an SV; drop (buffer, then discard)
    pair-bare small variants whose phase never meets an SV.  The reference
    keys on its PI/PDP FORMAT fields; this build's equivalents are the PS
    phase-set FORMAT tag and the PC pair-coverage INFO tag."""
    fh = _open(vcf_in)
    out = _open(out_path, "wt")
    stats = {"sv": 0, "paired": 0, "inphase": 0, "dropped": 0}
    backlog: dict = {}
    known_inphase: set = set()
    cur_chrom = None
    for line in fh:
        if line.startswith("#"):
            out.write(line)
            continue
        e = line.rstrip("\n").split("\t")
        if e[0] != cur_chrom:
            stats["dropped"] += sum(len(v) for v in backlog.values())
            backlog = {}
            known_inphase = set()
            cur_chrom = e[0]
        info = dict(
            kv.partition("=")[::2] for kv in e[7].split(";") if e[7] != "."
        )
        fmt = e[8].split(":") if len(e) > 8 else []
        smp = e[9].split(":") if len(e) > 9 else []
        ps = None
        if "PS" in fmt and fmt.index("PS") < len(smp):
            v = smp[fmt.index("PS")]
            ps = v if v not in (".", "") else None
        pc = int(info.get("PC", 0) or 0)
        if "SVLEN" in info:
            out.write(line)
            stats["sv"] += 1
            if ps is not None:
                known_inphase.add(ps)
                for bent in backlog.pop(ps, []):
                    out.write(bent)
                    stats["inphase"] += 1
        elif pc != 0:
            out.write(line)
            stats["paired"] += 1
        elif ps is not None and ps in known_inphase:
            out.write(line)
            stats["inphase"] += 1
        elif ps is not None:
            backlog.setdefault(ps, []).append(line)
        else:
            stats["dropped"] += 1
    stats["dropped"] += sum(len(v) for v in backlog.values())
    if fh is not sys.stdin:
        fh.close()
    if out is not sys.stdout:
        out.close()
    return stats


ML_INFO_KEYS = ["AF", "MAF", "AC", "AC_Het", "AC_Hom", "AC_Hemi", "HWE", "ExcHet"]


def vcf_to_ml_table(vcf_in: str, out_path: str) -> int:
    """Per-allele rows `bg_{chrom}:{pos}.{allele}` with cohort stats and one
    AD column per sample (vcf_to_ml_table.py).  Stats come from INFO when
    present, else are computed from the GTs."""
    fh = _open(vcf_in)
    out = _open(out_path, "wt")
    samples: List[str] = []
    n_rows = 0
    for line in fh:
        if line.startswith("##"):
            continue
        if line.startswith("#"):
            samples = line.rstrip("\n").split("\t")[9:]
            out.write("pos\t" + "\t".join(ML_INFO_KEYS) + "\t" + "\t".join(samples) + "\n")
            continue
        e = line.rstrip("\n").split("\t")
        alts = e[4].split(",")
        n_alt = len(alts)
        info = {}
        if e[7] != ".":
            for item in e[7].split(";"):
                k, _, v = item.partition("=")
                info[k] = v
        fmt = e[8].split(":") if len(e) > 8 else []
        ad_i = fmt.index("AD") if "AD" in fmt else -1
        gt_i = fmt.index("GT") if "GT" in fmt else -1
        cols = [c.split(":") for c in e[9:]]
        # per-allele stats from GTs when INFO lacks them
        stats = {k: info.get(k, "").split(",") if info.get(k) else None for k in ML_INFO_KEYS}
        if stats["AC"] is None and gt_i >= 0:
            ac = [0] * n_alt
            ac_het = [0] * n_alt
            ac_hom = [0] * n_alt
            ac_hemi = [0] * n_alt
            het_of = [0] * n_alt
            hom_of = [0] * n_alt
            n_called = 0
            an = 0
            for c in cols:
                if gt_i >= len(c):
                    continue
                g = c[gt_i].replace("|", "/").split("/")
                if "." in g:
                    continue
                g = [int(x) for x in g]
                an += len(g)
                n_called += 1
                for a in range(1, n_alt + 1):
                    cnt = g.count(a)
                    ac[a - 1] += cnt
                    if len(g) == 1 and cnt:
                        ac_hemi[a - 1] += 1
                    elif cnt == 1:
                        ac_het[a - 1] += 1
                        het_of[a - 1] += 1
                    elif cnt == 2:
                        ac_hom[a - 1] += 2
                        hom_of[a - 1] += 1
            af = [c / an if an else 0.0 for c in ac]
            stats["AC"] = [str(c) for c in ac]
            stats["AC_Het"] = [str(c) for c in ac_het]
            stats["AC_Hom"] = [str(c) for c in ac_hom]
            stats["AC_Hemi"] = [str(c) for c in ac_hemi]
            stats["AF"] = [f"{x:g}" for x in af]
            stats["MAF"] = [f"{min(x, 1 - x):g}" for x in af]
            hwe, exc = [], []
            for a in range(n_alt):
                n_hom_alt = hom_of[a]
                n_het = het_of[a]
                n_hom_ref = n_called - n_het - n_hom_alt
                p, pe = hwe_exact(n_het, n_hom_alt, max(n_hom_ref, 0))
                hwe.append(f"{p:g}")
                exc.append(f"{pe:g}")
            stats["HWE"] = hwe
            stats["ExcHet"] = exc
        ads = [
            c[ad_i].split(",") if 0 <= ad_i < len(c) else []
            for c in cols
        ]
        for allele in range(n_alt + 1):
            out.write(f"bg_{e[0]}:{e[1]}.{allele}")
            if allele == 0:
                out.write("\t." * len(ML_INFO_KEYS))
            else:
                for k in ML_INFO_KEYS:
                    vals = stats[k]
                    out.write(
                        "\t" + (vals[allele - 1] if vals and len(vals) >= allele else ".")
                    )
            for samp in ads:
                out.write("\t" + (samp[allele] if len(samp) > allele else "."))
            out.write("\n")
            n_rows += 1
    if fh is not sys.stdin:
        fh.close()
    if out is not sys.stdout:
        out.close()
    return n_rows
