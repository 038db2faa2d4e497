"""Per-stage call-set metrics and raw-read validation (the port's own copy).

Counterpart of ``biograph_tpu/variants/metrics.py``, which imports no JAX;
the port keeps its own copy because it imports nothing of the JAX package.

  * stage_metrics(calls, truth): precision / recall / TP / FP / FN of one
    stage's records against a truth set, matching normalized (chrom, pos,
    ref, alt).
  * raw_read_support(reference, reads, calls): for every call, the raw reads
    of a FASTQ (both strands, independent of the engine under test) that
    hold the call's ALT haplotype window, and those that hold the REF
    window.  The alt window applies every nearby call, so clustered
    substitutions validate against the k-mers the reads carry.
  * alignment_pileup / pileup_confirm: a mismatch-tolerant realignment
    pileup, a second channel that never consults the call set.
  * parity_report: both channels over every stage and truth set.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from biograph_tpu_torch.core import dna

Key = Tuple[str, int, str, str]

_COMP = str.maketrans("ACGT", "TGCA")


def record_key(r: dict | Sequence) -> Key:
    if isinstance(r, dict):
        return (r["chrom"], int(r["pos"]), r["ref"], r["alt"])
    return (r[0], int(r[1]), r[2], r[3])


def vcf_keys(path: str, max_pos: int | None = None) -> set:
    """Record keys of a VCF file (first ALT only, chrom prefix before ':')."""
    out = set()
    for ln in open(path):
        if ln.startswith("#"):
            continue
        f = ln.rstrip("\n").split("\t")
        pos = int(f[1])
        if max_pos is not None and pos > max_pos:
            continue
        out.add((f[0].split(":")[0], pos, f[3], f[4].split(",")[0]))
    return out


def normalize_key(k: Key) -> Key:
    """Minimal-representation normalization (vt-style): trim the common
    suffix then the common prefix of (ref, alt), advancing pos — so
    `CTTTTTT>CTTTTTTT @5070` and `C>CT @5070` (the same homopolymer
    insertion written by different callers) compare equal."""
    chrom, pos, rs, alt = k
    while len(rs) > 1 and len(alt) > 1 and rs[-1] == alt[-1]:
        rs, alt = rs[:-1], alt[:-1]
    while len(rs) > 1 and len(alt) > 1 and rs[0] == alt[0]:
        rs, alt = rs[1:], alt[1:]
        pos += 1
    return (chrom, pos, rs, alt)


def stage_metrics(calls: Iterable[Key], truth: set) -> Dict:
    """truvari-style metrics of one stage against a truth set, matching on
    normalized (chrom, pos, ref, alt)."""
    calls = {normalize_key(k) for k in calls}
    truth = {normalize_key(k) for k in truth}
    tp = len(calls & truth)
    fp = len(calls - truth)
    fn = len(truth - calls)
    return {
        "TP": tp,
        "FP": fp,
        "FN": fn,
        "precision": round(tp / max(tp + fp, 1), 4),
        "recall": round(tp / max(tp + fn, 1), 4),
        "f1": round(2 * tp / max(2 * tp + fp + fn, 1), 4),
    }


def _donor_haplotype(ref_seq: str, contig_start: int, calls: List[Key],
                     lo: int, hi: int):
    """Apply all (hom) calls in [lo, hi) to the reference; returns the donor
    string and each call's coordinate within it."""
    parts: List[str] = []
    pos_map: Dict[Key, int] = {}
    cur = lo
    total = 0
    for k in sorted(calls, key=lambda k: k[1]):
        _, pos, rs, alt = k
        p0 = pos - 1
        if p0 < cur:
            continue  # overlapping representation; skip from the haplotype
        seg = ref_seq[contig_start + cur : contig_start + p0]
        parts.append(seg)
        total += len(seg)
        pos_map[k] = total
        parts.append(alt)
        total += len(alt)
        cur = p0 + len(rs)
    parts.append(ref_seq[contig_start + cur : contig_start + hi])
    return "".join(parts), pos_map


def raw_read_support(
    reference,
    fastq_path: str,
    calls: List[dict],
    flank: int = 12,
    region: Tuple[int, int] | None = None,
    context_calls: List[dict] | None = None,
) -> List[Dict]:
    """Per-call raw-read evidence, computed WITHOUT the engine under test.

    Reads come straight off the FASTQ; support = occurrences (either strand)
    of the call's alt-haplotype window (all nearby calls applied) /
    ref window.  Returns one dict per call with alt_reads / ref_reads.

    context_calls (default: `calls`) is the FULL call set used to build the
    donor haplotype — when validating a subset (e.g. only the extras vs a
    truth VCF), neighbouring true calls inside the flank must still be
    applied or the probe window matches neither reads nor reference."""
    ref_seq = dna.codes_to_seq(np.asarray(reference.flat))
    reads = []
    import gzip

    op = gzip.open if fastq_path.endswith(".gz") else open
    with op(fastq_path, "rt") as f:
        for i, ln in enumerate(f):
            if i % 4 == 1:
                reads.append(ln.strip())
    text = "\n".join(reads)

    def count(w: str) -> int:
        return text.count(w) + text.count(w.translate(_COMP)[::-1])

    if context_calls is None:
        context_calls = calls
    by_contig: Dict[str, List[dict]] = {}
    ctx_by_contig: Dict[str, List[dict]] = {}
    for r in calls:
        by_contig.setdefault(r["chrom"], []).append(r)
    for r in context_calls:
        ctx_by_contig.setdefault(r["chrom"], []).append(r)
    out = []
    for chrom, group in by_contig.items():
        c = reference.contig_by_name(chrom)
        keys = [record_key(r) for r in group]
        ctx_keys = [record_key(r) for r in ctx_by_contig.get(chrom, group)]
        lo = max(min(k[1] for k in ctx_keys) - 1 - 2 * flank, 0)
        hi = min(max(k[1] + len(k[2]) for k in ctx_keys) + 2 * flank, c.length)
        if region is not None:
            lo, hi = max(lo, region[0]), min(hi, region[1])
        donor, pos_map = _donor_haplotype(ref_seq, c.start, ctx_keys, lo, hi)
        for r, k in zip(group, keys):
            _, pos, rs, alt = k
            p0 = c.start + pos - 1
            refw = ref_seq[max(p0 - flank, 0) : p0 + len(rs) + flank]
            if k in pos_map:
                dp = pos_map[k]
                altw = donor[max(dp - flank, 0) : dp + len(alt) + flank]
            else:
                altw = (
                    ref_seq[max(p0 - flank, 0) : p0] + alt
                    + ref_seq[p0 + len(rs) : p0 + len(rs) + flank]
                )
            out.append(
                {
                    "chrom": chrom,
                    "pos": pos,
                    "ref": rs,
                    "alt": alt,
                    "alt_reads": count(altw),
                    "ref_reads": count(refw),
                }
            )
    return out


def alignment_pileup(
    reference, fastq_path: str, chrom: str, lo: int, hi: int,
    max_mismatch: int = 5,
):
    """Mismatch-tolerant realignment pileup — the second, ORTHOGONAL
    evidence channel for call validation (the first, raw_read_support,
    counts exact alt-haplotype windows; this one never consults the call
    set at all).  Every read (and its reverse complement) is aligned to its
    best-mismatch-count offset in [lo, hi) of `chrom` by brute force;
    well-aligned reads (<= max_mismatch of ~L) vote per position.

    Returns (pile [hi-lo, 4] int32 base votes, n_aligned).  Gapless — SNV
    evidence only; indel calls validate through the haplotype-window
    channel."""
    import gzip

    c = reference.contig_by_name(chrom)
    ref = np.asarray(
        reference.flat[c.start + lo : c.start + min(hi, c.length)]
    ).astype(np.int8)
    G = len(ref)
    m = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 0}
    reads = []
    op = gzip.open if fastq_path.endswith(".gz") else open
    with op(fastq_path, "rt") as f:
        for i, ln in enumerate(f):
            if i % 4 == 1:
                reads.append(
                    np.array([m[ch] for ch in ln.strip().upper()], np.int8)
                )
    L = max(len(r) for r in reads)
    R = np.stack([np.pad(r, (0, L - len(r)), constant_values=-1) for r in reads])
    N = len(reads)
    Rrc = np.where(R[:, ::-1] >= 0, 3 - R[:, ::-1], -1)
    if G < L:
        return np.zeros((G, 4), np.int32), 0
    W = np.lib.stride_tricks.sliding_window_view(ref, L)

    def best(RD):
        bests = np.zeros(N, np.int32)
        bpos = np.zeros(N, np.int32)
        for i in range(0, N, 512):
            d = ((RD[i : i + 512, None, :] != W[None, :, :])
                 & (RD[i : i + 512, None, :] >= 0)).sum(2)
            bpos[i : i + 512] = d.argmin(1)
            bests[i : i + 512] = d.min(1)
        return bests, bpos

    bf, pf = best(R)
    br, pr = best(Rrc)
    use_rc = br < bf
    bb = np.where(use_rc, br, bf)
    pp = np.where(use_rc, pr, pf)
    sel = bb <= max_mismatch
    RD = np.where(use_rc[:, None], Rrc, R)
    pile = np.zeros((G, 4), np.int32)
    for r, p in zip(RD[sel], pp[sel]):
        for j in range(L):
            if r[j] >= 0:
                pile[p + j, r[j]] += 1
    return pile, int(sel.sum())


def pileup_confirm(pile, lo: int, calls: List[dict], min_alt: int = 3):
    """Per-SNV pileup evidence from an alignment_pileup: alt votes, total
    depth, and confirmed = (alt votes >= min_alt and alt is the majority).
    Non-SNV calls return confirmed=None (gapless pileup can't judge them)."""
    m = {"A": 0, "C": 1, "G": 2, "T": 3}
    out = []
    for r in calls:
        if len(r["ref"]) == 1 and len(r["alt"]) == 1 and r["alt"] in m:
            c = pile[r["pos"] - 1 - lo]
            alt = int(c[m[r["alt"]]])
            tot = int(c.sum())
            out.append(
                {
                    **{k: r[k] for k in ("chrom", "pos", "ref", "alt")},
                    "pileup_alt": alt,
                    "pileup_depth": tot,
                    "confirmed": bool(alt >= min_alt and 2 * alt > tot),
                }
            )
        else:
            out.append(
                {
                    **{k: r[k] for k in ("chrom", "pos", "ref", "alt")},
                    "pileup_alt": None,
                    "pileup_depth": None,
                    "confirmed": None,
                }
            )
    return out


def parity_report(
    reference,
    fastq_path: str,
    stage_records: Dict[str, List[dict]],
    truth_vcfs: Dict[str, str],
    max_pos: int | None = None,
    min_alt_reads: int = 3,
) -> Dict:
    """Full per-stage parity report: metrics vs every truth VCF + raw-read
    validation of the final stage's false positives.  The committed artifact
    (PARITY_METRICS.json) and its regression test are built on this."""
    truths = {name: vcf_keys(p, max_pos) for name, p in truth_vcfs.items()}
    report: Dict = {"stages": {}, "truth_sizes": {k: len(v) for k, v in truths.items()}}
    for stage, records in stage_records.items():
        keys = {
            record_key(r)
            for r in records
            if max_pos is None or r["pos"] <= max_pos
        }
        report["stages"][stage] = {
            name: stage_metrics(keys, t) for name, t in truths.items()
        }
    # validate the last stage's extras against the raw reads
    last = list(stage_records)[-1]
    primary = next(iter(truth_vcfs))
    truth_norm = {normalize_key(k) for k in truths[primary]}
    extras = [
        r
        for r in stage_records[last]
        if (max_pos is None or r["pos"] <= max_pos)
        and normalize_key(record_key(r)) not in truth_norm
    ]
    support = raw_read_support(
        reference,
        fastq_path,
        extras,
        context_calls=[
            r
            for r in stage_records[last]
            if max_pos is None or r["pos"] <= max_pos
        ],
    )
    n_proven = sum(
        1
        for s in support
        if s["alt_reads"] >= min_alt_reads and s["ref_reads"] == 0
    )
    # second, orthogonal channel: mismatch-tolerant realignment pileup
    # (never consults the call set) — every extra SNV should also be the
    # majority base at its position among independently aligned reads
    pile_summary = {}
    if extras:
        chroms = {r["chrom"] for r in extras}
        confirms = []
        for chrom in sorted(chroms):
            grp = [r for r in extras if r["chrom"] == chrom]
            lo = max(min(r["pos"] for r in grp) - 64, 0)
            hi = max(r["pos"] for r in grp) + 64
            pile, n_aligned = alignment_pileup(
                reference, fastq_path, chrom, lo, hi
            )
            confirms.extend(pileup_confirm(pile, lo, grp, min_alt_reads))
        snvs = [c for c in confirms if c["confirmed"] is not None]
        # a cluster of many variants within one read length defeats gapless
        # alignment (every read there exceeds the mismatch cap): the pileup
        # channel is SILENT (near-zero depth), which is not evidence against
        # the call — the haplotype-window channel covers those.  A call the
        # pileup actively CONTRADICTS (real depth, alt in the minority) is
        # the red flag this channel exists to raise.
        contradicted = [
            c for c in snvs
            if not c["confirmed"] and c["pileup_depth"] >= min_alt_reads
        ]
        pile_summary = {
            "n_snv_extras": len(snvs),
            "n_pileup_confirmed": sum(1 for c in snvs if c["confirmed"]),
            "n_pileup_silent": sum(
                1
                for c in snvs
                if not c["confirmed"] and c["pileup_depth"] < min_alt_reads
            ),
            "pileup_contradicted": contradicted,
        }
    report["extras_validation"] = {
        "stage": last,
        "vs": primary,
        "n_extras": len(extras),
        "n_read_proven": n_proven,
        "min_alt_reads": min_alt_reads,
        "unproven": [
            s for s in support
            if not (s["alt_reads"] >= min_alt_reads and s["ref_reads"] == 0)
        ],
        **pile_summary,
    }
    # validate what we MISS, too: a truth record our calls lack either has
    # raw-read support (a real recall gap) or none (a truth-set error — e.g.
    # golden pileup.vcf's 3882 ATTTT>ATTT carries zero alt reads)
    call_norm = {
        normalize_key(record_key(r))
        for r in stage_records[last]
        if max_pos is None or r["pos"] <= max_pos
    }
    report["missed_validation"] = {}
    for name, t in truths.items():
        missed = [
            {"chrom": k[0], "pos": k[1], "ref": k[2], "alt": k[3]}
            for k in t
            if normalize_key(k) not in call_norm
        ]
        sup = raw_read_support(
            reference, fastq_path, missed,
            context_calls=missed + list(stage_records[last]),
        ) if missed else []
        report["missed_validation"][name] = {
            "n_missed": len(missed),
            "with_read_support": [s for s in sup if s["alt_reads"] > 0],
            "without_read_support": [s for s in sup if s["alt_reads"] == 0],
        }
    return report
