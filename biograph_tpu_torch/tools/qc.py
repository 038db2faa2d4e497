"""QC reporting: k-mer quality report, reference fingerprint, stats (numpy
only, no torch).

Copy of ``biograph_tpu/tools/qc.py``.  Counterparts:
  * kmer_quality_report (reference datavis/kmer_quality_report, emitted by
    kmerize_bf.cpp) — k-mer multiplicity histogram with the trusted/error
    threshold, as a self-contained HTML file.
  * refhash (python/biograph/tools/refhash.py) — order-independent
    fingerprint of a reference's contigs so pipelines can verify that a VCF
    and a reference belong together.
  * bg_qc_stats (python/biograph/tools/bg_qc_stats.py) — aggregate the qc
    JSONs of one or more .bgt dirs.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List

import numpy as np


def kmer_histogram(counts_total: np.ndarray, max_bin: int = 100) -> np.ndarray:
    """hist[c] = number of distinct k-mers with multiplicity c (clamped)."""
    c = np.clip(np.asarray(counts_total, np.int64), 0, max_bin)
    return np.bincount(c, minlength=max_bin + 1)


def error_threshold(hist: np.ndarray) -> int:
    """First local minimum of the multiplicity histogram — the classic
    error/signal split the reference's overrepresentation filter uses
    (modules/bio_mapred/kmerize_bf.cpp histogram analysis)."""
    for c in range(2, len(hist) - 1):
        if hist[c] <= hist[c - 1] and hist[c] <= hist[c + 1]:
            return c
    return 2


def write_kmer_quality_report(path: str, counts_total: np.ndarray, k: int):
    hist = kmer_histogram(counts_total)
    thr = error_threshold(hist)
    n_total = int(len(counts_total))
    n_trusted = int((counts_total >= thr).sum())
    bars = []
    peak = max(int(hist[1:].max()), 1)
    for c in range(1, len(hist)):
        h = int(200 * hist[c] / peak)
        color = "#d9534f" if c < thr else "#5cb85c"
        bars.append(
            f'<div title="count {c}: {int(hist[c])} kmers" style="display:inline-block;'
            f"width:6px;height:{max(h,1)}px;background:{color};margin-right:1px;"
            f'vertical-align:bottom"></div>'
        )
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>k-mer quality report</title></head><body style="font-family:sans-serif">
<h2>k-mer quality report (k={k})</h2>
<p>{n_total} distinct canonical k-mers; error threshold at multiplicity
{thr}; {n_trusted} trusted ({100.0*n_trusted/max(n_total,1):.1f}%).</p>
<div style="border-bottom:1px solid #999;padding:4px">{''.join(bars)}</div>
<p style="color:#666">red: below threshold (likely sequencing errors);
green: trusted. x = multiplicity (1..100), y = #kmers (linear).</p>
</body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return {"threshold": thr, "distinct_kmers": n_total, "trusted_kmers": n_trusted}


def refhash(reference) -> str:
    """Order-independent reference fingerprint (refhash.py analog):
    sha1 over sorted (name, length, seq-digest) triples."""
    items = []
    for c in reference.contigs:
        seq = np.asarray(reference.flat[c.start : c.start + c.length])
        d = hashlib.sha1(seq.tobytes()).hexdigest()
        items.append(f"{c.name}:{c.length}:{d}")
    items.sort()
    return hashlib.sha1("\n".join(items).encode()).hexdigest()


def aggregate_qc(bgt_dirs: List[str]) -> Dict:
    """bg_qc_stats analog: merge create_stats/timings of several samples."""
    out = {}
    for d in bgt_dirs:
        name = os.path.basename(d.rstrip("/"))
        entry = {}
        for fn in ("qc/create_stats.json", "qc/timings.json", "metadata.json"):
            p = os.path.join(d, fn)
            if os.path.isfile(p):
                entry[os.path.basename(fn)] = json.load(open(p))
        out[name] = entry
    return out
