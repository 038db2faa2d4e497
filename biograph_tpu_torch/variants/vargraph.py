"""Variant-graph joint evaluation (torch).

Counterpart of ``biograph_tpu/variants/vargraph.py``.  Nearby records form
a window cluster; every realizable haplotype path through the cluster is
materialized and read support is measured on the path sequence, so each
edge is evaluated in its true joint context.  ``Readmap.coverage`` gives
the depth at every (path, position); an edge's count is the min over its
span, and the max over all paths carrying it, so a true variant keeps its
support through the path where a neighbouring junk call reverts to ref.
Genotypes come from the edge counts through the binomial model of
``coverage_tool.genotyper_log10``, with het-alt (j/k) when two alt edges
carry balanced support.

Where the JAX package makes one coverage call a cluster, the port makes one
for consecutive clusters of PATH_ROWS paths or so: a row's coverage does not
depend on the rows beside it, and on the general route (mixed read lengths)
one call costs some thousands of launches whatever its rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import List

import numpy as np

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.vcf import VcfRecord
from biograph_tpu_torch.variants.coverage_tool import WIN_CAP, _padded, genotyper_log10

PATH_ROWS = 256  # paths a coverage call, at least (whole clusters)


@dataclass
class VarGraphResult:
    gt: List[str]  # joint genotype of each record
    edge_reads: List[np.ndarray]  # per record: int32 [n_alts] best-path edge depth
    ref_reads: np.ndarray  # int32 [N] ref-edge depth (from the best ref-carrying path)
    cluster_of: np.ndarray  # int32 [N] cluster id (-1 = not evaluable)
    n_paths: np.ndarray  # int32 [N] paths enumerated for the record's cluster


def _is_dna(s: str) -> bool:
    return bool(s) and all(c in "ACGTacgt" for c in s)


def _clusters(flat_pos, ends, valid, reach: int, max_sites: int):
    """Group record indices whose windows overlap within ``reach`` bases; a
    cluster holds at most max_sites records (an over-dense window splits
    rather than multiplying the path set)."""
    order = sorted((i for i in range(len(flat_pos)) if valid[i]), key=lambda i: flat_pos[i])
    out: List[List[int]] = []
    cur: List[int] = []
    cur_end = -1
    for i in order:
        if cur and (flat_pos[i] - cur_end > reach or len(cur) >= max_sites):
            out.append(cur)
            cur = []
        cur.append(i)
        cur_end = max(cur_end, ends[i])
    if cur:
        out.append(cur)
    return out


def _path_seq(ref_flat, lo, hi, sites, choice):
    """Window [lo, hi) of the reference with the chosen allele edits applied.
    sites: (pos, ref_codes, [alt_codes...]) ascending; choice[j] is 0 for ref
    or a 1-based alt index.  Returns (codes, site_spans), site_spans[j] the
    (start, end) of site j's allele in path coordinates."""
    parts = []
    spans = []
    cur = lo
    for (p0, ra, alts), c in zip(sites, choice):
        parts.append(ref_flat[cur:p0])
        allele = ra if c == 0 else alts[c - 1]
        start = sum(len(x) for x in parts)
        parts.append(allele)
        spans.append((start, start + len(allele)))
        cur = p0 + len(ra)
    parts.append(ref_flat[cur:hi])
    return np.concatenate(parts), spans


def _score_cluster(sites, choices, spans, tot, ql, C: int, min_depth: int):
    """Edge counts and genotypes of one cluster's sites from the depth
    ``tot`` [P, L] along its P paths: (gt, edge reads int32 [n_alts], ref
    reads) a site."""
    # (path, site) edge depth: the min depth across the allele's span
    # widened by a base each side (a traversal crosses the edge); long
    # alleles score at their two breakpoint windows
    P, S = len(choices), len(sites)
    D = np.zeros((P, S), np.int32)
    for p in range(P):
        for s in range(S):
            a, b = spans[p][s]
            a2, b2 = max(a - 1, 0), min(b + 1, int(ql[p]))
            if b - a > 2 * WIN_CAP + C:
                wl = tot[p, a2 : a + WIN_CAP]
                wr = tot[p, b - WIN_CAP : b2]
                D[p, s] = min(int(wl.min()), int(wr.min()))
            else:
                D[p, s] = int(tot[p, a2:b2].min()) if b2 > a2 else 0

    # each allele edge's count: its best depth over all paths carrying it
    ch = np.asarray(choices, np.int32)  # [P, S]
    out = []
    for s in range(S):
        n_alts = len(sites[s][2])
        er = np.zeros(max(n_alts, 1), np.int32)
        for ai in range(n_alts):
            carry = ch[:, s] == ai + 1
            er[ai] = int(D[carry, s].max()) if carry.any() else 0
        carry0 = ch[:, s] == 0
        d_ref = int(D[carry0, s].max()) if carry0.any() else 0

        # the diploid state from the edge counts (annotate_coverage's
        # binomial model; the states two haplotype paths can realize: ref,
        # het or hom of one alt, or het-alt of two)
        k = int(np.argmax(er)) + 1
        d_alt = int(er[k - 1])
        tot_c = d_alt + d_ref
        if tot_c < min_depth:
            out.append(("./.", er, d_ref))
            continue
        gl = genotyper_log10(np.asarray([max(tot_c, 1)]), np.asarray([d_alt]))[0]
        state = int(np.argmax(gl))
        g = {0: "0/0", 1: f"0/{k}", 2: f"{k}/{k}"}[state]
        if n_alts >= 2:
            d = er.astype(np.int64)
            o2 = np.argsort(-d)
            a1, a2 = int(o2[0]), int(o2[1])
            total = int(d.sum()) + d_ref
            if d[a2] >= 3 and d[a2] >= 0.25 * total and d_ref < 0.2 * total:
                g = f"{min(a1, a2) + 1}/{max(a1, a2) + 1}"
        out.append((g, er, d_ref))
    return out


def evaluate_vargraph(
    readmap,
    reference,
    records: List[VcfRecord],
    max_sites: int = 4,
    max_paths: int = 16,
    min_depth: int = 1,
) -> VarGraphResult:
    """Edge read counts and joint diploid genotypes over window clusters."""
    N = len(records)
    C = int(readmap.max_read_len) + 2
    ref_flat = np.asarray(reference.flat)
    G = len(ref_flat)

    flat_pos = np.zeros(N, np.int64)
    ends = np.zeros(N, np.int64)
    valid = np.ones(N, bool)
    sites_of: List = [None] * N
    for i, rec in enumerate(records):
        alts = rec.alt.split(",")
        if not _is_dna(rec.ref) or not all(_is_dna(a) for a in alts):
            valid[i] = False
            continue
        contig = reference.contig_by_name(rec.chrom)
        p0 = contig.start + rec.pos - 1
        flat_pos[i] = p0
        ends[i] = p0 + len(rec.ref)
        # at most 2 alts a site: paths stay <= 3^max_sites before the
        # max_paths cut
        sites_of[i] = (
            p0,
            np.asarray(dna.seq_to_codes(rec.ref), np.uint8),
            [np.asarray(dna.seq_to_codes(a), np.uint8) for a in alts[:2]],
        )

    gt = ["./."] * N
    edge_reads = [np.zeros(max(len(records[i].alt.split(",")), 1), np.int32) for i in range(N)]
    ref_reads = np.zeros(N, np.int32)
    cluster_of = np.full(N, -1, np.int32)
    n_paths_out = np.zeros(N, np.int32)

    clusters = _clusters(flat_pos, ends, valid, reach=C, max_sites=max_sites)
    built = []  # (idxs, sites, choices, spans, paths) a cluster
    for idxs in clusters:
        sites = [sites_of[i] for i in idxs]
        lo = max(int(flat_pos[idxs[0]]) - C, 0)
        hi = min(int(max(ends[i] for i in idxs)) + C, G)

        # allele choices a site, cut until the path count fits
        n_allele = [1 + len(s[2]) for s in sites]
        while int(np.prod(n_allele)) > max_paths and max(n_allele) > 2:
            n_allele[int(np.argmax(n_allele))] -= 1
        choices = list(product(*[range(n) for n in n_allele]))
        if len(choices) > max_paths:
            # over-dense even at 2 alleles a site: the ref path, the
            # single-alt paths and the all-alt path (a star)
            star = [tuple(0 for _ in sites)]
            for j in range(len(sites)):
                c = [0] * len(sites)
                c[j] = 1
                star.append(tuple(c))
            star.append(tuple(1 for _ in sites))
            choices = star

        paths = []
        spans = []
        for ch in choices:
            seq, sp = _path_seq(ref_flat, lo, hi, sites, ch)
            paths.append(seq)
            spans.append(sp)
        built.append((idxs, sites, choices, spans, paths))

    # one coverage call for consecutive clusters holding PATH_ROWS paths or
    # so: the depth at every position of every path (a row's coverage does
    # not depend on the rows beside it)
    ci = 0
    while ci < len(built):
        group = [built[ci]]
        rows = len(built[ci][4])
        while ci + len(group) < len(built) and rows < PATH_ROWS:
            group.append(built[ci + len(group)])
            rows += len(group[-1][4])
        qc, ql = _padded([p for cluster in group for p in cluster[4]])
        fwd, rev = readmap.coverage(qc, ql)
        tot_all = (fwd + rev).cpu().numpy()
        row0 = 0
        for idxs, sites, choices, spans, paths in group:
            P = len(choices)
            scored = _score_cluster(sites, choices, spans, tot_all[row0 : row0 + P], ql[row0 : row0 + P], C, min_depth)
            for i, (g, er, d_ref) in zip(idxs, scored):
                gt[i], edge_reads[i], ref_reads[i] = g, er, d_ref
                cluster_of[i], n_paths_out[i] = ci, P
            row0 += P
            ci += 1

    return VarGraphResult(gt=gt, edge_reads=edge_reads, ref_reads=ref_reads, cluster_of=cluster_of, n_paths=n_paths_out)
