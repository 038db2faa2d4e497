"""Trusted k-mer set with batched membership lookup (torch).

Counterpart of ``biograph_tpu/kmers/kmer_set.py`` (the reference's kmer_set,
modules/bio_mapred/kmer_set.h:14): a sorted table of canonical k-mers on
the device; membership is one batched ``torch.searchsorted``.

The filter (``filter_kmer_counts``, kmerize_bf's kmer_passes,
modules/bio_mapred/kmerize_bf.cpp:288-335: BELOW_MIN_COUNT, SKEWED, and
NEAR_OVERREP, k-mers one substitution from an overrepresented k-mer whose
strand counts sit under the error thresholds) stays numpy on the host, as
in the JAX package, over int64 k-mers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.kmers.count import KmerCounts


def _hamming1_neighbors(kmers: np.ndarray, k: int) -> np.ndarray:
    """All 3k single-base substitutions of each kmer (int64 [n, 3k])."""
    kmers = np.asarray(kmers, np.int64)
    out = np.empty((len(kmers), 3 * k), np.int64)
    col = 0
    for pos in range(k):
        shift = 2 * pos
        cur = (kmers >> shift) & 3
        for delta in (1, 2, 3):
            nb = (cur + delta) & 3
            out[:, col] = (kmers & ~(3 << shift)) | (nb << shift)
            col += 1
    return out


def filter_kmer_counts(
    counts: KmerCounts,
    min_count: int = 2,
    max_count: int | None = None,
    prior_count: int = 5,
    skew_cutoff: float = 0.0,
    overrep_threshold: int = 0,
    sys_err_thresh: float = 0.1,
    rnd_err_thresh: float = 0.005,
):
    """kmer_passes analog (kmerize_bf.cpp:290-322).  Returns (keep bool [n],
    stats dict with per-filter-result counts)."""
    fwd = np.asarray(counts.fwd, np.int64)
    rev = np.asarray(counts.rev, np.int64)
    tot = fwd + rev
    below = tot < min_count
    if max_count is not None:
        below |= tot > max_count
    low = (np.minimum(fwd, rev) + prior_count) / (tot + 2 * prior_count)
    skewed = ~below & (low < skew_cutoff)
    near = np.zeros(len(tot), bool)
    n_overrep = 0
    if overrep_threshold:
        ov_mask = tot >= overrep_threshold
        n_overrep = int(ov_mask.sum())
        if n_overrep:
            ov_k = np.asarray(counts.kmers[ov_mask], np.int64)
            ov_c = tot[ov_mask]
            # find_near checks hamming(k, O) == 1 for k AND revcomp(k); the
            # latter equals hamming(k, revcomp(O)) == 1, so the neighbor
            # table covers each overrep kmer and its reverse complement
            ov_rc = dna.revcomp_kmer(torch.from_numpy(ov_k), counts.k).numpy()
            nbrs = np.concatenate(
                [_hamming1_neighbors(ov_k, counts.k), _hamming1_neighbors(ov_rc, counts.k)],
                axis=1,
            )  # [n_ov, 6k]
            cnts = np.broadcast_to(ov_c[:, None], nbrs.shape)
            flat = nbrs.reshape(-1)
            flatc = cnts.reshape(-1)
            # max overrep count per distinct neighbor (find_near keeps max)
            order = np.lexsort((-flatc, flat))
            flat, flatc = flat[order], flatc[order]
            first = np.concatenate([[True], flat[1:] != flat[:-1]])
            tab_k, tab_c = flat[first], flatc[first]
            q = np.asarray(counts.kmers, np.int64)
            lo = np.searchsorted(tab_k, q)
            loc = np.clip(lo, 0, len(tab_k) - 1)
            hit = (lo < len(tab_k)) & (tab_k[loc] == q)
            o_count = np.where(hit, tab_c[loc], 0)
            min_c = np.minimum(fwd, rev)
            max_c = np.maximum(fwd, rev)
            near = (
                hit
                & ~below
                & ~skewed
                & (min_c < o_count * rnd_err_thresh)
                & (max_c < o_count * sys_err_thresh)
            )
    keep = ~(below | skewed | near)
    stats = {
        "PASSED": int(keep.sum()),
        "BELOW_MIN_COUNT": int(below.sum()),
        "SKEWED": int(skewed.sum()),
        "NEAR_OVERREP": int(near.sum()),
        "OVERREP": n_overrep,
    }
    return keep, stats


@dataclass(frozen=True)
class KmerSet:
    k: int
    kmers: torch.Tensor  # int64 [n] sorted canonical k-mers, on the device

    @staticmethod
    def from_counts(
        counts: KmerCounts,
        min_count: int = 2,
        max_count: int | None = None,
        stats_out: dict | None = None,
        device="cuda",
        **filter_kw,
    ) -> "KmerSet":
        keep, stats = filter_kmer_counts(counts, min_count=min_count, max_count=max_count, **filter_kw)
        if stats_out is not None:
            stats_out.update(stats)
        kmers = np.ascontiguousarray(counts.kmers[keep], np.int64)
        return KmerSet(k=counts.k, kmers=torch.from_numpy(kmers).to(resolve_device(device)))

    @property
    def size(self) -> int:
        return int(self.kmers.shape[0])

    def contains(self, query_kmers) -> torch.Tensor:
        """Batched membership of *raw* k-mers (canonicalized here)."""
        q = torch.as_tensor(query_kmers, dtype=torch.int64, device=self.kmers.device)
        canon, _ = dna.canonicalize_kmers(q, self.k)
        return self.contains_canonical(canon)

    def contains_canonical(self, canon) -> torch.Tensor:
        canon = torch.as_tensor(canon, dtype=torch.int64, device=self.kmers.device)
        n = self.kmers.shape[0]
        if n == 0:
            return torch.zeros(canon.shape, dtype=torch.bool, device=canon.device)
        lo = torch.searchsorted(self.kmers, canon)
        return (lo < n) & (self.kmers[lo.clamp(max=n - 1)] == canon)

    def save_arrays(self):
        return {"kmers": self.kmers.cpu().numpy(), "k": self.k}
