"""Device k-mer counting: rolling encode -> sort -> segmented sum (torch).

Counterpart of ``biograph_tpu/kmers/count.py`` (the reference's
kmerize_reads map/sort/reduce, modules/bio_mapred/kmerize_reads_mapper.cpp:
86-140: canonical k-mer, a (fwd, rev) count pair split by orientation).
Counting is one device sort of the canonical k-mer keys plus a segmented
sum, per batch of reads; batches merge on the host.

Keys are int64 (torch has no shifts on uint64): a k-mer of k <= 31 bases
fills at most 62 bits, so the largest int64 sorts after every real key and
pads the invalid windows, where the JAX package pads its uint64 keys with
all ones.  ``k = 32`` raises, naming the limit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna

PAD = torch.iinfo(torch.int64).max


@dataclass
class KmerCounts:
    """Sorted unique canonical k-mers with per-orientation counts (host)."""

    k: int
    kmers: np.ndarray  # int64 [U], ascending
    fwd: np.ndarray  # int64 [U]
    rev: np.ndarray  # int64 [U]

    @property
    def total(self) -> np.ndarray:
        return self.fwd + self.rev

    def write_text(self, path: str):
        """Reference-compatible dump: 'SEQ\\tfwd\\trev' per line, sorted
        (format: modules/bio_format/kmer_count.cpp kmer_count_exporter)."""
        seqs = _kmers_to_text(np.asarray(self.kmers, np.int64), self.k)
        with open(path, "wb") as f:
            for s, fw, rv in zip(seqs, self.fwd.tolist(), self.rev.tolist()):
                f.write(b"%s\t%d\t%d\n" % (s, fw, rv))


def _kmers_to_text(kmers: np.ndarray, k: int) -> list:
    """int64 k-mers -> bytes rows."""
    shifts = 2 * (k - 1 - np.arange(k, dtype=np.int64))
    codes = ((kmers[:, None] >> shifts[None, :]) & 3).astype(np.uint8)
    return [row.tobytes() for row in dna.decode_to_ascii(codes)]


def count_kmers_device(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """(unique canonical k-mers, fwd counts, rev counts) of one batch, all
    int64 tensors on the batch's device, keys ascending.  One host read (the
    number of distinct keys)."""
    kmers, valid = dna.kmers_from_codes(codes, lengths, k)
    canon, is_fwd = dna.canonicalize_kmers(kmers, k)
    keys = torch.where(valid, canon, PAD).reshape(-1)
    keys, order = torch.sort(keys)
    fwd_flag = (is_fwd & valid).reshape(-1)[order].to(torch.int64)
    valid = valid.reshape(-1)[order].to(torch.int64)
    is_new = torch.ones_like(keys, dtype=torch.bool)
    is_new[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(is_new, 0) - 1
    n = keys.shape[0]
    fwd = torch.zeros(n, dtype=torch.int64, device=keys.device).index_add_(0, seg, fwd_flag)
    tot = torch.zeros(n, dtype=torch.int64, device=keys.device).index_add_(0, seg, valid)
    n_unique = int((is_new & (keys != PAD)).sum())
    # the segments' leaders in key order; the pad segment, if any, is last
    uk = keys[is_new][:n_unique]
    return uk, fwd[:n_unique], tot[:n_unique] - fwd[:n_unique]


def count_kmers(
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int,
    batch_rows: int = 1 << 17,
    device="cuda",
) -> KmerCounts:
    """Count canonical k-mers of a read set, each read once in its stored
    orientation (the kmerize_reads pipeline): batches of ``batch_rows``
    reads are counted on ``device`` and merged on the host."""
    dna.check_k(k)
    dev = resolve_device(device)
    empty = np.zeros(0, np.int64)
    if codes.shape[0] == 0 or codes.shape[1] < k:
        # no read wide enough to hold a single k-mer (e.g. aggressive
        # --cut-reads): an empty count
        return KmerCounts(k, empty, empty.copy(), empty.copy())
    parts = []
    for lo in range(0, codes.shape[0], batch_rows):
        hi = min(lo + batch_rows, codes.shape[0])
        c = torch.from_numpy(np.ascontiguousarray(codes[lo:hi], np.uint8)).to(dev)
        ln = torch.from_numpy(np.ascontiguousarray(lengths[lo:hi], np.int32)).to(dev)
        parts.append(tuple(t.cpu().numpy() for t in count_kmers_device(c, ln, k)))
    if len(parts) == 1 or not any(len(p[0]) for p in parts):
        uk, uf, ur = parts[0]
    else:
        uk = np.concatenate([p[0] for p in parts])
        uf = np.concatenate([p[1] for p in parts])
        ur = np.concatenate([p[2] for p in parts])
        order = np.argsort(uk, kind="stable")
        uk, uf, ur = uk[order], uf[order], ur[order]
        isnew = np.concatenate([[True], uk[1:] != uk[:-1]])
        seg = np.cumsum(isnew) - 1
        n_u = int(seg[-1]) + 1
        fwd = np.zeros(n_u, np.int64)
        rev = np.zeros(n_u, np.int64)
        np.add.at(fwd, seg, uf)
        np.add.at(rev, seg, ur)
        uk, uf, ur = uk[isnew], fwd, rev
    return KmerCounts(k=k, kmers=uk, fwd=uf, rev=ur)
