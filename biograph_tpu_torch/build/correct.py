"""Batched read error correction against the trusted k-mer set (torch).

Counterpart of ``biograph_tpu/build/correct.py`` (the reference's
fast_read_correct, modules/bio_base/fast_read_correct.cpp, and
correct_reads, modules/build_seqset/correct_reads.h:14): greedy
left-to-right extension where each next k-mer must be trusted; on a
mismatch all four bases are tried with a fixed lookahead and the best
score wins.  Every read of a batch advances one base a step.

The JAX package runs a batch as one jitted ``fori_loop`` of L steps; here a
step is tensor code in a host loop, with two changes that change no
answer: the 1 + 4 x ``lookahead`` membership probes of a step go to the
device as one ``searchsorted``, and the loop stops once no read is active
(read every ``SYNC_EVERY`` steps, the only host syncs of the loop).  The
rest is the JAX package's to the letter: a read is anchored at its first
trusted k-mer and its head before the anchor is kept; indices past the
read are clipped; a tie between candidate bases goes to the highest base;
a read that cannot be extended is cut where it failed, dropped below
``k + min_good_run`` bases, and zeroed past its new length.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.kmers.kmer_set import KmerSet

SYNC_EVERY = 8


@dataclass
class CorrectionResult:
    codes: np.ndarray  # corrected reads, uint8 [R, L]
    lengths: np.ndarray  # int32 [R] — 0 for dropped (uncorrectable) reads
    corrections: np.ndarray  # int32 [R]
    kept: np.ndarray  # bool [R]


def correct_reads(
    kmer_set: KmerSet,
    codes: np.ndarray,
    lengths: np.ndarray,
    max_corrections: int = 8,
    min_good_run: int = 2,
    lookahead: int = 6,
    batch_rows: int = 1 << 14,
) -> CorrectionResult:
    """Correct host reads in batches of ``batch_rows`` on the k-mer set's
    device; the result is on the host."""
    R, L = codes.shape
    dev = kmer_set.kmers.device
    out_codes = np.zeros((R, L), np.uint8)
    out_len = np.zeros(R, np.int32)
    out_corr = np.zeros(R, np.int32)
    for lo in range(0, R, batch_rows):
        hi = min(R, lo + batch_rows)
        c = torch.from_numpy(np.ascontiguousarray(codes[lo:hi], np.uint8)).to(dev)
        ln = torch.from_numpy(np.ascontiguousarray(lengths[lo:hi], np.int32)).to(dev)
        c, ln, nc = correct_batch(kmer_set, c, ln, max_corrections, min_good_run, lookahead)
        out_codes[lo:hi] = c.cpu().numpy()
        out_len[lo:hi] = ln.cpu().numpy()
        out_corr[lo:hi] = nc.cpu().numpy()
    return CorrectionResult(codes=out_codes, lengths=out_len, corrections=out_corr, kept=out_len > 0)


def correct_batch(ks: KmerSet, codes: torch.Tensor, lengths: torch.Tensor, max_corr: int, min_good_run: int, lookahead: int):
    """One batch on its device: (codes uint8 [B, L], lengths int32 [B],
    corrections int32 [B])."""
    k = ks.k
    B, L = codes.shape
    dev = codes.device
    mask = dna.kmer_mask(k)
    cols = torch.arange(L, device=dev)
    lengths = lengths.to(torch.int32)

    def roll(kmer, b):
        return ((kmer << 2) | b) & mask

    def base_at(out, p):
        return out.gather(1, p.clamp(0, L - 1).to(torch.int64)[:, None])[:, 0].to(torch.int64)

    # anchor: the first trusted k-mer of each read
    kms, valid = dna.kmers_from_codes(codes, lengths, k)
    ok = ks.contains(kms) & valid
    has_anchor = ok.any(dim=1)
    if ok.shape[1]:
        anchor = torch.where(has_anchor, ok.to(torch.uint8).argmax(dim=1), 0).to(torch.int32)
    else:
        anchor = torch.zeros(B, dtype=torch.int32, device=dev)
    kmer = torch.zeros(B, dtype=torch.int64, device=dev)
    for i in range(k):
        kmer = (kmer << 2) | base_at(codes, anchor + i)

    out = codes.clone()
    pos = anchor + k  # the next position to validate
    alive = has_anchor
    n_corr = torch.zeros(B, dtype=torch.int32, device=dev)
    dead_at = torch.where(alive, lengths, 0)
    bases = torch.arange(4, dtype=torch.int64, device=dev)
    for step in range(L):
        if step % SYNC_EVERY == 0 and not bool((alive & (pos < lengths)).any()):
            break
        act = alive & (pos < lengths)
        # the probes of a step: the read's own next k-mer, then for each of
        # the four bases its k-mer and lookahead - 1 k-mers rolled on over
        # the read's next bases
        km_try = roll(kmer, base_at(out, pos))
        kb = roll(kmer[:, None], bases[None, :])  # [B, 4]
        chain = [kb]
        for la in range(1, lookahead):
            chain.append(roll(chain[-1], base_at(out, pos + la)[:, None]))
        probes = torch.cat([km_try[:, None], torch.stack(chain, dim=2).reshape(B, 4 * lookahead)], dim=1)
        hits = ks.contains(probes)
        good = hits[:, 0]
        look = hits[:, 1:].reshape(B, 4, lookahead)
        okb = look[:, :, 0]
        inr = (pos[:, None] + torch.arange(1, lookahead, device=dev)[None, :]) < lengths[:, None]  # [B, la - 1]
        scores = okb.to(torch.int32) + (look[:, :, 1:] & okb[:, :, None] & inr[:, None, :]).to(torch.int32).sum(dim=2)
        best_b = 3 - scores.flip(1).argmax(dim=1)  # ties -> the highest base (the reference's >= keeps the last)
        best_score = scores.gather(1, best_b[:, None])[:, 0]
        can_fix = act & ~good & (best_score > 0) & (n_corr < max_corr)
        out = torch.where(can_fix[:, None] & (cols[None, :] == pos[:, None]), best_b.to(torch.uint8)[:, None], out)
        new_kmer = torch.where(good, km_try, torch.where(can_fix, roll(kmer, best_b), kmer))
        advanced = act & (good | can_fix)
        failed = act & ~good & ~can_fix
        dead_at = torch.where(failed, pos, dead_at)
        alive = alive & ~failed
        n_corr = n_corr + (can_fix & ~good).to(torch.int32)
        kmer = torch.where(advanced, new_kmer, kmer)
        pos = pos + advanced.to(torch.int32)
    eff_len = torch.where(has_anchor, torch.where(alive, lengths, dead_at), 0)
    # too-short results are dropped (min viable = k + min_good_run)
    eff_len = torch.where(eff_len >= k + min_good_run, eff_len, 0).to(torch.int32)
    out = torch.where(cols[None, :] < eff_len[:, None], out, 0)
    return out, eff_len, n_corr
