"""Batched seed-and-verify read placement against the reference (torch).

Counterpart of ``biograph_tpu/variants/align.py``: every read is seeded by
exact k-mer lookups into a sorted reference k-mer table, then all candidate
placements of all reads are verified in one vectorized mismatch count, with
no per-read control flow.  Discovery's pair gate, coverage's pair count and
the SV engine place reads with it; the first two pair them by ``proper_pairs``.

k-mers are int64 (k <= 31); the packed words of reads and of the genome's
phase packings are int64 holding 32-bit values, and the mismatch count is a
SWAR popcount (``core.bitvector.popcount32``): torch has none.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.core.bitvector import popcount32

SMALL_SENTINEL = 0xFFFFFFFF  # the pad key of a table of k <= 16 k-mers
LARGE_SENTINEL = torch.iinfo(torch.int64).max  # above every k-mer of k <= 31


@dataclass(frozen=True)
class RefKmerIndex:
    """Sorted k-mer table over the reference.  The genome is also stored as
    16 phase-shifted 2-bit packings (``ref_phases[p][w]`` = bases
    16*w+p .. 16*w+p+15), so a read window at any position is 3 aligned word
    gathers + XOR + popcount."""

    k: int
    kmers: torch.Tensor  # int64 [n] ascending
    positions: torch.Tensor  # int64 [n] start position of each k-mer
    ref_codes: torch.Tensor  # uint8 [G]
    ref_len: int
    ref_phases: torch.Tensor | None = None  # int64 [16, nw], 32-bit values

    @staticmethod
    def build(
        ref_codes: np.ndarray,
        k: int,
        is_n: np.ndarray | None = None,
        device="cuda",
    ) -> "RefKmerIndex":
        ref_np = np.asarray(ref_codes, np.uint8)
        G = len(ref_np)
        ref = torch.from_numpy(ref_np.copy()).to(device)
        kmers, valid = dna.kmers_from_codes(ref[None, :], torch.tensor([G], device=ref.device), k)
        kmers, valid = kmers[0], valid[0]
        if is_n is not None:
            # k-mers touching N positions are not seedable
            isn = np.asarray(is_n, bool)
            bad = np.convolve(isn.astype(np.int32), np.ones(k, np.int32))[k - 1 : len(isn)]
            valid = valid & torch.from_numpy(bad == 0).to(ref.device)
        small = k <= 16 and G < (1 << 31)
        keys = torch.where(valid, kmers, SMALL_SENTINEL if small else LARGE_SENTINEL)
        sk, order = torch.sort(keys, stable=True)
        n_valid = int(valid.sum())
        return RefKmerIndex(
            k=k,
            kmers=sk[:n_valid],
            positions=order[:n_valid],
            ref_codes=ref,
            ref_len=G,
            ref_phases=torch.from_numpy(_phase_packings(ref_np).astype(np.int64)).to(ref.device),
        )

    def lookup(self, query_kmers: torch.Tensor, max_hits: int):
        """Up to max_hits reference positions per query k-mer: (positions
        [..., max_hits] with -1 where there is none, valid mask), by binary
        search."""
        q = query_kmers
        hits = torch.arange(max_hits, dtype=torch.int64, device=q.device)
        n = self.positions.shape[0]
        if n == 0:
            shape = q.shape + (max_hits,)
            return (
                torch.full(shape, -1, dtype=torch.int64, device=q.device),
                torch.zeros(shape, dtype=torch.bool, device=q.device),
            )
        lo = torch.searchsorted(self.kmers, q)
        idx = lo[..., None] + hits
        hit = (idx < n) & (self.kmers[idx.clamp(0, n - 1)] == q[..., None])
        pos = self.positions[idx.clamp(0, n - 1)]
        return torch.where(hit, pos, -1), hit


def _phase_packings(ref_codes: np.ndarray) -> np.ndarray:
    """16 phase-shifted 2-bit packings of the genome: out[p, w] packs bases
    [16*w + p, 16*w + p + 16).  uint32; memory = 4x genome bytes."""
    G = len(ref_codes)
    nw = G // 16 + 2
    out = np.zeros((16, nw), np.uint32)
    padded = np.zeros(nw * 16 + 16, np.uint8)
    padded[:G] = ref_codes
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    for p in range(16):
        seg = padded[p : p + nw * 16].reshape(nw, 16).astype(np.uint32)
        out[p] = (seg << shifts).sum(axis=1, dtype=np.uint32)
    return out


@dataclass
class Placements:
    """Best placement per read (both strands considered)."""

    pos: np.ndarray  # int64 [R] start in flat ref coords (-1 = unplaced)
    is_rc: np.ndarray  # bool [R] — placed as reverse complement
    mismatches: np.ndarray  # int32 [R]


def place_reads(
    index: RefKmerIndex,
    codes: np.ndarray,
    lengths: np.ndarray,
    max_mismatches: int = 5,
    seeds_per_read: int = 3,
    max_hits_per_seed: int = 8,
    batch_rows: int = 1 << 15,
) -> Placements:
    """Place each read (and its reverse complement) on the reference; keep
    the best.  Seeds are k-mers at evenly spaced offsets; every (seed, hit)
    candidate is verified by a full mismatch count against the reference;
    the fewest-mismatch, leftmost placement wins.  Runs on the index's
    device."""
    R, L = codes.shape
    dev = index.ref_codes.device
    out_pos = np.full(R, -1, np.int64)
    out_rc = np.zeros(R, bool)
    out_mm = np.full(R, np.iinfo(np.int32).max, np.int32)
    for lo in range(0, R, batch_rows):
        hi = min(R, lo + batch_rows)
        c = torch.from_numpy(np.ascontiguousarray(codes[lo:hi], np.uint8)).to(dev)
        ln = torch.from_numpy(np.asarray(lengths[lo:hi], np.int32).copy()).to(dev)
        p, rc, mm = place_batch(index, c, ln, int(max_mismatches), seeds_per_read, max_hits_per_seed)
        out_pos[lo:hi] = p.cpu().numpy()
        out_rc[lo:hi] = rc.cpu().numpy()
        out_mm[lo:hi] = mm.cpu().numpy()
    return Placements(pos=out_pos, is_rc=out_rc, mismatches=out_mm)


def proper_pairs(placements: Placements, lengths: np.ndarray, mate_of: np.ndarray, max_frag: int):
    """The proper-pair rule over the forward reads (``Readmap.forward_reads``):
    read i and its mate ``mate_of[i]`` (i itself if unpaired) are a proper
    pair when both are placed, on opposite strands, at most max_frag apart.

    Returns (a, b, proper, half): each read's pair span [a, b) int64 [R],
    from the lower start to the higher start plus read i's own length (the
    mate's end too, as in the JAX package); the proper mask bool [R]; the
    half-placed mask bool [R], a paired read of which one mate alone is
    placed.  A proper pair is counted from both of its reads."""
    pos, rc = placements.pos, placements.is_rc
    placed = pos >= 0
    paired = mate_of != np.arange(len(pos))
    proper = (
        paired & placed & placed[mate_of]
        & (np.abs(pos - pos[mate_of]) <= max_frag)
        & (rc != rc[mate_of])
    )
    a = np.minimum(pos, pos[mate_of])
    b = np.maximum(pos, pos[mate_of]) + lengths
    return a, b, proper, paired & (placed ^ placed[mate_of])


def place_batch(index: RefKmerIndex, codes, lengths, max_mm: int, n_seeds: int, max_hits: int):
    """One batch of ``place_reads``: (pos int64, is_rc bool, mismatches
    int32), each [B]."""
    k = index.k
    B, L = codes.shape
    W = dna.words_for_bases(L)
    rc = dna.revcomp_codes(codes, lengths)
    lengths64 = lengths.to(torch.int64)

    def candidates(c):
        # seed offsets spread over the read
        offs = [
            ((lengths64 - k) * i // max(n_seeds - 1, 1)).clamp(0, L - k)
            for i in range(n_seeds)
        ]
        km, _ = dna.kmers_from_codes(c, lengths, k)  # [B, L-k+1]
        nwin = km.shape[1]
        cand = []
        for off in offs:
            offc = off.clamp(0, nwin - 1)
            q = km.gather(1, offc[:, None])[:, 0]
            pos, hit = index.lookup(q, max_hits)  # [B, H]
            cand.append(torch.where(hit, pos - offc[:, None], -1))
        return torch.cat(cand, dim=1)  # [B, n_seeds*H]

    def verify(c, starts):
        """Packed-word verify: 3 aligned word gathers + XOR/popcount per
        candidate instead of L byte gathers."""
        okpos = (starts >= 0) & (starts + lengths64[:, None] <= index.ref_len)
        s = starts.clamp(0, max(index.ref_len - 1, 0))
        rw = dna.pack_codes(c, lengths)  # [B, W]
        rmask = dna.prefix_mask_words(lengths, W)  # [B, W]
        phases = index.ref_phases
        nw = phases.shape[1]
        flat_ref = phases.reshape(-1)
        flat_base = (s & 15) * nw + (s >> 4)  # [B, C]
        mm = torch.zeros(starts.shape, dtype=torch.int64, device=c.device)
        for i in range(W):
            wref = flat_ref[(flat_base + i).clamp(0, flat_ref.shape[0] - 1)]
            x = (wref ^ rw[:, None, i]) & rmask[:, None, i]
            mm = mm + popcount32((x | (x >> 1)) & 0x55555555)
        return torch.where(okpos, mm, 1 << 30)

    def best(c):
        starts = candidates(c)
        mm = verify(c, starts)
        # prefer fewest mismatches, then the leftmost start; invalid lanes
        # get a key above every valid one; argmin takes the first minimum
        G = index.ref_len + 1
        ok = mm < (1 << 30)
        key = torch.where(ok, mm.clamp(max=255) * G + starts.clamp(0, G - 1), 1 << 62)
        j = torch.argmin(key, dim=1, keepdim=True)
        return starts.gather(1, j)[:, 0], mm.gather(1, j)[:, 0]

    fpos, fmm = best(codes)
    rpos, rmm = best(rc)
    use_rc = rmm < fmm
    pos = torch.where(use_rc, rpos, fpos)
    mm = torch.where(use_rc, rmm, fmm)
    placed = mm <= max_mm
    return (
        torch.where(placed, pos, -1),
        use_rc & placed,
        torch.where(placed, mm, -1).to(torch.int32),
    )
