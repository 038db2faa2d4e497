"""Reference BWT / FM-index: exact genome lookups of any length (torch).

Counterpart of ``biograph_tpu/index/bwt.py`` (the reference's SpiralBW
reference BWT, modules/bio_base/bwt_file.h:22, built by
modules/bio_mapred/make_bwt.cpp and queried by ``bgbinary bwtquery``):
``find(seq)`` gives the SA range of every exact occurrence, ``locate`` the
genome positions.  Queries of any length are one backward search, past the
k <= 16 cap of the seed table in ``variants/align.py``.

The suffix array comes from prefix doubling on the device: each round
orders the suffixes by (rank[i], rank[i + k]) and ranks them again.  The
JAX package sorts the (rank, key2, index) triple in one stable
``lax.sort``; here two stable passes do it, by key2 and then by rank,
never one packed key (``rank * (n + 2) + key2`` overflows int64 past about
3e9 bases).  The occurrence structure is four ``core.bitvector.RankBits``
(words int32, the bits of the JAX package's uint32 words), so an index
saved by either package loads in the other (``core/container.py``).
Backward search is a loop of L tensor steps over all query lanes; locate
walks LF steps until a sampled row, reading ``any(~done)`` every
``LOCATE_SYNC_EVERY`` steps (a finished lane never moves again).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import container, dna
from biograph_tpu_torch.core.bitvector import RankBits, low_bits_mask, popcount32

LOCATE_SYNC_EVERY = 8  # LF steps between reads of any(~done)


def build_suffix_array(codes, device="cuda") -> torch.Tensor:
    """Suffix array of codes plus an implicit terminal sentinel (the
    smallest character): int64 [G + 1] on ``device``, sa[0] == G."""
    dev = resolve_device(device)
    g = torch.from_numpy(np.array(codes, np.uint8)).to(dev)
    n = g.shape[0] + 1
    # rank 0 is the sentinel; bases shift up by 1
    rank = torch.cat([g.to(torch.int64) + 1, torch.zeros(1, dtype=torch.int64, device=dev)])
    idx = torch.arange(n, device=dev)
    k = 1
    while True:
        key2 = torch.where(idx + k < n, rank[(idx + k).clamp(max=n - 1)], -1)
        # stable by key2, then stable by rank: the (rank, key2, index) order
        order = torch.sort(key2, stable=True).indices
        order = order[torch.sort(rank[order], stable=True).indices]
        r1, r2 = rank[order], key2[order]
        new = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        nr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(new, 0)])
        rank = torch.empty_like(rank)
        rank[order] = nr
        if int(nr[-1]) + 1 == n or k >= n:
            return order
        k *= 2


@dataclass
class RefBwt:
    """FM-index over the flat reference (forward strand + sentinel)."""

    length: int  # G (without the sentinel)
    counts: np.ndarray  # int64 [6]: C array over {sentinel, A, C, G, T}
    occ: list  # 4 RankBits over the BWT, one a base
    sentinel_pos: int  # the BWT row whose character is the sentinel
    sa_sample: torch.Tensor  # int64 [ceil((G + 1) / sa_rate)]: every sa_rate-th row's suffix
    sa_rate: int = 32
    uuid: str = ""

    @staticmethod
    def build(ref_codes: np.ndarray, sa_rate: int = 32, device="cuda") -> "RefBwt":
        dev = resolve_device(device)
        g_np = np.asarray(ref_codes, np.uint8)
        G = len(g_np)
        g = torch.from_numpy(g_np.copy()).to(dev)
        sa = build_suffix_array(g_np, dev)
        n = G + 1
        prev = sa - 1
        bwt = torch.where(prev >= 0, g[prev.clamp(0, max(G - 1, 0))].to(torch.int64), 0) if G else torch.zeros(n, dtype=torch.int64, device=dev)
        sentinel_pos = int(torch.nonzero(sa == 0)[0, 0])
        base_counts = np.bincount(g_np, minlength=4)
        # C[c] = characters strictly smaller; alphabet order $, A, C, G, T
        C = np.zeros(6, np.int64)
        C[1] = 1
        for b in range(4):
            C[b + 2] = C[b + 1] + base_counts[b]
        not_sentinel = torch.arange(n, device=dev) != sentinel_pos
        occ = [RankBits.from_bools((bwt == b) & not_sentinel) for b in range(4)]
        return RefBwt(length=G, counts=C, occ=occ, sentinel_pos=sentinel_pos, sa_sample=sa[::sa_rate].clone(), sa_rate=sa_rate)

    @staticmethod
    def cached_build(ref_codes: np.ndarray, cache_dir: str, sa_rate: int = 32, device="cuda") -> "RefBwt":
        """Build with a content-addressed cache in ``cache_dir``: the stages
        that need the reference FM-index share one artifact keyed by the
        reference's bytes.  An unreadable cache entry is built again."""
        g = np.asarray(ref_codes, np.uint8)
        h = hashlib.sha256(g.tobytes()).hexdigest()[:24]
        path = os.path.join(cache_dir, f"refbwt_{h}_r{sa_rate}")
        if container.exists(path):
            try:
                return RefBwt.load(path, device)
            except (OSError, ValueError, KeyError):
                pass
        bwt = RefBwt.build(g, sa_rate, device)
        os.makedirs(cache_dir, exist_ok=True)
        bwt.save(path)
        return bwt

    @property
    def device(self) -> torch.device:
        return self.sa_sample.device

    @cached_property
    def d(self) -> "_BwtDevice":
        return _BwtDevice(
            counts=torch.from_numpy(np.asarray(self.counts, np.int64).copy()).to(self.device),
            occ_words=torch.stack([o.words for o in self.occ]),
            occ_cum=torch.stack([o.cum for o in self.occ]),
            n=self.length + 1,
            sentinel_pos=self.sentinel_pos,
            sa_sample=self.sa_sample,
            sa_rate=self.sa_rate,
        )

    # ---------------- queries ----------------

    def find(self, seqs, lengths=None):
        """Batched exact search.  seqs: [B, L] codes (or a str for B=1).
        Returns (lo, hi) int64 numpy [B] SA ranges ([lo, hi) empty if
        absent)."""
        if isinstance(seqs, str):
            seqs = dna.seq_to_codes(seqs)[None, :]
        seqs = np.asarray(seqs, np.uint8)
        if lengths is None:
            lengths = np.full(seqs.shape[0], seqs.shape[1], np.int32)
        lo, hi = _bwt_find(
            self.d, torch.from_numpy(seqs.copy()).to(self.device),
            torch.from_numpy(np.asarray(lengths, np.int64).copy()).to(self.device),
        )
        return lo.cpu().numpy(), hi.cpu().numpy()

    def locate(self, lo: int, hi: int, max_hits: int = 64) -> np.ndarray:
        """Genome positions of SA rows [lo, hi), ascending, at most
        max_hits of them."""
        m = min(int(hi) - int(lo), max_hits)
        if m <= 0:
            return np.zeros(0, np.int64)
        rows = torch.arange(int(lo), int(lo) + m, dtype=torch.int64, device=self.device)
        return np.sort(_bwt_locate(self.d, rows).cpu().numpy())

    def count(self, seq) -> int:
        lo, hi = self.find(seq)
        return int(hi[0] - lo[0])

    # ---------------- persistence ----------------

    def save(self, path: str):
        with container.ArtifactWriter(path, "refbwt") as w:
            w.set_scalar("length", self.length)
            w.set_scalar("sentinel_pos", self.sentinel_pos)
            w.set_scalar("sa_rate", self.sa_rate)
            w.add_array("counts", np.asarray(self.counts, np.int64))
            w.add_array("occ_words", torch.stack([o.words for o in self.occ]).cpu().numpy().view(np.uint32))
            w.add_array("occ_cum", torch.stack([o.cum for o in self.occ]).cpu().numpy())
            w.add_array("sa_sample", self.sa_sample.cpu().numpy())
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str, device="cuda") -> "RefBwt":
        dev = resolve_device(device)
        r = container.ArtifactReader(path, "refbwt")
        words = torch.from_numpy(np.ascontiguousarray(r.array("occ_words")).view(np.int32).copy()).to(dev)
        cum = torch.from_numpy(np.asarray(r.array("occ_cum"), np.int64).copy()).to(dev)
        n = r.scalar("length") + 1
        occ = [
            RankBits(n=n, words=words[b], cum=cum[b], total=int(cum[b][-1]) + int(popcount32(words[b][-1:].to(torch.int64))[0]))
            for b in range(4)
        ]
        return RefBwt(
            length=r.scalar("length"),
            counts=np.asarray(r.array("counts"), np.int64),
            occ=occ,
            sentinel_pos=r.scalar("sentinel_pos"),
            sa_sample=torch.from_numpy(np.asarray(r.array("sa_sample"), np.int64).copy()).to(dev),
            sa_rate=r.scalar("sa_rate"),
            uuid=r.uuid,
        )


@dataclass(frozen=True)
class _BwtDevice:
    counts: torch.Tensor  # int64 [6]
    occ_words: torch.Tensor  # int32 [4, nw] (the bits of uint32 words)
    occ_cum: torch.Tensor  # int64 [4, nw]
    n: int
    sentinel_pos: int
    sa_sample: torch.Tensor
    sa_rate: int

    def rank(self, b, pos):
        """Occurrences of base b in bwt[0:pos] (the sentinel row left out)."""
        nw = self.occ_words.shape[1]
        w = pos >> 5
        over = w >= nw
        flat = b.to(torch.int64) * nw + w.clamp(max=nw - 1)
        word = self.occ_words.reshape(-1)[flat].to(torch.int64)
        mask = torch.where(over, 0xFFFFFFFF, low_bits_mask(pos & 31))
        return self.occ_cum.reshape(-1)[flat] + popcount32(word & mask)

    def lf_step(self, lo, hi, b):
        """One backward-search step: prepend base b."""
        cb = self.counts[b.to(torch.int64) + 1]
        return cb + self.rank(b, lo), cb + self.rank(b, hi)

    def lf_row(self, row):
        """LF mapping of single BWT rows (the locate walk): (next row, the
        row's BWT base, -1 for the sentinel)."""
        w = row >> 5
        bit = row & 31
        chars = torch.full_like(row, -1)
        for b in range(4):
            has = ((self.occ_words[b][w].to(torch.int64) >> bit) & 1).to(torch.bool)
            chars = torch.where(has, b, chars)
        b = chars.clamp(min=0)
        nxt = self.counts[b + 1] + self.rank(b, row)
        return torch.where((row == self.sentinel_pos) | (chars < 0), 0, nxt), chars


def _bwt_find(d: _BwtDevice, seqs: torch.Tensor, lengths: torch.Tensor):
    """Backward search of every lane, last base first: L steps."""
    B, L = seqs.shape
    lo = torch.zeros(B, dtype=torch.int64, device=seqs.device)
    hi = torch.full((B,), d.n, dtype=torch.int64, device=seqs.device)
    for i in range(L):
        pos = lengths - 1 - i
        active = (pos >= 0) & (lo < hi)
        b = seqs.gather(1, pos.clamp(min=0)[:, None])[:, 0].to(torch.int64)
        nlo, nhi = d.lf_step(lo, hi, b)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
    return lo, hi


def _bwt_locate(d: _BwtDevice, rows: torch.Tensor) -> torch.Tensor:
    """Walk each row back by LF until a sampled row (or the row whose BWT
    base is the sentinel, i.e. SA == 0); position = sample + steps."""
    cur = rows.clone()
    steps = torch.zeros_like(rows)
    done = (cur % d.sa_rate) == 0
    sent = torch.zeros_like(done)
    it = 0
    while True:
        if it % LOCATE_SYNC_EVERY == 0 and not bool((~done).any()):
            break
        it += 1
        sampled = (cur % d.sa_rate) == 0
        nxt, chars = d.lf_row(cur)
        # BWT base '$' at cur means SA[cur] == 0: the position is steps
        is_sent = ~done & ~sampled & (chars < 0)
        move = ~done & ~sampled & ~is_sent
        cur = torch.where(move, nxt, cur)
        steps = torch.where(move, steps + 1, steps)
        done = done | sampled | is_sent
        sent = sent | is_sent
    return torch.where(sent, steps, d.sa_sample[cur // d.sa_rate] + steps)
