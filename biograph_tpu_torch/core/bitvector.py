"""Succinct rank bitvector, batched (torch).

Counterpart of ``biograph_tpu/core/bitvector.py``.  Layout:

  * ``words`` — 32-bit words, bit i of word w = position 32*w + i
  * ``cum``   — int64, exclusive prefix popcount per word

Representation: ``words`` is ``torch.int32`` holding the word's bits
reinterpreted (the form the rank kernels read); arithmetic widens to int64
and masks with ``& 0xFFFFFFFF``.  torch has no popcount op: ``popcount32``
is the SWAR count on int64 lanes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from biograph_tpu_torch.core.dna import MASK32, i32_to_u32, u32_to_i32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each int64 lane (SWAR), as int64."""
    x = x & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def popcount_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return np.unpackbits(x.view(np.uint8)).reshape(x.shape + (-1,)).sum(
        axis=-1, dtype=np.int64
    )


def low_bits_mask(rem: torch.Tensor) -> torch.Tensor:
    """(1 << rem) - 1 for rem in [0, 31], as int64."""
    return (torch.ones_like(rem) << rem) - 1


def rank_query(words: torch.Tensor, cum: torch.Tensor, i) -> torch.Tensor:
    """Vectorized rank over any index tensor.

    words: int32 [nw] (bit-reinterpreted); cum: int64 [nw]; i: int tensor
    [...] in [0, n].  Returns int64 [...]."""
    i = torch.as_tensor(i, device=words.device).to(torch.int64)
    w = i >> 5
    word = i32_to_u32(words[w])
    return cum[w] + popcount32(word & low_bits_mask(i & 31))


@dataclass
class RankBits:
    """Immutable rank-queryable bitvector."""

    n: int  # number of bits
    words: torch.Tensor  # int32 [n//32 + 1]  (one pad word so rank(n) works)
    cum: torch.Tensor  # int64 [n//32 + 1] exclusive prefix popcounts
    total: int  # total set bits

    @staticmethod
    def from_bools(bits) -> "RankBits":
        bits = torch.as_tensor(bits).to(torch.bool)
        n = bits.shape[0]
        nw = n // 32 + 1
        pad = torch.zeros(nw * 32, dtype=torch.int64, device=bits.device)
        pad[:n] = bits
        shifts = torch.arange(32, device=bits.device)
        words = (pad.reshape(nw, 32) << shifts).sum(dim=1)
        pc = popcount32(words)
        cum = torch.cumsum(pc, 0) - pc
        return RankBits(
            n=n, words=u32_to_i32(words), cum=cum, total=int(pc.sum())
        )

    @staticmethod
    def from_positions(pos, n: int) -> "RankBits":
        pos = torch.as_tensor(pos).to(torch.int64)
        bits = torch.zeros(n, dtype=torch.bool, device=pos.device)
        bits[pos] = True
        return RankBits.from_bools(bits)

    def get(self, i) -> torch.Tensor:
        """Batched bit test."""
        i = torch.as_tensor(i, device=self.words.device).to(torch.int64)
        return ((i32_to_u32(self.words[i >> 5]) >> (i & 31)) & 1).to(torch.bool)

    def rank(self, i) -> torch.Tensor:
        """Batched rank: number of set bits in [0, i).  i may be 0..n."""
        return rank_query(self.words, self.cum, i)

    def ones_positions(self) -> torch.Tensor:
        """Sorted positions of set bits (the select table)."""
        shifts = torch.arange(32, device=self.words.device)
        bits = (i32_to_u32(self.words)[:, None] >> shifts) & 1
        return torch.nonzero(bits.reshape(-1)[: self.n])[:, 0]
