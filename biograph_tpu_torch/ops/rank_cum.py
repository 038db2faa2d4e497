"""Exclusive prefix popcount of the rank bitvector words (kernel K4).

Replaces the TPU kernel ``biograph_tpu/ops/pallas_rank.py``
``rank_cum_pallas`` (``_popcount_cum_kernel``): an in-block Hillis-Steele
scan on a sequential grid with the cross-block offset fixed outside.  On the
GPU blocks run in no order, so ``csrc/rank_cum.cu`` is a single-pass scan
with decoupled look-back: a block takes a tile of ``TILE_WORDS`` words in the
order blocks start, scans it in registers, publishes its total, and adds up
its predecessors' totals until it meets a finished prefix.  One launch scans
every row of a ``[R, nw]`` input, each row on its own; the build hands it the
four base rows at once.  At a seqset's size the work is bound by launches,
past that by bytes (every word read once, every prefix written once).

Representation: ``words`` is ``torch.int32`` (bit-reinterpreted 32-bit
words), the result ``torch.int32``; the build widens it to int64.
"""

from __future__ import annotations

import ctypes

import torch

from biograph_tpu_torch.core.bitvector import popcount32
from biograph_tpu_torch.core.dna import i32_to_u32
from biograph_tpu_torch.ops import _build

TILE_WORDS = 4096  # words of one row a block of the kernel scans


def rank_cum_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the exclusive prefix popcount along the last
    dimension, int32 of the input's shape."""
    pc = popcount32(i32_to_u32(words))
    return (torch.cumsum(pc, -1) - pc).to(torch.int32)


def tiles_per_row(nw: int) -> int:
    """Blocks the kernel gives a row of nw words.  A row's tiles are laid
    over the 16-byte groups of memory it touches, and its first group may
    start up to three words before the row."""
    return -(-(nw + 3) // TILE_WORDS)


@_build.traced("rank_cum", 0)
def rank_cum(words: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix popcount per word, along the last dimension: int32
    [nw] or [R, nw] -> int32 of the same shape, every row scanned on its
    own, all in one launch.  Counts must stay below 2^31.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if words.dtype != torch.int32 or words.dim() not in (1, 2):
        raise TypeError("rank_cum: words must be a 1-D or 2-D int32 tensor")
    if words.device.type == "cpu":
        return rank_cum_plain(words)
    if words.device.type != "cuda" or not words.is_contiguous():
        raise ValueError("rank_cum: words must be a contiguous CUDA tensor")
    out = torch.empty_like(words)
    if words.numel() == 0:
        return out
    _build.check_constants("rank_cum", (("bgt_rank_cum_tile_words", TILE_WORDS),))
    nw = words.shape[-1]
    rows = words.numel() // nw
    tiles = tiles_per_row(nw)
    # the ticket counter and one 64-bit descriptor a tile; the call zeroes it
    scratch = torch.empty(1 + rows * tiles, dtype=torch.int64, device=words.device)
    _build.launch(
        "rank_cum", "bgt_rank_cum",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3, words.device,
        _build.ptr(words), _build.ptr(out), _build.ptr(scratch), rows, nw, tiles,
    )
    rank_cum.launches += 1
    return out


rank_cum.launches = 0
