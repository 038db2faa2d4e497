"""Exclusive prefix popcount of the rank bitvector words (kernel K4).

Replaces the TPU kernel ``biograph_tpu/ops/pallas_rank.py``
``rank_cum_pallas`` (``_popcount_cum_kernel``): an in-block Hillis-Steele
scan on a sequential grid with the cross-block offset fixed outside.  On the
GPU blocks run in no order, so ``csrc/rank_cum.cu`` is three launches:
per-block popcount + shared-memory scan writing block totals, a one-block
scan of those totals, and a pass adding the block offsets.  Bound by bytes
(every word read once, every prefix written once); the two extra passes
over the int32 output are what a single-pass look-back scan would remove.

Representation: ``words`` is ``torch.int32`` (bit-reinterpreted 32-bit
words), the result ``torch.int32``; the build widens it to int64.
"""

from __future__ import annotations

import ctypes

import torch

from biograph_tpu_torch.core.bitvector import popcount32
from biograph_tpu_torch.core.dna import i32_to_u32
from biograph_tpu_torch.ops import _build


def rank_cum_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int32 [nw] exclusive prefix popcount."""
    pc = popcount32(i32_to_u32(words))
    return (torch.cumsum(pc, 0) - pc).to(torch.int32)


def rank_cum(words: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix popcount per word: int32 [nw] -> int32 [nw].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("rank_cum: words must be a 1-D int32 tensor")
    if words.device.type == "cpu":
        return rank_cum_plain(words)
    if words.device.type != "cuda" or not words.is_contiguous():
        raise ValueError("rank_cum: words must be a contiguous CUDA tensor")
    nw = words.shape[0]
    if nw == 0:
        return torch.empty(0, dtype=torch.int32, device=words.device)
    block = _build.function("rank_cum", "bgt_rank_cum_block", [])()
    out = torch.empty(nw, dtype=torch.int32, device=words.device)
    totals = torch.empty(
        max(-(-nw // block), 1), dtype=torch.int32, device=words.device
    )
    _build.launch(
        "rank_cum", "bgt_rank_cum",
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong], words.device,
        _build.ptr(words), _build.ptr(out), _build.ptr(totals), nw,
    )
    rank_cum.launches += 1
    return out


rank_cum.launches = 0
