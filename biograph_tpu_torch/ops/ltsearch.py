"""Batched nearest-position-with-value-below queries over the shared array
(torch).

Counterpart of ``biograph_tpu/ops/ltsearch.py``'s ``LtSearch``: the
less-than search behind ``push_front_drop``, ``pop_front_ranges`` and
``truncate_ranges`` (``index/seqset.py``).  Two levels: the values padded
with int32 max to whole blocks of 256, and each block's minimum.  A query
scans its own block, walks the block minima to the first block holding a
value below its threshold, and scans that block; all lanes advance in
lockstep.

Sentinels as in the JAX package: ``next_backward_lt`` answers -1 where no
value before ``pos`` is below ``c``, ``next_forward_lt`` answers ``n`` where
none after it is.  Block scans clip their indices into the padded values as
``jnp.take`` does there (a block past the end reads the last padded value),
so positions ``0..n`` and ``next_forward_lt(-1)`` give the JAX answers.

Plain tensor code on every device.  The block walk is the JAX package's
``lax.while_loop`` on ``any(~done)``, one block a step, where each test of
that condition would be a device-to-host sync here.  So the walk first tests
a window of ``WALK_FIRST`` block minima at once, which ends the walks of a
few blocks (a lane of the wavefront), and then, after one sync, moves the
lanes still walking by a descent over minima of 2^k blocks (``levels``, one
table each way): one step a power of two, some 14 steps at 4 M entries,
whatever the distance.  Both stop each lane at the block the JAX walk stops
at: the first in its direction whose minimum is below its threshold, or -1
or nb past the blocks.  ``LtTree`` (the while-free variant) serves only the
walk engines, which are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BLOCK = 256
WALK_FIRST = 8  # block minima the walk tests before its descent
# lanes a block scan gathers at once: [LANE_CHUNK, BLOCK] int32 rows
LANE_CHUNK = 1 << 16
_INT32_MAX = torch.iinfo(torch.int32).max


@dataclass(frozen=True)
class LtSearch:
    values: torch.Tensor  # int32 [nb * BLOCK], padded with int32 max
    block_min: torch.Tensor  # int32 [nb]
    n: int
    # int32 [2, K + 1, nb], 2^K >= nb: [0, k, b] the minimum of the 2^k
    # blocks from b on, [1] the same over the blocks in reverse order
    levels: torch.Tensor

    @staticmethod
    def build(values: torch.Tensor) -> "LtSearch":
        """The structure over int32 ``values`` (n >= 1), on their device."""
        values = values.to(torch.int32)
        n = values.shape[0]
        if n == 0:
            raise ValueError("LtSearch: no values")
        nb = (n + BLOCK - 1) // BLOCK
        pad = torch.full((nb * BLOCK,), _INT32_MAX, dtype=torch.int32, device=values.device)
        pad[:n] = values
        bmin = pad.view(nb, BLOCK).amin(dim=1)
        return LtSearch(
            values=pad, block_min=bmin, n=n,
            levels=torch.stack([_levels(bmin), _levels(bmin.flip(0))]),
        )

    def next_backward_lt(self, pos, c) -> torch.Tensor:
        """Largest j < pos with values[j] < c; -1 if none.  Batched."""
        pos, c = self._args(pos, c)
        b0 = pos >> 8
        in_block = self._block_scan_back(b0, pos, c)
        found0 = in_block >= 0
        bptr = torch.where(found0, b0, b0 - 1)
        bptr = self._walk(bptr, found0 | (bptr < 0), c, -1)
        in_later = self._block_scan_back(
            bptr.clamp(min=0), torch.full_like(pos, self.values.shape[0]), c
        )
        return torch.where(found0, in_block, torch.where(bptr >= 0, in_later, -1))

    def next_forward_lt(self, pos, c) -> torch.Tensor:
        """Smallest j > pos with values[j] < c; n if none.  Batched."""
        pos, c = self._args(pos, c)
        nb = self.block_min.shape[0]
        b0 = pos >> 8
        in_block = self._block_scan_fwd(b0, pos, c)
        found0 = in_block >= 0
        bptr = torch.where(found0, b0, b0 + 1)
        bptr = self._walk(bptr, found0 | (bptr >= nb), c, 1)
        in_later = self._block_scan_fwd(bptr.clamp(max=nb - 1), torch.full_like(pos, -1), c)
        res = torch.where(found0, in_block, torch.where(bptr < nb, in_later, self.n))
        return torch.where(res < 0, self.n, res)

    # -- internals --

    def _args(self, pos, c):
        dev = self.values.device
        pos = torch.as_tensor(pos, device=dev).to(torch.int64)
        c = torch.as_tensor(c, device=dev).to(torch.int32).expand(pos.shape)
        return pos, c

    def _walk(self, bptr, done, c, step: int) -> torch.Tensor:
        """Move each lane's block pointer by ``step`` (+1 or -1) until its
        block's minimum is below c or the pointer leaves the blocks (-1 or
        nb).  Returns the final pointers; lanes done at the start keep
        theirs."""
        nb = self.block_min.shape[0]
        j = torch.arange(WALK_FIRST, device=bptr.device)
        idx = bptr[:, None] + step * j
        inside = (idx >= 0) & (idx < nb)
        stop = ~inside | (self.block_min[idx.clamp(0, nb - 1)] < c[:, None])
        first = torch.where(stop, j, WALK_FIRST).amin(dim=1)
        bptr = torch.where(done, bptr, bptr + step * first)
        lanes = torch.nonzero(~done & (first == WALK_FIRST))[:, 0]
        if lanes.shape[0]:
            # the descent runs forward: backward walks on the reversed blocks
            p = bptr[lanes] if step > 0 else nb - 1 - bptr[lanes]
            p = _descend(self.levels[0 if step > 0 else 1], p, c[lanes])
            bptr[lanes] = p if step > 0 else nb - 1 - p
        return bptr

    def _rows(self, blk) -> torch.Tensor:
        """int32 [L, BLOCK]: values[min(blk * BLOCK + j, len - 1)] for blk >= 0
        (a block past the end reads the last padded value throughout)."""
        nb = self.block_min.shape[0]
        rows = self.values.view(nb, BLOCK)[blk.clamp(0, nb - 1)]
        past = (blk >= nb)[:, None]
        return torch.where(past, self.values[-1], rows)

    def _scan(self, blk, pos_limit, c, back: bool) -> torch.Tensor:
        out = torch.empty_like(pos_limit)
        j = torch.arange(BLOCK, dtype=torch.int32, device=blk.device)
        size = self.values.shape[0]
        for lo in range(0, blk.shape[0], LANE_CHUNK):
            b = blk[lo : lo + LANE_CHUNK]
            base = b << 8
            lim = (pos_limit[lo : lo + LANE_CHUNK] - base)[:, None]
            ok = self._rows(b) < c[lo : lo + LANE_CHUNK, None]
            if back:
                ok &= j[None, :] < lim
                best = torch.where(ok, j[None, :], -1).amax(dim=1)
                out[lo : lo + LANE_CHUNK] = torch.where(best >= 0, base + best, -1)
            else:
                ok &= (j[None, :] > lim) & (j[None, :] < (size - base)[:, None])
                best = torch.where(ok, j[None, :], BLOCK).amin(dim=1)
                out[lo : lo + LANE_CHUNK] = torch.where(best < BLOCK, base + best, -1)
        return out

    def _block_scan_back(self, blk, pos_limit, c) -> torch.Tensor:
        """Largest j in block blk with j < pos_limit and values[j] < c, else -1."""
        return self._scan(blk, pos_limit, c, back=True)

    def _block_scan_fwd(self, blk, pos_limit, c) -> torch.Tensor:
        """Smallest j in block blk with j > pos_limit and values[j] < c, else -1."""
        return self._scan(blk, pos_limit, c, back=False)


def _levels(bmin: torch.Tensor) -> torch.Tensor:
    """int32 [K + 1, nb], 2^K >= nb: row k holds the minimum of the 2^k
    blocks from each block on (blocks past the end count as int32 max)."""
    rows = [bmin]
    span = 1
    while span < bmin.shape[0]:
        prev = rows[-1]
        nxt = prev.clone()
        nxt[:-span] = torch.minimum(prev[:-span], prev[span:])
        rows.append(nxt)
        span *= 2
    return torch.stack(rows)


def _descend(levels: torch.Tensor, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The first block q >= p (p >= 0) whose minimum is below c, or nb if
    none: from the widest span down, skip each span of 2^k blocks from p
    whose minimum is c or more."""
    nb = levels.shape[1]
    for k in range(levels.shape[0] - 1, -1, -1):
        skip = (p < nb) & (levels[k][p.clamp(max=nb - 1)] >= c)
        p = p + (skip.to(torch.int64) << k)
    return p.clamp(max=nb)
