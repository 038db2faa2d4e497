"""The entry-sharded seqset: the model-parallel axis of the port (torch).

Counterpart of ``biograph_tpu/parallel/sharded_seqset.py``.  At human scale
the seqset's per-entry tables outgrow one card, so the rank structure and
the entry arrays are cut into S shards by entry range and every global query
is answered by each shard's local contribution, summed over the shards: a
rank is the sum of the shards' ranks (0 before a shard, the local rank
inside it, the shard's total after it), an entry-array read is the one
owning shard's value, a nearest-shared-below search the maximum or minimum
of the shards' answers.  A process holds some of the S shards (its *local*
shards, a contiguous run of them); it sums its local shards itself and the
processes' sums meet in one ``torch.distributed.all_reduce`` a query.

Layout (S shards, the word space padded to S ranges of R words, the entry
space to S ranges of Re entries):

  words  int32 [S, 4, R]   the shard's prev[b] words, bits reinterpreted
  cum    int64 [S, 4, R]   exclusive prefix popcounts within the shard
  lo     int64 [S]         the first bit position of each shard
  shared int32 [S, Re]     (pad -1), sizes int32 [S, Re] (pad 0),
  pop_sel int64 [S, Re] (pad 0), elo int64 [S] the first entry of each shard

On the card each local shard's rank structure is one rank-block table
(``ops/rank4.build_rank_blocks``), and a process's tables lie end to end in
one tensor: the rank and rank4 kernels answer every local shard of a query
batch in one launch, at the shard's position clamped into [0, 32 R], where
the table answers 0 before the shard and the shard's total past it.  The
entry sizes go through the gather_sizes kernel, ``cum`` through rank_cum.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import torch
import torch.distributed as dist

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.index.seqset import SeqsetRanges, _WidenFamily
from biograph_tpu_torch.ops import rank4 as rank4_ops
from biograph_tpu_torch.ops.ltsearch import LtSearch
from biograph_tpu_torch.ops.rank_cum import rank_cum

_INT32_MAX = torch.iinfo(torch.int32).max
_NONE_AFTER = 1 << 62  # a shard's "no entry after pos", above every entry id


@dataclass
class ShardedRankArrays:
    """The sharded seqset structure, stacked over shards ``[S', ...]``: all
    S shards, or those named at ``build`` (a process's local shards)."""

    words: torch.Tensor  # int32 [S', 4, R], bits reinterpreted
    cum: torch.Tensor  # int64 [S', 4, R]: exclusive prefix popcounts per shard
    lo: torch.Tensor  # int64 [S']: first bit position of each shard
    fixed: torch.Tensor  # int64 [5] (replicated)
    n_entries: int
    shared: torch.Tensor  # int32 [S', Re] (pad -1 past n_entries)
    sizes: torch.Tensor  # int32 [S', Re] (pad 0)
    pop_sel: torch.Tensor  # int64 [S', Re] (pad 0)
    elo: torch.Tensor  # int64 [S']: first entry id of each shard

    @staticmethod
    def build(seqset, n_shards: int, shards=None, device=None) -> "ShardedRankArrays":
        """The structure of ``seqset`` cut into ``n_shards`` entry ranges.

        shards: the shard indices to keep (default all), in order; only
        they are moved to ``device`` (default the stored words' device).
        ``cum`` is computed there in one rank_cum launch over every kept
        shard's four rows."""
        dev = seqset.prev_words.device if device is None else resolve_device(device)
        sel = torch.arange(n_shards) if shards is None else torch.as_tensor(list(shards), dtype=torch.int64)
        if sel.numel() == 0 or int(sel.min()) < 0 or int(sel.max()) >= n_shards:
            raise ValueError(f"shards {sel.tolist()} outside 0..{n_shards - 1}")
        words = seqset.prev_words
        nw = words.shape[1]
        R = -(-nw // n_shards)
        wpad = words.new_zeros((4, R * n_shards))
        wpad[:, :nw] = words
        shard_words = wpad.view(4, n_shards, R).transpose(0, 1)[sel.to(wpad.device)].to(dev).contiguous()
        cum = rank_cum(shard_words.view(-1, R)).view(shard_words.shape).to(torch.int64)
        n = seqset.n_entries
        Re = -(-n // n_shards)

        def shard_arr(t, pad, dtype):
            out = torch.full((Re * n_shards,), pad, dtype=dtype, device=t.device)
            out[:n] = t
            return out.view(n_shards, Re)[sel.to(t.device)].to(dev)

        return ShardedRankArrays(
            words=shard_words,
            cum=cum,
            lo=(sel * (32 * R)).to(dev),
            fixed=seqset.fixed.to(dev, torch.int64),
            n_entries=n,
            shared=shard_arr(seqset.shared, -1, torch.int32),
            sizes=shard_arr(seqset.entry_sizes, 0, torch.int32),
            pop_sel=shard_arr(seqset.pop_sel, 0, torch.int64),
            elo=(sel * Re).to(dev),
        )


class _ShardLocalDevice(_WidenFamily):
    """A process's local shards as a query engine with the surface of
    ``index/seqset._SeqsetDevice`` that discovery and the widen family use
    (``rank``, ``rank4``, ``sizes_at``, ``push_front``, ``push4``,
    ``trunc_gather``, ``truncate_ranges``, ``push_front_drop``, ``fixed``,
    ``n_entries``, ``device``).  Every answer is global: the local shards'
    contributions, reduced over ``group`` (None: this process holds every
    shard).  It has no ``rank_blocks``, so the probes take their step-by-step
    chains, one collective push a step.

    Every process must make the same calls in the same order with tensors of
    the same shapes; every value a caller branches on is a reduced, so
    replicated, one."""

    def __init__(self, arrays: ShardedRankArrays, group=None):
        S, _, R = arrays.words.shape
        Re = arrays.shared.shape[1]
        elo = arrays.elo.cpu()
        if S > 1 and not bool((elo[1:] - elo[:-1] == Re).all()):
            raise ValueError("a process's shards must be a contiguous run of entry ranges")
        tables = [rank4_ops.build_rank_blocks(arrays.words[s], arrays.cum[s]) for s in range(S)]
        nblk = tables[0].shape[0]
        self.blocks = torch.cat(tables)  # int32 [S * nblk, 4, 8]: the local tables end to end
        self.fixed = arrays.fixed
        self.n_entries = arrays.n_entries
        self.group = group
        self.R, self.Re, self.n_local = R, Re, S
        dev = self.blocks.device
        self._lo = arrays.lo
        self._table_at = torch.arange(S, device=dev) * (nblk * rank4_ops.BLOCK_WORDS * 32)
        self._elo = arrays.elo
        self._entry_at = torch.arange(S, device=dev) * Re
        self.first_entry = int(elo[0])
        self.shared = arrays.shared  # [S, Re]
        self.sizes = arrays.sizes.reshape(-1).contiguous()  # the local shards' sizes end to end

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _reduce(self, t, op=dist.ReduceOp.SUM):
        """The local sum (or extremum) made global: one all_reduce over the
        shard axis's processes."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def nbytes(self) -> int:
        """Device bytes of this process's shards: the rank-block tables,
        ``shared`` and the sizes (the LtSearch that the widen family builds
        not counted)."""
        return sum(t.numel() * t.element_size() for t in (self.blocks, self.shared, self.sizes, self.fixed))

    # -- the local contributions --

    def _local_pos(self, pos):
        """Each local shard's table position of global rank positions:
        int64 [S, *pos.shape], pos clamped into the shard's [0, 32 R]."""
        shape = (self.n_local,) + (1,) * pos.dim()
        rel = (pos[None] - self._lo.view(shape)).clamp(0, 32 * self.R)
        return rel + self._table_at.view(shape)

    def _owned(self, idx):
        """(own [S, ...], the index into each local shard [S, ...]) of
        global entry ids."""
        shape = (self.n_local,) + (1,) * idx.dim()
        rel = idx[None] - self._elo.view(shape)
        return (rel >= 0) & (rel < self.Re), rel.clamp(0, self.Re - 1)

    def _egather(self, table, idx):
        """The local part of table[idx] for a per-entry table sharded as
        ``shared`` ([S, Re]): the owner's value, 0 elsewhere, summed over
        the local shards (int64; not yet reduced)."""
        own, rel = self._owned(idx)
        v = torch.gather(table, 1, rel.reshape(self.n_local, -1)).view(rel.shape)
        return torch.where(own, v, 0).sum(0, dtype=torch.int64)

    # -- collective primitives --

    def rank(self, b, pos) -> torch.Tensor:
        """Global rank of prev[base b] at positions pos (int64), one rank
        launch over every local shard."""
        b, pos = torch.broadcast_tensors(self._t(b, torch.int64), self._t(pos, torch.int64))
        local = self._local_pos(pos)
        part = rank4_ops.rank(self.blocks, b.expand(local.shape).contiguous(), local.contiguous())
        return self._reduce(part.sum(0))

    def _rank_ends(self, b, begin, end):
        """(rank_b(begin), rank_b(end)): one rank launch, one all_reduce."""
        lb, le = self._local_pos(begin), self._local_pos(end)
        bb = b.expand(lb.shape).contiguous()
        rb, re = rank4_ops.rank(self.blocks, bb, lb.contiguous(), le.contiguous())
        both = self._reduce(torch.stack([rb.sum(0), re.sum(0)]))
        return both[0], both[1]

    def rank4(self, pos) -> torch.Tensor:
        """All-four-bases rank at each position: int32 [B, 4], one rank4
        launch over every local shard."""
        pos = self._t(pos, torch.int64)
        local = self._local_pos(pos).reshape(-1).contiguous()
        part = rank4_ops.rank4(self.blocks, local).view(self.n_local, -1, 4)
        return self._reduce(part.sum(0, dtype=torch.int64)).to(torch.int32)

    def sizes_at(self, entry) -> torch.Tensor:
        """entry_sizes[min(entry, n-1)]: the owner's size through one
        gather_sizes launch over the local shards, int32."""
        idx = self._t(entry, torch.int64).clamp(max=self.n_entries - 1)
        own, rel = self._owned(idx)
        shape = (self.n_local,) + (1,) * idx.dim()
        v = rank4_ops.gather_sizes(self.sizes, (rel + self._entry_at.view(shape)).contiguous())
        return self._reduce(torch.where(own, v, 0).sum(0, dtype=torch.int64)).to(torch.int32)

    def trunc_gather(self, prev_lt, next_lt, begin, end):
        """Constant-threshold truncation boundaries from the entry-sharded
        widen tables (``ShardedDiscoveryEngine.trunc_tables``: this
        process's [S, Re] slices): both owner gathers in one all_reduce."""
        n = self.n_entries
        wb, we = self._reduce(torch.stack([
            self._egather(prev_lt, begin.clamp(0, n - 1)),
            self._egather(next_lt, end.clamp(0, n - 1)),
        ]))
        return wb.clamp(min=0), torch.where(end >= n, n, we)

    def push_front(self, r: SeqsetRanges, b) -> SeqsetRanges:
        """Batched push_front (the rules of ``_SeqsetDevice.push_front``)."""
        b = self._t(b, torch.int64).expand(r.begin.shape)
        fixed_b = self.fixed[b]
        rb, re = self._rank_ends(b, r.begin, r.end)
        nb = fixed_b + rb
        ne = fixed_b + re
        new_size = r.size + 1
        kick = (nb < ne) & (self.sizes_at(nb) < new_size)
        nb = nb + kick.to(nb.dtype)
        was_valid = r.begin < r.end
        return SeqsetRanges(
            begin=torch.where(was_valid, nb, r.begin),
            end=torch.where(was_valid, ne, r.begin),
            size=torch.where(was_valid, new_size, r.size),
        )

    def push4(self, r: SeqsetRanges):
        """Children of each range for all four pushed bases: (begin4,
        end4) int64 [B, 4] (the rules of ``ops/rank4.push4_plain``).  One
        rank4 launch at both range ends, then the owner gather of the
        children's first entry sizes: the kick needs the reduced ranks."""
        B = r.begin.shape[0]
        r4 = self.rank4(torch.cat([r.begin, r.end])).to(torch.int64)
        nb = self.fixed[None, :4] + r4[:B]
        ne = self.fixed[None, :4] + r4[B:]
        kick = (nb < ne) & (self.sizes_at(nb) < (r.size + 1)[:, None])
        nb = nb + kick.to(nb.dtype)
        was_valid = (r.begin < r.end)[:, None]
        return (
            torch.where(was_valid, nb, r.begin[:, None]),
            torch.where(was_valid, ne, r.begin[:, None]),
        )

    # -- the widen family's reads (``_WidenFamily``) --

    @cached_property
    def shared_lt(self) -> LtSearch:
        """LtSearch over the local shards' ``shared`` end to end, the pads
        past the last entry never below a threshold: built by the first
        widen query."""
        entry = self.first_entry + torch.arange(self.shared.numel(), device=self.device)
        return LtSearch.build(torch.where(entry < self.n_entries, self.shared.reshape(-1), _INT32_MAX))

    def _lt_back(self, pos, c):
        """Largest j < pos with shared[j] < c, -1 if none: the local
        search's answer, then the maximum over the processes."""
        span = self.shared.numel()
        j = self.shared_lt.next_backward_lt((pos - self.first_entry).clamp(0, span), c)
        return self._reduce(torch.where(j >= 0, j + self.first_entry, -1), dist.ReduceOp.MAX)

    def _lt_fwd(self, pos, c):
        """Smallest j > pos with shared[j] < c, n if none: the local
        search's answer, then the minimum over the processes."""
        span = self.shared.numel()
        j = self.shared_lt.next_forward_lt((pos - self.first_entry).clamp(-1, span - 1), c)
        found = torch.where(j < span, j + self.first_entry, _NONE_AFTER)
        return self._reduce(found, dist.ReduceOp.MIN).clamp(max=self.n_entries)

    def _shared_at(self, idx):
        return self._reduce(self._egather(self.shared, idx)).to(torch.int32)

    def _size_at(self, idx):
        return self.sizes_at(idx)


def make_sharded_rank(arrays: ShardedRankArrays, group=None):
    """The collective rank over a process's shards: rank(b, pos) -> int64,
    global (``group``: the shard axis's processes, None when this process
    holds every shard)."""
    return _ShardLocalDevice(arrays, group).rank


def sharded_entry_push_front(rank_fn, arrays: ShardedRankArrays, entries, b):
    """Global entry_push_front through the collective rank."""
    b = torch.as_tensor(b, device=arrays.fixed.device).to(torch.int64)
    entries = torch.as_tensor(entries, device=arrays.fixed.device).to(torch.int64)
    return arrays.fixed[b] + rank_fn(b, entries)


def make_sharded_seqset_ops(arrays: ShardedRankArrays, group=None):
    """The collective seqset ops over a process's shards, each (begin, end,
    size, q) -> (begin, end, size) with the lane state replicated:
    ``push_front`` (q the pushed bases), ``push_front_drop`` (q the pushed
    bases) and ``truncate`` (q the new sizes)."""
    d = _ShardLocalDevice(arrays, group)

    def op(fn):
        return lambda begin, end, size, q: tuple(fn(SeqsetRanges(begin, end, size), q))

    return dict(
        push_front=op(d.push_front),
        push_front_drop=op(d.push_front_drop),
        truncate=op(d.truncate_ranges),
    )

