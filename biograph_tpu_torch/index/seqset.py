"""The seqset: a BWT-like suffix-ordered read store, queried in batch (torch).

Counterpart of ``biograph_tpu/index/seqset.py``.  Semantics:

  * The *closure set* C = every suffix of every read and reverse complement.
  * *Entries* = the prefix-maximal elements of C, sorted in prefix-first
    lexicographic order (no entry is a prefix of another).
  * ``prev[b][i] = 1`` iff i is the first entry whose prefix P satisfies
    "b+P is an entry".  Rank/select over prev[b] is the LF mapping:
      - push_front(range [s,e) of seq S, base b) =
          fixed[b] + [rank_b(s), rank_b(e))
      - pop_front(entry e starting with b) = select_b(e - fixed[b]), stored
        directly as ``pop_sel``.
  * ``entry_sizes[i]`` — length of entry i; ``shared[i]`` — LCP with entry
    i-1.

Everything queryable is a flat tensor on one device; all query methods are
batched.  The engine (``Seqset.d``) holds the rank structure in one form, the
rank-block table of ``ops/rank4.py`` (one 32-byte sector a rank), built once
from the stored pair and never saved.  ``rank4`` (the rank4 kernel),
``push4`` (the push4 kernel: rank4 at both range ends and the kick's size
gather in one launch), ``rank``, ``push_front``, ``find`` and
``find_existing`` (the rank kernel, both ends of a range in one launch),
``sizes_at`` (gather_sizes) and the find-window chains of
``index/probes.py`` (chain_window) all read that table when the tensors are
on the card, whatever the batch size and whatever the seqset's size; the
remaining primitives are plain tensor code.  The widen family
(``truncate_ranges``, ``pop_front_ranges``, ``push_front_drop``) answers its
nearest-shared-below queries through ``ops/ltsearch.py``'s ``LtSearch``
over ``shared``, built on the engine's device by the first query that reads
it; ``push_front_drop`` ranks both ends of its ranges in one launch of the
rank kernel.

Representation: ``prev_words`` is ``torch.int32`` [4, nw] holding the 32-bit
words bit-reinterpreted; ``save`` writes them as ``uint32`` so the artifact
is byte-compatible with the JAX package's.  ``prev_words`` and ``prev_cum``
are kept for ``save`` and for building tables; after ``load`` they stay on
the host.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import container, dna
from biograph_tpu_torch.ops import rank4 as rank4_ops
from biograph_tpu_torch.ops.ltsearch import LtSearch


class SeqsetRanges(NamedTuple):
    """A batch of seqset ranges."""

    begin: torch.Tensor  # int64 [B]
    end: torch.Tensor  # int64 [B]
    size: torch.Tensor  # int32 [B] — length of the represented sequence

    @property
    def valid(self):
        return self.begin < self.end


_TENSOR_FIELDS = (
    "fixed", "prev_words", "prev_cum", "entry_sizes", "shared", "pop_sel"
)


@dataclass
class Seqset:
    n_entries: int
    max_entry_len: int
    fixed: torch.Tensor  # int64 [5]
    prev_words: torch.Tensor  # int32 [4, nw] — bit i of prev[b], reinterpreted
    prev_cum: torch.Tensor  # int64 [4, nw] — exclusive prefix popcounts
    entry_sizes: torch.Tensor  # int32 [n]
    shared: torch.Tensor  # int32 [n]
    pop_sel: torch.Tensor  # int64 [n] — select table == pop_front cache
    uuid: str = ""

    @property
    def device(self) -> torch.device:
        """Where the queries run: the device of every tensor but, after
        ``load``, the stored rank pair, which then stays on the host."""
        return self.entry_sizes.device

    def to(self, device="cuda") -> "Seqset":
        """A seqset with every tensor on ``device``."""
        dev = resolve_device(device)
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        for name in _TENSOR_FIELDS:
            kw[name] = kw[name].to(dev)
        return Seqset(**kw)

    @cached_property
    def d(self) -> "_SeqsetDevice":
        """The batched query engine over this seqset, on ``self.device``
        (entry points put it on CUDA by default).  It reads the rank
        structure only through the rank-block table, built here, once, from
        the stored pair where that lies, and then moved to the device."""
        blocks = rank4_ops.build_rank_blocks(
            self.prev_words.contiguous(), self.prev_cum.contiguous()
        )
        return _SeqsetDevice(
            fixed=self.fixed,
            rank_blocks=blocks.to(self.device),
            entry_sizes=self.entry_sizes.contiguous(),
            shared=self.shared,
            pop_sel=self.pop_sel,
            n_entries=self.n_entries,
        )

    # ---------------- convenience (small queries) -------------

    def size(self) -> int:
        return self.n_entries

    @property
    def read_len(self) -> int:
        return self.max_entry_len

    def ctx_begin(self) -> SeqsetRanges:
        """The range of the empty sequence: every entry."""
        dev = self.device
        return SeqsetRanges(
            begin=torch.zeros(1, dtype=torch.int64, device=dev),
            end=torch.full((1,), self.n_entries, dtype=torch.int64, device=dev),
            size=torch.zeros(1, dtype=torch.int32, device=dev),
        )

    def find_str(self, seq: str):
        """Find a single sequence; returns (begin, end, size) ints."""
        codes = torch.from_numpy(dna.seq_to_codes(seq)[None, :].copy())
        r = self.d.find(
            codes.to(self.device),
            torch.tensor([len(seq)], dtype=torch.int32, device=self.device),
        )
        return int(r.begin[0]), int(r.end[0]), int(r.size[0])

    def entry_sequence(self, entry: int, length: int | None = None) -> str:
        n = int(self.entry_sizes[entry]) if length is None else length
        ids = torch.tensor([entry], dtype=torch.int64, device=self.device)
        return dna.codes_to_seq(self.d.sequences(ids, n)[0, :n])

    # ---------------- persistence ----------------

    def save(self, path: str):
        def host(t, dtype):
            return t.cpu().numpy().astype(dtype, copy=False)

        with container.ArtifactWriter(path, "seqset") as w:
            w.set_scalar("n_entries", self.n_entries)
            w.set_scalar("max_entry_len", self.max_entry_len)
            w.add_array("fixed", host(self.fixed, np.int64))
            w.add_array(
                "prev_words", host(self.prev_words, np.int32).view(np.uint32)
            )
            w.add_array("prev_cum", host(self.prev_cum, np.int64))
            w.add_array("entry_sizes", host(self.entry_sizes, np.int32))
            w.add_array("shared", host(self.shared, np.int32))
            w.add_array("pop_sel", host(self.pop_sel, np.int64))
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str, device="cuda") -> "Seqset":
        """The saved seqset with its queryable tensors on ``device``.  The
        stored rank pair (``prev_words``, ``prev_cum``) stays on the host: no
        query reads it, ``save`` writes it, and ``d`` builds the rank-block
        table from it."""
        dev = resolve_device(device)
        r = container.ArtifactReader(path, "seqset", mmap=False)
        from biograph_tpu_torch.convert import seqset_from_numpy

        arrays = {name: r.array(name) for name in _TENSOR_FIELDS}
        arrays["n_entries"] = r.scalar("n_entries")
        arrays["max_entry_len"] = r.scalar("max_entry_len")
        ss = seqset_from_numpy(arrays, "cpu")
        for name in _TENSOR_FIELDS:
            if name not in ("prev_words", "prev_cum"):
                setattr(ss, name, getattr(ss, name).to(dev))
        ss.uuid = r.uuid
        return ss


@dataclass(frozen=True)
class _SeqsetDevice:
    """Batched query engine over the seqset's tensors.  The rank structure
    is here in one form only, the rank-block table."""

    fixed: torch.Tensor
    rank_blocks: torch.Tensor  # int32 [nblk, 4, 8] (``build_rank_blocks``)
    entry_sizes: torch.Tensor
    shared: torch.Tensor
    pop_sel: torch.Tensor
    n_entries: int

    @property
    def device(self) -> torch.device:
        return self.entry_sizes.device

    @cached_property
    def shared_lt(self) -> LtSearch:
        """LtSearch over ``shared``, built here by the first query that
        needs it (the widen family, the wavefront without trunc tables)."""
        return LtSearch.build(self.shared)

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- primitive ops (all batched) --

    def rank(self, b, pos) -> torch.Tensor:
        """rank of prev[base b] at positions pos; b and pos same shape.
        Through the rank kernel on the card."""
        return rank4_ops.rank(
            self.rank_blocks,
            self._t(b, torch.int64).contiguous(),
            self._t(pos, torch.int64).contiguous(),
        )

    def entry_has_front(self, entry, b) -> torch.Tensor:
        return rank4_ops.has_bit_blocks(
            self.rank_blocks, self._t(b, torch.int64), self._t(entry, torch.int64)
        )

    def entry_push_front(self, entry, b) -> torch.Tensor:
        b = self._t(b, torch.int64)
        return self.fixed[b] + self.rank(b, entry)

    def entry_first_base(self, entry) -> torch.Tensor:
        entry = self._t(entry)
        ge = [(entry >= self.fixed[i]).to(torch.int32) for i in (1, 2, 3)]
        return ge[0] + ge[1] + ge[2]

    def entry_pop_front(self, entry) -> torch.Tensor:
        """Batched pop via the select table (== pop_front cache)."""
        return self.pop_sel[self._t(entry, torch.int64)]

    def push_front(self, r: SeqsetRanges, b) -> SeqsetRanges:
        """Batched push_front.  Lanes with invalid input ranges come back
        as (begin, begin, size).  Both range ends are ranked in one launch
        of the rank kernel on the card."""
        return SeqsetRanges(
            *rank4_ops.push_front_over(
                self._rank_ends, self.entry_sizes, self.fixed, r.begin, r.end, r.size,
                self._t(b, torch.int64),
            )
        )

    def sizes_at(self, entry) -> torch.Tensor:
        """entry_sizes[min(entry, n-1)], exact, through the gather_sizes
        kernel on the card."""
        idx = self._t(entry, torch.int64).clamp(max=self.n_entries - 1)
        return rank4_ops.gather_sizes(self.entry_sizes, idx.contiguous())

    def rank4(self, pos) -> torch.Tensor:
        """All-4-bases rank at each position: int32 [B, 4], through the
        rank4 kernel on the card."""
        pos = self._t(pos, torch.int64).contiguous()
        return rank4_ops.rank4(self.rank_blocks, pos)

    def push4(self, r: SeqsetRanges):
        """Children of each range for ALL four pushed bases at once.

        Returns (begin4, end4) int64 [B, 4] indexed by the pushed base —
        column b equals push_front(r, b).(begin, end).  One launch of the
        push4 kernel on the card: both range ends ranked for the four bases
        and the kick's size gather, fused."""
        return rank4_ops.push4(
            self.rank_blocks, self.entry_sizes, self.fixed,
            r.begin.contiguous(), r.end.contiguous(), r.size.contiguous(),
        )

    def trunc_gather(self, prev_lt, next_lt, begin, end):
        """Constant-threshold truncation boundaries via the caller-built
        widen tables (``variants/discover._trunc_tables``): prev_lt and
        next_lt are per-entry tensors; returns (new_begin, new_end) for each
        lane."""
        n_e = self.n_entries
        wb = prev_lt[begin.clamp(0, n_e - 1)].clamp(min=0)
        we = torch.where(end >= n_e, n_e, next_lt[end.clamp(0, n_e - 1)])
        return wb, we

    def find(self, codes, lengths) -> SeqsetRanges:
        """Batched backward search.

        codes: [B, L] uint8 padded; lengths: [B].  Pushes bases from last to
        first; short lanes start later so all lanes finish together."""
        codes = self._t(codes)
        B, L = codes.shape
        lengths = self._t(lengths, torch.int32)
        begin = torch.zeros(B, dtype=torch.int64, device=self.device)
        end = torch.full((B,), self.n_entries, dtype=torch.int64, device=self.device)
        size = torch.zeros(B, dtype=torch.int32, device=self.device)
        for i in range(L):
            pos = lengths - 1 - i
            active = (pos >= 0) & (begin < end)
            bidx = torch.gather(
                codes, 1, pos.clamp(min=0).to(torch.int64)[:, None]
            )[:, 0]
            r2 = self.push_front(SeqsetRanges(begin, end, size), bidx)
            begin = torch.where(active, r2.begin, begin)
            end = torch.where(active, r2.end, end)
            size = torch.where(active, r2.size, size)
        return SeqsetRanges(begin=begin, end=end, size=size)

    def find_existing(self, codes, lengths) -> torch.Tensor:
        """Entry ids for sequences known to exist (undefined otherwise)."""
        codes = self._t(codes)
        B, L = codes.shape
        lengths = self._t(lengths, torch.int32)
        entry = torch.zeros(B, dtype=torch.int64, device=self.device)
        for i in range(L):
            pos = lengths - 1 - i
            bidx = torch.gather(
                codes, 1, pos.clamp(min=0).to(torch.int64)[:, None]
            )[:, 0]
            entry = torch.where(
                pos >= 0, self.entry_push_front(entry, bidx), entry
            )
        return entry

    def sequences(self, entries, max_len: int) -> torch.Tensor:
        """The first max_len bases of each entry id via pop chains: uint8
        [B, max_len]."""
        cur = self._t(entries, torch.int64)
        out = torch.zeros(
            (cur.shape[0], max_len), dtype=torch.uint8, device=self.device
        )
        for i in range(max_len):
            out[:, i] = self.entry_first_base(cur).to(torch.uint8)
            cur = self.entry_pop_front(cur)
        return out

    # -- the widen family: nearest-shared-below searches (LtSearch) --

    def _widen(self, begin, end, size):
        """Expand [begin, end) to the maximal run where shared >= size: the
        largest j <= begin and the smallest j >= end with shared[j] < size
        (n if none)."""
        lt = self.shared_lt
        nb = lt.next_backward_lt(begin + 1, size).clamp(min=0)
        ne = lt.next_forward_lt(end - 1, size)
        return nb, ne

    def truncate_ranges(self, r: SeqsetRanges, new_size) -> SeqsetRanges:
        """Shorten each lane's sequence to new_size bases, widening the range
        to every entry sharing that prefix.  Lanes already <= new_size pass
        through unchanged."""
        new_size = self._t(new_size, torch.int32).expand(r.size.shape)
        need = r.size > new_size
        tgt = torch.where(need, new_size, r.size)
        nb, ne = self._widen(r.begin, r.end, tgt.clamp(min=1))
        return SeqsetRanges(
            begin=torch.where(need, nb, r.begin),
            end=torch.where(need, ne, r.end),
            size=tgt,
        )

    def pop_front_ranges(self, r: SeqsetRanges) -> SeqsetRanges:
        """Drop the first base of each lane's sequence and widen to all
        entries sharing the rest.  Popping to the empty sequence gives every
        entry.  The pop reads ``pop_sel`` at the range's first entry, clipped
        to the last entry (an empty range at the end has no first entry)."""
        new_size = r.size - 1
        popped = self.entry_pop_front(r.begin.clamp(max=self.n_entries - 1))
        nb, ne = self._widen(popped, popped + 1, new_size.clamp(min=1))
        empty = new_size <= 0
        return SeqsetRanges(
            begin=torch.where(empty, 0, nb),
            end=torch.where(empty, self.n_entries, ne),
            size=new_size.clamp(min=0),
        )

    def push_front_drop(self, r: SeqsetRanges, b, min_ctx=0) -> SeqsetRanges:
        """Push base b onto each lane's sequence; where the result would be
        empty (or a lone too-short entry), drop context, widening the range
        to a shorter shared suffix through nearest-shared-below searches,
        until the push succeeds.  Lanes whose context would fall below
        ``min_ctx`` come back invalid, as (0, 0, 0)."""
        b = self._t(b, torch.int64).contiguous()
        n = self.n_entries
        fixed_b = self.fixed[b]
        # updated in place below: copies, never the caller's tensors
        o_begin, o_end = r.begin.clone(), r.end.clone()
        o_ctx = r.size.to(torch.int32, copy=True)
        min_ctx = self._t(min_ctx, torch.int32).expand(b.shape)
        sub_b, sub_e = self._rank_ends(b, o_begin, o_end)
        dead = (o_ctx < min_ctx) | (o_begin >= o_end)

        def need_drop(fixed_b, sub_b, sub_e, o_ctx):
            first = (fixed_b + sub_b).clamp(0, n - 1)
            lone_short = (sub_b + 1 == sub_e) & (self.entry_sizes[first] < o_ctx + 1)
            return (sub_b == sub_e) | lone_short

        done = dead | ~need_drop(fixed_b, sub_b, sub_e, o_ctx)
        # one iteration drops context once on the lanes not yet done (a done
        # lane is frozen, so the rest need not be computed); the loop ends
        # when every lane is done
        while True:
            act = torch.nonzero(~done)[:, 0]
            if act.shape[0] == 0:
                break
            fb, bb, ob, oe, oc, sb, se = (
                x[act] for x in (fixed_b, b, o_begin, o_end, o_ctx, sub_b, sub_e)
            )
            first = (fb + sb).clamp(0, n - 1)
            sh_b = self.shared[ob.clamp(0, n - 1)]
            sh_e = self.shared[oe.clamp(0, n - 1)]
            drop = torch.maximum(sh_b, torch.where(oe >= n, 0, sh_e)).to(torch.int32)
            drop = torch.where(sb != se, torch.maximum(drop, self.entry_sizes[first] - 1), drop)
            upd_b = (ob > 0) & (sh_b >= drop)
            upd_e = (oe < n) & (sh_e >= drop)
            nb = self.shared_lt.next_backward_lt(torch.where(upd_b, ob, 1), drop).clamp(min=0)
            ne = self.shared_lt.next_forward_lt(torch.where(upd_e, oe, n - 1), drop)
            newly_dead = (drop < min_ctx[act]) | ~(upd_b | upd_e | (drop != oc))
            ob2 = torch.where(upd_b, nb, ob)
            oe2 = torch.where(upd_e, ne, oe)
            rb, re = self._rank_ends(bb, ob2, oe2)
            sb2 = torch.where(upd_b, rb, sb)
            se2 = torch.where(upd_e, re, se)
            still = need_drop(fb, sb2, se2, drop)
            dead[act] = newly_dead
            done[act] = newly_dead | ~still
            keep = ~newly_dead
            o_begin[act] = torch.where(keep, ob2, ob)
            o_end[act] = torch.where(keep, oe2, oe)
            o_ctx[act] = torch.where(keep, drop, oc)
            sub_b[act] = torch.where(keep, sb2, sb)
            sub_e[act] = torch.where(keep, se2, se)
        new_begin = fixed_b + sub_b
        new_end = fixed_b + sub_e
        kick = (new_begin < new_end) & (self.entry_sizes[new_begin.clamp(0, n - 1)] < o_ctx + 1)
        new_begin = new_begin + kick.to(new_begin.dtype)
        return SeqsetRanges(
            begin=torch.where(dead, 0, new_begin),
            end=torch.where(dead, 0, new_end),
            size=torch.where(dead, 0, o_ctx + 1),
        )

    def _rank_ends(self, b, begin, end):
        """(rank_b(begin), rank_b(end)) in one launch of the rank kernel on
        the card."""
        return rank4_ops.rank(
            self.rank_blocks, b.contiguous(), begin.contiguous(), end.contiguous()
        )
