"""Seqset construction as device-wide sorting (torch).

Counterpart of ``biograph_tpu/build/seqset_build.py``:

  1. reads + reverse complements -> all suffixes, 2-bit packed [N, W] words
  2. one prefix-first lexicographic sort (``ops/sortutil.py``)
  3. dedup + prefix-maximality filter  -> entries
  4. sizes, shared (vectorized LCP), fixed (first-base offsets)
  5. prev[b] bitvectors + select table by a batched lower bound of every
     entry's pop against the entry list (one more merged sort); the
     exclusive popcount prefix ``prev_cum`` comes from the ``rank_cum``
     kernel, once per base row.

A read set whose sort would not fit the caller's memory budget takes the
prefix-partitioned multi-pass build (the reference's part_repo 4^d buckets,
modules/build_seqset/part_repo.h:9, over device passes instead of files):
the reads stay on the host and go to the device a chunk at a time, once to
count the suffixes of each partition of their first d bases and once for
every pass, a run of partitions whose rows fit the budget.  Passes run from
the last; each keeps its sorted rows on the device, and its last row is
held against the next pass's first for prefix-maximality.  The result is
bit-identical to the one-shot build.  ``build_plan`` is the one place that
decides, from the port's own bytes a suffix row.

Representation: suffix and entry words are int64 tensors holding 32-bit
values; ``prev_words`` is stored bit-reinterpreted as int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.index.seqset import Seqset
from biograph_tpu_torch.ops import sortutil
from biograph_tpu_torch.ops.rank_cum import rank_cum

# Device bytes the plan counts for one suffix row of W words: a row is W
# int64 words and an int32 length, and the plan counts SORT_ROW_COPIES of it
# (the rows, their sorted copy, the radix passes' packed keys and
# permutations, torch.sort's buffers).  ``chip_smoke.py`` fails if the
# in-memory build's own peak on the card exceeds the count; an H100
# measured 170 B a row at W = 7, under the 240 counted (PERF.md).
SORT_ROW_COPIES = 4
# Device bytes a base of a read chunk costs while its suffixes are made
# (``_chunk_heads`` and ``_suffix_words_range``: the codes and their
# reverse complement, the int64 word heads at every offset and the
# temporaries of building them, two orientations' heads at once), per
# base of L + 16 W.
CHUNK_BYTES_PER_BASE = 64
CHUNK_SHARE = 8  # the read chunk takes at most 1/CHUNK_SHARE of a budget
MIN_PASS_ROWS = 1 << 8
MIN_CHUNK_ROWS = 128
MAX_DEPTH = 12  # 4^12 partitions at most


def suffix_row_bytes(W: int) -> int:
    return SORT_ROW_COPIES * (8 * W + 4)


def chunk_read_bytes(L: int, W: int) -> int:
    return CHUNK_BYTES_PER_BASE * (L + 16 * W)


@dataclass(frozen=True)
class BuildPlan:
    """How a read set's suffixes are sorted: in memory, or in passes of at
    most ``per_pass_rows`` rows over partitions by their first ``d`` bases,
    the reads streamed ``chunk_rows`` at a time."""

    rows: int
    row_bytes: int
    in_memory: bool
    d: int = 0
    per_pass_rows: int = 0
    chunk_rows: int = 0

    @property
    def sort_bytes(self) -> int:
        return self.rows * self.row_bytes


def build_plan(rows: int, W: int, L: int, budget_bytes: int | None) -> BuildPlan:
    """The build's plan for ``rows`` suffix rows of W words from reads of
    at most L bases under ``budget_bytes`` (None: no budget)."""
    row_bytes = suffix_row_bytes(W)
    if budget_bytes is None or rows * row_bytes <= budget_bytes:
        return BuildPlan(rows, row_bytes, True)
    read_bytes = chunk_read_bytes(L, W)
    chunk_rows = max(budget_bytes // CHUNK_SHARE // read_bytes, MIN_CHUNK_ROWS)
    per_pass_rows = max((budget_bytes - chunk_rows * read_bytes) // row_bytes, MIN_PASS_ROWS)
    d = 1
    while rows / 4**d > per_pass_rows / 4 and d < MAX_DEPTH:
        d += 1
    return BuildPlan(rows, row_bytes, False, d, int(per_pass_rows), int(chunk_rows))


def pass_ranges(counts: np.ndarray, per_pass_rows: int) -> list:
    """Contiguous partition ranges [lo, hi) whose rows fit a pass (a
    partition larger than a pass gets one of its own); the last ends at
    ``len(counts)``.  Empty partitions cannot move a boundary's rows, so
    only the others are visited."""
    ranges = []
    lo = acc = 0
    for p in np.nonzero(counts)[0].tolist():
        c = int(counts[p])
        if acc and acc + c > per_pass_rows:
            ranges.append((lo, p))
            lo, acc = p, 0
        acc += c
    ranges.append((lo, len(counts)))
    return ranges


def build_seqset(
    codes,
    lengths,
    include_rc: bool = True,
    budget=None,
    device="cuda",
) -> Seqset:
    """Build a seqset from a padded read matrix.

    codes: uint8 [R, L] zero-padded (numpy array, memmap or tensor);
    lengths: [R].  Every tensor of the result lies on ``device``.

    ``budget`` (a ``runtime.resources.MemoryBudget`` or a raw byte count)
    bounds the device-resident suffix sort: when ``build_plan`` says the
    sort would exceed it, the reads stay where they are and the build takes
    the prefix-partitioned passes, with the identical result.  The plan is
    kept as ``seqset.build_info``.
    """
    dev = resolve_device(device)
    R, L = codes.shape
    total = int(lengths.sum()) if R else 0
    if R == 0 or int(lengths.max()) == 0:
        raise ValueError(
            "build_seqset: no nonempty reads (all reads dropped by "
            "correction/filters?)"
        )
    W = dna.words_for_bases(L)
    plan = build_plan(total * (2 if include_rc else 1), W, L, getattr(budget, "bytes", budget))
    if not plan.in_memory:
        ew, el, passes = _entries_partitioned(codes, lengths, W, plan, include_rc, dev)
        ss = seqset_from_entries(ew, el)
        ss.__dict__["build_info"] = {"plan": plan, "passes": passes}
        return ss

    codes_dev = _on(codes, torch.uint8, dev)
    lens_dev = _on(lengths, torch.int32, dev)
    if include_rc:
        seqs = torch.cat(
            [codes_dev, dna.revcomp_codes(codes_dev, lens_dev)], dim=0
        )
        seq_lens = torch.cat([lens_dev, lens_dev])
    else:
        seqs, seq_lens = codes_dev, lens_dev

    words, wlens = _suffix_words(seqs, seq_lens, W)
    del seqs
    ew, el = _entries_from_suffixes(words, wlens)
    del words, wlens
    ss = seqset_from_entries(ew, el)
    ss.__dict__["build_info"] = {"plan": plan, "passes": 1}
    return ss


def _on(x, dtype, dev) -> torch.Tensor:
    """A host array (numpy, memmap) or tensor as a tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:  # a read-only memmap: torch wants its own copy
        x = x.copy()
    return torch.from_numpy(x).to(device=dev, dtype=dtype)


def _chunk_heads(codes, lengths, W: int, include_rc: bool, chunk_rows: int, dev):
    """Stream host reads to the device ``chunk_rows`` at a time; yields
    (word heads [S, L + 16 (W - 1)], lengths [S]) for each chunk and, made
    on the device, for its reverse complements."""
    R, L = codes.shape
    cols = torch.arange(L, device=dev)
    for r0 in range(0, R, chunk_rows):
        r1 = min(R, r0 + chunk_rows)
        ln = _on(lengths[r0:r1], torch.int32, dev)
        c = torch.where(cols[None, :] < ln[:, None], _on(codes[r0:r1], torch.uint8, dev), 0)
        yield _suffix_heads(c, W), ln
        if include_rc:
            yield _suffix_heads(dna.revcomp_codes(c, ln), W), ln


def _suffix_heads(seqs: torch.Tensor, W: int) -> torch.Tensor:
    """heads[:, p] = the 16 bases from p as one 32-bit word (zero past the
    row), so the suffix at offset j packs as heads[:, j + 16 w], w < W."""
    S, L = seqs.shape
    width = L + 16 * (W - 1)
    padded = torch.nn.functional.pad(seqs, (0, 16 * W))
    heads = torch.zeros((S, width), dtype=torch.int64, device=seqs.device)
    for i in range(16):
        heads |= padded[:, i : i + width].to(torch.int64) << (2 * (15 - i))
    return heads


def _partition_values(heads: torch.Tensor, lens: torch.Tensor, L: int, d: int):
    """Partition value (first d bases, zero-padded) of every suffix and
    whether the suffix is nonempty, [S, L] each.  A suffix shorter than d
    pads with code 0, which places it exactly before every longer string it
    prefixes (prefix-first order is kept)."""
    vals = heads[:, :L] >> (32 - 2 * d)
    live = torch.arange(L, device=heads.device)[None, :] < lens[:, None]
    return vals, live


def _entries_partitioned(codes, lengths, W: int, plan: BuildPlan, include_rc: bool, dev):
    """Prefix-partitioned entry construction under the plan: one pass
    counts the suffixes of every partition, then each run of partitions
    whose rows fit ``plan.per_pass_rows`` is gathered from every chunk,
    sorted and filtered; the passes run from the last, so the first sorted
    row of the following pass (the global successor of a pass's last row)
    is known when a pass is filtered.  Returns (entry words, entry lengths,
    number of passes), entries on ``dev``."""
    L = codes.shape[1]
    P = 4**plan.d
    counts = torch.zeros(P, dtype=torch.int64, device=dev)
    for heads, lens in _chunk_heads(codes, lengths, W, include_rc, plan.chunk_rows, dev):
        vals, live = _partition_values(heads, lens, L, plan.d)
        counts += torch.bincount(vals[live], minlength=P)
    ranges = pass_ranges(counts.cpu().numpy(), plan.per_pass_rows)

    out_words, out_lens = [], []
    next_head = None  # (words [W], length) of the following pass's first row
    for plo, phi in reversed(ranges):
        pw, pl = [], []
        for heads, lens in _chunk_heads(codes, lengths, W, include_rc, plan.chunk_rows, dev):
            w, l = _suffix_words_range(heads, lens, L, W, plan.d, plo, phi)
            if w.shape[0]:
                pw.append(w)
                pl.append(l)
            del heads, w, l
        if not pw:
            continue
        words, wlens = torch.cat(pw), torch.cat(pl)
        del pw, pl
        sw, sl, _ = sortutil.sort_sequences_device(words, wlens)
        del words, wlens
        keep = ~sortutil.is_prefix_of_next(sw, sl)
        if next_head is not None:
            last = sortutil.is_prefix_of_next(torch.stack([sw[-1], next_head[0]]), torch.stack([sl[-1], next_head[1]]))
            keep[-1] = ~last[0]
        next_head = (sw[0].clone(), sl[0].clone())
        out_words.append(sw[keep])
        out_lens.append(sl[keep])
        del sw, sl, keep
    out_words.reverse()
    out_lens.reverse()
    return torch.cat(out_words), torch.cat(out_lens), len(ranges)


def _suffix_words_range(heads, lens, L: int, W: int, d: int, plo: int, phi: int):
    """Packed suffixes (words [k, W], int32 lengths [k]) of one chunk whose
    partition value falls in [plo, phi)."""
    vals, live = _partition_values(heads, lens, L, d)
    r, j = torch.nonzero(live & (vals >= plo) & (vals < phi), as_tuple=True)
    words = heads[r[:, None], j[:, None] + 16 * torch.arange(W, device=heads.device)]
    return words, (lens[r] - j).to(torch.int32)


def _suffix_words(seqs: torch.Tensor, seq_lens: torch.Tensor, W: int):
    """All nonempty suffixes of all rows, packed.  Returns ([N, W] int64
    words, [N] int32 lengths), suffix offset major."""
    S, L = seqs.shape
    # ONE host read bounds the loop
    Lmax = int(seq_lens.max()) if seq_lens.numel() else 0
    padded = torch.nn.functional.pad(seqs, (0, L))
    out_words = []
    out_lens = []
    for j in range(min(L, Lmax)):
        ln = (seq_lens - j).clamp(min=0)
        out_words.append(dna.pack_codes(padded[:, j : j + L], ln))
        out_lens.append(ln)
    words = torch.cat(out_words, dim=0)
    lens = torch.cat(out_lens, dim=0)
    del out_words, out_lens
    keep = lens > 0
    if bool(keep.all()):
        return words, lens
    # compact keepers to the front preserving order (a stable partition)
    return words[keep], lens[keep]


def _entries_from_suffixes(words: torch.Tensor, lens: torch.Tensor):
    """Sort suffixes, drop duplicates and non-prefix-maximal rows."""
    sw, sl, _ = sortutil.sort_sequences_device(words, lens)
    # Drop every row that is a (non-strict) prefix of its successor: this
    # removes duplicates (keeping the last copy) AND non-prefix-maximal rows
    # in one mask.
    keep = ~sortutil.is_prefix_of_next(sw, sl)
    return sw[keep], sl[keep]


def _rank_structure_dev(first_base: torch.Tensor, lb: torch.Tensor, n: int, nw: int):
    """prev[b] rank bitvectors: scatter each entry's pop lower-bound bit
    into its first-base row, then the exclusive per-word popcount prefix
    (kernel K4, the four base rows in one launch).  Also returns the stat vector
    [counts(4), select_monotone_ok] so the caller needs one fetch."""
    flat = first_base * nw + (lb >> 5)
    # bits are distinct within a word, so adding them is OR-ing them
    words = torch.zeros(4 * nw, dtype=torch.int64, device=lb.device)
    words.index_add_(0, flat, torch.ones_like(lb) << (lb & 31))
    words = dna.u32_to_i32(words & dna.MASK32).reshape(4, nw).contiguous()
    cum = rank_cum(words).to(torch.int64)
    counts = torch.bincount(first_base, minlength=4)
    if n > 1:
        same_base = first_base[1:] == first_base[:-1]
        mono = (~same_base | (lb[1:] > lb[:-1])).all()
    else:
        mono = torch.ones((), dtype=torch.bool, device=lb.device)
    stats = torch.cat([counts, mono.to(torch.int64)[None]])
    return words, cum, stats


def seqset_from_entries(e_words: torch.Tensor, e_lens: torch.Tensor) -> Seqset:
    """Assemble seqset tensors from the sorted prefix-maximal entry list.

    Everything stays on the entries' device; one small stat fetch."""
    n = int(e_words.shape[0])
    dev = e_words.device

    shared = sortutil.lcp_with_prev(e_words, e_lens)
    sizes = e_lens.to(torch.int32)
    first_base = (e_words[:, 0] >> 30) & 3
    # pop of each entry: shift one base off the front of the packed words
    lb = sortutil.merge_lower_bound(
        e_words, e_lens, _shift_one_base(e_words), (e_lens - 1).to(torch.int32)
    )
    nw = n // 32 + 1
    prev_words, prev_cum, dstats = _rank_structure_dev(first_base, lb, n, nw)
    host = torch.cat([dstats, sizes.max()[None].to(torch.int64)]).cpu()
    counts, mono, max_len = host[:4], bool(host[4]), int(host[5])
    fixed = torch.zeros(5, dtype=torch.int64)
    torch.cumsum(counts, 0, out=fixed[1:])
    if int(fixed[4]) != n:
        raise AssertionError("fixed counts disagree with entry count")
    if not mono:
        raise AssertionError("select table not increasing within a base")
    ss = Seqset(
        n_entries=n,
        max_entry_len=max_len,
        fixed=fixed.to(dev),
        prev_words=prev_words,
        prev_cum=prev_cum,
        entry_sizes=sizes,
        shared=shared,
        pop_sel=lb,
    )
    # keep the packed entry matrix for the readmap build (it would otherwise
    # reconstruct it entry-by-entry via pop chains)
    ss.__dict__["_entry_cache"] = (e_words, e_lens)
    return ss


def _shift_one_base(words: torch.Tensor) -> torch.Tensor:
    """Drop the first base: each word takes its tail plus the head of the next."""
    nxt = torch.cat([words[:, 1:], words.new_zeros(words.shape[0], 1)], dim=1)
    return ((words << 2) | (nxt >> 30)) & dna.MASK32
