"""Seqset construction as device-wide sorting (torch).

Counterpart of ``biograph_tpu/build/seqset_build.py``, in-memory path:

  1. reads + reverse complements -> all suffixes, 2-bit packed [N, W] words
  2. one prefix-first lexicographic sort (``ops/sortutil.py``)
  3. dedup + prefix-maximality filter  -> entries
  4. sizes, shared (vectorized LCP), fixed (first-base offsets)
  5. prev[b] bitvectors + select table by a batched lower bound of every
     entry's pop against the entry list (one more merged sort); the
     exclusive popcount prefix ``prev_cum`` comes from the ``rank_cum``
     kernel, once per base row.

The prefix-partitioned multi-pass build for read sets beyond device memory
is not ported yet: a ``budget`` that would need it raises
NotImplementedError.

Representation: suffix and entry words are int64 tensors holding 32-bit
values; ``prev_words`` is stored bit-reinterpreted as int32.
"""

from __future__ import annotations

import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.index.seqset import Seqset
from biograph_tpu_torch.ops import sortutil
from biograph_tpu_torch.ops.rank_cum import rank_cum


def build_seqset(
    codes,
    lengths,
    include_rc: bool = True,
    budget=None,
    device="cuda",
) -> Seqset:
    """Build a seqset from a padded read matrix.

    codes: uint8 [R, L] zero-padded (numpy array or tensor); lengths: [R].
    Every tensor of the result lies on ``device``.

    ``budget`` (an object with ``.bytes`` or a raw byte count) bounds the
    device-resident suffix sort; a read set whose sort would exceed it
    needs the partitioned build, which is not ported.
    """
    dev = resolve_device(device)
    codes_dev = torch.as_tensor(codes).to(device=dev, dtype=torch.uint8)
    lens_dev = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
    if codes_dev.shape[0] == 0 or int(lens_dev.max()) == 0:
        raise ValueError(
            "build_seqset: no nonempty reads (all reads dropped by "
            "correction/filters?)"
        )
    R, L = codes_dev.shape
    W = dna.words_for_bases(L)

    budget_bytes = getattr(budget, "bytes", budget)
    if budget_bytes is not None:
        total_suffixes = int(lens_dev.sum()) * (2 if include_rc else 1)
        # sort working set: operand columns + sorted copies (~4x)
        sort_bytes = total_suffixes * (W * 4 + 8) * 4
        if sort_bytes > budget_bytes:
            raise NotImplementedError(
                "build_seqset: the suffix sort needs about "
                f"{sort_bytes} bytes, over the budget of {budget_bytes}; "
                "the prefix-partitioned build is not ported"
            )

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
    return seqset_from_entries(ew, el)


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
