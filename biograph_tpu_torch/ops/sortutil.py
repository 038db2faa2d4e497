"""Device-wide lexicographic sorting of packed DNA sequences (torch).

Counterpart of ``biograph_tpu/ops/sortutil.py``.  Sequence keys are
(word_0, ..., word_{W-1}, length): zero padding makes unsigned word
comparison lexicographic, and the ascending length tiebreak yields exact
"prefix-first" order (see ``core/dna.py``).

``torch.sort`` takes one key, where the JAX package sorts W+1 operands at
once.  ``lex_argsort`` packs the 32-bit key columns in pairs into int64
(sign bit flipped, so signed order is the unsigned order of the pair) and
runs stable least-significant-first passes over the packed keys.

Representation: packed words are int64 tensors holding 32-bit values.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from biograph_tpu_torch.core.dna import MASK32, prefix_mask_words

_SIGN = -(1 << 63)


def lex_argsort(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable argsort of rows by key columns, most significant first.

    Every column is an int64 tensor [N] with values in [0, 2**32)."""
    N = cols[0].shape[0]
    cols = list(cols)
    keys = []
    if len(cols) % 2:
        keys.append(cols.pop(0))
    for hi, lo in zip(cols[0::2], cols[1::2]):
        keys.append(((hi << 32) | lo) ^ _SIGN)
    perm = torch.arange(N, device=keys[0].device)
    for key in reversed(keys):
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    return perm


def sort_sequences_device(
    words: torch.Tensor,
    lengths: torch.Tensor,
    payloads: Sequence[torch.Tensor] = (),
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Sort rows of [N, W] packed words in prefix-first lexicographic order.

    Returns (sorted_words, sorted_lengths, sorted_payloads).
    """
    W = words.shape[1]
    cols = [words[:, i] for i in range(W)] + [lengths.to(torch.int64)]
    perm = lex_argsort(cols)
    return words[perm], lengths[perm], tuple(p[perm] for p in payloads)


def is_prefix_of_next(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """mask[i] = row i is a (non-strict) prefix of row i+1 (mask[-1]=False).

    Requires sorted order.  Row i is a prefix of row i+1 iff
    lengths[i] <= lengths[i+1] and the first lengths[i] bases agree; with
    zero padding that's a masked word comparison.
    """
    W = words.shape[1]
    mask = prefix_mask_words(lengths[:-1], W)
    pref = ((words[1:] & mask) == words[:-1]).all(dim=1) & (
        lengths[:-1] <= lengths[1:]
    )
    return torch.cat([pref, pref.new_zeros(1)])


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of the 32-bit value in each int64 lane (0 -> 32)."""
    x = x & MASK32
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for shift in (16, 8, 4, 2, 1):
        hi = x >> shift
        use = hi != 0
        n = torch.where(use, n, n + shift)
        x = torch.where(use, hi, x)
    return torch.where(x == 0, n + 1, n)  # after the loop x is 0 or 1


def lcp_with_prev(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Longest common prefix (in bases) of each row with the previous row.

    Per-word XOR, locate the first differing word, count leading zero
    *bases* there.  lcp[0] = 0.  Returns int32 [N].
    """
    N, W = words.shape
    if N == 0:
        return torch.zeros(0, dtype=torch.int32, device=words.device)
    x = words[1:] ^ words[:-1]  # [N-1, W]
    nz = x != 0
    any_nz = nz.any(dim=1)
    first_nz = torch.where(any_nz, torch.argmax(nz.to(torch.uint8), dim=1), W)
    diff_word = torch.gather(x, 1, first_nz.clamp(max=W - 1)[:, None])[:, 0]
    lead_bases = _clz32(diff_word) >> 1  # 2 bits per base
    min_len = torch.minimum(lengths[1:], lengths[:-1]).to(torch.int64)
    lcp = torch.where(any_nz, first_nz * 16 + lead_bases, min_len)
    lcp = torch.minimum(lcp, min_len)
    return torch.cat([lcp.new_zeros(1), lcp]).to(torch.int32)


def merge_lower_bound(
    entry_words: torch.Tensor,
    entry_lengths: torch.Tensor,
    query_words: torch.Tensor,
    query_lengths: torch.Tensor,
) -> torch.Tensor:
    """For each query sequence, the index of the first entry >= it.

    Entries must be sorted (prefix-first order).  One combined sort with an
    entry/query tag as the final tiebreak: the number of entries preceding
    each query in the merged order is exactly its lower bound.  Returns
    int64 [Nq].
    """
    Ne, W = entry_words.shape
    Nq = query_words.shape[0]
    dev = entry_words.device
    words = torch.cat([entry_words, query_words], dim=0)
    # A query must sort BEFORE an equal entry so that an exact match is not
    # counted in its own lower bound: tag query=0, entry=1, folded into the
    # length column as its lowest bit.
    tag = torch.cat(
        [
            torch.ones(Ne, dtype=torch.int64, device=dev),
            torch.zeros(Nq, dtype=torch.int64, device=dev),
        ]
    )
    len_tag = (
        torch.cat([entry_lengths, query_lengths]).to(torch.int64) << 1
    ) | tag
    perm = lex_argsort([words[:, i] for i in range(W)] + [len_tag])
    stag = tag[perm]
    # number of entries strictly before each merged position
    entries_before = torch.cumsum(stag, 0) - stag
    is_query = stag == 0
    lb = torch.zeros(Nq, dtype=torch.int64, device=dev)
    lb[perm[is_query] - Ne] = entries_before[is_query]
    return lb
