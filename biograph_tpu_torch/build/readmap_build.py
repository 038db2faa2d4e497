"""Readmap construction: batch lower-bound of oriented reads into the seqset.

Counterpart of ``biograph_tpu/build/readmap_build.py``: every read and
reverse complement is located with ONE merged sort
(``ops.sortutil.merge_lower_bound``) per chunk, then the CSR, the mate-loop
permutation and the is_forward bits are assembled with vectorized scatters,
all on the seqset's device.
"""

from __future__ import annotations

import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.core.packed import exclusive_cumsum
from biograph_tpu_torch.index.readmap import Readmap
from biograph_tpu_torch.index.seqset import Seqset
from biograph_tpu_torch.ops import sortutil


def build_readmap(
    seqset: Seqset,
    codes,
    lengths,
    mate_of=None,
    entry_words: torch.Tensor | None = None,
    entry_lens: torch.Tensor | None = None,
    chunk_rows: int = 1 << 20,
    device="cuda",
) -> Readmap:
    """Build a readmap for reads already incorporated in ``seqset``.

    codes: uint8 [R, L] (numpy array or tensor; reads go to the device in
    ``chunk_rows`` batches); lengths: int32 [R]; mate_of: int64 [R] with the
    mate read index or -1 (mates must be symmetric).  ``seqset`` must lie on
    ``device``.

    entry_words/entry_lens: packed entry sequences (kept from the build); if
    absent they are reconstructed from the seqset via pop chains.
    """
    dev = seqset.device
    if dev.type != resolve_device(device).type:
        raise ValueError(
            f"build_readmap: seqset lies on {dev}, not on {device!r}"
        )
    codes = torch.as_tensor(codes)
    lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
    R, L = codes.shape
    olens = torch.cat([lengths, lengths])

    if entry_words is None:
        cached = seqset.__dict__.get("_entry_cache")
        if cached is not None:
            entry_words, entry_lens = cached
        else:
            entry_words, entry_lens = reconstruct_entry_words(seqset)
    W = entry_words.shape[1]

    def locate(c, ln):
        q = dna.pack_codes(c, ln)
        if q.shape[1] < W:
            q = torch.nn.functional.pad(q, (0, W - q.shape[1]))
        elif q.shape[1] > W:
            raise ValueError("reads longer than seqset max entry length")
        return sortutil.merge_lower_bound(entry_words, entry_lens, q, ln)

    # entry of every oriented read: fwd block then rc block, chunked so only
    # one chunk of reads is packed at a time
    entry_ids = torch.empty(2 * R, dtype=torch.int64, device=dev)
    for r0 in range(0, R, chunk_rows):
        r1 = min(R, r0 + chunk_rows)
        c = codes[r0:r1].to(device=dev, dtype=torch.uint8)
        ln = lengths[r0:r1]
        entry_ids[r0:r1] = locate(c, ln)
        entry_ids[R + r0 : R + r1] = locate(dna.revcomp_codes(c, ln), ln)

    # readmap-entry ordering: sorted by (seqset entry, read length, oriented
    # id) — deterministic, CSR-compatible.  Two stable passes, least
    # significant key first; the oriented id is the initial order.
    order = torch.sort(olens, stable=True).indices
    order = order[torch.sort(entry_ids[order], stable=True).indices]
    n = seqset.n_entries
    offsets = exclusive_cumsum(torch.bincount(entry_ids, minlength=n))

    # rm index of each oriented read
    rm_of_oriented = torch.empty(2 * R, dtype=torch.int64, device=dev)
    rm_of_oriented[order] = torch.arange(2 * R, device=dev)

    # mate loop: fwd -> rc -> mate_fwd -> mate_rc -> fwd; unpaired: fwd -> rc -> fwd
    if mate_of is None:
        mate_of = torch.full((R,), -1, dtype=torch.int64, device=dev)
    mate_of = torch.as_tensor(mate_of).to(device=dev, dtype=torch.int64)
    fwd_rm = rm_of_oriented[:R]
    rc_rm = rm_of_oriented[R:]
    loop = torch.empty(2 * R, dtype=torch.int64, device=dev)
    paired = mate_of >= 0
    loop[fwd_rm] = rc_rm  # fwd -> rc (always)
    # rc -> mate fwd (paired) or back to fwd (unpaired)
    loop[rc_rm[paired]] = fwd_rm[mate_of[paired]]
    loop[rc_rm[~paired]] = fwd_rm[~paired]

    return Readmap(
        seqset=seqset,
        offsets=offsets,
        read_lengths=olens[order],
        is_forward=order < R,
        mate_pair_ptr=loop,
        read_ids=order % R,  # original read index of each readmap entry
    )


def reconstruct_entry_words(seqset: Seqset, chunk: int = 1 << 18):
    """Recover packed entry sequences from the seqset via pop chains."""
    n = seqset.n_entries
    L = seqset.max_entry_len
    dev = seqset.device
    sizes = seqset.entry_sizes.to(torch.int32)
    outs = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        outs.append(dna.pack_codes(seqset.d.sequences(ids, L), sizes[lo:hi]))
    if not outs:
        return torch.zeros((0, 1), dtype=torch.int64, device=dev), sizes
    return torch.cat(outs, dim=0), sizes
