"""Multi-sample seqset merge and readmap migration (torch).

Counterpart of ``biograph_tpu/build/merge.py`` (the reference's
modules/biograph/biograph_merge.cpp:33, modules/bio_base/make_mergemap.h:47,
seqset_merger.h:13, make_readmap::migrate, make_readmap.h:27): several
samples' seqsets combine into one, and each sample's readmap is re-pointed
at it.  One device pass: every input's entry sequences concatenated,
sorted, the non-prefix-maximal rows dropped (make_mergemap.h:28-36: if X
is a prefix of Y only Y survives), the rank structures rebuilt, and each
input's mergemap a batched lower bound of its entries in the merged order.
Everything stays on the inputs' device.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from biograph_tpu_torch.build.readmap_build import reconstruct_entry_words
from biograph_tpu_torch.build.seqset_build import _entries_from_suffixes, seqset_from_entries
from biograph_tpu_torch.core.packed import exclusive_cumsum
from biograph_tpu_torch.index.readmap import Readmap
from biograph_tpu_torch.index.seqset import Seqset
from biograph_tpu_torch.ops import sortutil


def merge_seqsets(seqsets: List[Seqset]) -> Tuple[Seqset, List[torch.Tensor]]:
    """Merge seqsets; returns (merged, mergemaps).

    mergemaps[i][e] = merged entry id that input i's entry e maps to (the
    merged entry having input entry e's sequence as a prefix) — the rank/
    position form of the reference's mergemap bitcounts
    (seqset_mergemap.h:21), int64 on the inputs' device."""
    # the packed entries a build kept, or else rebuilt from pop chains
    parts = [ss.__dict__.get("_entry_cache") or reconstruct_entry_words(ss) for ss in seqsets]
    W = max(w.shape[1] for w, _ in parts)
    padded = [torch.nn.functional.pad(w, (0, W - w.shape[1])) for w, _ in parts]
    # inputs are suffix-closed, so their union is too: only dedup and
    # prefix-maximality are needed, which _entries_from_suffixes does
    ew, el = _entries_from_suffixes(torch.cat(padded), torch.cat([l for _, l in parts]))
    merged = seqset_from_entries(ew, el)
    mergemaps = [
        sortutil.merge_lower_bound(ew, el, w, l.to(torch.int32)) for w, (_, l) in zip(padded, parts)
    ]
    return merged, mergemaps


def migrate_readmap(rm: Readmap, merged: Seqset, mergemap: torch.Tensor) -> Readmap:
    """Re-point a readmap at the merged seqset (make_readmap::migrate):
    readmap entries ordered by (merged entry, read length, old position)."""
    dev = rm.device
    new_entry = mergemap.to(dev)[rm.entry_of_rm]
    order = torch.sort(rm.read_lengths, stable=True).indices
    order = order[torch.sort(new_entry[order], stable=True).indices]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(rm.num_entries, device=dev)
    return Readmap(
        seqset=merged,
        offsets=exclusive_cumsum(torch.bincount(new_entry, minlength=merged.n_entries)),
        read_lengths=rm.read_lengths[order],
        is_forward=rm.is_forward[order],
        mate_pair_ptr=inv[rm.mate_pair_ptr[order]],
        read_ids=rm.read_ids[order],
    )
