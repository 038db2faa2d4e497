"""Readmap: seqset entries <-> reads, lengths, pairing (torch).

Counterpart of ``biograph_tpu/index/readmap.py``:
  * CSR ``offsets`` mapping seqset entry -> readmap entries
  * per readmap entry: read length, is_forward bit, mate-loop link
    (fwd -> RC -> mate -> mate-RC cycle)

A "readmap entry" exists for each orientation of each read (a read and its
reverse complement are separate entries pointing at different seqset
entries, linked by the mate loop).  read_count == num_entries / 2.

All queries are batched tensors in, tensors out.  The coverage queries, the
window hash and the read-iteration surface are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import container


@dataclass
class Readmap:
    seqset: object
    # CSR over seqset entries -> readmap entry ids
    offsets: torch.Tensor  # int64 [n_seqset_entries + 1]
    read_lengths: torch.Tensor  # int32 [n_rm]
    is_forward: torch.Tensor  # bool [n_rm]
    mate_pair_ptr: torch.Tensor  # int64 [n_rm] — next link in the mate loop
    read_ids: torch.Tensor  # int64 [n_rm] — original read index
    uuid: str = ""

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def num_entries(self) -> int:
        return self.read_lengths.shape[0]

    @property
    def read_count(self) -> int:
        return self.num_entries // 2

    @cached_property
    def entry_of_rm(self) -> torch.Tensor:
        """seqset entry id owning each readmap entry (reverse CSR)."""
        n = self.offsets.shape[0] - 1
        counts = self.offsets[1:] - self.offsets[:-1]
        ids = torch.arange(n, dtype=torch.int64, device=self.device)
        return torch.repeat_interleave(ids, counts)

    @cached_property
    def length_groups(self):
        """Per-entry attached-read counts grouped by (read length, strand).

        Returns (lens int32 [D], counts int32 [D, 2, n_entries]) where
        counts[d, 0] counts attached reads of length lens[d] whose
        is_forward is False and counts[d, 1] those with True."""
        n = self.offsets.shape[0] - 1
        ent = self.entry_of_rm
        lens = torch.unique(self.read_lengths)
        counts = torch.zeros((len(lens), 2, n), dtype=torch.int32, device=self.device)
        fwd = self.is_forward
        for d, m in enumerate(lens):
            sel = self.read_lengths == m
            counts[d, 0] = torch.bincount(ent[sel & ~fwd], minlength=n)
            counts[d, 1] = torch.bincount(ent[sel & fwd], minlength=n)
        return lens.to(torch.int32), counts

    @cached_property
    def min_read_len(self) -> int:
        if self.num_entries == 0:
            return 0
        return int(self.read_lengths.min())

    @cached_property
    def max_read_len(self) -> int:
        if self.num_entries == 0:
            return 0
        return int(self.read_lengths.max())

    # ------------- batched queries -------------

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.int64)

    def entry_read_range(self, entries):
        """[start, end) into readmap-entry ids for each seqset entry."""
        e = self._ids(entries)
        return self.offsets[e], self.offsets[e + 1]

    def entry_read_count(self, entries):
        s, e = self.entry_read_range(entries)
        return e - s

    def get_rev_comp(self, rm_ids):
        """Mate loop walked 1 (forward) or 3 (rc) times."""
        rm_ids = self._ids(rm_ids)
        loop = self.mate_pair_ptr
        one = loop[rm_ids]
        three = loop[loop[one]]
        return torch.where(self.is_forward[rm_ids], one, three)

    def get_mate(self, rm_ids):
        """Mate = loop twice; for unpaired returns self."""
        loop = self.mate_pair_ptr
        return loop[loop[self._ids(rm_ids)]]

    def has_mate(self, rm_ids):
        return self.get_mate(rm_ids) != self._ids(rm_ids)

    def get_pair_stats(self):
        loop = self.mate_pair_ptr
        mate2 = loop[loop]
        paired = mate2 != torch.arange(self.num_entries, device=self.device)
        fwd = self.is_forward
        lens = self.read_lengths.to(torch.int64)
        return {
            "paired_reads": int((paired & fwd).sum()),
            "paired_bases": int(lens[paired & fwd].sum()),
            "unpaired_reads": int((~paired & fwd).sum()),
            "unpaired_bases": int(lens[~paired & fwd].sum()),
        }

    # ------------- persistence -------------

    def save(self, path: str):
        def host(t, dtype):
            return t.cpu().numpy().astype(dtype, copy=False)

        with container.ArtifactWriter(path, "readmap") as w:
            w.set_scalar("seqset_uuid", getattr(self.seqset, "uuid", ""))
            w.add_array("offsets", host(self.offsets, np.int64))
            w.add_array("read_lengths", host(self.read_lengths, np.int32))
            w.add_array("is_forward", host(self.is_forward, bool))
            w.add_array("mate_pair_ptr", host(self.mate_pair_ptr, np.int64))
            w.add_array("read_ids", host(self.read_ids, np.int64))
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str, seqset, device="cuda") -> "Readmap":
        from biograph_tpu_torch.convert import READMAP_DTYPES, readmap_from_numpy

        dev = resolve_device(device)
        r = container.ArtifactReader(path, "readmap", mmap=False)
        rm = readmap_from_numpy(
            {name: r.array(name) for name in READMAP_DTYPES}, seqset, dev
        )
        rm.uuid = r.uuid
        return rm
