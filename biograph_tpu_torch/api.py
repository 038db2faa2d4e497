"""User-facing SDK objects (torch).

Counterpart of ``biograph_tpu/api.py``: ``BioGraph``, ``Sequence``,
``SeqsetEntry``, ``ReadmapRead`` and ``ReferenceRange``.  ``BioGraph(path,
device="cuda")`` opens the ``.bgt`` layout (``seqset``, ``readmap``,
``metadata.json``) that either package saves, or the reference's ``.bg``
layout through ``io/bgimport.open_bg_dir``, with its tensors on
``device``; like every entry point it raises when CUDA is absent unless the
caller asks for the CPU.  Navigation (``push_front``, ``pop_front``,
``truncate``) runs one-lane batches through the seqset's query engine.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna


class Sequence:
    """An immutable DNA sequence of 2-bit codes on the host."""

    def __init__(self, seq):
        if isinstance(seq, str):
            self._codes = dna.seq_to_codes(seq)
        elif isinstance(seq, torch.Tensor):
            self._codes = seq.cpu().numpy().astype(np.uint8)
        else:
            self._codes = np.asarray(seq, np.uint8)

    @property
    def codes(self) -> np.ndarray:
        return self._codes

    def __len__(self):
        return len(self._codes)

    def __str__(self):
        return dna.codes_to_seq(self._codes)

    def __repr__(self):
        return f"Sequence({str(self)!r})"

    def __eq__(self, other):
        if isinstance(other, str):
            return str(self) == other
        return isinstance(other, Sequence) and np.array_equal(self._codes, other._codes)

    def rev_comp(self) -> "Sequence":
        return Sequence((3 - self._codes)[::-1])

    def __getitem__(self, sl):
        return Sequence(self._codes[sl])


class SeqsetEntry:
    """A seqset range with navigation (the SDK's seqset_range)."""

    def __init__(self, seqset, begin: int, end: int, size: int):
        self._ss = seqset
        self.begin = int(begin)
        self.end = int(end)
        self.size = int(size)

    @property
    def valid(self) -> bool:
        return self.begin < self.end

    def _one(self):
        from biograph_tpu_torch.index.seqset import SeqsetRanges

        dev = self._ss.device
        return SeqsetRanges(
            torch.tensor([self.begin], dtype=torch.int64, device=dev),
            torch.tensor([self.end], dtype=torch.int64, device=dev),
            torch.tensor([self.size], dtype=torch.int32, device=dev),
        )

    def _entry(self, r) -> "SeqsetEntry":
        return SeqsetEntry(self._ss, int(r.begin[0]), int(r.end[0]), int(r.size[0]))

    def sequence(self, length: int | None = None) -> Sequence:
        n = self.size if length is None else min(length, self.size)
        ids = torch.tensor([self.begin], dtype=torch.int64, device=self._ss.device)
        return Sequence(self._ss.d.sequences(ids, max(n, 1))[0, :n])

    def push_front(self, base: str) -> "SeqsetEntry":
        b = torch.tensor([int(dna.seq_to_codes(base)[0])], dtype=torch.int64, device=self._ss.device)
        return self._entry(self._ss.d.push_front(self._one(), b))

    def pop_front(self) -> "SeqsetEntry":
        return self._entry(self._ss.d.pop_front_ranges(self._one()))

    def truncate(self, new_size: int) -> "SeqsetEntry":
        return self._entry(self._ss.d.truncate_ranges(self._one(), new_size))

    def __repr__(self):
        return f"SeqsetEntry([{self.begin},{self.end}), size={self.size})"


class ReadmapRead:
    """Handle on one readmap entry."""

    def __init__(self, readmap, rm_id: int):
        self._rm = readmap
        self.rm_id = int(rm_id)

    @property
    def length(self) -> int:
        return int(self._rm.read_lengths[self.rm_id])

    @property
    def is_forward(self) -> bool:
        return bool(self._rm.is_forward[self.rm_id])

    @property
    def read_id(self) -> int:
        return int(self._rm.read_ids[self.rm_id])

    @property
    def entry_id(self) -> int:
        return int(self._rm.entry_of_rm[self.rm_id])

    def sequence(self) -> Sequence:
        ids = torch.tensor([self.entry_id], dtype=torch.int64, device=self._rm.device)
        return Sequence(self._rm.seqset.d.sequences(ids, self.length)[0, : self.length])

    def rev_comp(self) -> "ReadmapRead":
        return ReadmapRead(self._rm, int(self._rm.get_rev_comp([self.rm_id])[0]))

    def mate(self) -> "ReadmapRead | None":
        if not bool(self._rm.has_mate([self.rm_id])[0]):
            return None
        return ReadmapRead(self._rm, int(self._rm.get_mate([self.rm_id])[0]))

    def __repr__(self):
        return (
            f"ReadmapRead(rm_id={self.rm_id}, len={self.length}, "
            f"{'fwd' if self.is_forward else 'rev'})"
        )


class ReferenceRange:
    """A [start, end) window of one reference contig."""

    def __init__(self, reference, contig: str, start: int, end: int):
        self._ref = reference
        self.contig = contig
        self.start = int(start)
        self.end = int(end)

    @property
    def size(self) -> int:
        return self.end - self.start

    def sequence(self) -> Sequence:
        return Sequence(self._ref.get_codes(self.contig, self.start, self.end))

    def __repr__(self):
        return f"ReferenceRange({self.contig}:{self.start}-{self.end})"


class BioGraph:
    """Open a sample archive, ``.bgt`` (either package's) or ``.bg`` (the
    reference's), its tensors on ``device``."""

    def __init__(self, path: str, device="cuda"):
        from biograph_tpu_torch.core import container
        from biograph_tpu_torch.index.readmap import Readmap
        from biograph_tpu_torch.index.seqset import Seqset

        dev = resolve_device(device)
        self.path = path
        self.metadata = {}
        self.readmap: Optional[Readmap] = None
        bgt_seqset = os.path.join(path, "seqset")
        if container.exists(bgt_seqset):
            meta_path = os.path.join(path, "metadata.json")
            if os.path.isfile(meta_path):
                with open(meta_path) as f:
                    self.metadata = json.load(f)
            self.seqset = Seqset.load(bgt_seqset, dev)
            rm_path = os.path.join(path, "readmap")
            if os.path.isdir(rm_path):
                self.readmap = Readmap.load(rm_path, self.seqset, dev)
        elif os.path.isfile(bgt_seqset):
            # the reference's .bg layout (spiral_file ZIP members)
            from biograph_tpu_torch.io.bgimport import open_bg_dir

            self.seqset, self.readmap, self.metadata = open_bg_dir(path, dev)
        else:
            raise FileNotFoundError(f"{path}: no seqset found (.bgt or .bg)")

    def find(self, seq) -> SeqsetEntry:
        """Find a sequence; returns a (possibly invalid) SeqsetEntry."""
        if isinstance(seq, Sequence):
            seq = str(seq)
        b, e, s = self.seqset.find_str(seq)
        return SeqsetEntry(self.seqset, b, e, s)

    def entry(self, entry_id: int) -> SeqsetEntry:
        """The range of one full seqset entry."""
        return SeqsetEntry(
            self.seqset, entry_id, entry_id + 1, int(self.seqset.entry_sizes[entry_id])
        )

    def seq_coverage(self, seq) -> np.ndarray:
        """Per-base read coverage of a sequence (fwd + rev), via the readmap."""
        if self.readmap is None:
            raise ValueError("no readmap")
        codes = seq.codes if isinstance(seq, Sequence) else Sequence(seq).codes
        dev = self.readmap.device
        f, r = self.readmap.coverage(
            torch.from_numpy(codes[None, :].copy()).to(dev),
            torch.tensor([len(codes)], dtype=torch.int32, device=dev),
        )
        return (f + r)[0].cpu().numpy()

    def read(self, rm_id: int) -> ReadmapRead:
        """Handle on one readmap entry."""
        if self.readmap is None:
            raise ValueError("no readmap")
        return ReadmapRead(self.readmap, rm_id)

    def pair_stats(self) -> dict:
        """Paired and unpaired read and base counts."""
        if self.readmap is None:
            raise ValueError("no readmap")
        return self.readmap.get_pair_stats()

    @property
    def num_reads(self) -> int:
        return self.readmap.read_count if self.readmap else 0

    def __repr__(self):
        return (
            f"BioGraph({self.path!r}: {self.seqset.n_entries} entries, "
            f"{self.num_reads} reads)"
        )
