"""Reference genome: flattened contigs + scaffold coordinates (host numpy).

Counterpart of ``biograph_tpu/index/reference.py``: a FASTA is flattened
into one code array with contig extents and an N mask; ``save``/``load``
write the same artifact as the JAX package's; ``make_range`` gives the
SDK's ``ReferenceRange``.  A reference dir holds a FASTA or a BWA
``.pac``/``.ann``/``.amb`` index (``io/pac.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from biograph_tpu_torch.core import container
from biograph_tpu_torch.io import fastq as fio


@dataclass
class Contig:
    name: str
    start: int  # offset in the flat array
    length: int


@dataclass
class Reference:
    flat: np.ndarray  # uint8 codes, all contigs concatenated (N -> 0)
    is_n: np.ndarray  # bool, N/ambiguous mask
    contigs: List[Contig]
    uuid: str = ""

    @staticmethod
    def from_fasta(path: str) -> "Reference":
        parsed = fio.read_fasta_with_n(path)
        contigs = []
        chunks = []
        nmask = []
        off = 0
        for name, codes, is_n in parsed:
            contigs.append(Contig(name=name, start=off, length=len(codes)))
            chunks.append(codes)
            nmask.append(is_n)
            off += len(codes)
        return Reference(
            flat=np.concatenate(chunks) if chunks else np.zeros(0, np.uint8),
            is_n=np.concatenate(nmask) if nmask else np.zeros(0, bool),
            contigs=contigs,
        )

    @staticmethod
    def from_reference_dir(path: str) -> "Reference":
        """Open a reference directory: prefers a FASTA; else BWA
        .pac/.ann/.amb files, whose .amb holes become N (the reference
        repo's bundled reference dirs ship only the latter)."""
        for fa in ("source.fasta", "reference.fasta", "genome.fa"):
            p = os.path.join(path, fa)
            if os.path.isfile(p):
                return Reference.from_fasta(p)
        for stem in ("source.fasta", "reference.fasta"):
            pac = os.path.join(path, stem + ".pac")
            ann = os.path.join(path, stem + ".ann")
            if os.path.isfile(pac) and os.path.isfile(ann):
                from biograph_tpu_torch.io import pac as pacio

                total_len, contig_list = pacio.read_ann(ann)
                flat = pacio.read_pac(pac, total_len)
                is_n = np.zeros(total_len, bool)
                for off, length in pacio.read_amb(os.path.join(path, stem + ".amb")):
                    is_n[off : off + length] = True
                contigs = [Contig(name=n, start=o, length=l) for n, o, l in contig_list]
                return Reference(flat=flat, is_n=is_n, contigs=contigs)
        raise FileNotFoundError(f"no FASTA or BWA pac index in {path}")

    @property
    def total_bases(self) -> int:
        return len(self.flat)

    def contig_by_name(self, name: str) -> Contig:
        for c in self.contigs:
            if c.name == name:
                return c
        # supercontig naming "scaffold:offset" (the reference's flat_ref
        # exporters emit positions relative to a scaffold's supercontig,
        # modules/bio_base/flat_ref.h — e.g. golden/pileup.vcf "Chromosome:0")
        if ":" in name:
            base, _, off = name.rpartition(":")
            if off.isdigit():
                c = self.contig_by_name(base)
                off = int(off)
                return Contig(name=name, start=c.start + off, length=c.length - off)
        raise KeyError(name)

    def make_range(self, name: str, start: int, end: int):
        """ReferenceRange handle on [start, end) of contig ``name``."""
        from biograph_tpu_torch.api import ReferenceRange

        c = self.contig_by_name(name)
        if not (0 <= start <= end <= c.length):
            raise ValueError(f"{name}:{start}-{end} outside contig of {c.length}")
        return ReferenceRange(self, name, start, end)

    def get_codes(self, name: str, start: int = 0, end: int | None = None) -> np.ndarray:
        c = self.contig_by_name(name)
        end = c.length if end is None else end
        return self.flat[c.start + start : c.start + end]

    def save(self, path: str):
        with container.ArtifactWriter(path, "reference") as w:
            w.add_array("flat", self.flat)
            # long runs of False with rare N blocks: zlib shrinks the mask
            # ~1000x and it is read once per open (never mmap-queried)
            w.add_array("is_n", self.is_n, codec="zlib")
            w.set_scalar(
                "contigs",
                [[c.name, c.start, c.length] for c in self.contigs],
            )
            self.uuid = w.meta["uuid"]

    @staticmethod
    def load(path: str) -> "Reference":
        r = container.ArtifactReader(path, "reference")
        contigs = [Contig(n, s, l) for n, s, l in r.scalar("contigs")]
        return Reference(
            flat=np.asarray(r.array("flat")),
            is_n=np.asarray(r.array("is_n")),
            contigs=contigs,
            uuid=r.uuid,
        )
