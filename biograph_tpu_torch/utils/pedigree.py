"""Pedigree (.ped) file handling (pure Python).

Copy of ``biograph_tpu/utils/pedigree.py``.

Counterpart of the reference SDK's Pedigree (python/biograph/utils.py:684):
a mapping of individual id -> PedSample with family views, parent
synthesis, offspring links, and trio/quad extraction.  PED columns
(tab-separated, GATK convention):

    family_id  individual_id  paternal_id  maternal_id  sex  phenotype...

sex: 1=male, 2=female, other=unknown; phenotype: 1=unaffected, 2=affected;
'0' means unknown/absent parent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple


@dataclass
class PedSample:
    """One individual (reference _PedSample, utils.py:806)."""

    fam_id: str
    ind_id: str
    pat_id: str
    mat_id: str
    sex: str
    phenotype: List[str] = field(default_factory=list)
    father: "PedSample | None" = None
    mother: "PedSample | None" = None
    offspring: List["PedSample"] = field(default_factory=list)

    def __hash__(self):
        return hash(self.ind_id)

    @property
    def is_proband(self) -> bool:
        return self.pat_id != "0" and self.mat_id != "0"

    @property
    def pheno(self) -> str:
        return self.phenotype[0] if self.phenotype else "0"


class Pedigree(Dict[str, PedSample]):
    """Parse a pedigree file and expose family/trio views."""

    def __init__(self, file_name: str):
        super().__init__()
        self.families: Dict[str, List[PedSample]] = {}
        with open(file_name) as fh:
            for ln, line in enumerate(fh, 1):
                if line.startswith("#") or not line.strip():
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 5:
                    raise ValueError(f"{file_name}:{ln}: PED wants >=5 columns")
                s = PedSample(*cols[:5], phenotype=list(cols[5:]))
                if s.ind_id in self:
                    raise KeyError(f"duplicate individual id {s.ind_id}")
                self[s.ind_id] = s
                self.families.setdefault(s.fam_id, []).append(s)
        # parents referenced without their own line still exist in the ped
        for s in list(self.values()):
            for pid, sex in ((s.pat_id, "1"), (s.mat_id, "2")):
                if pid != "0" and pid not in self:
                    ghost = PedSample(s.fam_id, pid, "0", "0", sex, ["0"])
                    self[pid] = ghost
                    self.families.setdefault(s.fam_id, []).append(ghost)
        for s in self.values():
            if s.pat_id in self:
                s.father = self[s.pat_id]
                s.father.offspring.append(s)
            if s.mat_id in self:
                s.mother = self[s.mat_id]
                s.mother.offspring.append(s)

    # ---- views (reference utils.py:744-808) ----

    def all_male(self) -> Iterator[PedSample]:
        return (s for s in self.values() if s.sex == "1")

    def all_female(self) -> Iterator[PedSample]:
        return (s for s in self.values() if s.sex == "2")

    def all_affected(self) -> Iterator[PedSample]:
        return (s for s in self.values() if s.pheno == "2")

    def all_unaffected(self) -> Iterator[PedSample]:
        return (s for s in self.values() if s.pheno == "1")

    def get_siblings(self, ind_id: str) -> Iterator[PedSample]:
        me = self[ind_id]
        for s in self.values():
            if s.ind_id == ind_id:
                continue
            if (me.pat_id != "0" and s.pat_id == me.pat_id) or (
                me.mat_id != "0" and s.mat_id == me.mat_id
            ):
                yield s

    def get_trio_probands(self) -> Iterator[PedSample]:
        """Individuals with both parents known (trio probands)."""
        return (s for s in self.values() if s.is_proband)

    def trios(self) -> Iterator[Tuple[PedSample, PedSample, PedSample]]:
        """(proband, father, mother) triples."""
        for s in self.get_trio_probands():
            yield s, self[s.pat_id], self[s.mat_id]

    def filter(
        self,
        inc_fam=None,
        exc_fam=None,
        inc_indiv=None,
        exc_indiv=None,
    ) -> None:
        """Drop individuals outside the include sets / inside the excludes."""
        drop = [
            i
            for i, s in self.items()
            if (inc_fam is not None and s.fam_id not in inc_fam)
            or (inc_indiv is not None and i not in inc_indiv)
            or (exc_fam is not None and s.fam_id in exc_fam)
            or (exc_indiv is not None and i in exc_indiv)
        ]
        for i in drop:
            s = self.pop(i)
            self.families[s.fam_id].remove(s)
