"""VCF writing/reading (pure Python).

Counterpart of ``biograph_tpu/io/vcf.py``, kept as the port's own copy: the
writer streams one-sample records to a path (gzip when it ends in ``.gz``)
in the same bytes but names this package in the ``##source=`` line; the
reader is a light parser for tests and checks.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class VcfRecord:
    chrom: str
    pos: int  # 1-based
    ref: str
    alt: str
    qual: float | None = None
    id: str = "."
    filter: str = "PASS"
    info: Dict[str, object] = field(default_factory=dict)
    fmt: Dict[str, object] = field(default_factory=dict)

    def info_str(self) -> str:
        if not self.info:
            return "."
        parts = []
        for key, v in self.info.items():
            if v is True:
                parts.append(key)
            else:
                parts.append(f"{key}={v}")
        return ";".join(parts)


class VcfWriter:
    def __init__(
        self,
        path: str,
        sample: str = "SAMPLE",
        contigs: List[Tuple[str, int]] | None = None,
        extra_headers: List[str] | None = None,
    ):
        self._f = gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")
        self._f.write("##fileformat=VCFv4.2\n")
        self._f.write("##source=biograph_tpu_torch\n")
        for name, length in contigs or []:
            self._f.write(f"##contig=<ID={name},length={length}>\n")
        for h in extra_headers or []:
            self._f.write(h.rstrip("\n") + "\n")
        self._f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")
        # ordering canary (the reference's assembly-pipeline order verifier /
        # sorted_output_pipeline_step invariant, modules/variants/assemble.cpp):
        # records must arrive chrom-grouped with non-decreasing positions —
        # a violated invariant means an upstream merge/sort bug, so fail loudly
        # instead of emitting a silently unsorted VCF.
        self._last: Tuple[str, int] | None = None
        self._done_chroms: set = set()

    def write(self, rec: VcfRecord):
        if self._last is not None:
            lc, lp = self._last
            if rec.chrom == lc:
                if rec.pos < lp:
                    raise ValueError(
                        f"VCF order violation: {rec.chrom}:{rec.pos} after {lc}:{lp}"
                    )
            else:
                self._done_chroms.add(lc)
                if rec.chrom in self._done_chroms:
                    raise ValueError(
                        f"VCF order violation: contig {rec.chrom} re-entered after {lc}"
                    )
        self._last = (rec.chrom, rec.pos)
        qual = "." if rec.qual is None else ("%g" % rec.qual)
        fmt_keys = list(rec.fmt) or ["GT"]
        self._f.write(
            "\t".join(
                [
                    rec.chrom,
                    str(rec.pos),
                    rec.id,
                    rec.ref,
                    rec.alt,
                    qual,
                    rec.filter,
                    rec.info_str(),
                    ":".join(fmt_keys),
                    ":".join(str(rec.fmt.get(k, ".")) for k in fmt_keys),
                ]
            )
            + "\n"
        )

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_vcf(path: str) -> List[VcfRecord]:
    opener = gzip.open if path.endswith(".gz") else open
    out: List[VcfRecord] = []
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos, rid, ref, alt, qual, filt, info = fields[:8]
            info_d: Dict[str, object] = {}
            if info != ".":
                for item in info.split(";"):
                    if "=" in item:
                        k, v = item.split("=", 1)
                        info_d[k] = v
                    else:
                        info_d[item] = True
            fmt_d: Dict[str, object] = {}
            if len(fields) >= 10:
                for k, v in zip(fields[8].split(":"), fields[9].split(":")):
                    fmt_d[k] = v
            out.append(
                VcfRecord(
                    chrom=chrom,
                    pos=int(pos),
                    id=rid,
                    ref=ref,
                    alt=alt,
                    qual=None if qual == "." else float(qual),
                    filter=filt,
                    info=info_d,
                    fmt=fmt_d,
                )
            )
    return out
