"""FASTQ/FASTA ingestion (numpy and the native scanner, no torch).

Copy of ``biograph_tpu/io/fastq.py``.  ``read_fastq`` parses with the
native C++ scanner (``native/``) unless the caller asks for names or passes
``use_native=False``, the explicit numpy route.  One deliberate difference:
where the JAX package swallows any failure of the native path and parses
with numpy instead, this one raises when the scanner cannot be built.

Counterpart of the reference's read importer / fastq parser
(modules/build_seqset/read_importer.h:18, modules/bio_format/fastq.cpp).
Parsing is host-side but vectorized: the whole (decompressed) buffer is
scanned with numpy newline arithmetic — no per-read Python loop — and reads
are emitted as a padded [R, Lmax] uint8 code matrix + length vector, the
device-ready layout every downstream stage consumes.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from biograph_tpu_torch.core import dna


@dataclass
class ReadBatch:
    """A batch of reads as device-ready padded arrays."""

    codes: np.ndarray  # uint8 [R, Lmax], zero-padded
    lengths: np.ndarray  # int32 [R]
    quals: np.ndarray | None = None  # uint8 [R, Lmax] phred (0-padded), optional
    names: List[bytes] | None = None
    flags: np.ndarray | None = None  # int32 [R] SAM FLAG (BAM, SAM and CRAM input)

    @property
    def num_reads(self) -> int:
        return self.codes.shape[0]

    @property
    def max_len(self) -> int:
        return self.codes.shape[1]

    def sequence(self, i: int) -> str:
        return dna.codes_to_seq(self.codes[i, : self.lengths[i]])


def _read_maybe_gz(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.open(f).read()
        return f.read()


def _buf_maybe_gz(path: str):
    """File contents with no copy when possible: plain files mmap, gzipped
    files decompress (RAM)."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.open(f).read()
    if not os.path.getsize(path):
        return b""
    return np.memmap(path, np.uint8, "r")


def _split_lines(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Return (line_starts, line_ends) for every line in buf (no newlines)."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    nl = np.flatnonzero(arr == ord("\n"))
    if len(buf) and (len(nl) == 0 or nl[-1] != len(buf) - 1):
        nl = np.append(nl, len(buf))
    starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
    ends = nl.astype(np.int64)
    # strip \r
    has_cr = (ends > starts) & (arr[np.minimum(ends - 1, len(arr) - 1)] == ord("\r"))
    ends = ends - has_cr
    return starts, ends


def _gather_rows(
    arr: np.ndarray, starts: np.ndarray, ends: np.ndarray, pad_to: int | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather variable-length byte rows into a padded matrix."""
    lengths = (ends - starts).astype(np.int32)
    L = int(lengths.max(initial=0))
    if pad_to:
        L = max(L, pad_to)
    idx = starts[:, None] + np.arange(L)[None, :]
    valid = np.arange(L)[None, :] < lengths[:, None]
    rows = arr[np.minimum(idx, len(arr) - 1)]
    rows = np.where(valid, rows, 0).astype(np.uint8)
    return rows, lengths


def read_fastq(
    path: str,
    with_quals: bool = True,
    with_names: bool = False,
    use_native: bool = True,
    spill_dir: str | None = None,
) -> ReadBatch:
    """Parse a (possibly gzipped) FASTQ file into a ReadBatch.

    Uses the native C++ scanner (``biograph_tpu_torch.native``) unless names
    are wanted or ``use_native`` is False; a scanner that cannot be built
    raises.  spill_dir (native path) keeps the code/qual matrices on disk
    so WGS-scale imports stay within bounded host RAM; plain files are
    mmap'd, never copied.
    """
    native = use_native and not with_names
    buf = _buf_maybe_gz(path) if native else _read_maybe_gz(path)
    if native:
        from biograph_tpu_torch.native import fastq_scan_native

        try:
            codes, quals, lengths = fastq_scan_native(buf, with_quals=with_quals, spill_dir=spill_dir)
        except ValueError:
            raise ValueError(f"{path}: malformed FASTQ")
        nonblank = (
            bool(buf.strip())
            if isinstance(buf, bytes)
            else bool((~np.isin(buf, np.frombuffer(b" \t\r\n", np.uint8))).any())
        )
        if codes.shape[0] == 0 and nonblank:
            # non-empty file that parsed to zero reads = truncated record
            raise ValueError(f"{path}: malformed FASTQ (truncated record)")
        return ReadBatch(codes=codes, lengths=lengths, quals=quals)
    arr = np.frombuffer(buf, dtype=np.uint8)
    starts, ends = _split_lines(buf)
    n_lines = len(starts) - (1 if len(starts) and starts[-1] >= len(buf) else 0)
    if n_lines % 4:
        # Tolerate trailing blank lines
        while n_lines % 4 and starts[n_lines - 1] == ends[n_lines - 1]:
            n_lines -= 1
    if n_lines % 4:
        raise ValueError(f"{path}: FASTQ line count {n_lines} not divisible by 4")
    seq_rows, lengths = _gather_rows(
        arr, starts[1:n_lines:4], ends[1:n_lines:4]
    )
    codes = dna.encode_ascii(seq_rows)
    codes[seq_rows == 0] = 0
    quals = None
    if with_quals:
        qrows, qlens = _gather_rows(
            arr, starts[3:n_lines:4], ends[3:n_lines:4], pad_to=seq_rows.shape[1]
        )
        qraw = qrows[:, : seq_rows.shape[1]]
        # store phred (ASCII-33), matching the native scanner
        quals = np.where(qraw >= 33, qraw - 33, 0).astype(np.uint8)
    names = None
    if with_names:
        names = [
            bytes(arr[s + 1 : e]) for s, e in zip(starts[0:n_lines:4], ends[0:n_lines:4])
        ]
    return ReadBatch(codes=codes, lengths=lengths, quals=quals, names=names)


def read_fasta(path: str) -> List[Tuple[str, np.ndarray]]:
    """Parse a (possibly gzipped) FASTA file -> [(name, uint8 codes)].

    Ambiguous IUPAC codes map to 0 ('A'), N runs are preserved separately by
    callers that need them (see biograph_tpu.index.reference for scaffolds
    with N-gap extents).
    """
    buf = _read_maybe_gz(path)
    out: List[Tuple[str, np.ndarray]] = []
    name = None
    chunks: List[bytes] = []
    for line in buf.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                out.append((name, _fasta_codes(b"".join(chunks))))
            name = line[1:].split()[0].decode()
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        out.append((name, _fasta_codes(b"".join(chunks))))
    return out


def read_fasta_with_n(path: str) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """Like read_fasta but also returns an is_N bool mask per contig."""
    buf = _read_maybe_gz(path)
    out = []
    name = None
    chunks: List[bytes] = []

    def flush():
        if name is None:
            return
        raw = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        codes = dna.encode_ascii(raw)
        is_acgt = np.isin(raw, np.frombuffer(b"ACGTacgt", dtype=np.uint8))
        out.append((name, codes, ~is_acgt))

    for line in buf.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            flush()
            name = line[1:].split()[0].decode()
            chunks = []
        else:
            chunks.append(line)
    flush()
    return out


def _fasta_codes(seq: bytes) -> np.ndarray:
    return dna.encode_ascii(np.frombuffer(seq, dtype=np.uint8))


def sample_mask(n_reads: int, fraction: float) -> np.ndarray:
    """Deterministic read sampling (bool keep-mask).

    Analog of the reference importer's accumulator sampler
    (modules/biograph/biograph_create.cpp:125-128: accum starts at 0.5,
    += fraction per read, a read is taken each time it crosses 1):
    read i is kept iff floor(0.5 + f*(i+1)) > floor(0.5 + f*i)."""
    if not 0.0 < fraction < 1.0:
        raise ValueError("--sample-reads fraction must be in (0, 1)")
    i = np.arange(n_reads + 1, dtype=np.float64)
    marks = np.floor(0.5 + fraction * i)
    return (marks[1:] > marks[:-1])


def subset_batch(batch: ReadBatch, keep: np.ndarray) -> ReadBatch:
    """Row-subset a ReadBatch by a bool mask or index array."""
    names = None
    if batch.names is not None:
        idx = np.nonzero(keep)[0] if keep.dtype == bool else keep
        names = [batch.names[int(i)] for i in idx]
    return ReadBatch(
        codes=batch.codes[keep],
        lengths=batch.lengths[keep],
        quals=None if batch.quals is None else batch.quals[keep],
        names=names,
    )


def cut_reads(batch: ReadBatch, start: int, end: int) -> ReadBatch:
    """Keep only the start-th..end-th base (1-based, inclusive) of each read
    (analog of read_importer::set_cut_region,
    modules/build_seqset/read_importer.h:35).  Reads shorter than `start`
    become zero-length (they are dropped later like uncorrectable reads)."""
    if not (1 <= start < end):
        raise ValueError("--cut-reads wants START-END with 1 <= START < END")
    s, w = start - 1, end - start + 1
    R, L = batch.codes.shape
    new_len = np.clip(batch.lengths.astype(np.int64) - s, 0, w).astype(np.int32)
    wL = max(min(w, L - s), 1)
    take = batch.codes[:, s : s + wL] if s < L else np.zeros((R, 1), np.uint8)
    mask = np.arange(take.shape[1])[None, :] < new_len[:, None]
    quals = None
    if batch.quals is not None:
        tq = batch.quals[:, s : s + wL] if s < L else np.zeros((R, 1), np.uint8)
        quals = np.where(mask, tq, 0)
    return ReadBatch(
        codes=np.where(mask, take, 0),
        lengths=new_len,
        quals=quals,
        names=batch.names,
    )


def pad_batches(batches: List[ReadBatch]) -> ReadBatch:
    """Concatenate ReadBatches, padding to the widest."""
    L = max(b.max_len for b in batches)
    codes = np.concatenate(
        [np.pad(b.codes, ((0, 0), (0, L - b.max_len))) for b in batches]
    )
    lengths = np.concatenate([b.lengths for b in batches])
    quals = None
    if all(b.quals is not None for b in batches):
        quals = np.concatenate(
            [np.pad(b.quals, ((0, 0), (0, L - b.max_len))) for b in batches]
        )
    return ReadBatch(codes=codes, lengths=lengths, quals=quals)
