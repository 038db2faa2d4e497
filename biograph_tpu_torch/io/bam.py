"""SAM/BAM read import (no htslib; numpy and the native scanner, no torch).

Counterpart of ``biograph_tpu/io/bam.py`` (the reference's BAM ingestion,
modules/build_seqset/read_importer.cpp:543 via htslib sam_read1).  BAM is
BGZF (concatenated gzip members) over a simple binary record format.  The
port takes the route the JAX package takes on any host with ``g++``: the
blocks inflate in parallel (``native.bgzf_decompress_native``) and the
native record scanner walks the records, so a missing quality (0xFF) reads
as 0.  A member without the BGZF 'BC' subfield (plain gzip) is read by the
serial walk, ``_bgzf_decompress``, as in the JAX package.  Where the JAX
package falls back to serial zlib and to a Python record loop on any
failure, this one raises: a failed build, a corrupt or truncated block.

Emits the same ReadBatch as the FASTQ importer, with ``flags``, and pairing
derived from FLAG bits and read names.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.fastq import ReadBatch


def _bgzf_bsize(view, pos: int) -> int:
    """Total size of the BGZF member at pos via its 'BC' extra subfield;
    -1 when the member is plain gzip (no FEXTRA/BC)."""
    if not (view[pos + 3] & 4):
        return -1
    xlen = view[pos + 10] | (view[pos + 11] << 8)
    q, xend = pos + 12, pos + 12 + xlen
    while q + 4 <= xend:
        slen = view[q + 2] | (view[q + 3] << 8)
        if view[q] == 0x42 and view[q + 1] == 0x43 and slen == 2:
            return (view[q + 4] | (view[q + 5] << 8)) + 1
        q += 4 + slen
    return -1


def _bgzf_decompress(buf) -> bytes:
    """Decompress all BGZF/gzip members, one after another.

    BGZF members are walked by their 'BC' size field so each inflate sees
    only its own block; plain-gzip members take a decompressobj.  A member
    that ends before its deflate stream does raises (the JAX walk returns
    what it inflated)."""
    data = bytes(buf) if not isinstance(buf, bytes) else buf
    view = memoryview(data)
    out = []
    pos = 0
    n = len(view)
    while pos + 18 <= n:
        if view[pos] != 0x1F or view[pos + 1] != 0x8B:
            break
        bsize = _bgzf_bsize(view, pos)
        if 0 < bsize <= n - pos:
            try:
                out.append(zlib.decompress(view[pos : pos + bsize], wbits=31))
            except zlib.error as e:
                raise ValueError(f"gzip member at byte {pos} is corrupt: {e}") from e
            pos += bsize
            continue
        d = zlib.decompressobj(wbits=31)
        try:
            out.append(d.decompress(view[pos:]))
        except zlib.error as e:
            raise ValueError(f"gzip member at byte {pos} is corrupt: {e}") from e
        if not d.eof:
            raise ValueError(f"gzip member at byte {pos} is truncated")
        consumed = n - pos - len(d.unused_data)
        pos += consumed
        if consumed <= 0:
            break
    return b"".join(out)


def _load_decompressed(path: str, spill_dir: str | None = None):
    """mmap the file and BGZF-decompress it: in parallel when every member
    is BGZF, else by the serial walk.  Returns a buffer supporting
    slicing/frombuffer; with spill_dir the parallel route's stream lives on
    disk, not in RAM."""
    from biograph_tpu_torch.native import bgzf_decompress_native

    raw = np.memmap(path, np.uint8, "r") if os.path.getsize(path) else b""
    out = bgzf_decompress_native(raw, spill_dir=spill_dir)
    return out if out is not None else _bgzf_decompress(raw)


def _header_refs(data, off: int):
    """The reference list after the header text: ([(name, length)], offset
    of the first alignment record)."""
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        refs.append(
            (
                bytes(data[off + 4 : off + 4 + l_name - 1]).decode(),
                struct.unpack_from("<i", data, off + 4 + l_name)[0],
            )
        )
        off += 8 + l_name
    return refs, off


def read_bam(
    path: str, with_names: bool = True, keep_unmapped: bool = True, spill_dir: str | None = None
) -> Tuple[ReadBatch, dict]:
    """Parse a BAM file -> (ReadBatch with ``flags``, {"refs", "flags"}).

    Reverse-strand alignments are flipped back to original read orientation
    (matching the reference importer, read_importer.cpp BAM path);
    secondary and supplementary records are dropped, unmapped ones kept
    unless keep_unmapped is False.  spill_dir keeps the decompressed stream
    and the code/qual matrices on disk (memmap)."""
    from biograph_tpu_torch.native import bam_scan_native

    data = _load_decompressed(path, spill_dir)
    if bytes(data[:4]) != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    refs, off = _header_refs(data, 8 + l_text)
    codes, quals, lengths, flags, names = bam_scan_native(data[off:], keep_unmapped, spill_dir=spill_dir)
    batch = ReadBatch(
        codes=codes, lengths=lengths, quals=quals, names=names if with_names else None,
        flags=np.asarray(flags, np.int32),
    )
    return batch, {"refs": refs, "flags": flags}


def read_sam(path: str, with_names: bool = True) -> Tuple[ReadBatch, dict]:
    """Parse a SAM text file -> (ReadBatch with ``flags``, {"refs"})."""
    seqs, quals, names, flags = [], [], [], []
    refs = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                if line.startswith(b"@SQ"):
                    d = dict(kv.split(b":", 1) for kv in line.split(b"\t")[1:] if b":" in kv)
                    refs.append((d.get(b"SN", b"?").decode(), int(d.get(b"LN", b"0"))))
                continue
            fields = line.rstrip(b"\n").split(b"\t")
            if len(fields) < 11:
                continue
            flag = int(fields[1])
            if flag & 0x100 or flag & 0x800:
                continue
            seq = fields[9]
            if seq == b"*":
                continue
            codes = dna.encode_ascii(np.frombuffer(seq, np.uint8))
            q = np.frombuffer(fields[10], np.uint8) - 33 if fields[10] != b"*" else np.zeros(len(seq), np.uint8)
            if flag & 0x10:
                codes = (3 - codes[::-1]).astype(np.uint8)
                q = q[::-1].copy()
            seqs.append(codes)
            quals.append(q)
            names.append(bytes(fields[0]))
            flags.append(flag)
    return _to_batch(seqs, quals, names if with_names else None, flags), {"refs": refs}


def _to_batch(seqs, quals, names, flags) -> ReadBatch:
    if not seqs:
        return ReadBatch(codes=np.zeros((0, 0), np.uint8), lengths=np.zeros(0, np.int32))
    L = max(len(s) for s in seqs)
    codes = np.zeros((len(seqs), L), np.uint8)
    qarr = np.zeros((len(seqs), L), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        codes[i, : len(s)] = s
        qarr[i, : len(q)] = q
        lens[i] = len(s)
    return ReadBatch(codes=codes, lengths=lens, quals=qarr, names=names, flags=np.asarray(flags, np.int32))


def mate_pairs_from_names(names: List[bytes], flags: np.ndarray) -> np.ndarray:
    """Pair reads by name + FLAG paired bit -> mate_of array."""
    mate_of = np.full(len(names), -1, np.int64)
    first: dict = {}
    for i, nm in enumerate(names):
        if not flags[i] & 0x1:
            continue
        if nm in first:
            j = first.pop(nm)
            mate_of[i] = j
            mate_of[j] = i
        else:
            first[nm] = i
    return mate_of
