"""QSEQ (Illumina GAPipeline) import (numpy, no torch).

Copy of ``biograph_tpu/io/qseq.py`` (the reference's qseq importer,
modules/bio_format/qseq.cpp): tab-separated lines, 11 columns — machine,
run, lane, tile, x, y, index, read number, SEQUENCE, QUALITY (phred+64),
filter flag.  '.' in the sequence means N.
"""

from __future__ import annotations

import bz2

import numpy as np

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.fastq import ReadBatch, _read_maybe_gz


def read_qseq(path: str) -> ReadBatch:
    """Parse a (possibly gzip/bzip2 compressed) QSEQ file.

    Matches the reference importer's rules (qseq.cpp): seq = column 9,
    qual = column 10 (phred+64); '.' and any base whose quality is 'B'
    become N; leading/trailing N runs are trimmed off the read."""
    buf = _read_maybe_gz(path)
    if buf[:3] == b"BZh":
        buf = bz2.decompress(buf)
    seqs = []
    quals = []
    for lineno, line in enumerate(buf.split(b"\n"), 1):
        if not line.strip():
            continue
        cols = line.rstrip(b"\r").split(b"\t")
        if len(cols) < 10:
            raise ValueError(f"{path}:{lineno}: QSEQ needs >=10 columns")
        seq = bytearray(cols[8])
        qual = bytearray(cols[9])
        if len(seq) != len(qual):
            raise ValueError(f"{path}:{lineno}: seq/qual length mismatch")
        for i in range(len(seq)):
            if seq[i] == ord(".") or qual[i] == ord("B"):
                seq[i] = ord("N")
            if qual[i] < 64:
                raise ValueError(f"{path}:{lineno}: quality below phred+64")
        # trim leading/trailing N runs (the reference keeps first..last)
        non_n = np.nonzero(np.frombuffer(bytes(seq), np.uint8) != ord("N"))[0]
        if len(non_n) == 0:
            continue
        a, b = int(non_n[0]), int(non_n[-1]) + 1
        seqs.append(bytes(seq[a:b]))
        quals.append(bytes(qual[a:b]))
    R = len(seqs)
    L = max((len(s) for s in seqs), default=1)
    codes = np.zeros((R, L), np.uint8)
    qmat = np.zeros((R, L), np.uint8)
    lengths = np.zeros(R, np.int32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        arr = np.frombuffer(s, np.uint8)
        codes[i, : len(arr)] = dna.encode_ascii(arr)
        qa = np.frombuffer(q, np.uint8)
        qmat[i, : len(qa)] = qa - 64  # store phred
        lengths[i] = len(arr)
    return ReadBatch(codes=codes, lengths=lengths, quals=qmat)
