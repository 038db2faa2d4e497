"""BWA .pac/.ann/.amb reader (numpy, no torch): the import path for
reference dirs that ship BWA indexes instead of raw FASTA.

Copy of ``biograph_tpu/io/pac.py``.  pac format: 4 bases a byte, base i =
(pac[i>>2] >> ((3-(i&3))*2)) & 3 with A=0 C=1 G=2 T=3; the final byte
stores len%4.  .ann lists contigs with offsets; .amb lists ambiguous-base
holes (restored as N).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def read_pac(pac_path: str, total_len: int) -> np.ndarray:
    raw = np.fromfile(pac_path, dtype=np.uint8)
    # last byte is the len % 4 marker; data bytes = ceil(total_len/4)
    data = raw[: (total_len + 3) // 4]
    shifts = np.array([6, 4, 2, 0], np.uint8)
    codes = ((data[:, None] >> shifts[None, :]) & 3).reshape(-1)
    return codes[:total_len].astype(np.uint8)


def read_ann(ann_path: str) -> Tuple[int, List[Tuple[str, int, int]]]:
    """Returns (total_len, [(name, offset, length)])."""
    with open(ann_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    total_len, n_seqs, _seed = (int(x) for x in lines[0].split()[:3])
    contigs = []
    idx = 1
    for _ in range(n_seqs):
        name = lines[idx].split()[1]
        off, length = (int(x) for x in lines[idx + 1].split()[:2])
        contigs.append((name, off, length))
        idx += 2
    return total_len, contigs


def read_amb(amb_path: str) -> List[Tuple[int, int]]:
    """Returns [(offset, length)] ambiguous holes ([] without the file)."""
    if not os.path.isfile(amb_path):
        return []
    with open(amb_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n_holes = int(lines[0].split()[2])
    holes = []
    for ln in lines[1 : 1 + n_holes]:
        parts = ln.split()
        holes.append((int(parts[0]), int(parts[1])))
    return holes
