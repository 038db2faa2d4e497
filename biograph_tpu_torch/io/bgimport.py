"""Import the reference's .bg archives (spiral_file seqsets and readmaps).

Counterpart of ``biograph_tpu/io/bgimport.py``.  The reference's
spiral_file container (modules/io/spiral_file.h:29-120) is an
*uncompressed* ZIP whose members are mmap-ed directly; CRCs are not
maintained, so payloads are extracted via the local headers rather than
Python's zipfile reader.

Binary layouts (modules/io/):
  * bitcount bits: uint64 little-endian words, bit i = word[i/64] >> (i&63)
    (bitcount.h:213); their uint32 view is the seqset's ``prev_words``.
  * packed_varbit_vector: values bit-packed at start_bit = index *
    bits_per_value, little-endian across bytes
    (packed_varbit_vector.cpp:56-81); decoded on the host in numpy, which
    has the uint64 shifts torch lacks.
  * packed_vector<unsigned,1>: 1 bit an element, the same order.
  * sparse_multi: source_to_mid bitcount (source has >=1 dest) +
    dest_to_mid bitcount (dest is first of its group) (sparse_multi.h:20-45).

The members are parsed on the host; the seqset's exclusive prefix popcount
``prev_cum`` comes from ``ops/rank_cum.rank_cum`` on the importer's device
(the K4 kernel on the card, its plain version on the CPU), all four bases in
one call, and every tensor of the store lies on that device.  The .bg
readmap has no read ids: entry i is read i.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.ops.rank_cum import rank_cum


class SpiralZip:
    """Raw member extraction from an uncompressed (stored) ZIP, ignoring CRCs."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        self.members: Dict[str, tuple] = {}
        self._scan()

    def _scan(self):
        buf = self._buf
        pos = 0
        n = len(buf)
        while pos + 30 <= n and buf[pos : pos + 4] == b"PK\x03\x04":
            (_ver, flags, method, _t, _d, _crc, _csize, usize, name_len, extra_len) = struct.unpack_from(
                "<HHHHHIIIHH", buf, pos + 4
            )
            name = buf[pos + 30 : pos + 30 + name_len].decode()
            data_off = pos + 30 + name_len + extra_len
            if method != 0:
                raise ValueError(f"{self.path}:{name}: compressed member")
            if flags & 0x8 and usize == 0:
                # sizes in a data descriptor: spiral_file doesn't write these
                raise ValueError(f"{self.path}:{name}: streamed sizes")
            self.members[name] = (data_off, usize)
            pos = data_off + usize

    def read(self, name: str) -> bytes:
        off, size = self.members[name]
        return self._buf[off : off + size]

    def json(self, name: str):
        return json.loads(self.read(name).decode())

    def __contains__(self, name):
        return name in self.members


def decode_varbit(data: bytes, meta: dict) -> np.ndarray:
    """Decode a packed_varbit_vector elements buffer -> int64 [n]."""
    n = meta["element_count"]
    bits = meta["bits_per_value"]
    if n == 0:
        return np.zeros(0, np.int64)
    if bits == 0:
        return np.zeros(n, np.int64)
    arr = np.frombuffer(data, np.uint8)
    if bits % 8 == 0 and bits in (8, 16, 32, 64):
        dt = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[bits]
        return np.frombuffer(data, dt)[:n].astype(np.int64)
    # general bit-packed little-endian: read 8 bytes from start_bit//8, plus
    # an explicit 9th byte for fields crossing 64 bits from the start byte
    # (bits 58-63 with shift > 0; a shift of 64 would wrap to 0 in numpy)
    start_bits = np.arange(n, dtype=np.int64) * bits
    byte0 = start_bits >> 3
    shift = (start_bits & 7).astype(np.uint64)
    pad = np.zeros(len(arr) + 16, np.uint8)
    pad[: len(arr)] = arr
    low = np.zeros(n, np.uint64)
    for i in range(8):
        low |= pad[byte0 + i].astype(np.uint64) << np.uint64(8 * i)
    vals = low >> shift
    byte8 = pad[byte0 + 8].astype(np.uint64)
    # clamp the shift so the discarded (shift == 0) lanes never shift by 64
    hi_shift = np.uint64(64) - np.maximum(shift, np.uint64(1))
    hi = np.where(shift > 0, byte8 << hi_shift, np.uint64(0))
    vals |= hi
    vals &= np.uint64((1 << bits) - 1) if bits < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
    return vals.astype(np.int64)


def _bit_ones(bits_u32: np.ndarray, nbits: int) -> np.ndarray:
    """Positions of set bits (little-endian u32 words)."""
    exploded = np.unpackbits(bits_u32.view(np.uint8), bitorder="little")
    return np.nonzero(exploded[:nbits])[0].astype(np.int64)


def _tensor(arr, dtype, dev):
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(dev)


def import_bg_seqset(path: str, device="cuda"):
    """Open a reference spiral_file seqset as a port ``Seqset`` on
    ``device``."""
    from biograph_tpu_torch.index.seqset import Seqset

    dev = resolve_device(device)
    z = SpiralZip(path)
    meta = z.json("seqset.json")
    n = meta["num_entries"]
    fixed = np.frombuffer(z.read("fixed"), np.uint64).astype(np.int64)

    def int_array(name):
        # seqset v1.0 stores plain uint8 membufs; v1.1+ packed_varbit
        # subparts (seqset.cpp:58 detect_subpart_or_uint8_membuf)
        if f"{name}/elements" in z:
            return decode_varbit(
                z.read(f"{name}/elements"), z.json(f"{name}/packed_varbit_vector.json")
            ).astype(np.int32)
        return np.frombuffer(z.read(name), np.uint8).astype(np.int32)

    entry_sizes = int_array("entry_sizes")[:n]
    shared = int_array("shared")[:n]

    nw = n // 32 + 1
    prev_words = np.zeros((4, nw), np.uint32)
    pop_sel = np.zeros(n, np.int64)
    for bi, bname in enumerate("ACGT"):
        raw = np.frombuffer(z.read(f"prev_{bname}/bits"), np.uint32)
        w = prev_words[bi]
        w[: min(len(raw), nw)] = raw[:nw]
        if n % 32:  # mask the tail bits beyond n
            w[n // 32] &= np.uint32((1 << (n % 32)) - 1)
        ones = _bit_ones(w, n)
        lo, hi = int(fixed[bi]), int(fixed[bi + 1])
        if len(ones) != hi - lo:
            raise ValueError(f"{path}: prev_{bname} has {len(ones)} bits for block {hi-lo}")
        pop_sel[lo:hi] = ones
    words = _tensor(prev_words.view(np.int32), np.int32, dev)
    return Seqset(
        n_entries=n,
        max_entry_len=int(entry_sizes.max(initial=0)),
        fixed=_tensor(np.concatenate([fixed, [n]]) if len(fixed) == 4 else fixed, np.int64, dev),
        prev_words=words,
        prev_cum=rank_cum(words).to(torch.int64),
        entry_sizes=_tensor(entry_sizes, np.int32, dev),
        shared=_tensor(shared, np.int32, dev),
        pop_sel=_tensor(pop_sel, np.int64, dev),
    )


def import_bg_readmap(path: str, seqset, device="cuda"):
    """Open a reference spiral_file readmap against an imported seqset, as
    a port ``Readmap`` on ``device``."""
    from biograph_tpu_torch.convert import readmap_from_numpy

    z = SpiralZip(path)
    n_src = z.json("read_ids/source_to_mid/bitcount.json")["nbits"]
    n_dest = z.json("read_ids/dest_to_mid/bitcount.json")["nbits"]
    src_bits = np.frombuffer(z.read("read_ids/source_to_mid/bits"), np.uint32)
    dest_bits = np.frombuffer(z.read("read_ids/dest_to_mid/bits"), np.uint32)
    src_ones = _bit_ones(src_bits, n_src)  # sources with >=1 read
    dest_ones = _bit_ones(dest_bits, n_dest)  # first dest of each group
    if len(src_ones) != len(dest_ones):
        raise ValueError(f"{path}: sparse_multi group count mismatch")
    group_sizes = np.diff(np.concatenate([dest_ones, [n_dest]]))
    counts = np.zeros(n_src, np.int64)
    counts[src_ones] = group_sizes
    offsets = np.zeros(n_src + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    def int_array(name):
        # readmap v1.0: plain uint8 membuf (read_lengths) or packed_vector
        # (mate_loop_ptr, 32-bit); v1.1+: packed_varbit
        if f"{name}/elements" in z:
            return decode_varbit(z.read(f"{name}/elements"), z.json(f"{name}/packed_varbit_vector.json"))
        if f"{name}/packed_data" in z:
            bits = z.json(f"{name}/packed_vector.json").get("value_width_bits", 32)
            data = z.read(f"{name}/packed_data")
            if bits == 32:
                return np.frombuffer(data, np.uint32).astype(np.int64)
            if bits == 1:
                return np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little").astype(np.int64)
            raise ValueError(f"{path}:{name}: packed_vector bits={bits}")
        return np.frombuffer(z.read(name), np.uint8).astype(np.int64)

    read_lengths = int_array("read_lengths")[:n_dest]
    mate_loop = int_array("mate_loop_ptr")[:n_dest]
    isfwd_bits = np.frombuffer(z.read("is_forward/packed_data"), np.uint8)
    is_forward = np.unpackbits(isfwd_bits, bitorder="little")[:n_dest].astype(bool)
    arrays = dict(offsets=offsets, read_lengths=read_lengths, is_forward=is_forward, mate_pair_ptr=mate_loop,
                  read_ids=np.arange(n_dest, dtype=np.int64))
    return readmap_from_numpy(arrays, seqset, device)


def open_bg_dir(path: str, device="cuda"):
    """Open a reference .bg directory -> (Seqset, Readmap | None, metadata)
    with the store's tensors on ``device``."""
    dev = resolve_device(device)
    ss = import_bg_seqset(os.path.join(path, "seqset"), dev)
    rm = None
    cov_dir = os.path.join(path, "coverage")
    if os.path.isdir(cov_dir):
        rms = [f for f in os.listdir(cov_dir) if f.endswith(".readmap")]
        if rms:
            rm = import_bg_readmap(os.path.join(cov_dir, rms[0]), ss, dev)
    meta = {}
    mpath = os.path.join(path, "metadata", "bg_info.json")
    if os.path.isfile(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    return ss, rm, meta
