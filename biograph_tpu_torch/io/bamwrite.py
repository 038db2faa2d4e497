"""SAM/BAM writing (BGZF deflate + binary BAM records; no torch).

Counterpart of ``biograph_tpu/io/bamwrite.py``: BGZF blocks are gzip
members with the BC/BSIZE extra subfield (SAMv1 spec §4.1), records are the
standard binary layout (refID/pos/bin/flag/cigar/4-bit seq/qual/tags).  At
the same zlib level its bytes equal the JAX writer's, header lines
included; the 4-bit packing and the qualities go through byte tables
instead of a loop a base.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OPS = "MIDNSHP=X"
# byte -> 4-bit code, the JAX writer's ``_SEQ_NIBBLE.get(chr(b).upper(), 15)``
_NIB_OF_BYTE = bytes(_SEQ_NIBBLE.get(chr(b).upper(), 15) for b in range(256))
# printable quality byte -> phred, capped at 93 (bytes below '!' never reach it)
_QUAL_OF_BYTE = bytes(min(max(b - 33, 0), 93) for b in range(256))


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str  # "*" = unmapped
    pos: int  # 1-based; 0 = unmapped
    mapq: int
    cigar: List[Tuple[int, str]]  # [(length, op)]
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: dict = field(default_factory=dict)  # {"NM": 2, "RG": "x"}

    def cigar_str(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.cigar) if self.cigar else "*"


def _tag_sam(k, v):
    if isinstance(v, int):
        return f"{k}:i:{v}"
    if isinstance(v, float):
        return f"{k}:f:{v}"
    return f"{k}:Z:{v}"


def _header_text(refs, extra_header) -> str:
    text = "@HD\tVN:1.6\tSO:coordinate\n"
    for name, ln in refs:
        text += f"@SQ\tSN:{name}\tLN:{ln}\n"
    for h in extra_header:
        text += h.rstrip("\n") + "\n"
    # the program line names the JAX package, so both writers' files are
    # byte-identical
    return text + "@PG\tID:biograph_tpu\tPN:biograph_tpu\n"


def write_sam(path: str, refs: List[Tuple[str, int]], records, extra_header=()):
    """Plain-text SAM.  Returns the number of records written."""
    n = 0
    with open(path, "w") as f:
        f.write(_header_text(refs, extra_header))
        for r in records:
            cols = [
                r.qname, str(r.flag), r.rname, str(r.pos), str(r.mapq),
                r.cigar_str(), r.rnext, str(r.pnext), str(r.tlen), r.seq,
                r.qual,
            ] + [_tag_sam(k, v) for k, v in r.tags.items()]
            f.write("\t".join(cols) + "\n")
            n += 1
    return n


# ---------------- BGZF ----------------

_BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
BGZF_MAX = 65280  # payload bytes a block


def bgzf_write_blocks(f, payload: bytes, level: int = 6):
    """Write ``payload`` as BGZF blocks (gzip members with BSIZE extra)."""
    for lo in range(0, len(payload), BGZF_MAX):
        chunk = payload[lo : lo + BGZF_MAX]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        data = co.compress(chunk) + co.flush()
        bsize = len(data) + 25  # header(12)+XLEN(6)+data+crc(4)+isize(4) - 1
        f.write(
            struct.pack(
                "<BBBBIBBHBBHH",
                0x1F, 0x8B, 8, 4,  # magic, CM=deflate, FLG=FEXTRA
                0, 0, 255,  # MTIME, XFL, OS
                6,  # XLEN
                0x42, 0x43, 2,  # 'B','C', SLEN
                bsize,
            )
        )
        f.write(data)
        f.write(struct.pack("<II", zlib.crc32(chunk), len(chunk)))


def _reg2bin(beg: int, end: int) -> int:
    """SAMv1 §5.3 region->bin."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _tag_bam(k: str, v) -> bytes:
    kb = k.encode()[:2]
    if isinstance(v, int):
        return kb + b"i" + struct.pack("<i", v)
    if isinstance(v, float):
        return kb + b"f" + struct.pack("<f", v)
    s = str(v).encode()
    return kb + b"Z" + s + b"\0"


def _pack_seq(seq: bytes) -> bytes:
    """4-bit codes, two a byte, the first in the high nibble."""
    nib = np.frombuffer(seq.translate(_NIB_OF_BYTE), np.uint8)
    if len(nib) % 2:
        nib = np.append(nib, np.uint8(0))
    return ((nib[0::2] << 4) | nib[1::2]).tobytes()


def _qual_bytes(qual: str) -> bytes:
    if qual.isascii() and min(qual, default="!") >= "!":
        return qual.encode().translate(_QUAL_OF_BYTE)
    return bytes(min(ord(c) - 33, 93) for c in qual)  # raises below '!', as the JAX writer does


def _encode_record(r: SamRecord, ref_ids: dict) -> bytes:
    refid = ref_ids.get(r.rname, -1)
    pos0 = r.pos - 1
    name = r.qname.encode() + b"\0"
    cigar = b"".join(struct.pack("<I", (n << 4) | _CIGAR_OPS.index(op)) for n, op in r.cigar)
    seq = b"" if r.seq == "*" else r.seq.encode()
    l_seq = len(seq)
    if r.qual == "*" or not l_seq:
        qual = b"\xff" * l_seq
    else:
        qual = _qual_bytes(r.qual)
    tags = b"".join(_tag_bam(k, v) for k, v in r.tags.items())
    span = sum(n for n, op in r.cigar if op in "MDN=X") or 1
    body = struct.pack(
        "<iiBBHHHiiii",
        refid,
        pos0,
        len(name),
        r.mapq,
        _reg2bin(max(pos0, 0), max(pos0, 0) + span),
        len(r.cigar),
        r.flag,
        l_seq,
        ref_ids.get(r.rnext if r.rnext != "=" else r.rname, -1),
        r.pnext - 1,
        r.tlen,
    ) + name + cigar + _pack_seq(seq) + qual + tags
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, refs: List[Tuple[str, int]], records, extra_header=()):
    """Binary BAM with BGZF framing, readable by ``io/bam.py`` and
    samtools.  Returns the number of records written."""
    ht = _header_text(refs, extra_header).encode()
    payload = bytearray()
    payload += b"BAM\x01"
    payload += struct.pack("<i", len(ht)) + ht
    payload += struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode() + b"\0"
        payload += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    ref_ids = {name: i for i, (name, _) in enumerate(refs)}
    n = 0
    for r in records:
        payload += _encode_record(r, ref_ids)
        n += 1
    with open(path, "wb") as f:
        bgzf_write_blocks(f, bytes(payload))
        f.write(_BGZF_EOF)
    return n
