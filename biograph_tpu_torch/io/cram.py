"""CRAM 3.0 import: a decoder from scratch, no htslib (host Python and
numpy, no torch).

Copy of ``biograph_tpu/io/cram.py`` (the reference's CRAM path,
modules/build_seqset/read_importer.cpp:543 via htslib sam_read1).  It
implements the subset of the CRAM 3.0 specification that
reference-compressed files produced by samtools/htslib use: ITF8/LTF8
varints, raw, gzip, bzip2, lzma and rANS-4x8 (order 0 and 1) blocks,
EXTERNAL / constant-HUFFMAN / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP encodings,
and the standard record series (read features rebuild mapped bases against
the supplied reference).  Core-bitstream codecs (beta/gamma/subexp,
non-trivial huffman) and any other block method raise.  The rANS decoder
is a host loop a symbol.
"""

from __future__ import annotations

import bz2
import lzma
import struct
import zlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.fastq import ReadBatch


# ---------------------------------------------------------------- varints


def _itf8(b, p):
    v0 = b[p]
    if v0 < 0x80:
        return v0, p + 1
    if v0 < 0xC0:
        return ((v0 & 0x7F) << 8) | b[p + 1], p + 2
    if v0 < 0xE0:
        return ((v0 & 0x3F) << 16) | (b[p + 1] << 8) | b[p + 2], p + 3
    if v0 < 0xF0:
        return (
            ((v0 & 0x1F) << 24) | (b[p + 1] << 16) | (b[p + 2] << 8) | b[p + 3],
            p + 4,
        )
    v = (
        ((v0 & 0x0F) << 28)
        | (b[p + 1] << 20)
        | (b[p + 2] << 12)
        | (b[p + 3] << 4)
        | (b[p + 4] & 0x0F)
    )
    return v, p + 5


def _itf8_signed(b, p):
    v, p = _itf8(b, p)
    if v >= (1 << 31):
        v -= 1 << 32
    return v, p


def _ltf8(b, p):
    v0 = b[p]
    n = 0
    while n < 8 and (v0 << n) & 0x80:
        n += 1
    if n == 0:
        return v0, p + 1
    v = v0 & (0xFF >> (n + 1)) if n < 8 else 0
    for i in range(n):
        v = (v << 8) | b[p + 1 + i]
    return v, p + 1 + n


# ---------------------------------------------------------------- rANS 4x8

_TF = 4096  # 12-bit normalized frequencies


def _rans_freqs(b, p):
    """RLE frequency table -> (F[256], p) (htslib rans_static 4x8 layout)."""
    F = np.zeros(256, np.int64)
    sym = b[p]
    p += 1
    rle = 0
    while True:
        f = b[p]
        p += 1
        if f >= 128:
            f = ((f & 127) << 8) | b[p]
            p += 1
        F[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        elif b[p] == (sym + 1) & 0xFF:
            sym = b[p]
            p += 1
            rle = b[p]
            p += 1
        else:
            sym = b[p]
            p += 1
            if sym == 0:
                break
    return F, p


def _rans_tables(F):
    C = np.zeros(257, np.int64)
    C[1:] = np.cumsum(F)
    lookup = np.zeros(_TF, np.uint8)
    for s in range(256):
        if F[s]:
            lookup[C[s] : C[s + 1]] = s
    return C, lookup


def _rans_decode(data: bytes, raw_size: int) -> bytes:
    order = data[0]
    n_in, n_out = struct.unpack("<ii", data[1:9])
    p = 9
    if order == 0:
        F, p = _rans_freqs(data, p)
        C, lookup = _rans_tables(F)
        R = list(struct.unpack("<4I", data[p : p + 16]))
        p += 16
        out = bytearray(n_out)
        for i in range(n_out):
            j = i & 3
            m = R[j] & (_TF - 1)
            s = lookup[m]
            out[i] = s
            R[j] = int(F[s]) * (R[j] >> 12) + m - int(C[s])
            while R[j] < (1 << 23) and p < len(data):
                R[j] = (R[j] << 8) | data[p]
                p += 1
        return bytes(out)
    if order == 1:
        Fs = {}
        Cs = {}
        Ls = {}
        ctx = data[p]
        p += 1
        rle = 0
        while True:
            F, p = _rans_freqs(data, p)
            Cs[ctx], Ls[ctx] = _rans_tables(F)
            Fs[ctx] = F
            if rle > 0:
                rle -= 1
                ctx += 1
            elif data[p] == (ctx + 1) & 0xFF:
                ctx = data[p]
                p += 1
                rle = data[p]
                p += 1
            else:
                ctx = data[p]
                p += 1
                if ctx == 0:
                    break
        R = list(struct.unpack("<4I", data[p : p + 16]))
        p += 16
        out = bytearray(n_out)
        isz4 = n_out >> 2
        L = [0, 0, 0, 0]  # last byte (context) per stream
        i0, i1, i2, i3 = 0, isz4, 2 * isz4, 3 * isz4
        for _ in range(isz4):
            for j, idx in enumerate((i0, i1, i2, i3)):
                c = L[j]
                m = R[j] & (_TF - 1)
                s = Ls[c][m] if c in Ls else 0
                out[idx] = s
                R[j] = int(Fs[c][s]) * (R[j] >> 12) + m - int(Cs[c][s])
                while R[j] < (1 << 23) and p < len(data):
                    R[j] = (R[j] << 8) | data[p]
                    p += 1
                L[j] = s
            i0 += 1
            i1 += 1
            i2 += 1
            i3 += 1
        # remainder decoded by stream 3
        for idx in range(4 * isz4, n_out):
            c = L[3]
            m = R[3] & (_TF - 1)
            s = Ls[c][m] if c in Ls else 0
            out[idx] = s
            R[3] = int(Fs[c][s]) * (R[3] >> 12) + m - int(Cs[c][s])
            while R[3] < (1 << 23) and p < len(data):
                R[3] = (R[3] << 8) | data[p]
                p += 1
            L[3] = s
        return bytes(out)
    raise ValueError(f"rANS order {order} unsupported")


# ---------------------------------------------------------------- blocks


def _read_block(buf, p):
    method = buf[p]
    ctype = buf[p + 1]
    q = p + 2
    cid, q = _itf8_signed(buf, q)
    csize, q = _itf8(buf, q)
    rsize, q = _itf8(buf, q)
    data = buf[q : q + csize]
    q += csize + 4  # + CRC32
    if method == 0:
        raw = bytes(data)
    elif method == 1:
        raw = zlib.decompress(data, 31)
    elif method == 2:
        raw = bz2.decompress(data)
    elif method == 3:
        raw = lzma.decompress(data)
    elif method == 4:
        raw = _rans_decode(data, rsize)
    else:
        raise ValueError(f"CRAM block method {method} unsupported")
    if len(raw) != rsize:
        raise ValueError(f"block decode size {len(raw)} != {rsize}")
    return dict(method=method, ctype=ctype, cid=cid, data=raw), q


# ---------------------------------------------------------------- encodings


@dataclass
class _Enc:
    codec: int
    params: bytes
    # parsed fields
    cid: int = -1
    const: int | None = None
    stop: int = 0
    len_enc: "_Enc" = None
    val_enc: "_Enc" = None

    @staticmethod
    def parse(codec: int, params: bytes) -> "_Enc":
        e = _Enc(codec=codec, params=params)
        p = 0
        if codec == 0:  # NULL
            pass
        elif codec == 1:  # EXTERNAL
            e.cid, p = _itf8(params, p)
        elif codec == 3:  # HUFFMAN — only the 0-bit constant form
            nalpha, p = _itf8(params, p)
            syms = []
            for _ in range(nalpha):
                v, p = _itf8_signed(params, p)
                syms.append(v)
            nlen, p = _itf8(params, p)
            lens = []
            for _ in range(nlen):
                v, p = _itf8(params, p)
                lens.append(v)
            if nalpha == 1 and (not lens or lens[0] == 0):
                e.const = syms[0]
            else:
                raise ValueError("non-constant HUFFMAN needs a core bitstream")
        elif codec == 4:  # BYTE_ARRAY_LEN
            lc, p = _itf8(params, p)
            ll, p = _itf8(params, p)
            e.len_enc = _Enc.parse(lc, params[p : p + ll])
            p += ll
            vc, p = _itf8(params, p)
            vl, p = _itf8(params, p)
            e.val_enc = _Enc.parse(vc, params[p : p + vl])
        elif codec == 5:  # BYTE_ARRAY_STOP
            e.stop = params[0]
            e.cid, p = _itf8(params, 1)
        else:
            raise ValueError(f"CRAM encoding codec {codec} unsupported")
        return e


class _Streams:
    """External block byte streams with per-cid cursors."""

    def __init__(self, blocks):
        self.data = {b["cid"]: b["data"] for b in blocks if b["ctype"] == 4}
        self.pos = {cid: 0 for cid in self.data}

    def read_itf8(self, cid):
        v, self.pos[cid] = _itf8_signed(self.data[cid], self.pos[cid])
        return v

    def read_byte(self, cid):
        v = self.data[cid][self.pos[cid]]
        self.pos[cid] += 1
        return v

    def read_bytes(self, cid, n):
        p = self.pos[cid]
        self.pos[cid] = p + n
        return self.data[cid][p : p + n]

    def read_until(self, cid, stop):
        d = self.data[cid]
        p = self.pos[cid]
        q = d.index(bytes([stop]), p)
        self.pos[cid] = q + 1
        return d[p:q]


def _read_int(enc: _Enc, streams: _Streams) -> int:
    if enc.const is not None:
        return enc.const
    if enc.codec == 1:
        return streams.read_itf8(enc.cid)
    raise ValueError(f"int read from codec {enc.codec}")


def _read_byte_val(enc: _Enc, streams: _Streams) -> int:
    if enc.const is not None:
        return enc.const
    if enc.codec == 1:
        return streams.read_byte(enc.cid)
    raise ValueError(f"byte read from codec {enc.codec}")


def _read_array(enc: _Enc, streams: _Streams, n: int | None = None) -> bytes:
    if enc.codec == 5:
        return streams.read_until(enc.cid, enc.stop)
    if enc.codec == 4:
        ln = _read_int(enc.len_enc, streams)
        return _read_bytes_val(enc.val_enc, streams, ln)
    if enc.codec == 1 and n is not None:
        return streams.read_bytes(enc.cid, n)
    raise ValueError(f"array read from codec {enc.codec}")


def _read_bytes_val(enc: _Enc, streams: _Streams, n: int) -> bytes:
    if enc.codec == 1:
        return streams.read_bytes(enc.cid, n)
    raise ValueError(f"bytes read from codec {enc.codec}")


# ---------------------------------------------------------------- decoder

_SUB_BASES = {  # substitution targets per reference base, rank order
    0: b"CGTN",  # A
    1: b"AGTN",  # C
    2: b"ACTN",  # G
    3: b"ACGN",  # T
    4: b"ACGT",  # N
}
_B2I = {65: 0, 67: 1, 71: 2, 84: 3, 78: 4}


@dataclass
class CramRecord:
    name: bytes
    flags: int
    ref_id: int
    pos: int  # 1-based leftmost mapped position (0 if unmapped)
    seq: bytes  # ASCII bases
    qual: bytes  # phred values


def read_cram(path: str, ref_codes: np.ndarray | None = None, contigs=None):
    """Decode a CRAM file -> (records, sam_header_text).

    ref_codes: the flat reference genome (uint8 base codes) the file was
    compressed against (required when any container holds mapped reads);
    contigs: [(name, flat_start)] of that flat genome — @SQ entries in the
    file header map onto it by name so multi-contig references offset
    correctly."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"CRAM":
        raise ValueError(f"{path}: not a CRAM file")
    if buf[4] != 3:
        raise ValueError(f"{path}: CRAM major version {buf[4]} unsupported")
    pos = 26
    header_text = ""
    records: List[CramRecord] = []
    ref_ascii = (
        dna.decode_to_ascii(np.asarray(ref_codes)).tobytes()
        if ref_codes is not None
        else None
    )
    ref_offsets: List[int] = []  # flat start per @SQ refid, header order
    while pos < len(buf):
        length = struct.unpack("<i", buf[pos : pos + 4])[0]
        p = pos + 4
        c_refid, p = _itf8_signed(buf, p)
        c_start, p = _itf8(buf, p)
        c_span, p = _itf8(buf, p)
        c_nrec, p = _itf8(buf, p)
        _, p = _ltf8(buf, p)
        _, p = _ltf8(buf, p)
        c_nblocks, p = _itf8(buf, p)
        nland, p = _itf8(buf, p)
        for _ in range(nland):
            _, p = _itf8(buf, p)
        p += 4  # crc
        body_end = p + length
        if c_nrec == 0 and not header_text:
            blk, _ = _read_block(buf, p)
            if blk["ctype"] == 0:
                (hlen,) = struct.unpack("<i", blk["data"][:4])
                header_text = blk["data"][4 : 4 + hlen].decode(
                    "ascii", "replace"
                )
                by_name = dict(contigs or [])
                for line in header_text.splitlines():
                    if line.startswith("@SQ"):
                        name = ""
                        for f in line.split("\t"):
                            if f.startswith("SN:"):
                                name = f[3:]
                        ref_offsets.append(by_name.get(name, 0))
            pos = body_end
            continue
        if c_nrec == 0:  # EOF container
            pos = body_end
            continue
        # data container: compression header + slices
        blocks = []
        q = p
        for _ in range(c_nblocks):
            blk, q = _read_block(buf, q)
            blocks.append(blk)
        comp = _parse_compression_header(blocks[0]["data"])
        # slices: each starts with a ctype==2 block
        i = 1
        while i < len(blocks):
            if blocks[i]["ctype"] != 2:
                i += 1
                continue
            sh = _parse_slice_header(blocks[i]["data"])
            slice_blocks = blocks[i + 1 : i + 1 + sh["nblocks"]]
            records.extend(
                _decode_slice(comp, sh, slice_blocks, ref_ascii, ref_offsets)
            )
            i += 1 + sh["nblocks"]
        pos = body_end
    return records, header_text


def _parse_compression_header(d: bytes):
    dp = 0
    _, dp = _itf8(d, dp)
    nkeys, dp = _itf8(d, dp)
    pres = {"RN": 1, "AP": 0, "RR": 1, "SM": b"\x1b" * 5, "TD": b"\x00"}
    for _ in range(nkeys):
        key = d[dp : dp + 2].decode()
        dp += 2
        if key in ("RN", "AP", "RR"):
            pres[key] = d[dp]
            dp += 1
        elif key == "SM":
            pres[key] = d[dp : dp + 5]
            dp += 5
        elif key == "TD":
            tl, dp = _itf8(d, dp)
            pres[key] = d[dp : dp + tl]
            dp += tl
        else:
            raise ValueError(f"preservation key {key}")
    _, dp = _itf8(d, dp)
    nkeys, dp = _itf8(d, dp)
    series = {}
    for _ in range(nkeys):
        key = d[dp : dp + 2].decode()
        dp += 2
        codec, dp = _itf8(d, dp)
        plen, dp = _itf8(d, dp)
        series[key] = _Enc.parse(codec, d[dp : dp + plen])
        dp += plen
    _, dp = _itf8(d, dp)
    nkeys, dp = _itf8(d, dp)
    tags = {}
    for _ in range(nkeys):
        tkey, dp = _itf8(d, dp)
        codec, dp = _itf8(d, dp)
        plen, dp = _itf8(d, dp)
        tags[tkey] = _Enc.parse(codec, d[dp : dp + plen])
        dp += plen
    td_lines = pres["TD"].split(b"\x00")
    return dict(pres=pres, series=series, tags=tags, td=td_lines)


def _parse_slice_header(d: bytes):
    p = 0
    refid, p = _itf8_signed(d, p)
    start, p = _itf8(d, p)
    span, p = _itf8(d, p)
    nrec, p = _itf8(d, p)
    counter, p = _ltf8(d, p)
    nblocks, p = _itf8(d, p)
    nids, p = _itf8(d, p)
    ids = []
    for _ in range(nids):
        v, p = _itf8(d, p)
        ids.append(v)
    emb, p = _itf8_signed(d, p)
    return dict(
        refid=refid, start=start, span=span, nrec=nrec, nblocks=nblocks,
        embedded_ref=emb,
    )


def _decode_slice(comp, sh, blocks, ref_ascii, ref_offsets=()):
    streams = _Streams(blocks)
    S = comp["series"]
    pres = comp["pres"]
    sub = pres["SM"]
    out = []
    last_pos = sh["start"]
    for _ in range(sh["nrec"]):
        bf = _read_int(S["BF"], streams)
        cf = _read_int(S["CF"], streams)
        refid = sh["refid"]
        if sh["refid"] == -2:
            refid = _read_int(S["RI"], streams)
        rl = _read_int(S["RL"], streams)
        if pres["AP"]:
            last_pos = last_pos + _read_int(S["AP"], streams)
            apos = last_pos
        else:
            apos = _read_int(S["AP"], streams)
        _rg = _read_int(S["RG"], streams)
        name = b""
        if pres["RN"]:
            name = _read_array(S["RN"], streams)
        if cf & 0x02:  # detached mate
            _mf = _read_int(S["MF"], streams)
            if not pres["RN"]:
                name = _read_array(S["RN"], streams)
            _ns = _read_int(S["NS"], streams)
            _np = _read_int(S["NP"], streams)
            _ts = _read_int(S["TS"], streams)
        elif cf & 0x04:  # mate downstream
            _nf = _read_int(S["NF"], streams)
        tl = _read_int(S["TL"], streams)
        # consume tag values (each tag stream is private, but BYTE_ARRAY_LEN
        # lengths may share streams — decode properly, discard values)
        td_line = comp["td"][tl] if tl < len(comp["td"]) else b""
        for t0 in range(0, len(td_line) - 2, 3):
            tkey = (
                (td_line[t0] << 16) | (td_line[t0 + 1] << 8) | td_line[t0 + 2]
            )
            enc = comp["tags"][tkey]
            _read_array(enc, streams)
        if not (bf & 4):  # mapped
            fn = _read_int(S["FN"], streams)
            seq = bytearray()
            qual = bytearray(b"\xff" * rl)
            # build read from reference + features
            feats = []
            fpos = 0
            for _ in range(fn):
                fc = chr(_read_byte_val(S["FC"], streams))
                fp = _read_int(S["FP"], streams)
                fpos += fp
                feats.append((fc, fpos, _read_feature(fc, S, streams)))
            off = (
                ref_offsets[refid]
                if 0 <= refid < len(ref_offsets)
                else 0
            )
            seq = _apply_features(
                ref_ascii, off, apos, rl, feats, sub
            )
            _mq = _read_int(S["MQ"], streams)
        else:
            ba = S["BA"]
            seq = bytes(
                bytearray(_read_byte_val(ba, streams) for _ in range(rl))
            )
            feats = []
        if cf & 0x01:  # quality scores stored
            qual = _read_bytes_val(S["QS"], streams, rl)
        else:
            qual = b"\xff" * rl
        # per-feature quals (code 'B'/'Q') already folded in _read_feature
        out.append(
            CramRecord(
                name=bytes(name),
                flags=bf,
                ref_id=refid,
                pos=apos,  # placed-unmapped reads keep their position too
                seq=bytes(seq),
                qual=bytes(qual),
            )
        )
    return out


def _read_feature(fc, S, streams):
    if fc == "X":  # substitution
        return _read_byte_val(S["BS"], streams)
    if fc == "S":  # soft clip
        return _read_array(S["SC"], streams)
    if fc == "I":  # insertion
        return _read_array(S["IN"], streams)
    if fc == "i":  # single inserted base
        return bytes([_read_byte_val(S["BA"], streams)])
    if fc == "D":  # deletion
        return _read_int(S["DL"], streams)
    if fc == "N":  # ref skip
        return _read_int(S["RS"], streams)
    if fc == "H":  # hard clip
        return _read_int(S["HC"], streams)
    if fc == "P":  # padding
        return _read_int(S["PD"], streams)
    if fc == "B":  # base + qual
        b = _read_byte_val(S["BA"], streams)
        q = _read_byte_val(S["QS"], streams)
        return (b, q)
    if fc == "b":  # bases array
        return _read_array(S["BB"], streams)
    if fc == "q":  # quals array
        return _read_array(S["QQ"], streams)
    if fc == "Q":  # single qual
        return _read_byte_val(S["QS"], streams)
    raise ValueError(f"CRAM feature code {fc!r}")


def _apply_features(ref_ascii, contig_off, apos, rl, feats, sub):
    """Reconstruct read bases: walk reference from apos applying features.

    Positions are 1-based within the read; between features the read copies
    the reference."""
    if ref_ascii is None:
        raise ValueError("mapped CRAM records need the reference genome")
    seq = bytearray(rl)
    rpos = 0  # read cursor (0-based)
    gpos = contig_off + apos - 1  # flat genome cursor (0-based)
    for fc, fpos, payload in feats:
        # copy reference up to the feature position (fpos is 1-based)
        gap = fpos - 1 - rpos
        if gap > 0:
            seq[rpos : rpos + gap] = ref_ascii[gpos : gpos + gap]
            rpos += gap
            gpos += gap
        if fc == "X":
            refb = ref_ascii[gpos : gpos + 1] or b"N"
            ri = _B2I.get(refb[0], 4)
            code = payload
            if ri < 4:
                # substitution matrix: 2-bit codes packed per ref base
                byte = sub[ri]
                letters = _SUB_BASES[ri]
                got = None
                for k in range(4):
                    if (byte >> (6 - 2 * k)) & 3 == code:
                        got = letters[k]
                        break
                seq[rpos] = got if got is not None else ord("N")
            else:
                seq[rpos] = _SUB_BASES[4][payload]
            rpos += 1
            gpos += 1
        elif fc in ("S",):
            sc = payload
            seq[rpos : rpos + len(sc)] = sc
            rpos += len(sc)
        elif fc in ("I", "b"):
            ins = payload
            seq[rpos : rpos + len(ins)] = ins
            rpos += len(ins)
        elif fc == "i":
            seq[rpos : rpos + 1] = payload
            rpos += 1
        elif fc == "D":
            gpos += payload
        elif fc == "N":
            gpos += payload
        elif fc in ("H", "P"):
            pass
        elif fc == "B":
            seq[rpos] = payload[0]
            rpos += 1
            gpos += 1
        elif fc in ("q", "Q"):
            pass
    if rpos < rl:
        seq[rpos:rl] = ref_ascii[gpos : gpos + (rl - rpos)]
    return bytes(seq)


# ---------------------------------------------------------------- public


def read_cram_batch(path: str, reference) -> Tuple[ReadBatch, dict]:
    """CRAM -> ReadBatch (same contract as read_bam): reverse-strand reads
    restored to original orientation (revcomp + reversed quals), secondary/
    supplementary records dropped, names kept for mate pairing."""
    ref_codes = np.asarray(reference.flat) if reference is not None else None
    contigs = (
        [(c.name, c.start) for c in reference.contigs]
        if reference is not None
        else None
    )
    records, header = read_cram(path, ref_codes, contigs)
    records = [r for r in records if not (r.flags & 0x100 or r.flags & 0x800)]
    R = len(records)
    L = max((len(r.seq) for r in records), default=1)
    codes = np.zeros((R, L), np.uint8)
    quals = np.zeros((R, L), np.uint8)
    lengths = np.zeros(R, np.int32)
    names = []
    flags = np.zeros(R, np.int32)
    for i, r in enumerate(records):
        arr = np.frombuffer(r.seq, np.uint8)
        c = dna.encode_ascii(arr)
        q = np.frombuffer(r.qual[: len(arr)], np.uint8)
        q = np.where(q == 0xFF, 30, q).astype(np.uint8)
        if r.flags & 0x10:  # reverse strand: restore original orientation
            c = (3 - c[::-1]).astype(np.uint8)
            q = q[::-1]
        codes[i, : len(c)] = c
        quals[i, : len(q)] = q
        lengths[i] = len(c)
        names.append(r.name)
        flags[i] = r.flags
    batch = ReadBatch(codes=codes, lengths=lengths, quals=quals, names=names, flags=flags)
    return batch, {"text": header, "flags": flags}
