"""The port's CRAM 3.0 decoder (``io/cram.py``) against the JAX package's,
exact equality.  Files come from the minimal CRAM writer of
``chip_smoke.py``: raw, gzip and rANS order-0 and order-1 blocks; EXTERNAL,
constant HUFFMAN, BYTE_ARRAY_LEN and BYTE_ARRAY_STOP encodings; mapped
records with substitutions, insertions, deletions and soft clips on two
contigs; unmapped records; reads with and without qualities; several
containers and slices, single- and multi-reference, positions as deltas
and absolute; an RG:Z tag on some records.  ITF8, signed ITF8 and LTF8 at
their edge values; rANS of order 0 and 1; whole files (records, header
text, ``read_cram_batch``); the CRAM's reads against those of the BAM
written from the same records; and each unsupported codec raising."""


import numpy as np
import pytest

from biograph_tpu.index.reference import Contig as JContig
from biograph_tpu.index.reference import Reference as JReference
from biograph_tpu.io import bam as jbam
from biograph_tpu.io import cram as jcram
from biograph_tpu_torch.convert import reference_from_numpy
from biograph_tpu_torch.io import bam as tbam
from biograph_tpu_torch.io import cram as tcram
from biograph_tpu_torch.io.bamwrite import SamRecord, write_bam
from test_torch_cli import _chip_smoke as _cs

CONTIGS = [("chrA", 6000), ("chrB", 3500)]
# external block id -> method: every method on the series that suit it
# (the rANS writer refuses byte 255, which ITF8 values past 127 may hold)
METHODS = {1: "raw", 2: "rans0", 3: "gzip", 4: "rans1", 5: "gzip", 6: "rans1", 7: "raw", 8: "gzip", 9: "gzip",
           10: "gzip", 11: "rans0", 12: "rans0", 13: "rans1", 14: "rans0", 15: "rans1", 16: "rans0", 17: "raw",
           18: "raw", 19: "rans1", 20: "gzip", 21: "rans0", 22: "rans1", 23: "rans1"}


def genome_and_refs(seed=8):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, 4, sum(n for _, n in CONTIGS)).astype(np.uint8)
    contigs, off = [], 0
    for name, n in CONTIGS:
        contigs.append((name, off, n))
        off += n
    port = reference_from_numpy(flat, np.zeros(len(flat), bool), contigs)
    jax = JReference(flat=flat, is_n=np.zeros(len(flat), bool), contigs=[JContig(n, s, l) for n, s, l in contigs])
    seqs = {name: "".join("ACGT"[b] for b in flat[s : s + n]) for name, s, n in contigs}
    return port, jax, seqs


def mapped_records(seqs, seed=9, n=600):
    """Records on both contigs: a read copied from the reference along its
    CIGAR (M, I, D, S), with substitutions; every fifth unmapped; every
    seventh without qualities; a quarter reverse strand (bases in reference
    orientation, as BAM and CRAM store them).  Sorted by contig and
    position, the unmapped at the end."""
    rng = np.random.default_rng(seed)
    out, unmapped = [], []
    for i in range(n):
        name = f"q{i // 2}"
        flag = 0x1 | (0x40 if i % 2 == 0 else 0x80) | (0x10 if (i // 2) % 4 == 1 else 0)
        qlen = int(rng.integers(50, 101))
        qual = "*" if i % 7 == 3 else "".join(chr(33 + int(q)) for q in rng.integers(2, 41, qlen))
        if i % 5 == 4:
            seq = "".join("ACGT"[b] for b in rng.integers(0, 4, qlen))
            unmapped.append(SamRecord(qname=name, flag=flag | 0x4, rname="*", pos=0, mapq=0, cigar=[], seq=seq, qual=qual))
            continue
        contig = CONTIGS[i % 2][0]
        shape = i % 4
        ins, dele, clip = int(rng.integers(1, 6)), int(rng.integers(1, 9)), int(rng.integers(1, 8))
        if shape == 0:
            cigar = [(qlen, "M")]
        elif shape == 1:
            a = qlen // 2
            cigar = [(a, "M"), (ins, "I"), (qlen - a - ins, "M")]
        elif shape == 2:
            a = qlen // 3
            cigar = [(a, "M"), (dele, "D"), (qlen - a, "M")]
        else:
            cigar = [(clip, "S"), (qlen - 2 * clip, "M"), (clip, "S")]
        ref = seqs[contig]
        pos = int(rng.integers(1, len(ref) - qlen - 20))
        parts, g = [], pos - 1
        for length, op in cigar:
            if op == "M":
                piece = list(ref[g : g + length])
                for k in rng.choice(length, int(rng.integers(0, 4)), replace=False):
                    piece[k] = "ACGT"[("ACGT".index(piece[k]) + int(rng.integers(1, 4))) % 4]
                parts.append("".join(piece))
                g += length
            elif op == "D":
                g += length
            else:
                parts.append("".join("ACGT"[b] for b in rng.integers(0, 4, length)))
        seq = "".join(parts)
        out.append(SamRecord(qname=name, flag=flag, rname=contig, pos=pos, mapq=int(rng.integers(1, 61)), cigar=cigar,
                             rnext="=", pnext=pos + 200, tlen=int(rng.integers(-400, 400)), seq=seq, qual=qual))
    out.sort(key=lambda r: ([c for c, _ in CONTIGS].index(r.rname), r.pos))
    return out + unmapped


@pytest.fixture(scope="module")
def cram_file(tmp_path_factory):
    port_ref, jax_ref, seqs = genome_and_refs()
    records = mapped_records(seqs)
    path = str(tmp_path_factory.mktemp("cram") / "reads.cram")
    _cs().write_cram(path, CONTIGS, seqs, records, slice_records=50, container_slices=3, methods=METHODS)
    return dict(path=path, records=records, port_ref=port_ref, jax_ref=jax_ref)


def test_varints_at_their_edges():
    cs = _cs()
    for v in (0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, 0x1FFFFF, 0x200000, 0xFFFFFFF, 0x10000000, 0x7FFFFFFF, -1, -2, -(1 << 31)):
        data = cs.itf8(v) + b"\x55"
        assert tcram._itf8_signed(data, 0) == jcram._itf8_signed(data, 0) == (v, len(data) - 1)
        assert tcram._itf8(data, 0) == jcram._itf8(data, 0) == (v & 0xFFFFFFFF, len(data) - 1)
    for shift in range(65):
        for v in {(1 << shift) - 1, 1 << shift if shift < 64 else 0}:
            data = cs.ltf8(v) + b"\x55"
            assert tcram._ltf8(data, 0) == jcram._ltf8(data, 0) == (v, len(data) - 1)


@pytest.mark.parametrize("order", [0, 1])
def test_rans_equal_to_jax(order):
    rng = np.random.default_rng(order + 30)
    for n in (1, 2, 3, 4, 5, 7, 8, 63, 1000, 20_000):
        for alphabet in (4, 40, 254):
            data = bytes(rng.integers(0, alphabet, n).astype(np.uint8))
            enc = _cs().rans_encode(data, order)
            assert tcram._rans_decode(enc, n) == jcram._rans_decode(enc, n) == data
    skewed = bytes([7] * 5000 + [9] * 3 + [200])
    enc = _cs().rans_encode(skewed, order)
    assert tcram._rans_decode(enc, len(skewed)) == skewed


def test_whole_file_equal_to_jax(cram_file):
    flat = np.asarray(cram_file["port_ref"].flat)
    contigs = [(c.name, c.start) for c in cram_file["port_ref"].contigs]
    got, text = tcram.read_cram(cram_file["path"], flat, contigs)
    want, jtext = jcram.read_cram(cram_file["path"], flat, contigs)
    assert text == jtext and "@SQ\tSN:chrB\tLN:3500" in text
    assert [vars(r) for r in got] == [vars(r) for r in want]
    recs = cram_file["records"]
    assert len(got) == len(recs)
    for r, rec in zip(got, recs):
        assert r.name == rec.qname.encode() and r.flags == rec.flag and r.seq == rec.seq.encode()
        if rec.qual != "*":
            assert r.qual == bytes(ord(c) - 33 for c in rec.qual)
        else:
            assert r.qual == b"\xff" * len(rec.seq)


def test_read_cram_batch_equal_to_jax_and_to_the_bam(cram_file, tmp_path):
    batch, hdr = tcram.read_cram_batch(cram_file["path"], cram_file["port_ref"])
    jbatch, jhdr = jcram.read_cram_batch(cram_file["path"], cram_file["jax_ref"])
    for name in ("codes", "lengths", "quals"):
        np.testing.assert_array_equal(getattr(batch, name), getattr(jbatch, name), err_msg=name)
    assert batch.names == jbatch.names and hdr["text"] == jhdr["text"]
    np.testing.assert_array_equal(hdr["flags"], jhdr["flags"])
    np.testing.assert_array_equal(batch.flags, hdr["flags"])
    # the same records as BAM: equal reads; a missing quality reads 30
    # from CRAM and 0 from BAM
    bam = str(tmp_path / "same.bam")
    write_bam(bam, CONTIGS, cram_file["records"])
    bbatch, _ = tbam.read_bam(bam)
    for name in ("codes", "lengths", "flags"):
        np.testing.assert_array_equal(getattr(batch, name), getattr(bbatch, name), err_msg=name)
    assert batch.names == bbatch.names
    no_qual = np.array([r.qual == "*" for r in cram_file["records"]])
    assert no_qual.any()
    np.testing.assert_array_equal(batch.quals[~no_qual], bbatch.quals[~no_qual])
    inside = np.arange(batch.max_len)[None, :] < batch.lengths[:, None]
    assert (batch.quals[no_qual][inside[no_qual]] == 30).all() and (bbatch.quals[no_qual][inside[no_qual]] == 0).all()
    np.testing.assert_array_equal(
        tbam.mate_pairs_from_names(batch.names, hdr["flags"]), jbam.mate_pairs_from_names(jbatch.names, jhdr["flags"])
    )


def test_unmapped_only_file_needs_no_reference(tmp_path):
    _, _, seqs = genome_and_refs()
    recs = [r for r in mapped_records(seqs, n=100) if r.flag & 0x4]
    path = str(tmp_path / "unmapped.cram")
    _cs().write_cram(path, CONTIGS, seqs, recs, slice_records=7, container_slices=2)
    got, _ = tcram.read_cram(path)
    assert [vars(r) for r in got] == [vars(r) for r in jcram.read_cram(path)[0]]
    assert [r.seq for r in got] == [r.seq.encode() for r in recs]
    mapped = str(tmp_path / "mapped.cram")
    _cs().write_cram(mapped, CONTIGS, seqs, mapped_records(seqs, n=10)[:3])
    with pytest.raises(ValueError, match="need the reference genome"):
        tcram.read_cram(mapped)


def test_unsupported_codecs_raise(cram_file, tmp_path):
    """A block method, an encoding and a HUFFMAN code past what the
    decoders read raise ValueError in both packages."""
    cs = _cs()
    # a block of method 5 (the next codec after rANS)
    blk = bytearray(cs.cram_block(cs.CT_EXTERNAL, 3, b"abc"))
    blk[0] = 5
    for read_block in (tcram._read_block, jcram._read_block):
        with pytest.raises(ValueError, match="block method 5 unsupported"):
            read_block(bytes(blk), 0)
    # an encoding of codec 2 (GOLOMB), and a HUFFMAN with two symbols
    for parse in (tcram._Enc.parse, jcram._Enc.parse):
        with pytest.raises(ValueError, match="encoding codec 2 unsupported"):
            parse(2, cs.itf8(1))
        with pytest.raises(ValueError, match="non-constant HUFFMAN"):
            parse(3, cs.itf8(2) + cs.itf8(1) + cs.itf8(2) + cs.itf8(2) + cs.itf8(1) + cs.itf8(1))
    with pytest.raises(ValueError, match="rANS order 2 unsupported"):
        tcram._rans_decode(b"\x02" + b"\x00" * 8, 0)
    raw = open(cram_file["path"], "rb").read()
    for name, data, message in (("v2.cram", raw[:4] + b"\x02" + raw[5:], "major version 2"), ("x.cram", b"BAM\x01" + raw[4:], "not a CRAM")):
        path = tmp_path / name
        path.write_bytes(data)
        for read in (tcram.read_cram, jcram.read_cram):
            with pytest.raises(ValueError, match=message):
                read(str(path))
