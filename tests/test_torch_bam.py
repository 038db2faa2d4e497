"""The port's SAM/BAM reading and writing against the JAX package's, with
exact equality: seeded paired reads written as SAM and BAM by both
packages' writers (byte-identical files), read back by both packages'
readers (the JAX package's native route, the one it takes on a host with
g++) with equal codes, lengths, qualities, names, flags, header refs and
mate pairs.  The inputs hold a payload past 64 KiB (several BGZF blocks),
reverse-strand, secondary, supplementary and unmapped records, missing
qualities (0xFF), a plain-gzip member and an empty file; the spill_dir
route; the threaded inflation against the serial walk; and what the port
does where the JAX package carries on: a truncated or corrupt block and a
scanner that cannot be built raise."""

import gzip
import io
import os

import numpy as np
import pytest

import biograph_tpu.native as jax_native
from biograph_tpu.io import bam as jbam
from biograph_tpu.io import bamwrite as jbw
from biograph_tpu_torch import native
from biograph_tpu_torch.io import bam as tbam
from biograph_tpu_torch.io import bamwrite as tbw

REFS = [("chr1", 9000), ("chr2", 4000)]
BASES = "ACGT"


def paired_records(pkg, seed=3, n_pairs=700, L=100):
    """Paired reads named r<i>, flags 0x1 | 0x40/0x80; a quarter of the
    pairs reverse strand (stored reverse-complemented, qualities reversed),
    some unmapped, some without qualities, with secondary and supplementary
    copies and a few ambiguity codes.  ``pkg`` is the bamwrite module whose
    SamRecord to make.  Returns (records, the reads in original
    orientation as (name, seq, qual or None, flag))."""
    rng = np.random.default_rng(seed)
    recs, reads = [], []
    for i in range(2 * n_pairs):
        n = int(rng.integers(30, L + 1))
        seq = "".join(BASES[b] for b in rng.integers(0, 4, n))
        if i % 97 == 5:
            seq = seq[:3] + "N" + seq[4:7] + "R" + seq[8:]
        qual = None if i % 11 == 3 else "".join(chr(33 + int(q)) for q in rng.integers(2, 42, n))
        flag = 0x1 | (0x40 if i % 2 == 0 else 0x80)
        reverse = (i // 2) % 4 == 1
        unmapped = i % 13 == 7
        if reverse:
            flag |= 0x10
        if unmapped:
            flag |= 0x4
        stored = seq[::-1].translate(str.maketrans("ACGTNR", "TGCANY")) if reverse else seq
        stored_q = qual[::-1] if (reverse and qual) else qual
        ref = REFS[i % 2][0]
        rec = pkg.SamRecord(
            qname=f"r{i // 2}", flag=flag, rname="*" if unmapped else ref, pos=0 if unmapped else int(rng.integers(1, 3000)),
            mapq=0 if unmapped else 60, cigar=[] if unmapped else [(n, "M")], rnext="=", pnext=int(rng.integers(1, 3000)),
            tlen=int(rng.integers(-500, 500)), seq=stored, qual=stored_q or "*", tags={"NM": i % 3, "RG": "g1"} if i % 5 else {},
        )
        recs.append(rec)
        reads.append((f"r{i // 2}", seq, qual, flag))
        if i % 9 == 4:  # a secondary and a supplementary copy of the same read
            for extra in (0x100, 0x800):
                recs.append(pkg.SamRecord(**{**rec.__dict__, "flag": flag | extra, "tags": {}}))
    return recs, reads


def write_both(tmp_path, name, **kw):
    """The same records through both writers: (JAX path, port path)."""
    out = []
    for pkg, tag in ((jbw, "jax"), (tbw, "port")):
        recs, _ = paired_records(pkg, **kw)
        path = str(tmp_path / f"{tag}_{name}")
        (pkg.write_bam if name.endswith(".bam") else pkg.write_sam)(path, REFS, recs, extra_header=["@RG\tID:g1"])
        out.append(path)
    return out


def assert_read_equal(got, want):
    (gb, gh), (wb, wh) = got, want
    for name in ("codes", "lengths", "quals"):
        np.testing.assert_array_equal(np.asarray(getattr(gb, name)), np.asarray(getattr(wb, name)), err_msg=name)
    np.testing.assert_array_equal(gb.flags, wb.flags)
    assert gb.names == wb.names
    assert gh["refs"] == wh["refs"]
    if gb.names is not None:
        np.testing.assert_array_equal(
            tbam.mate_pairs_from_names(gb.names, gb.flags), jbam.mate_pairs_from_names(wb.names, wb.flags)
        )


@pytest.mark.parametrize("name", ["reads.sam", "reads.bam"])
def test_writers_are_byte_identical(tmp_path, name):
    jax_path, port_path = write_both(tmp_path, name)
    assert open(jax_path, "rb").read() == open(port_path, "rb").read()
    if name.endswith(".bam"):
        assert os.path.getsize(port_path) > 3 * 28  # several blocks
        assert len(tbam._bgzf_decompress(open(port_path, "rb").read())) > 3 * tbw.BGZF_MAX


def test_bgzf_blocks_and_reg2bin():
    payload = np.random.default_rng(5).integers(0, 4, 200_000).astype(np.uint8).tobytes()
    a, b = io.BytesIO(), io.BytesIO()
    jbw.bgzf_write_blocks(a, payload)
    tbw.bgzf_write_blocks(b, payload)
    assert a.getvalue() == b.getvalue()
    assert tbam._bgzf_decompress(b.getvalue()) == payload
    for beg, end in ((0, 1), (100, 16384), (16383, 16385), (1 << 17, (1 << 17) + 5000), (1 << 20, 1 << 23), (0, 1 << 29)):
        assert tbw._reg2bin(beg, end) == jbw._reg2bin(beg, end)


@pytest.mark.parametrize("keep_unmapped", [True, False])
@pytest.mark.parametrize("with_names", [True, False])
def test_read_bam_equal_to_jax(tmp_path, keep_unmapped, with_names):
    path, _ = write_both(tmp_path, "reads.bam")
    got = tbam.read_bam(path, with_names=with_names, keep_unmapped=keep_unmapped)
    want = jbam.read_bam(path, with_names=with_names, keep_unmapped=keep_unmapped)
    assert_read_equal(got, want)
    np.testing.assert_array_equal(got[1]["flags"], want[1]["flags"])
    flags = got[0].flags
    assert not (flags & 0x900).any() and (flags & 0x10).any()
    assert (flags & 0x4).any() == keep_unmapped


def test_reads_come_back_in_their_orientation(tmp_path):
    """Reverse-strand records are flipped back: the reads written equal the
    reads read, names and flags in order, secondary and supplementary
    copies dropped; a missing quality reads as 0."""
    path, _ = write_both(tmp_path, "reads.bam")
    batch, hdr = tbam.read_bam(path)
    _, reads = paired_records(tbw)
    assert batch.num_reads == len(reads) and hdr["refs"] == REFS
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i, (name, seq, qual, flag) in enumerate(reads):
        n = len(seq)
        assert batch.names[i] == name.encode() and batch.flags[i] == flag and batch.lengths[i] == n
        # an ambiguity code reads as A, so as T on a read stored reverse-complemented
        want = [code.get(c, 3 if flag & 0x10 else 0) for c in seq]
        np.testing.assert_array_equal(batch.codes[i, :n], want)
        want_q = np.zeros(n, np.uint8) if qual is None else np.frombuffer(qual.encode(), np.uint8) - 33
        np.testing.assert_array_equal(batch.quals[i, :n], want_q)
    mates = tbam.mate_pairs_from_names(batch.names, batch.flags)
    np.testing.assert_array_equal(mates, np.arange(len(reads)) ^ 1)


def test_read_sam_equal_to_jax(tmp_path):
    path, _ = write_both(tmp_path, "reads.sam")
    assert_read_equal(tbam.read_sam(path), jbam.read_sam(path))
    assert_read_equal(tbam.read_sam(path, with_names=False), jbam.read_sam(path, with_names=False))


def test_spill_dir_route(tmp_path):
    path, _ = write_both(tmp_path, "reads.bam")
    got = tbam.read_bam(path, spill_dir=str(tmp_path / "spill_port"))
    want = jbam.read_bam(path, spill_dir=str(tmp_path / "spill_jax"))
    assert_read_equal(got, want)
    assert isinstance(got[0].codes, np.memmap) and isinstance(got[0].quals, np.memmap)
    assert sorted(os.listdir(tmp_path / "spill_port")) == ["bam_codes.mm", "bam_quals.mm", "bgzf_out.mm"]


def test_plain_gzip_member(tmp_path):
    """A stream whose second half is one plain gzip member: no BC subfield,
    so both packages read the file by the serial walk."""
    path, _ = write_both(tmp_path, "reads.bam")
    payload = tbam._bgzf_decompress(open(path, "rb").read())
    half = len(payload) // 2
    mixed = io.BytesIO()
    tbw.bgzf_write_blocks(mixed, payload[:half])
    mixed.write(gzip.compress(payload[half:], mtime=0))
    mixed.write(tbw._BGZF_EOF)
    mpath = tmp_path / "mixed.bam"
    mpath.write_bytes(mixed.getvalue())
    assert native.bgzf_decompress_native(np.frombuffer(mixed.getvalue(), np.uint8)) is None
    assert_read_equal(tbam.read_bam(str(mpath)), jbam.read_bam(str(mpath)))
    assert_read_equal(tbam.read_bam(str(mpath)), tbam.read_bam(path))


def test_empty_inputs(tmp_path):
    empty = tmp_path / "empty.bam"
    empty.write_bytes(b"")
    for read in (tbam.read_bam, jbam.read_bam):
        with pytest.raises(ValueError, match="not a BAM file"):
            read(str(empty))
    no_records = str(tmp_path / "no_records.bam")
    tbw.write_bam(no_records, REFS, [])
    got, want = tbam.read_bam(no_records), jbam.read_bam(no_records)
    assert got[0].num_reads == want[0].num_reads == 0
    assert_read_equal(got, want)
    sam = str(tmp_path / "no_records.sam")
    tbw.write_sam(sam, REFS, [])
    assert tbam.read_sam(sam)[0].num_reads == jbam.read_sam(sam)[0].num_reads == 0


def test_threaded_inflation_equals_the_serial_walk(tmp_path):
    path, _ = write_both(tmp_path, "reads.bam", n_pairs=1500)
    raw = np.fromfile(path, np.uint8)
    serial = tbam._bgzf_decompress(raw)
    blocks = native.bgzf_blocks(raw)
    assert len(blocks[0]) >= 4
    for threads in (1, 3, 8):
        assert native.bgzf_decompress_native(raw, n_threads=threads).tobytes() == serial
    assert jax_native.bgzf_decompress_native(raw).tobytes() == serial


def test_truncated_and_corrupt_blocks_raise(tmp_path):
    """The JAX package returns what it could inflate; the port raises."""
    path, _ = write_both(tmp_path, "reads.bam")
    raw = open(path, "rb").read()
    cut = tmp_path / "cut.bam"
    cut.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="truncated"):
        tbam.read_bam(str(cut))
    jax_batch, _ = jbam.read_bam(str(cut))
    assert 0 < jax_batch.num_reads < tbam.read_bam(path)[0].num_reads
    bad = bytearray(raw)
    blocks = native.bgzf_blocks(np.frombuffer(raw, np.uint8))
    at = int(blocks[0][1]) + 40  # inside the second block's deflate payload
    bad[at : at + 16] = b"\xff" * 16
    corrupt = tmp_path / "corrupt.bam"
    corrupt.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="BGZF block 1"):
        tbam.read_bam(str(corrupt))
    isize = bytearray(raw)
    end = int(blocks[0][0]) + int(blocks[1][0])  # the first block's ISIZE, off by one
    isize[end - 4] ^= 1
    with pytest.raises(ValueError, match="ISIZE"):
        native.bgzf_decompress_native(np.frombuffer(bytes(isize), np.uint8))


def test_a_scanner_that_cannot_be_built_raises(tmp_path, monkeypatch):
    """Where the JAX package would run its Python record loop, the port
    raises."""
    path, _ = write_both(tmp_path, "reads.bam")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbam.read_bam(path)


def test_jax_python_route_keeps_0xff_qualities(tmp_path, monkeypatch):
    """A reference behaviour: the JAX package's Python route copies a
    missing quality (0xFF) through, its native route (and the port) reads
    0.  Only the qualities differ."""
    path, _ = write_both(tmp_path, "reads.bam")
    native_route = jbam.read_bam(path)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    python_route = jbam.read_bam(path)
    port = tbam.read_bam(path)
    missing = python_route[0].quals == 0xFF
    assert missing.any()
    np.testing.assert_array_equal(port[0].quals, np.where(missing, 0, python_route[0].quals))
    np.testing.assert_array_equal(port[0].quals, native_route[0].quals)
    np.testing.assert_array_equal(port[0].codes, python_route[0].codes)
    assert port[0].names == python_route[0].names
    assert "flags" not in python_route[1] and "flags" in port[1]
