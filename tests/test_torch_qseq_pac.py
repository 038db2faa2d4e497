"""QSEQ import and BWA ``.pac`` reference dirs: the port against the JAX
package, exact equality.  QSEQ: plain, gzip and bzip2 files, '.' and a
quality of 'B' made N, leading and trailing N runs trimmed, reads that are
all N dropped, and each ValueError.  ``.pac``: a FASTA with N holes written
as ``.pac``/``.ann``/``.amb`` gives equal ``flat``, ``is_n`` and contigs
through both packages' ``Reference.from_reference_dir``, and equal to the
FASTA's."""

import bz2
import gzip

import numpy as np
import pytest

from biograph_tpu.index.reference import Reference as JReference
from biograph_tpu.io.qseq import read_qseq as jax_read_qseq
from biograph_tpu_torch.index.reference import Reference
from biograph_tpu_torch.io import pac as pacio
from biograph_tpu_torch.io.qseq import read_qseq


def qseq_text(seed=11, n=400, L=80) -> bytes:
    """QSEQ lines: random bases, '.' no-calls, 'B' qualities, N runs at the
    ends, an all-N read, and CRLF line ends on some lines."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        m = int(rng.integers(1, L + 1))
        seq = bytearray(rng.choice(list(b"ACGTN."), m, p=[0.23, 0.23, 0.23, 0.23, 0.04, 0.04]).astype(np.uint8).tobytes())
        qual = bytearray((rng.integers(66, 105, m)).astype(np.uint8).tobytes())
        if i % 7 == 0:
            qual[: min(3, m)] = b"B" * min(3, m)
        if i % 9 == 0:
            seq[-min(4, m):] = b"N" * min(4, m)
        if i % 50 == 17:
            seq = bytearray(b"." * m)
        cols = [b"M1", b"7", b"1", b"%d" % (i % 120), b"%d" % i, b"%d" % (i * 3), b"0", b"1", bytes(seq), bytes(qual), b"1"]
        lines.append(b"\t".join(cols) + (b"\r\n" if i % 13 == 0 else b"\n"))
    return b"".join(lines) + b"\n"


def assert_batches_equal(got, want):
    for name in ("codes", "lengths", "quals"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("compress", ["plain", "gzip", "bzip2"])
def test_read_qseq_equal_to_jax(tmp_path, compress):
    text = qseq_text()
    data = {"plain": text, "gzip": gzip.compress(text, mtime=0), "bzip2": bz2.compress(text)}[compress]
    path = tmp_path / f"reads_{compress}.qseq"
    path.write_bytes(data)
    got, want = read_qseq(str(path)), jax_read_qseq(str(path))
    assert_batches_equal(got, want)
    assert 0 < got.num_reads < 400  # all-N reads dropped
    plain = tmp_path / "plain.qseq"
    plain.write_bytes(text)
    assert_batches_equal(got, read_qseq(str(plain)))


def test_qseq_rules(tmp_path):
    """'.' and quality 'B' become N; N runs at both ends are trimmed; the
    quality is phred+64."""
    line = b"M\t1\t1\t1\t1\t1\t0\t1\tN.ACGBTN\tBhhhhBhh\t1\n"
    path = tmp_path / "one.qseq"
    path.write_bytes(line)
    got = read_qseq(str(path))
    # N . A C G B T N with qualities B h h h h B h h: 'B' at 0 and 5 -> N
    # -> NNACGNTN -> trimmed to ACGNT
    assert got.num_reads == 1 and got.lengths[0] == 5
    np.testing.assert_array_equal(got.codes[0, :5], [0, 1, 2, 0, 3])
    np.testing.assert_array_equal(got.quals[0, :5], [40, 40, 40, 2, 40])
    assert_batches_equal(got, jax_read_qseq(str(path)))


@pytest.mark.parametrize(
    "line, message",
    [
        (b"M\t1\t1\t1\t1\t1\t0\t1\tACGT\n", "needs >=10 columns"),
        (b"M\t1\t1\t1\t1\t1\t0\t1\tACGT\thhh\t1\n", "length mismatch"),
        (b"M\t1\t1\t1\t1\t1\t0\t1\tACGT\thh?h\t1\n", "below phred\\+64"),
    ],
)
def test_qseq_errors(tmp_path, line, message):
    path = tmp_path / "bad.qseq"
    path.write_bytes(b"M\t1\t1\t1\t1\t1\t0\t1\tAC\thh\t1\n" + line)
    for read in (read_qseq, jax_read_qseq):
        with pytest.raises(ValueError, match=f"bad.qseq:2: .*{message}"):
            read(str(path))


def write_pac_dir(path, contigs, stem="source.fasta"):
    """A BWA index of [(name, ASCII seq)]: .pac (4 bases a byte, the last
    byte len % 4, N written as a random base), .ann and .amb (the N runs)."""
    path.mkdir()
    rng = np.random.default_rng(2)
    flat = "".join(s for _, s in contigs)
    code = np.frombuffer(flat.encode(), np.uint8)
    table = np.zeros(256, np.uint8)
    for i, c in enumerate(b"ACGT"):
        table[c] = i
    codes = table[code]
    is_n = code == ord("N")
    codes[is_n] = rng.integers(0, 4, int(is_n.sum()))
    padded = np.zeros(-(-len(codes) // 4) * 4, np.uint8)
    padded[: len(codes)] = codes
    quads = padded.reshape(-1, 4)
    packed = (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    (path / f"{stem}.pac").write_bytes(packed.astype(np.uint8).tobytes() + bytes([len(codes) % 4]))
    ann = [f"{len(codes)} {len(contigs)} 11"]
    off = 0
    for name, s in contigs:
        ann += [f"0 {name} (null)", f"{off} {len(s)} 0"]
        off += len(s)
    (path / f"{stem}.ann").write_text("\n".join(ann) + "\n")
    holes = []
    for m in __import__("re").finditer("N+", flat):
        holes.append(f"{m.start()} {m.end() - m.start()} N")
    (path / f"{stem}.amb").write_text("\n".join([f"{len(codes)} {len(contigs)} {len(holes)}", *holes]) + "\n")
    return str(path)


@pytest.mark.parametrize("stem", ["source.fasta", "reference.fasta"])
def test_pac_reference_dir_equal_to_jax_and_to_the_fasta(tmp_path, stem):
    rng = np.random.default_rng(9)

    def seq(n):
        return "".join("ACGT"[b] for b in rng.integers(0, 4, n))

    contigs = [("chrA", seq(1001) + "N" * 37 + seq(400)), ("chrB", "NN" + seq(999)), ("chrC", seq(13))]
    pac_dir = write_pac_dir(tmp_path / "bwa", contigs, stem)
    fa_dir = tmp_path / "fa"
    fa_dir.mkdir()
    (fa_dir / "genome.fa").write_text("".join(f">{n}\n{s}\n" for n, s in contigs))
    got, want, fasta = Reference.from_reference_dir(pac_dir), JReference.from_reference_dir(pac_dir), Reference.from_reference_dir(str(fa_dir))
    np.testing.assert_array_equal(got.flat, np.asarray(want.flat))
    np.testing.assert_array_equal(got.is_n, np.asarray(want.is_n))
    assert [(c.name, c.start, c.length) for c in got.contigs] == [(c.name, c.start, c.length) for c in want.contigs]
    assert [(c.name, c.start, c.length) for c in got.contigs] == [(c.name, c.start, c.length) for c in fasta.contigs]
    np.testing.assert_array_equal(got.is_n, fasta.is_n)
    np.testing.assert_array_equal(got.flat[~got.is_n], fasta.flat[~fasta.is_n])
    assert got.is_n.sum() == 39
    total, ann = pacio.read_ann(f"{pac_dir}/{stem}.ann")
    assert total == len(got.flat) and [a[0] for a in ann] == ["chrA", "chrB", "chrC"]


def test_pac_dir_without_amb_and_no_index(tmp_path):
    pac_dir = write_pac_dir(tmp_path / "bwa", [("c", "ACGTTGCAAC")])
    (tmp_path / "bwa" / "source.fasta.amb").unlink()
    got = Reference.from_reference_dir(pac_dir)
    assert not got.is_n.any()
    np.testing.assert_array_equal(got.flat, np.asarray(JReference.from_reference_dir(pac_dir).flat))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no FASTA or BWA pac index"):
        Reference.from_reference_dir(str(tmp_path / "empty"))
