"""The port's native FASTQ scanner against the port's numpy parser and the
JAX package's (``read_fastq(use_native=False)``), on synthetic files:
plain, gzipped, with CRLF line ends, with empty records, with trailing
blank lines; malformed, truncated and empty input; ``spill_dir`` memmaps;
``pack_codes_2bit`` against ``dna.pack_codes``; and a scanner that cannot
be built raising where the JAX package falls back."""

import gzip

import numpy as np
import pytest
import torch

from biograph_tpu.io.fastq import read_fastq as jax_read_fastq
from biograph_tpu_torch import native
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.io.fastq import read_fastq


def records(seed, n=300, max_len=120, empty_every=0):
    """FASTQ text of n reads of random length (ACGT, some N and lower case)
    with qualities from '!' to 'J'."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTACGTNacgt", np.uint8)
    out = []
    for i in range(n):
        m = 0 if empty_every and i % empty_every == 0 else int(rng.integers(1, max_len + 1))
        seq = alphabet[rng.integers(0, len(alphabet), m)].tobytes()
        qual = (rng.integers(33, 75, m).astype(np.uint8)).tobytes()
        out.append(b"@read%d extra words\n%s\n+\n%s\n" % (i, seq, qual))
    return b"".join(out)


def write(tmp_path, name, data, gz=False):
    path = tmp_path / name
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)
    return str(path)


def assert_batches_equal(a, b, quals=True):
    assert a.codes.shape == b.codes.shape
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    if quals:
        np.testing.assert_array_equal(a.quals, b.quals)


FILES = {
    "plain": (records(1), False),
    "gz": (records(2), True),
    "crlf": (records(3).replace(b"\n", b"\r\n"), False),
    "empty_records": (records(4, empty_every=7), False),
    "trailing_blank_lines": (records(5) + b"\n\n\n", False),
    "no_final_newline": (records(6)[:-1], False),
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_native_matches_both_numpy_parsers(tmp_path, name):
    data, gz = FILES[name]
    path = write(tmp_path, name + ".fq" + (".gz" if gz else ""), data, gz)
    got = read_fastq(path)
    assert got.num_reads == 300 and got.quals is not None
    assert_batches_equal(got, read_fastq(path, use_native=False))
    assert_batches_equal(got, jax_read_fastq(path, use_native=False))
    assert_batches_equal(got, jax_read_fastq(path, use_native=True))
    no_quals = read_fastq(path, with_quals=False)
    assert no_quals.quals is None
    assert_batches_equal(no_quals, got, quals=False)


def test_names_take_the_numpy_route(tmp_path):
    path = write(tmp_path, "named.fq", records(7, n=20))
    got = read_fastq(path, with_names=True)
    assert got.names == jax_read_fastq(path, with_names=True).names
    assert got.names[3] == b"read3 extra words"


@pytest.mark.parametrize(
    "data",
    [b"@r1\nACGT\n", b"ACGT\nno header\n", b"@r1\nACGT\n+\nII\n", b"@r1\nACGT\n-\nIIII\n", b"@r1\nACGT\n+\n\n"],
    ids=["no_plus_line", "no_header", "short_quality", "bad_separator", "blank_quality"],
)
def test_malformed_input_raises(tmp_path, data):
    path = write(tmp_path, "bad.fq", data)
    with pytest.raises(ValueError, match="malformed FASTQ"):
        read_fastq(path)
    with pytest.raises(ValueError, match="malformed FASTQ"):
        jax_read_fastq(path)
    with pytest.raises(ValueError):
        native.fastq_scan_native(data)


@pytest.mark.parametrize("data", [b"", b"\n\n\r\n"], ids=["empty", "blank"])
def test_empty_input(tmp_path, data):
    path = write(tmp_path, "empty.fq", data)
    got = read_fastq(path)
    assert got.num_reads == 0 and got.lengths.shape == (0,)
    assert jax_read_fastq(path).num_reads == 0


def test_spill_dir_memmaps(tmp_path):
    data, _ = FILES["plain"]
    path = write(tmp_path, "reads.fq", data)
    spilled = read_fastq(path, spill_dir=str(tmp_path / "spill"))
    assert isinstance(spilled.codes, np.memmap) and isinstance(spilled.quals, np.memmap)
    assert sorted(p.name for p in (tmp_path / "spill").iterdir()) == ["fq_codes.mm", "fq_quals.mm"]
    assert_batches_equal(spilled, read_fastq(path))
    assert_batches_equal(spilled, jax_read_fastq(path, spill_dir=str(tmp_path / "jax_spill")))


def test_pack_codes_2bit_matches_pack_codes():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(7, 40), dtype=np.uint8)
    lengths = np.array([40, 35, 17, 16, 1, 0, 33], np.int32)
    want = dna.pack_codes(torch.from_numpy(codes), torch.from_numpy(lengths)).numpy()
    W = want.shape[1]
    words = np.zeros((7, W), np.uint32)
    native.get_lib().pack_codes_2bit(codes.ctypes.data, 7, 40, lengths.ctypes.data, words.ctypes.data, W)
    np.testing.assert_array_equal(words.astype(np.int64), want)
    full = np.zeros((7, W), np.uint32)
    native.get_lib().pack_codes_2bit(codes.ctypes.data, 7, 40, None, full.ctypes.data, W)
    np.testing.assert_array_equal(full.astype(np.int64), dna.pack_codes(torch.from_numpy(codes)).numpy())


def test_a_scanner_that_cannot_be_built_raises(tmp_path, monkeypatch):
    """Where the JAX package would parse with numpy, the port raises."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    path = write(tmp_path, "reads.fq", records(8, n=5))
    with pytest.raises(RuntimeError, match="FASTQ scanner"):
        read_fastq(path)
    assert read_fastq(path, use_native=False).num_reads == 5
