"""core/bitvector.py, core/packed.py, core/container.py and io/fastq.py of
the PyTorch port against the JAX package.  Tolerance: exact equality."""

import gzip

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.core import bitvector as jbv, container as jcont, packed as jpk
from biograph_tpu.io import fastq as jfq
from biograph_tpu_torch.core import bitvector as tbv, container as tcont, packed as tpk
from biograph_tpu_torch.io import fastq as tfq


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 1000])
def test_rankbits(n):
    rng = np.random.default_rng(n)
    bits = rng.random(n) < 0.4
    j = jbv.RankBits.from_bools(bits)
    t = tbv.RankBits.from_bools(torch.from_numpy(bits))
    assert t.words.dtype == torch.int32 and t.cum.dtype == torch.int64
    np.testing.assert_array_equal(t.words.numpy().view(np.uint32), j.words)
    np.testing.assert_array_equal(t.cum.numpy(), j.cum)
    assert (t.n, t.total) == (j.n, j.total)
    i = np.concatenate([rng.integers(0, n + 1, 200), [0, n]])
    np.testing.assert_array_equal(t.rank(torch.from_numpy(i)).numpy(), j.rank_np(i))
    np.testing.assert_array_equal(t.rank(torch.from_numpy(i)).numpy(), np.asarray(j.rank(i)))
    k = rng.integers(0, n, 100)
    np.testing.assert_array_equal(t.get(torch.from_numpy(k)).numpy(), j.get(k))
    np.testing.assert_array_equal(t.ones_positions().numpy(), j.ones_positions())
    p = tbv.RankBits.from_positions(torch.from_numpy(np.nonzero(bits)[0]), n)
    assert torch.equal(p.words, t.words) and torch.equal(p.cum, t.cum)


def test_popcount():
    rng = np.random.default_rng(0)
    vals = np.concatenate(
        [rng.integers(0, 1 << 32, 500, dtype=np.uint64), [0, 1, 1 << 31, (1 << 32) - 1]]
    ).astype(np.uint32)
    want = jbv.popcount_np(vals)
    np.testing.assert_array_equal(tbv.popcount32(torch.from_numpy(vals.astype(np.int64))).numpy(), want)
    np.testing.assert_array_equal(tbv.popcount_np(vals), want)


def test_sparse_multi_and_cumsum():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 50, 300)
    values = rng.integers(0, 10_000, 300)
    j = jpk.SparseMulti.from_pairs(keys, values, 50)
    t = tpk.SparseMulti.from_pairs(torch.from_numpy(keys), torch.from_numpy(values), 50)
    np.testing.assert_array_equal(t.offsets.numpy(), j.offsets)
    np.testing.assert_array_equal(t.values.numpy(), j.values)
    assert (t.n, t.total) == (j.n, j.total)
    i = rng.integers(0, 50, 40)
    for got, want in zip(t.lookup_range(torch.from_numpy(i)), j.lookup_range(i)):
        np.testing.assert_array_equal(got.numpy(), want)
    dense = rng.integers(0, 300, 60)
    np.testing.assert_array_equal(t.reverse_lookup(torch.from_numpy(dense)).numpy(), j.reverse_lookup(dense))
    x = rng.integers(0, 9, 33)
    np.testing.assert_array_equal(tpk.exclusive_cumsum(torch.from_numpy(x)).numpy(), jpk.exclusive_cumsum(x))


@pytest.mark.parametrize("writer,reader", [(tcont, jcont), (jcont, tcont)])
def test_container_cross_read(tmp_path, writer, reader):
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 1 << 32, (4, 9), dtype=np.uint64).astype(np.uint32)
    cold = rng.integers(0, 40, 500).astype(np.uint8)
    path = str(tmp_path / "a.bgt")
    with writer.ArtifactWriter(path, "seqset", {"k": 3}) as w:
        w.add_array("raw", raw)
        w.add_array("cold", cold, codec="zlib")
        w.set_scalar("n", 7)
    assert reader.exists(path) and not reader.exists(str(tmp_path))
    r = reader.ArtifactReader(path, "seqset")
    np.testing.assert_array_equal(r.array("raw"), raw)
    np.testing.assert_array_equal(r.array("cold"), cold)
    assert (r.scalar("n"), r.scalar("k"), r.kind) == (7, 3, "seqset")
    assert sorted(r.names()) == ["cold", "raw"]
    with pytest.raises(ValueError):
        reader.ArtifactReader(path, "readmap")


def _write_fastq(path, seqs, gz=False):
    text = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(seqs))
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(text.encode())


@pytest.mark.parametrize("gz", [False, True])
def test_read_fastq(tmp_path, gz):
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGTN"), rng.integers(5, 40))) for _ in range(30)]
    path = str(tmp_path / ("r.fq.gz" if gz else "r.fq"))
    _write_fastq(path, seqs, gz)
    j = jfq.read_fastq(path, use_native=False, with_names=True)
    t = tfq.read_fastq(path, with_names=True)
    np.testing.assert_array_equal(t.codes, j.codes)
    np.testing.assert_array_equal(t.lengths, j.lengths)
    np.testing.assert_array_equal(t.quals, j.quals)
    assert t.names == j.names and t.num_reads == 30
    assert t.sequence(4) == seqs[4].replace("N", "A")


def test_read_fastq_malformed_and_empty(tmp_path):
    bad = tmp_path / "bad.fq"
    bad.write_text("@r0\nACGT\n+\n")
    with pytest.raises(ValueError, match="bad.fq"):
        tfq.read_fastq(str(bad))
    empty = tmp_path / "empty.fq"
    empty.write_text("")
    assert tfq.read_fastq(str(empty)).num_reads == 0


def test_fastq_batch_tools(tmp_path):
    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list("ACGT"), rng.integers(10, 30))) for _ in range(20)]
    path = str(tmp_path / "r.fq")
    _write_fastq(path, seqs)
    j, t = jfq.read_fastq(path, use_native=False), tfq.read_fastq(path)
    np.testing.assert_array_equal(tfq.sample_mask(20, 0.3), jfq.sample_mask(20, 0.3))
    keep = tfq.sample_mask(20, 0.5)
    for got, want in (
        (tfq.subset_batch(t, keep), jfq.subset_batch(j, keep)),
        (tfq.cut_reads(t, 3, 12), jfq.cut_reads(j, 3, 12)),
        (tfq.pad_batches([t, tfq.cut_reads(t, 1, 8)]), jfq.pad_batches([j, jfq.cut_reads(j, 1, 8)])),
    ):
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        np.testing.assert_array_equal(got.quals, want.quals)
    fa = tmp_path / "x.fa"
    fa.write_text(">c1 desc\nACGTN\nacgt\n>c2\nTTTT\n")
    for (tn, tc), (jn, jc) in zip(tfq.read_fasta(str(fa)), jfq.read_fasta(str(fa))):
        assert tn == jn
        np.testing.assert_array_equal(tc, jc)
    for a, b in zip(tfq.read_fasta_with_n(str(fa)), jfq.read_fasta_with_n(str(fa))):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
