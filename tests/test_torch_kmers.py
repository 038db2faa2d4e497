"""k-mer counting and the trusted k-mer set of the PyTorch port against the
JAX package on the same numpy-seeded reads: counts, the text dump byte for
byte, the filter's keep mask and stats, and membership, all exact."""

import numpy as np
import pytest
import torch

from biograph_tpu.kmers.count import KmerCounts as JKmerCounts
from biograph_tpu.kmers.count import count_kmers as jax_count_kmers
from biograph_tpu.kmers.kmer_set import KmerSet as JKmerSet
from biograph_tpu.kmers.kmer_set import _hamming1_neighbors as jax_neighbors
from biograph_tpu.kmers.kmer_set import filter_kmer_counts as jax_filter
from biograph_tpu_torch import convert
from biograph_tpu_torch.kmers import kmer_set as tks
from biograph_tpu_torch.kmers.count import count_kmers, count_kmers_device
from biograph_tpu_torch.kmers.kmer_set import KmerSet, filter_kmer_counts


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reads(seed, R=300, L=60, genome_len=900, min_len=None):
    """Reads of a small genome (so k-mers repeat), half reverse-complemented,
    lengths from min_len to L."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - L, R)
    codes = genome[starts[:, None] + np.arange(L)]
    codes[: R // 2] = (3 - codes[: R // 2])[:, ::-1]
    lengths = rng.integers(min_len or L, L + 1, R).astype(np.int32)
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0).astype(np.uint8)
    return codes, lengths


def assert_counts_equal(got, want):
    assert got.k == want.k
    assert got.kmers.dtype == np.int64
    np.testing.assert_array_equal(got.kmers, np.asarray(want.kmers).astype(np.int64))
    np.testing.assert_array_equal(got.fwd, want.fwd)
    np.testing.assert_array_equal(got.rev, want.rev)
    np.testing.assert_array_equal(got.total, want.total)


@pytest.mark.parametrize("k", [15, 23, 31])
@pytest.mark.parametrize("batch_rows", [1 << 17, 64, 37])
def test_count_kmers(k, batch_rows):
    codes, lengths = reads(k, min_len=10)  # some reads shorter than k
    want = jax_count_kmers(codes, lengths, k=k, batch_rows=batch_rows)
    got = count_kmers(codes, lengths, k=k, batch_rows=batch_rows, device="cpu")
    assert len(got.kmers) > 100
    assert_counts_equal(got, want)


@pytest.mark.parametrize("shape", ["no_reads", "reads_narrower_than_k", "all_reads_shorter_than_k"])
def test_count_kmers_with_nothing_to_count(shape):
    codes, lengths = reads(3, R=8, L=40)
    if shape == "no_reads":
        codes, lengths = codes[:0], lengths[:0]
    elif shape == "reads_narrower_than_k":
        codes = np.ascontiguousarray(codes[:, :20])
        lengths = np.minimum(lengths, 20)
    else:
        lengths = np.full(8, 12, np.int32)
    got = count_kmers(codes, lengths, k=23, device="cpu")
    assert len(got.kmers) == len(got.fwd) == len(got.rev) == 0 and got.kmers.dtype == np.int64
    if shape != "all_reads_shorter_than_k":
        assert_counts_equal(got, jax_count_kmers(codes, lengths, k=23))
    # and in several batches, where the host merge sees empty batches
    assert len(count_kmers(codes, lengths, k=23, batch_rows=3, device="cpu").kmers) == 0


def test_count_kmers_device_is_one_batch():
    codes, lengths = reads(5)
    uk, uf, ur = count_kmers_device(torch.from_numpy(codes), torch.from_numpy(lengths), 23)
    want = jax_count_kmers(codes, lengths, k=23)
    np.testing.assert_array_equal(uk.numpy(), want.kmers.astype(np.int64))
    np.testing.assert_array_equal(uf.numpy(), want.fwd)
    np.testing.assert_array_equal(ur.numpy(), want.rev)


def test_k_32_raises_naming_the_limit():
    codes, lengths = reads(1, R=4)
    with pytest.raises(ValueError, match="k <= 31"):
        count_kmers(codes, lengths, k=32, device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    codes, lengths = reads(1, R=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        count_kmers(codes, lengths, k=15)


@pytest.mark.parametrize("k", [11, 23, 31])
def test_write_text_byte_for_byte(tmp_path, k):
    codes, lengths = reads(k + 100)
    want = jax_count_kmers(codes, lengths, k=k)
    got = count_kmers(codes, lengths, k=k, device="cpu")
    want.write_text(str(tmp_path / "jax.txt"))
    got.write_text(str(tmp_path / "torch.txt"))
    assert (tmp_path / "torch.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "torch.txt").read_bytes().count(b"\n") == len(got.kmers)


def test_hamming1_neighbors():
    rng = np.random.default_rng(9)
    km = rng.integers(0, 1 << 46, 50, dtype=np.uint64)
    np.testing.assert_array_equal(tks._hamming1_neighbors(km.astype(np.int64), 23), jax_neighbors(km, 23).astype(np.int64))


def overrep_counts():
    """test_correct.py::test_overrep_filter_parity's counts."""
    k = 23
    rng = np.random.default_rng(5)
    base = np.uint64(rng.integers(0, 1 << (2 * k), dtype=np.uint64))
    nb = (base & ~(np.uint64(3) << np.uint64(14))) | (((base >> np.uint64(14)) + np.uint64(1)) & np.uint64(3)) << np.uint64(14)
    far = base ^ np.uint64(0b1111)
    normal = np.uint64(rng.integers(0, 1 << (2 * k), dtype=np.uint64))
    kmers = np.sort(np.array([base, nb, far, normal], np.uint64))
    idx = {int(v): i for i, v in enumerate(kmers)}
    fwd = np.zeros(4, np.int64)
    rev = np.zeros(4, np.int64)
    for v, f, r in ((base, 3000, 3100), (nb, 4, 3), (far, 5, 5), (normal, 20, 22)):
        fwd[idx[int(v)]], rev[idx[int(v)]] = f, r
    return JKmerCounts(k=k, kmers=kmers, fwd=fwd, rev=rev)


def random_counts(seed, n=4000, k=23):
    """Random counts with a few overrepresented k-mers and some of their
    one-substitution neighbours (on either strand) at low counts."""
    rng = np.random.default_rng(seed)
    kmers = rng.integers(0, 1 << (2 * k), n, dtype=np.uint64)
    ov = kmers[:8]
    near = jax_neighbors(ov, k)[:, ::7].reshape(-1)
    from biograph_tpu.core import dna as jdna

    near_rc = jax_neighbors(np.asarray(jdna.revcomp_kmer(ov, k)), k)[:, ::11].reshape(-1)
    kmers = np.unique(np.concatenate([kmers, near, near_rc]))
    m = len(kmers)
    fwd = rng.integers(0, 40, m).astype(np.int64)
    rev = rng.integers(0, 40, m).astype(np.int64)
    hot = np.isin(kmers, ov)
    fwd[hot] += 5000
    rev[hot] += rng.integers(0, 6000, int(hot.sum()))
    lowish = rng.random(m) < 0.3
    fwd[lowish] //= 8
    rev[lowish] = 0
    return JKmerCounts(k=k, kmers=kmers, fwd=fwd, rev=rev)


FILTERS = [
    dict(min_count=2),
    dict(min_count=2, overrep_threshold=1000),
    dict(min_count=3, max_count=60, skew_cutoff=0.2, overrep_threshold=1000, sys_err_thresh=0.2, rnd_err_thresh=0.01),
    dict(min_count=1, prior_count=2, skew_cutoff=0.35, overrep_threshold=500),
]


@pytest.mark.parametrize("counts", ["overrep_parity", "random_a", "random_b"])
@pytest.mark.parametrize("kw", FILTERS, ids=["min", "overrep", "all", "strict_skew"])
def test_filter_kmer_counts(counts, kw):
    jc = overrep_counts() if counts == "overrep_parity" else random_counts({"random_a": 1, "random_b": 2}[counts])
    want_keep, want_stats = jax_filter(jc, **kw)
    keep, stats = filter_kmer_counts(convert.kmer_counts_from_numpy(vars(jc)), **kw)
    np.testing.assert_array_equal(keep, want_keep)
    assert stats == want_stats
    if counts != "overrep_parity" and kw.get("overrep_threshold"):
        assert stats["OVERREP"] > 0 and stats["NEAR_OVERREP"] > 0


def test_kmer_set_contains():
    codes, lengths = reads(21)
    jc = jax_count_kmers(codes, lengths, k=23)
    stats_j, stats_t = {}, {}
    jks = JKmerSet.from_counts(jc, min_count=2, stats_out=stats_j)
    tks_ = KmerSet.from_counts(convert.kmer_counts_from_numpy(vars(jc)), min_count=2, stats_out=stats_t, device="cpu")
    assert stats_t == stats_j and tks_.size == jks.size > 0
    np.testing.assert_array_equal(tks_.save_arrays()["kmers"], np.asarray(jks.kmers).astype(np.int64))
    # raw k-mers of the reads, their reverse complements and random ones
    from biograph_tpu.core import dna as jdna

    km, valid = jdna.kmers_from_codes(codes, lengths, 23)
    rng = np.random.default_rng(4)
    q = np.concatenate([km[valid][:3000], np.asarray(jdna.revcomp_kmer(km[valid][:500], 23)), rng.integers(0, 1 << 46, 2000, dtype=np.uint64)])
    want = np.asarray(jks.contains(q))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(tks_.contains(torch.from_numpy(q.astype(np.int64))).numpy(), want)
    carried = convert.kmer_set_from_numpy(jks.save_arrays(), device="cpu")
    np.testing.assert_array_equal(carried.contains(q.astype(np.int64)).numpy(), want)
    empty = KmerSet(k=23, kmers=torch.zeros(0, dtype=torch.int64))
    assert not empty.contains(torch.from_numpy(q[:10].astype(np.int64))).any()
