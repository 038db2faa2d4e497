"""Read correction of the PyTorch port against the JAX package: the same
reads and the same trusted k-mer set (carried across from the JAX
package's) give identical corrected codes, lengths and correction counts,
on single errors, error bursts, uncorrectable reads, reads anchored past
their first base, mixed lengths, and batches smaller than the read set."""

import numpy as np
import pytest
import torch

from biograph_tpu.build.correct import correct_reads as jax_correct
from biograph_tpu.kmers.count import count_kmers as jax_count_kmers
from biograph_tpu.kmers.kmer_set import KmerSet as JKmerSet
from biograph_tpu_torch import convert
from biograph_tpu_torch.build import correct as tcorrect
from biograph_tpu_torch.build.correct import correct_reads


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def world(seed, G=2500, n=900, L=50, k=23, min_count=3):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    starts = rng.integers(0, G - L, n)
    reads = genome[starts[:, None] + np.arange(L)]
    lens = np.full(n, L, np.int32)
    jks = JKmerSet.from_counts(jax_count_kmers(reads, lens, k=k), min_count=min_count)
    return rng, reads, lens, jks


def assert_same(jks, codes, lengths, **kw):
    want = jax_correct(jks, codes, lengths, **kw)
    got = correct_reads(convert.kmer_set_from_numpy(jks.save_arrays(), device="cpu"), codes, lengths, **kw)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.corrections, want.corrections)
    np.testing.assert_array_equal(got.kept, want.kept)
    assert got.codes.dtype == np.uint8 and got.lengths.dtype == np.int32 and got.corrections.dtype == np.int32
    return got


def substitute(rng, codes, rows, lo, hi, n=1):
    bad = codes.copy()
    for i in rows:
        for p in rng.choice(np.arange(lo, hi), n, replace=False):
            bad[i, p] = (bad[i, p] + rng.integers(1, 4)) % 4
    return bad


def test_single_errors():
    rng, reads, lens, jks = world(1)
    bad = substitute(rng, reads, rng.choice(len(reads), 80, replace=False), 25, 50)
    got = assert_same(jks, bad, lens)
    assert (got.corrections == 1).sum() >= 60


def test_error_bursts_truncate():
    rng, reads, lens, jks = world(2)
    bad = reads[:40].copy()
    bad[:, 30:] = rng.integers(0, 4, (40, 20), dtype=np.uint8)
    got = assert_same(jks, bad, lens[:40], max_corrections=2)
    assert ((got.lengths > 0) & (got.lengths < 50)).sum() >= 20


def test_uncorrectable_reads_dropped():
    rng, reads, lens, jks = world(3)
    junk = rng.integers(0, 4, (30, 50), dtype=np.uint8)
    mixed = np.concatenate([junk, reads[:30]])
    got = assert_same(jks, mixed, np.full(60, 50, np.int32))
    assert (got.lengths[:30] == 0).all() and (got.lengths[30:] > 0).all()


def test_anchors_past_the_first_base():
    """Errors in the first k bases move the anchor; the head is kept."""
    rng, reads, lens, jks = world(4)
    bad = substitute(rng, reads, range(100), 0, 20)
    bad = substitute(rng, bad, range(50, 100), 30, 50)
    got = assert_same(jks, bad, lens)
    assert (got.lengths[:100] > 0).sum() > 50


def test_mixed_lengths_and_small_batches():
    rng, reads, lens, jks = world(5, L=60)
    lens = rng.integers(20, 61, len(reads)).astype(np.int32)
    codes = np.where(np.arange(60)[None, :] < lens[:, None], reads, 0).astype(np.uint8)
    bad = substitute(rng, codes, rng.choice(len(reads), 200, replace=False), 24, 40, n=2)
    bad = np.where(np.arange(60)[None, :] < lens[:, None], bad, 0).astype(np.uint8)
    got = assert_same(jks, bad, lens, batch_rows=128)
    assert (got.lengths == 0).any() and (got.corrections > 0).any()
    assert_same(jks, bad, lens, batch_rows=128, max_corrections=1, min_good_run=5, lookahead=3)


def test_loop_leaves_once_no_read_is_active(monkeypatch):
    """The early exit changes no answer: the same batch with a check at
    every step and with one before the first."""
    rng, reads, lens, jks = world(6)
    bad = substitute(rng, reads, range(0, 900, 3), 23, 50)
    ks = convert.kmer_set_from_numpy(jks.save_arrays(), device="cpu")
    args = (ks, torch.from_numpy(bad), torch.from_numpy(lens), 8, 2, 6)
    monkeypatch.setattr(tcorrect, "SYNC_EVERY", 1)
    every = tcorrect.correct_batch(*args)
    monkeypatch.setattr(tcorrect, "SYNC_EVERY", 10_000)
    never = tcorrect.correct_batch(*args)
    for a, b in zip(every, never):
        assert torch.equal(a, b)
