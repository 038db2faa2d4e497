"""ops/sortutil.py of the PyTorch port against the JAX package.

Cases of tests/test_sortutil.py plus words with the top bit set, duplicate
rows and rows that are prefixes of others.  Tolerance: exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.core import dna as jdna
from biograph_tpu.ops import sortutil as jsort
from biograph_tpu_torch.ops import sortutil as tsort


def _seqs(seed, N, L):
    """Random sequences with duplicates, prefixes of other rows, runs of
    trailing A's and first bases 2/3 (top bit of the word set)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (N, L)).astype(np.uint8)
    lengths = rng.integers(1, L + 1, N).astype(np.int32)
    codes[N // 2 :] = codes[: N - N // 2]  # same bases, other lengths
    lengths[-5:] = lengths[N - N // 2 - 5 : N - N // 2]  # exact duplicates
    codes[::3, -4:] = 0
    codes[:, 0] = rng.integers(0, 4, N)
    words = jdna.pack_codes(codes, lengths)
    return codes, lengths, words


def _t(words):
    return torch.from_numpy(np.asarray(words).astype(np.int64))


@pytest.mark.parametrize("seed,N,L", [(0, 200, 40), (1, 333, 100), (2, 50, 16), (3, 64, 17)])
def test_sort_sequences_device(seed, N, L):
    _, lengths, words = _seqs(seed, N, L)
    payload = np.arange(N, dtype=np.int64)
    jw, jl, (jp,) = jsort.sort_sequences_device(
        jnp.asarray(words), jnp.asarray(lengths), (jnp.asarray(payload),)
    )
    tw, tl, (tp,) = tsort.sort_sequences_device(
        _t(words), torch.from_numpy(lengths), (torch.from_numpy(payload),)
    )
    np.testing.assert_array_equal(tw.numpy().astype(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))  # stable
    np.testing.assert_array_equal(tp.numpy(), jsort.sort_sequences_np(words, lengths))


@pytest.mark.parametrize("ncols", [1, 2, 3, 4, 5])
def test_lex_argsort_any_column_count(ncols):
    rng = np.random.default_rng(ncols)
    cols = [rng.choice([0, 1, (1 << 31), (1 << 32) - 1], 300) for _ in range(ncols)]
    got = tsort.lex_argsort([torch.from_numpy(c.astype(np.int64)) for c in cols])
    want = np.lexsort(cols[::-1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,N,L", [(4, 300, 40), (5, 200, 100)])
def test_is_prefix_of_next_and_lcp_with_prev(seed, N, L):
    _, lengths, words = _seqs(seed, N, L)
    order = jsort.sort_sequences_np(words, lengths)
    sw, sl = words[order], lengths[order]
    tw, tl = _t(sw), torch.from_numpy(sl)
    want = np.asarray(jsort.is_prefix_of_next(jnp.asarray(sw), jnp.asarray(sl)))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(tsort.is_prefix_of_next(tw, tl).numpy(), want)
    np.testing.assert_array_equal(
        tsort.lcp_with_prev(tw, tl).numpy(),
        np.asarray(jsort.lcp_with_prev(jnp.asarray(sw), jnp.asarray(sl))),
    )
    assert tsort.lcp_with_prev(tw[:0], tl[:0]).shape == (0,)


def test_clz32():
    vals = np.array([0, 1, 2, 3, 255, 256, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint32)
    want = np.asarray(jsort._clz32(vals, np))
    got = tsort._clz32(torch.from_numpy(vals.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [6, 7])
def test_merge_lower_bound(seed):
    _, lengths, words = _seqs(seed, 240, 40)
    order = jsort.sort_sequences_np(words, lengths)
    sw, sl = words[order], lengths[order]
    keep = ~np.asarray(jsort.rows_equal(sw, sl))
    ew, el = sw[keep], sl[keep]
    # queries: some equal to entries, some random, some prefixes
    _, ql, qw = _seqs(seed + 100, 120, 40)
    qw = np.concatenate([qw, ew[::4]])
    ql = np.concatenate([ql, el[::4]])
    want = np.asarray(
        jsort.merge_lower_bound(jnp.asarray(ew), jnp.asarray(el), jnp.asarray(qw), jnp.asarray(ql))
    )
    got = tsort.merge_lower_bound(_t(ew), torch.from_numpy(el), _t(qw), torch.from_numpy(ql))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # an exact match is its own lower bound
    np.testing.assert_array_equal(got.numpy()[120:], np.arange(len(ew))[::4])
