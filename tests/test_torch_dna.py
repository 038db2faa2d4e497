"""core/dna.py of the PyTorch port against the JAX package, bit for bit.

Inputs are made from a seed with numpy and handed to both packages.  The
port carries packed words as int64 holding 32-bit values; they are compared
as uint32.  Tolerance: exact equality (everything is integer)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.core import dna as jdna
from biograph_tpu_torch.core import dna as tdna


def u32(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    assert a.dtype == np.int64 and a.min(initial=0) >= 0 and a.max(initial=0) < 1 << 32
    return a.astype(np.uint32)


def _codes(seed, R, L, top_heavy=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    if top_heavy:
        codes[:, ::16] = rng.integers(2, 4, codes[:, ::16].shape)  # top bit set
    lengths = rng.integers(0, L + 1, R).astype(np.int32)
    lengths[:2] = (0, L)
    return codes, lengths


@pytest.mark.parametrize("L", [1, 15, 16, 17, 40, 100])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_pack_codes(L, with_lengths):
    codes, lengths = _codes(L, 37, L, top_heavy=True)
    want = np.asarray(jdna.pack_codes(jnp.asarray(codes), jnp.asarray(lengths) if with_lengths else None))
    got = tdna.pack_codes(torch.from_numpy(codes), torch.from_numpy(lengths) if with_lengths else None)
    assert got.shape == want.shape == (37, tdna.words_for_bases(L))
    np.testing.assert_array_equal(u32(got), want)
    if L >= 16:
        assert (want >> 31).any()  # the case really has words with the top bit set


@pytest.mark.parametrize("L", [1, 16, 33, 100])
def test_unpack_words(L):
    codes, _ = _codes(L + 7, 20, L, top_heavy=True)
    words = jdna.pack_codes(codes)
    want = jdna.unpack_words(jnp.asarray(words), L)
    got = tdna.unpack_words(torch.from_numpy(words.astype(np.int64)), L)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), codes)


@pytest.mark.parametrize("L", [1, 7, 50])
def test_revcomp_codes(L):
    codes, lengths = _codes(L + 3, 25, L)
    np.testing.assert_array_equal(
        tdna.revcomp_codes(torch.from_numpy(codes)).numpy(),
        np.asarray(jdna.revcomp_codes(jnp.asarray(codes))),
    )
    np.testing.assert_array_equal(
        tdna.revcomp_codes(torch.from_numpy(codes), torch.from_numpy(lengths)).numpy(),
        np.asarray(jdna.revcomp_codes(jnp.asarray(codes), jnp.asarray(lengths))),
    )


@pytest.mark.parametrize("W", [1, 3, 7])
def test_prefix_mask_words(W):
    lengths = np.arange(0, 16 * W + 1, dtype=np.int32)
    want = jdna.prefix_mask_words(lengths, W)
    got = tdna.prefix_mask_words(torch.from_numpy(lengths), W)
    np.testing.assert_array_equal(u32(got), want)
    scalar = tdna.prefix_mask_words(17, W)
    np.testing.assert_array_equal(u32(scalar), jdna.prefix_mask_words(17, W))


def test_host_codec_and_word_count():
    seq = "ACGTNacgtTTGA"
    np.testing.assert_array_equal(tdna.seq_to_codes(seq), jdna.seq_to_codes(seq))
    codes = tdna.seq_to_codes(seq)
    assert tdna.codes_to_seq(codes) == jdna.codes_to_seq(codes)
    assert tdna.codes_to_seq(torch.from_numpy(codes.copy())) == jdna.codes_to_seq(codes)
    for n in (0, 1, 16, 17, 100):
        assert tdna.words_for_bases(n) == jdna.words_for_bases(n)


def test_u32_i32_round_trip():
    vals = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint32)
    t = torch.from_numpy(vals.astype(np.int64))
    as_i32 = tdna.u32_to_i32(t)
    np.testing.assert_array_equal(as_i32.numpy(), vals.view(np.int32))
    np.testing.assert_array_equal(u32(tdna.i32_to_u32(as_i32)), vals)
