"""build_seqset and build_readmap of the PyTorch port against the JAX
package on the same random reads: every field bit-identical."""

import numpy as np
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu_torch.build import seqset_build as tbuild
from biograph_tpu_torch.build.readmap_build import build_readmap, reconstruct_entry_words
from biograph_tpu_torch.convert import READMAP_DTYPES, SEQSET_DTYPES, seqset_to_numpy
from biograph_tpu_torch.ops.rank_cum import rank_cum_plain


def make_reads(seed, R, L, uniform, genome_len=1500):
    """Reads of a small genome, half reverse-complemented, with exact
    duplicates and reads that are prefixes of other reads."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - L, R)
    codes = genome[starts[:, None] + np.arange(L)]
    codes[: R // 2] = (3 - codes[: R // 2])[:, ::-1]
    lengths = np.full(R, L, np.int32) if uniform else rng.integers(L // 2, L + 1, R).astype(np.int32)
    codes[-10:] = codes[:10]  # duplicates ...
    if not uniform:
        lengths[-10:-5] = lengths[:5]
        lengths[-5:] = np.maximum(lengths[5:10] - 7, 1)  # ... and strict prefixes
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0).astype(np.uint8)
    return codes, lengths


CASES = [(0, 200, 40, True), (1, 250, 50, False), (2, 120, 33, False), (3, 64, 16, True)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"seed{c[0]}-R{c[1]}-L{c[2]}-{'uniform' if c[3] else 'mixed'}")
def built(request):
    codes, lengths = make_reads(*request.param)
    return codes, lengths, jax_build_seqset(codes, lengths), tbuild.build_seqset(codes, lengths, device="cpu")


def test_seqset_fields_identical(built):
    _, _, js, ts = built
    got = seqset_to_numpy(ts)
    assert got["n_entries"] == js.n_entries and got["max_entry_len"] == js.max_entry_len
    assert ts.prev_words.dtype == torch.int32 and ts.prev_cum.dtype == torch.int64
    assert ts.entry_sizes.dtype == ts.shared.dtype == torch.int32
    assert ts.pop_sel.dtype == ts.fixed.dtype == torch.int64
    for name, dtype in SEQSET_DTYPES.items():
        want = np.asarray(getattr(js, name))
        assert got[name].dtype == want.dtype == dtype and got[name].shape == want.shape, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    # prev_cum is what the rank_cum kernel's plain version gives, row by row
    for b in range(4):
        np.testing.assert_array_equal(rank_cum_plain(ts.prev_words[b]).numpy(), got["prev_cum"][b])


@pytest.mark.parametrize("paired", [False, True])
def test_readmap_fields_identical(built, paired):
    codes, lengths, js, ts = built
    R = len(lengths)
    mate_of = None
    if paired:
        mate_of = np.arange(R, dtype=np.int64) ^ 1
        mate_of[-2:] = -1  # two unpaired reads among the pairs
    jr = jax_build_readmap(js, codes, lengths, mate_of)
    tr = build_readmap(ts, codes, lengths, mate_of, device="cpu")
    for name, dtype in READMAP_DTYPES.items():
        want = np.asarray(getattr(jr, name))
        got = getattr(tr, name).numpy()
        assert got.dtype == dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tr.get_pair_stats() == jr.get_pair_stats()
    assert (tr.num_entries, tr.read_count) == (jr.num_entries, jr.read_count)


def test_readmap_from_reconstructed_entries(built):
    """Without the build's entry cache the entry words come back from pop
    chains; the readmap is the same."""
    codes, lengths, _, ts = built
    cached_words, cached_lens = ts.__dict__["_entry_cache"]
    words, lens = reconstruct_entry_words(ts, chunk=97)
    assert torch.equal(words, cached_words) and torch.equal(lens, cached_lens.to(torch.int32))
    a = build_readmap(ts, codes, lengths, device="cpu")
    b = build_readmap(ts, codes, lengths, entry_words=words, entry_lens=lens, chunk_rows=50, device="cpu")
    for name in READMAP_DTYPES:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_build_without_reverse_complements():
    codes, lengths = make_reads(4, 80, 30, False)
    js = jax_build_seqset(codes, lengths, include_rc=False)
    got = seqset_to_numpy(tbuild.build_seqset(codes, lengths, include_rc=False, device="cpu"))
    for name in SEQSET_DTYPES:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


def test_build_drops_empty_reads_and_short_batches():
    """Zero-length reads contribute no suffix; a batch whose longest read is
    shorter than the matrix is cut at that length."""
    codes, lengths = make_reads(6, 90, 40, False)
    lengths = np.minimum(lengths, 31).astype(np.int32)
    lengths[::9] = 0
    codes = np.where(np.arange(40)[None, :] < lengths[:, None], codes, 0).astype(np.uint8)
    js = jax_build_seqset(codes, lengths)
    got = seqset_to_numpy(tbuild.build_seqset(codes, lengths, device="cpu"))
    assert got["max_entry_len"] == js.max_entry_len == 31
    for name in SEQSET_DTYPES:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(js, name)), err_msg=name)


def test_build_entry_points_refuse_what_they_cannot_do():
    codes, lengths = make_reads(5, 40, 20, True)
    with pytest.raises(ValueError, match="no nonempty reads"):
        tbuild.build_seqset(codes[:0], lengths[:0], device="cpu")
    with pytest.raises(ValueError, match="no nonempty reads"):
        tbuild.build_seqset(codes, np.zeros_like(lengths), device="cpu")
    with pytest.raises(NotImplementedError, match="partitioned"):
        tbuild.build_seqset(codes, lengths, budget=1000, device="cpu")
    ts = tbuild.build_seqset(codes, lengths, budget=1 << 30, device="cpu")
    assert ts.n_entries > 0
    if not torch.cuda.is_available():
        # the default device is the card: no silent move to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbuild.build_seqset(codes, lengths)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_readmap(ts, codes, lengths)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.to()
