"""The pop-chain read rebuild as one kernel: ``sequences`` and its plain
version against the JAX package, csrc/sequences.cu replayed block by block on
the host, and ``Readmap.forward_reads`` (the library's reads, as coverage's
pairs, the pair gate and the SV engine take them) on a paired library.

``sequences_plain`` (which ``Seqset.d.sequences`` takes on CPU tensors) is
held to the JAX package's ``Seqset.d.sequences``, with and without the
lengths that mask each lane's bases.  The replay follows the kernel's loop: a
block of LANES lanes, each walking its own chain and stopping at its length,
the bases staged in a tile laid out as the block's rows of the output, the
tile written out in 16-byte pieces where it holds whole rows and byte by byte
where a row is walked in column chunks.  The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py.  Inputs come from
numpy seeds; everything is integer, so the tolerance is exact equality.

Run alone on the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_sequences.py -q``."""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu_torch import convert
from biograph_tpu_torch.ops import _build
from biograph_tpu_torch.ops import rank4 as trank4

L = 40
SOURCE = open(_build.source_path("sequences")).read()
LANES = int(re.search(r"constexpr int LANES = (\d+);", SOURCE).group(1))
MAX_TILE = int(np.prod([int(x) for x in re.search(r"constexpr int MAX_TILE = ([\d *]+);", SOURCE).group(1).split("*")]))


@pytest.fixture(scope="module")
def store():
    """A paired library of mixed lengths built by the JAX package, half the
    reads trimmed at their 3' end by 1-15 bases (as in hg002_35x), and the
    same store and readmap in the port, on the CPU."""
    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    rows = []
    for _ in range(150):
        f = int(rng.integers(90, 140))
        s = int(rng.integers(0, len(genome) - f))
        rows.append(genome[s : s + L])
        rows.append((3 - genome[s + f - L : s + f])[::-1])
    codes = np.stack(rows).astype(np.uint8)
    lens = np.full(len(rows), L, np.int32)
    lens[1::2] -= rng.integers(1, 16, len(lens[1::2])).astype(np.int32)
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    js = jax_build_seqset(codes, lens)
    jr = jax_build_readmap(js, codes, lens, np.arange(len(rows)) ^ 1)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    return dict(js=js, jr=jr, ts=ts, tr=tr)


def _entries(n, count=300, seed=5):
    """Random entries of a store of n, with its first and last."""
    e = np.random.default_rng(seed).integers(0, n, count).astype(np.int64)
    e[:3] = [0, n - 1, 0]
    return e


def _lengths(count, max_len, seed=6):
    """Lengths over [-2, max_len + 3]: 0, 1, max_len and past it included."""
    ln = np.random.default_rng(seed).integers(-2, max_len + 4, count).astype(np.int32)
    ln[:5] = [0, 1, max_len, max_len + 3, -1]
    return ln


def _tables(ts):
    d = ts.d
    return d.pop_sel, d.fixed


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [1, 12, 150])
def test_plain_version_is_the_jax_packages(store, max_len):
    """Random entries, the first and the last; entries shorter than max_len
    walk on past their end in both."""
    ts, js = store["ts"], store["js"]
    e = _entries(ts.n_entries)
    assert (ts.entry_sizes.numpy()[e] < max_len).any() == (max_len > 1)
    want = np.asarray(js.d.sequences(jnp.asarray(e), max_len))
    got = trank4.sequences_plain(*_tables(ts), torch.from_numpy(e), max_len)
    assert got.dtype == torch.uint8 and got.shape == (len(e), max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    # Seqset.d.sequences takes it on CPU tensors, through the wrapper
    before = trank4.sequences.launches
    np.testing.assert_array_equal(ts.d.sequences(torch.from_numpy(e), max_len).numpy(), want)
    assert trank4.sequences.launches == before


@pytest.mark.parametrize("max_len", [1, 12, 150])
def test_lengths_mask_the_unmasked_walk(store, max_len):
    ts = store["ts"]
    e = _entries(ts.n_entries)
    ln = _lengths(len(e), max_len)
    full = trank4.sequences_plain(*_tables(ts), torch.from_numpy(e), max_len).numpy()
    want = np.where(np.arange(max_len)[None, :] < ln[:, None], full, 0)
    got = trank4.sequences(*_tables(ts), torch.from_numpy(e), max_len, torch.from_numpy(ln))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ts.d.sequences(e, max_len, ln).numpy(), want)


def test_wrapper_checks_its_inputs(store):
    pop_sel, fixed = _tables(store["ts"])
    e = torch.zeros(4, dtype=torch.int64)
    for args in ((pop_sel, fixed, e.to(torch.int32), 3), (pop_sel, fixed[:4], e, 3),
                 (pop_sel, fixed, e, 3, torch.zeros(4, dtype=torch.int64)),
                 (pop_sel, fixed, e, 3, torch.zeros(5, dtype=torch.int32))):
        with pytest.raises(TypeError, match="sequences"):
            trank4.sequences(*args)
    with pytest.raises(ValueError, match="max_len"):
        trank4.sequences(pop_sel, fixed, e, -1)
    assert trank4.sequences(pop_sel, fixed, e[:0], 5).shape == (0, 5)
    assert trank4.sequences(pop_sel, fixed, e, 0).shape == (4, 0)


# ---------------------------------------------------------------------------
# the kernel's loop, block by block on the host (csrc/sequences.cu)
# ---------------------------------------------------------------------------


def _sequences_kernel_in_numpy(pop_sel, fixed, entries, max_len, lengths, max_tile=MAX_TILE):
    """sequences_kernel a block at a time, its lanes side by side: (out
    uint8 [B, max_len], gathers made, bytes written by 16-byte stores).  The
    output starts as garbage, as the wrapper's torch.empty does."""
    n, B = len(pop_sel), len(entries)
    f1, f2, f3 = (int(fixed[k]) for k in (1, 2, 3))
    out = np.full(B * max_len, 0xAB, np.uint8)
    W = min(max_len, max_tile // LANES)
    gathers = vector_bytes = 0
    for q0 in range(0, B, LANES):
        rows = min(LANES, B - q0)
        e = entries[q0 : q0 + rows].copy()
        ln = np.full(rows, max_len) if lengths is None else np.clip(lengths[q0 : q0 + rows], 0, max_len)
        for c0 in range(0, max_len, W):
            w = min(W, max_len - c0)
            tile = np.full(LANES * w, 0xCD, np.uint8)  # rows past the block's lanes stay unwritten
            for j in range(w):
                i = c0 + j
                live = i < ln
                base = (e >= f1).astype(np.uint8) + (e >= f2) + (e >= f3)
                tile[np.arange(rows) * w + j] = np.where(live, base, 0)
                step = i + 1 < ln
                assert ((e[step] >= 0) & (e[step] < n)).all()
                e = np.where(step, pop_sel[np.clip(e, 0, n - 1)], e)
                gathers += int(step.sum())
            dst, nbytes = q0 * max_len + c0, rows * w
            if w == max_len and dst % 16 == 0:  # whole rows: one run of the output
                vecs = nbytes >> 4
                for v in range(vecs):
                    out[dst + 16 * v : dst + 16 * v + 16] = tile[16 * v : 16 * v + 16]
                vector_bytes += 16 * vecs
                out[dst + 16 * vecs : dst + nbytes] = tile[16 * vecs : nbytes]
            else:
                f = np.arange(nbytes)
                out[dst + (f // w) * max_len + f % w] = tile[f]
    return out.reshape(B, max_len), gathers, vector_bytes


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("max_len,tile_cols", [(150, None), (150, 64), (12, None), (1, None)])
def test_kernel_replay_is_the_plain_version(store, max_len, tile_cols, masked):
    """The replay equals the plain version: whole-row tiles written in
    16-byte pieces, rows walked in column chunks (a tile of 64 columns, as a
    row past MAX_TILE / LANES bases is), a last block of fewer lanes; with
    lengths, a lane gathers one base fewer than its length and no more."""
    ts = store["ts"]
    pop_sel, fixed = (t.numpy() for t in _tables(ts))
    e = _entries(ts.n_entries, count=2 * LANES + 44)
    ln = _lengths(len(e), max_len) if masked else None
    want = trank4.sequences_plain(*_tables(ts), torch.from_numpy(e), max_len,
                                  None if ln is None else torch.from_numpy(ln)).numpy()
    max_tile = MAX_TILE if tile_cols is None else tile_cols * LANES
    got, gathers, vector_bytes = _sequences_kernel_in_numpy(pop_sel, fixed, e, max_len, ln, max_tile)
    np.testing.assert_array_equal(got, want)
    walked = np.full(len(e), max_len) if ln is None else np.clip(ln, 0, max_len)
    assert gathers == int(np.maximum(walked - 1, 0).sum())
    whole_rows = tile_cols is None or tile_cols >= max_len
    assert (vector_bytes > 0) == whole_rows and vector_bytes <= got.size


# ---------------------------------------------------------------------------
# coverage's read rebuild
# ---------------------------------------------------------------------------


def _sample_reads_before(jr):
    """The library's reads as coverage rebuilt them before ``sequences``
    took lengths: the forward reads' entries walked a chunk at a time (here
    by the JAX package), then masked at each read's length; each read's
    mate among them from the mate loop, itself where it has none."""
    fwd = np.nonzero(np.asarray(jr.is_forward))[0]
    entries = np.asarray(jr.entry_of_rm)[fwd]
    lens = np.asarray(jr.read_lengths)[fwd]
    Lm = int(lens.max(initial=1))
    codes = np.zeros((len(fwd), Lm), np.uint8)
    for lo in range(0, len(fwd), 64):
        codes[lo : lo + 64] = np.asarray(jr.seqset.d.sequences(jnp.asarray(entries[lo : lo + 64]), Lm))
    codes = np.where(np.arange(Lm)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    loop = np.asarray(jr.mate_pair_ptr)
    index_of = np.full(len(loop), -1, np.int64)
    index_of[fwd] = np.arange(len(fwd))
    mate_of = index_of[loop[loop[fwd]]]
    return codes, lens, np.where(mate_of >= 0, mate_of, np.arange(len(fwd)))


def test_sample_reads_as_before_on_a_trimmed_paired_library(store):
    tr = store["tr"]
    codes, lens, mate_of = tr.forward_reads()
    want = _sample_reads_before(store["jr"])
    assert len(np.unique(lens)) > 5 and (lens < L).any() and (lens == L).any()
    assert (mate_of != np.arange(len(mate_of))).any()
    for got, w in zip((codes, lens, mate_of), want):
        assert got.dtype == w.dtype and got.shape == w.shape
        np.testing.assert_array_equal(got, w)
    assert codes.shape == (tr.read_count, L)
