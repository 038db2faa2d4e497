"""The port's batched affine-gap aligner against the JAX package's: the same
block pairs, made from a numpy seed, through both ``align_blocks_batch``.
Tolerance: identical op lists (and identical traceback bytes where the DP
itself is compared)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.ops import align_dp as jalign
from biograph_tpu_torch.ops import align_dp as talign
from biograph_tpu_torch.variants.discover import _align_decompose


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is many small tensor operations; run
    beside other test workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SIMPLE = [
    ([0, 1, 2, 3], [0, 1, 2, 3]),  # equal
    ([0, 1, 2, 3], [0, 1, 1, 3]),  # 1 SNP
    ([0, 1, 2, 3], [0, 1, 3]),  # 1 del
    ([0, 1, 3], [0, 1, 2, 3]),  # 1 ins
    ([0, 1, 2, 3, 0, 1], [0, 3, 2, 1, 0, 1]),  # SNPs
    ([0] * 10, [0] * 4),  # big del
    ([1, 2], [3, 0, 1, 2, 3, 3]),  # messy
    ([2], [2, 2, 2]),  # one base against a run of it
    ([], [1, 2]),  # nothing against something
    ([3, 3], []),
]


def _blocks(cases):
    return [np.array(r, np.uint8) for r, _ in cases], [np.array(a, np.uint8) for _, a in cases]


def _tied_pairs(rng, n, lo, hi):
    """Block pairs of mixed lengths built to hold score ties: homopolymer
    runs and short repeats, the alt a copy of the ref with runs stretched,
    cut and mutated, so that a gap has many equally cheap places."""
    refs, alts = [], []
    for _ in range(n):
        target = int(rng.integers(lo, hi + 1))
        parts = []
        while sum(map(len, parts)) < target:
            kind = rng.integers(0, 3)
            if kind == 0:
                parts.append(np.full(rng.integers(2, 12), rng.integers(0, 4), np.uint8))
            elif kind == 1:
                parts.append(np.tile(rng.integers(0, 4, rng.integers(2, 4)).astype(np.uint8), rng.integers(2, 5)))
            else:
                parts.append(rng.integers(0, 4, rng.integers(1, 9)).astype(np.uint8))
        ref = np.concatenate(parts)[:target]
        alt = []
        for p in parts:
            roll = rng.random()
            if roll < 0.2:
                continue  # the part is deleted
            if roll < 0.4:
                p = np.concatenate([p, p[: rng.integers(1, len(p) + 1)]])  # stretched
            if roll > 0.8:
                p = p.copy()
                p[rng.integers(0, len(p))] = rng.integers(0, 4)
            alt.append(p)
        alt = np.concatenate(alt)[: hi] if alt else np.zeros(0, np.uint8)
        if len(alt) == 0:
            alt = ref[:1].copy()
        refs.append(ref)
        alts.append(alt)
    return refs, alts


def test_simple_cases_identical_ops():
    refs, alts = _blocks(SIMPLE)
    got = talign.align_blocks_batch(refs, alts, device="cpu")
    assert got == jalign.align_blocks_batch(refs, alts)
    assert got[0] == [("M", i, i) for i in range(4)]
    assert got[2].count(("D", 2, 2)) == 1 and len(got[2]) == 4


@pytest.mark.parametrize("seed,n,lo,hi", [(0, 80, 1, 40), (1, 80, 20, 120), (2, 40, 100, 300)])
def test_random_tied_blocks_identical_ops(seed, n, lo, hi):
    """200 pairs of lengths 1-300 in all, in mixed-length batches, so the
    pow2 buckets of both packages are walked as well."""
    refs, alts = _tied_pairs(np.random.default_rng(seed), n, lo, hi)
    assert min(map(len, refs)) >= 1 and max(max(map(len, refs)), max(map(len, alts))) <= hi + 12
    got = talign.align_blocks_batch(refs, alts, device="cpu")
    want = jalign.align_blocks_batch(refs, alts)
    assert got == want
    mixed = sum(1 for ops in got if {"D", "I"} <= {op for op, _, _ in ops})
    assert mixed > 0  # both kinds of gap in one alignment


def test_traceback_bytes_and_final_state_identical():
    """The DP itself: every traceback byte the host could read, and the final
    state, on tied blocks padded into one shape."""
    refs, alts = _tied_pairs(np.random.default_rng(5), 24, 5, 28)
    Lr = La = 32
    N = len(refs)
    ref = np.zeros((N, Lr), np.uint8)
    alt = np.zeros((N, La + 1), np.uint8)
    rl, al = np.zeros(N, np.int32), np.zeros(N, np.int32)
    for i, (r, a) in enumerate(zip(refs, alts)):
        a = a[:La]
        ref[i, : len(r)], alt[i, 1 : 1 + len(a)], rl[i], al[i] = r, a, len(r), len(a)
    jt, jf = jalign._align_scores_jit(jnp.asarray(ref), jnp.asarray(alt), jnp.asarray(rl), jnp.asarray(al), Lr, La)
    tt, tf = talign._align_scores(torch.from_numpy(ref), torch.from_numpy(alt), torch.from_numpy(rl.astype(np.int64)), torch.from_numpy(al.astype(np.int64)), Lr, La)
    assert tt.dtype == tf.dtype == torch.uint8
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    jt, tt = np.asarray(jt), tt.numpy()
    for i in range(N):  # rows and columns inside the block: the cells a traceback can visit
        np.testing.assert_array_equal(tt[i, : rl[i] + 1, : al[i] + 1], jt[i, : rl[i] + 1, : al[i] + 1])


def test_first_minimum_wins_ties():
    a = torch.tensor([1.0, 2.0, 2.0, 3.0, 1e9])
    b = torch.tensor([1.0, 2.0, 1.0, 3.0, 1e9])
    c = torch.tensor([1.0, 1.0, 1.0, 4.0, 1e9])
    best, src = talign._first_min3(a.double(), b.double(), c.double())
    assert src.tolist() == [0, 2, 1, 0, 0] and best.tolist() == [1.0, 1.0, 1.0, 3.0, 1e9]
    want = np.argmin(np.stack([a.numpy(), b.numpy(), c.numpy()]), axis=0)
    assert src.tolist() == want.tolist()


def test_pieces_from_batch_ops_match_the_scalar_aligner_cost():
    """The batch DP's ops and the scalar NW beside extract_variants cost the
    same on every pair (their ties may fall differently)."""

    def cost(ref, alt, ops):
        c, prev = 0.0, None
        for op, i, j in ops:
            c += (0.0 if ref[i] == alt[j] else 1.0) if op == "M" else (2.5 if prev != op else 0.5)
            prev = op
        return c

    refs, alts = _tied_pairs(np.random.default_rng(9), 12, 3, 30)
    genome = np.zeros(64, np.uint8)
    for r, a, ops in zip(refs, alts, talign.align_blocks_batch(refs, alts, device="cpu")):
        # the scalar aligner, reached the way a direct caller reaches it
        n, m = len(r), len(a)
        M = np.full((n + 1, m + 1), 1e18)
        Ix, Iy = M.copy(), M.copy()
        M[0, 0] = 0.0
        Ix[1:, 0] = 2.5 + 0.5 * np.arange(n)
        Iy[0, 1:] = 2.5 + 0.5 * np.arange(m)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                M[i, j] = (r[i - 1] != a[j - 1]) + min(M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1])
                Ix[i, j] = min(M[i - 1, j] + 2.5, Ix[i - 1, j] + 0.5)
                Iy[i, j] = min(M[i, j - 1] + 2.5, Iy[i, j - 1] + 0.5)
        assert cost(r, a, ops) == min(M[n, m], Ix[n, m], Iy[n, m])
        # and both routes of _align_decompose give pieces that rebuild alt from ref
        for pieces in (_align_decompose(genome, 8, r, a, ops=ops), _align_decompose(genome, 8, r, a)):
            assert all(len(rs) >= 1 and len(as_) >= 1 for _, rs, as_ in pieces)


def test_device_argument_defaults_to_the_card():
    refs, alts = _blocks(SIMPLE[:2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            talign.align_blocks_batch(refs, alts)
    assert talign.align_blocks_batch([], [], device="cpu") == []
