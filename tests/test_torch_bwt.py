"""The port's reference FM-index (``biograph_tpu_torch/index/bwt.py``)
against the JAX package's, on the CPU.

``tests/test_bwt.py``'s cases, plus genomes that need many doubling
rounds (a homopolymer, tandem repeats, a repeat next to random sequence):
the suffix array, the stored arrays, ``find``, ``locate`` and ``count``
equal to the JAX package's and to brute force; an index saved by either
package loads in the other; ``cached_build`` into a cache directory.
Tolerance: exact equality.
"""

import os

import numpy as np
import pytest
import torch

from biograph_tpu.core import dna as jdna
from biograph_tpu.index import bwt as jbwt
from biograph_tpu_torch.index import bwt as tbwt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genomes():
    rng = np.random.default_rng(21)
    return {
        "random": rng.integers(0, 4, 3000).astype(np.uint8),
        "homopolymer": np.full(700, 2, np.uint8),
        "tandem_5": np.tile(np.array([0, 1, 2, 1, 3], np.uint8), 150),
        "dinucleotide_then_random": np.concatenate([np.tile(np.array([2, 3], np.uint8), 400), rng.integers(0, 4, 60).astype(np.uint8)]),
        "tandem_37_with_snps": _tandem_with_snps(rng),
        "one_base": np.array([1], np.uint8),
    }


def _tandem_with_snps(rng):
    g = np.tile(rng.integers(0, 4, 37).astype(np.uint8), 30)
    g[rng.choice(len(g), 5, replace=False)] ^= 1
    return g


GENOMES = _genomes()


def _stored(b):
    """The stored arrays of either package's index, as numpy."""
    if isinstance(b, tbwt.RefBwt):
        words = torch.stack([o.words for o in b.occ]).numpy().view(np.uint32)
        cum = torch.stack([o.cum for o in b.occ]).numpy()
        return words, cum, b.sa_sample.numpy(), np.asarray(b.counts), b.sentinel_pos, [o.total for o in b.occ]
    return (np.stack([o.words for o in b.occ]), np.stack([o.cum for o in b.occ]), b.sa_sample, b.counts, b.sentinel_pos, [o.total for o in b.occ])


def _naive(text, q):
    return [j for j in range(len(text) - len(q) + 1) if text[j : j + len(q)] == q]


def test_suffix_array_small():
    g = jdna.seq_to_codes("ACGTACGTAC")
    suff = ["".join("ACGT"[c] for c in g[i:]) for i in range(len(g))] + [""]
    order = sorted(range(len(suff)), key=lambda i: suff[i])
    assert tbwt.build_suffix_array(g, device="cpu").tolist() == order == list(jbwt.build_suffix_array(g))


@pytest.mark.parametrize("name", sorted(GENOMES))
def test_index_equals_jax(name):
    """Suffix array and every stored array equal to the JAX package's;
    the suffix array is brute force's."""
    g = GENOMES[name]
    sa = tbwt.build_suffix_array(g, device="cpu").numpy()
    np.testing.assert_array_equal(sa, jbwt.build_suffix_array(g))
    if len(g) <= 1000:
        text = jdna.codes_to_seq(g)
        assert sa.tolist() == sorted(range(len(g) + 1), key=lambda i: text[i:] if i < len(g) else "")
    got, want = _stored(tbwt.RefBwt.build(g, device="cpu")), _stored(jbwt.RefBwt.build(g))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(GENOMES))
def test_find_locate_count_equal_jax(name):
    """Batched find of substrings of every length (present, repeated and
    absent), locate and count: the JAX package's answers, and brute force's."""
    g = GENOMES[name]
    rng = np.random.default_rng(len(g))
    tb, jb = tbwt.RefBwt.build(g, device="cpu"), jbwt.RefBwt.build(g)
    text = jdna.codes_to_seq(g)
    L = min(41, len(g))
    starts = rng.integers(0, len(g) - L + 1, 48)
    q = np.stack([g[s : s + L] for s in starts] + [rng.integers(0, 4, L).astype(np.uint8) for _ in range(8)])
    ql = np.concatenate([rng.integers(1, L + 1, 48), np.full(8, L)]).astype(np.int32)
    got, want = tb.find(q, ql), jb.find(q, ql)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for i in range(0, len(q), 5):
        lo, hi = int(got[0][i]), int(got[1][i])
        seq = jdna.codes_to_seq(q[i, : ql[i]])
        naive = _naive(text, seq)
        assert hi - lo == len(naive) == tb.count(seq) == jb.count(seq)
        assert list(tb.locate(lo, hi, max_hits=len(naive))) == naive == list(jb.locate(lo, hi, max_hits=len(naive)))
        if len(naive) > 3:
            np.testing.assert_array_equal(tb.locate(lo, hi, max_hits=3), jb.locate(lo, hi, max_hits=3))


def test_find_and_locate_random(rng):
    """tests/test_bwt.py's random genome: counts and positions of brute
    force for lengths 1 to 40, and an absent query."""
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    bwt = tbwt.RefBwt.build(g, device="cpu")
    text = jdna.codes_to_seq(g)
    for L in (1, 5, 17, 40):
        for _ in range(10):
            i = int(rng.integers(0, len(g) - L))
            q = text[i : i + L]
            lo, hi = bwt.find(q)
            naive = _naive(text, q)
            assert int(hi[0] - lo[0]) == len(naive), (L, q)
            assert list(bwt.locate(int(lo[0]), int(hi[0]), max_hits=len(naive))) == naive
    qm = "A" * 41 if "A" * 41 not in text else "C" * 41
    lo, hi = bwt.find(qm)
    assert int(hi[0] - lo[0]) == 0 and len(bwt.locate(int(lo[0]), int(hi[0]))) == 0


def test_saved_by_either_loads_in_the_other(tmp_path, rng):
    g = rng.integers(0, 4, 2000).astype(np.uint8)
    tb, jb = tbwt.RefBwt.build(g, device="cpu"), jbwt.RefBwt.build(g)
    tb.save(str(tmp_path / "torch"))
    jb.save(str(tmp_path / "jax"))
    for part in ("counts", "occ_words", "occ_cum", "sa_sample"):
        a = open(tmp_path / "torch" / f"{part}.npy", "rb").read()
        assert a == open(tmp_path / "jax" / f"{part}.npy", "rb").read(), part
    from_jax, from_torch = tbwt.RefBwt.load(str(tmp_path / "jax"), "cpu"), jbwt.RefBwt.load(str(tmp_path / "torch"))
    assert from_jax.uuid == jb.uuid and from_torch.uuid == tb.uuid
    for a, b in zip(_stored(from_jax), _stored(jb)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    q = jdna.codes_to_seq(g[500:540])
    assert from_jax.count(q) == from_torch.count(q) == tb.count(q) >= 1
    lo, hi = from_jax.find(q)
    assert 500 in list(from_jax.locate(int(lo[0]), int(hi[0])))
    assert list(from_torch.locate(int(lo[0]), int(hi[0]))) == list(from_jax.locate(int(lo[0]), int(hi[0])))


def test_cached_build(tmp_path, rng):
    """The first call builds and saves into the cache directory, the second
    loads that artifact; a cache entry that cannot be read is built again."""
    g = rng.integers(0, 4, 1500).astype(np.uint8)
    cache = str(tmp_path / "cache")
    first = tbwt.RefBwt.cached_build(g, cache, device="cpu")
    (entry,) = os.listdir(cache)
    assert entry.startswith("refbwt_") and entry.endswith("_r32") and first.uuid
    again = tbwt.RefBwt.cached_build(g, cache, device="cpu")
    assert again.uuid == first.uuid
    for a, b in zip(_stored(again), _stored(jbwt.RefBwt.build(g))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    os.remove(os.path.join(cache, entry, "occ_words.npy"))
    rebuilt = tbwt.RefBwt.cached_build(g, cache, device="cpu")
    assert rebuilt.uuid != first.uuid and rebuilt.count(jdna.codes_to_seq(g[100:130])) >= 1


def test_entry_points_default_to_cuda(rng):
    g = rng.integers(0, 4, 100).astype(np.uint8)
    if not torch.cuda.is_available():
        for fn in (tbwt.RefBwt.build, tbwt.build_suffix_array):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn(g)
