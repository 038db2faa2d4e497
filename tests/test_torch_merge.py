"""Seqset merge and readmap migration of the PyTorch port against the JAX
package, on ``tests/test_merge.py``'s two cases (two samples, one with a
variant; a sample merged with itself): the merged seqset's fields, the
mergemaps and every migrated readmap field exact, each package on its own
builds of the same reads; the merged seqset also equals the seqset built
from both read sets at once."""

import numpy as np
import pytest
import torch

from biograph_tpu.build.merge import merge_seqsets as jax_merge
from biograph_tpu.build.merge import migrate_readmap as jax_migrate
from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu_torch.build.merge import merge_seqsets, migrate_readmap
from biograph_tpu_torch.build.readmap_build import build_readmap
from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.convert import READMAP_DTYPES, SEQSET_DTYPES, seqset_from_numpy, seqset_to_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(rng, genome, n, L=30):
    starts = rng.integers(0, len(genome) - L, size=n)
    return np.stack([genome[s : s + L] for s in starts]), np.full(n, L, np.int32)


def two_samples(rng):
    g1 = rng.integers(0, 4, size=2000, dtype=np.uint8)
    g2 = g1.copy()
    g2[800] = (g2[800] + 1) % 4  # sample 2 has a variant
    c1, l1 = _reads(rng, g1, 300)
    c2, l2 = _reads(rng, g2, 300)
    return [(c1, l1), (c2, l2)]


def identical_samples(rng):
    g = rng.integers(0, 4, size=1500, dtype=np.uint8)
    c, l = _reads(rng, g, 200)
    return [(c, l), (c, l)]


def assert_seqset_equal(got, want):
    a = seqset_to_numpy(got)
    assert a["n_entries"] == want.n_entries
    for name in SEQSET_DTYPES:
        np.testing.assert_array_equal(a[name], np.asarray(getattr(want, name)), err_msg=name)


@pytest.fixture(scope="module", params=["two_samples", "identical"])
def merged(request):
    rng = np.random.default_rng(12345)
    samples = two_samples(rng) if request.param == "two_samples" else identical_samples(rng)
    mates = [None, np.arange(len(samples[1][1]), dtype=np.int64) ^ 1]  # the second sample paired
    jss = [jax_build_seqset(c, l) for c, l in samples]
    jrm = [jax_build_readmap(s, c, l, m) for s, (c, l), m in zip(jss, samples, mates)]
    tss = [build_seqset(c, l, device="cpu") for c, l in samples]
    trm = [build_readmap(s, c, l, m, device="cpu") for s, (c, l), m in zip(tss, samples, mates)]
    return request.param, samples, (jss, jrm, *jax_merge(jss)), (tss, trm, *merge_seqsets(tss))


def test_merged_seqset_and_mergemaps(merged):
    case, samples, (_, _, jm, jmaps), (tss, _, tm, tmaps) = merged
    assert_seqset_equal(tm, jm)
    for got, want in zip(tmaps, jmaps):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    if case == "identical":
        assert tm.n_entries == tss[0].n_entries
        assert all(torch.equal(m, torch.arange(tss[0].n_entries)) for m in tmaps)
    # the union of two stores' maximal entries is the store of both read sets
    both = build_seqset(np.concatenate([c for c, _ in samples]), np.concatenate([l for _, l in samples]), device="cpu")
    a, b = seqset_to_numpy(tm), seqset_to_numpy(both)
    for name in SEQSET_DTYPES:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_mergemap_entries_are_prefixes(merged):
    _, _, _, (tss, _, tm, tmaps) = merged
    for ss, mm in zip(tss, tmaps):
        for e in range(0, ss.n_entries, max(ss.n_entries // 40, 1)):
            assert tm.entry_sequence(int(mm[e])).startswith(ss.entry_sequence(e))


def test_migrated_readmaps(merged):
    _, _, (_, jrm, jm, jmaps), (_, trm, tm, tmaps) = merged
    for j, t, jmm, tmm in zip(jrm, trm, jmaps, tmaps):
        want = jax_migrate(j, jm, jmm)
        got = migrate_readmap(t, tm, tmm)
        for name, dtype in READMAP_DTYPES.items():
            g = getattr(got, name).numpy()
            assert g.dtype == dtype, name
            np.testing.assert_array_equal(g, np.asarray(getattr(want, name)), err_msg=name)
        assert got.get_pair_stats() == t.get_pair_stats()


def test_merge_of_loaded_stores_rebuilds_entries(merged):
    """Stores without the build's entry cache (as loaded from disk) merge
    to the same seqset through pop chains."""
    _, _, (jss, _, jm, jmaps), _ = merged
    loaded = []
    for js in jss:
        arrays = {k: np.asarray(getattr(js, k)) for k in SEQSET_DTYPES}
        loaded.append(seqset_from_numpy({**arrays, "n_entries": js.n_entries, "max_entry_len": js.max_entry_len}, "cpu"))
    assert all("_entry_cache" not in ss.__dict__ for ss in loaded)
    got, maps = merge_seqsets(loaded)
    assert_seqset_equal(got, jm)
    for g, w in zip(maps, jmaps):
        np.testing.assert_array_equal(g.numpy(), w)


def test_migrated_coverage(merged):
    """A migrated readmap counts the same reads over a sample's own
    sequence as the readmap it came from."""
    case, samples, _, (tss, trm, tm, tmaps) = merged
    for (c, l), rm, mm in zip(samples, trm, tmaps):
        moved = migrate_readmap(rm, tm, mm)
        win = torch.from_numpy(np.ascontiguousarray(c[:16]))
        lens = torch.from_numpy(l[:16])
        for a, b in zip(rm.coverage(win, lens), moved.coverage(win, lens)):
            assert torch.equal(a, b)


def test_migrated_coverage_of_mixed_lengths_is_the_jax_packages():
    """A trimmed, paired sample merged with a uniform one: its migrated
    readmap's coverage can differ from that on its own store (a probe range
    stops being unique once the other sample's entries join), in the JAX
    package as in the port, and the two packages agree exactly."""
    import os
    import sys

    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import trimmed_paired_library

    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    starts = rng.integers(0, 6000 - 100, 400)
    c1, l1 = genome[starts[:, None] + np.arange(100)], np.full(400, 100, np.int32)
    c2, l2, mate, _ = trimmed_paired_library(genome, 400, 8, 4, 2, seed=101)
    win = genome[rng.integers(0, 6000 - 150, 64)[:, None] + np.arange(150)]
    wlen = np.full(64, 150, np.int32)

    jss = [jax_build_seqset(c1, l1), jax_build_seqset(c2, l2)]
    jm, jmaps = jax_merge(jss)
    jcov = jax_migrate(jax_build_readmap(jss[1], c2, l2, mate), jm, jmaps[1]).coverage(jnp.asarray(win), jnp.asarray(wlen))
    tss = [build_seqset(c1, l1, device="cpu"), build_seqset(c2, l2, device="cpu")]
    own = build_readmap(tss[1], c2, l2, mate, device="cpu")
    tm, tmaps = merge_seqsets(tss)
    moved = migrate_readmap(own, tm, tmaps[1]).coverage(torch.from_numpy(win), torch.from_numpy(wlen))
    for got, want in zip(moved, jcov):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = own.coverage(torch.from_numpy(win), torch.from_numpy(wlen))
    differ = ((before[0] != moved[0]) | (before[1] != moved[1])).any(dim=1)
    assert 0 < int(differ.sum()) < 8
