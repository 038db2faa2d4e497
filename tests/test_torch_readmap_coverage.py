"""Readmap coverage of the PyTorch port against the JAX package.

The same numpy-seeded read sets and query rows go through both packages:
the window hash (keys and ids), ``Readmap.coverage`` and
``coverage_events`` on each of the port's three probe routes (the
rank-free hash probe, ``chain_fixed`` for uniform reads without the hash,
and ``probes.probe_ranges`` with the exact recompute for mixed read
lengths), both counting passes (per-entry totals, and the kmax path with
its truncation count), and ``probe_ranges`` itself.  The JAX package runs
as its own tests run it on the CPU.  Everything is integer, so the
tolerance is exact equality throughout.
"""

import dataclasses
import unittest.mock as mock
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.core import dna as jdna
from biograph_tpu.index import probes as jprobes
from biograph_tpu.index import readmap as jreadmap
from biograph_tpu_torch import convert
from biograph_tpu_torch.build.readmap_build import build_readmap
from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.index import probes as tprobes
from biograph_tpu_torch.index import readmap as treadmap


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor operations: beside other test workers, more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads_to_arrays(reads):
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = jdna.seq_to_codes(r)
        lens[i] = len(r)
    return codes, lens


def _sample():
    """``tests/test_readmap.py``'s sample: 40 random 20-mers, mates 2i and
    2i+1 but the last four."""
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGT"), size=20)) for _ in range(40)]
    mate_of = np.full(len(reads), -1, np.int64)
    for i in range(0, len(reads) - 4, 2):
        mate_of[i], mate_of[i + 1] = i + 1, i
    codes, lens = _reads_to_arrays(reads)
    return codes, lens, mate_of, (codes[:6], lens[:6])


def _duplicates():
    """``test_coverage_counts_duplicates``: a read three times and an
    overlapping one."""
    codes, lens = _reads_to_arrays(["ACGGCATTAA"] * 3 + ["TTACGGCATT"])
    return codes, lens, None, (codes[:1], lens[:1])


def _hash_queries(rng, codes, R):
    """``test_coverage_hash_probe_matches_chain``'s query rows: a read at an
    offset of up to 8 bases in random flanks, rows of 60-159 bases."""
    q = np.zeros((24, 160), np.uint8)
    ql = np.zeros(24, np.int32)
    for i in range(24):
        s = rng.integers(0, R)
        off = rng.integers(0, 9)
        seq = np.concatenate([rng.integers(0, 4, off), codes[s], rng.integers(0, 4, 160)])[:160]
        q[i] = seq
        ql[i] = rng.integers(60, 160)
    return q, ql


def _uniform():
    """``test_coverage_hash_probe_matches_chain``'s library: 400 reads of 48
    bases, so the hash route serves it."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (400, 48)).astype(np.uint8)
    lens = np.full(400, 48, np.int32)
    return codes, lens, None, _hash_queries(rng, codes, 400)


def _mixed():
    """The same library with about half the reads trimmed by 1-20 bases:
    the general route (restart chain, then the exact recompute)."""
    codes, lens, _, queries = _uniform()
    rng = np.random.default_rng(8)
    lens = lens.copy()
    lens[::2] -= rng.integers(1, 21, 200).astype(np.int32)
    codes = np.where(np.arange(48)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    return codes, lens, None, queries


def _many_lengths():
    """Reads of eleven lengths, some entries carrying many duplicates: more
    than eight lengths leave the per-entry totals out, so the kmax path
    counts, and truncates at a small kmax."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 300).astype(np.uint8)
    starts = rng.integers(0, 260, 150)
    lens = rng.integers(20, 31, 150).astype(np.int32)
    starts[:40] = 17
    lens[:40] = 25  # one read forty times
    codes = np.zeros((150, 30), np.uint8)
    for i, (s, n) in enumerate(zip(starts, lens)):
        codes[i, :n] = genome[s : s + n]
    codes[1::2] = np.stack([np.concatenate([(3 - c[:n])[::-1], c[n:]]) for c, n in zip(codes[1::2], lens[1::2])])
    q = np.stack([genome[:120], genome[90:210], genome[180:300]])
    return codes, lens, None, (q, np.array([120, 100, 120], np.int32))


LIBRARIES = {
    "sample": _sample,
    "duplicates": _duplicates,
    "uniform": _uniform,
    "mixed": _mixed,
    "many_lengths": _many_lengths,
}


@pytest.fixture(scope="module")
def worlds():
    """Each library's seqset and readmap in both packages: the port's
    carried across from the JAX package's arrays (no build cache) and built
    by the port itself (with the build's packed entries)."""
    made = {}

    def get(name):
        if name not in made:
            codes, lens, mate_of, queries = LIBRARIES[name]()
            js = jax_build_seqset(codes, lens)
            jr = jax_build_readmap(js, codes, lens, mate_of)
            arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
            arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
            ts = convert.seqset_from_numpy(arrays, "cpu")
            tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
            bs = build_seqset(codes, lens, device="cpu")
            br = build_readmap(bs, codes, lens, mate_of, device="cpu")
            made[name] = dict(jr=jr, tr=tr, br=br, queries=queries)
        return made[name]

    return get


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("P", [1, 2, 100, 1 << 20])
def test_hash_powers(P):
    want = jreadmap._hash_pows_np(P)
    got = treadmap._hash_pows(P, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("name", ["sample", "uniform", "mixed"])
def test_window_hash_keys_and_ids(worlds, name):
    w = worlds(name)
    want = w["jr"].window_hash
    for side in ("tr", "br"):  # from Seqset.d.sequences, and from the build's packed entries
        got = w[side].window_hash
        assert ("_entry_cache" in w[side].seqset.__dict__) == (side == "br")
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    keys = np.asarray(want[0])
    assert (keys < 0).any() and (keys > 0).any()  # h1 with and without its top bit


def test_window_hash_in_chunks_and_for_short_entries(worlds, monkeypatch):
    w = worlds("uniform")
    monkeypatch.setattr(treadmap, "ENTRY_CHUNK", 7)
    for side in ("tr", "br"):
        got = w[side].to("cpu").window_hash  # a new instance: nothing cached
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(w["jr"].window_hash[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(w["jr"].window_hash[1]))
    codes, lens = _reads_to_arrays(["ACGTAC", "GGCATT"])  # entries under 8 bases: no hash
    js = jax_build_seqset(codes, lens)
    ts = build_seqset(codes, lens, device="cpu")
    assert jax_build_readmap(js, codes, lens).window_hash is None
    assert build_readmap(ts, codes, lens, device="cpu").window_hash is None


@pytest.mark.parametrize("name", sorted(LIBRARIES))
@pytest.mark.parametrize("side", ["tr", "br"])
def test_coverage_and_events(worlds, name, side):
    w = worlds(name)
    q, ql = w["queries"]
    jr, rm = w["jr"], w[side]
    want = [np.asarray(x) for x in (*jr.coverage(jnp.asarray(q), jnp.asarray(ql)), *jr.coverage_events(jnp.asarray(q), jnp.asarray(ql)))]
    got = [_np(x) for x in (*rm.coverage(q, ql), *rm.coverage_events(torch.from_numpy(q), torch.from_numpy(ql)))]
    for g, x in zip(got, want):
        assert g.dtype == np.int32 and g.shape == q.shape
        np.testing.assert_array_equal(g, x)
    tot = got[0] + got[1]
    if name == "sample":  # each read covered by itself
        assert all((tot[i, : ql[i]] >= 1).all() for i in range(len(ql)))
    if name == "duplicates":
        assert (tot[0] >= 3).all()
    assert (tot > 0).any()


def test_kmax_truncation_counted_and_warned_once(worlds):
    w = worlds("many_lengths")
    q, ql = w["queries"]
    # fresh instances: their truncation counts and warnings start anew
    jr = dataclasses.replace(w["jr"], coverage_truncated=0, _warned_truncation=False)
    rm = w["tr"].to("cpu")
    assert rm.length_groups[0].shape[0] > 8
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for _ in range(2):
            want = [np.asarray(x) for x in jr.coverage(jnp.asarray(q), jnp.asarray(ql), kmax=2)]
            got = [x.numpy() for x in rm.coverage(q, ql, kmax=2)]
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g, x)
    assert rm.coverage_truncated == jr.coverage_truncated > 0
    assert sum("kmax=2" in str(x.message) for x in seen) == 2  # once a package
    f, r = rm.coverage(q, ql, kmax=64)
    assert rm.coverage_truncated == jr.coverage_truncated  # nothing more past a cap of 64
    assert (f + r >= 40).any()  # the forty copies count once the cap is raised


@pytest.mark.parametrize("name", ["uniform", "sample"])
def test_uniform_route_without_the_hash_is_the_hash_route(worlds, name, monkeypatch):
    """Uniform reads without the hash index take chain_fixed (depth
    max_entry_len) and give the hash route's coverage; with the hash the
    chain kernel is not called at all."""
    w = worlds(name)
    rm = w["tr"]
    q, ql = w["queries"]
    calls = []
    real = treadmap.rank4_ops.chain_fixed
    monkeypatch.setattr(treadmap.rank4_ops, "chain_fixed", lambda *a: calls.append(a[-1]) or real(*a))
    hashed = rm._coverage_full(q, ql, 16)
    assert calls == []
    chained = rm._coverage_full(q, ql, 16, use_hash=False)
    assert calls and set(calls) == {rm.seqset.max_entry_len}
    for a, b in zip(hashed, chained):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_general_route_runs_the_exact_recompute(worlds, monkeypatch):
    w = worlds("mixed")
    rm = w["tr"]
    assert rm.min_read_len < rm.max_read_len
    seen = []
    real = tprobes.probe_exact_kernel
    monkeypatch.setattr(tprobes, "probe_exact_kernel", lambda d, text, pos, *a: seen.append(pos) or real(d, text, pos, *a))
    rm.coverage(*w["queries"])
    assert seen and all(p.shape[0] == p.unique().shape[0] for p in seen)  # each restarted lane once, no padding


@pytest.mark.parametrize("name,depth", [("uniform", 30), ("mixed", 48), ("mixed", 9)])
def test_probe_ranges(worlds, name, depth):
    w = worlds(name)
    jd, td = w["jr"].seqset.d, w["tr"].seqset.d
    rng = np.random.default_rng(depth)
    q, _ = w["queries"]
    text = q.reshape(-1)
    Lp = q.shape[1]
    P = text.shape[0] - 5
    seg = (np.arange(P) + 5) // Lp * Lp
    want = jprobes.probe_ranges_jit(jd, jnp.asarray(text), jnp.asarray(5, jnp.int64), jnp.asarray(seg), P, depth)
    got = tprobes.probe_ranges(td, torch.from_numpy(text), 5, torch.from_numpy(seg), P, depth)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert got[3].any() and not got[3].all()
    mask = torch.from_numpy(rng.random(37) < 0.5)
    np.testing.assert_array_equal(tprobes.fetch_mask(mask), jprobes.fetch_mask(jnp.asarray(mask.numpy())))


def test_row_bucketing_and_slabs(worlds, monkeypatch):
    """Rows spread over several slabs (the lane budget cut to force them), a
    row longer than 64 bases and B not a power of two give the JAX values."""
    w = worlds("uniform")
    q, ql = w["queries"]
    q, ql = q[:21, :131], np.minimum(ql[:21], 131)
    want = [np.asarray(x) for x in w["jr"].coverage(jnp.asarray(q), jnp.asarray(ql))]
    mixed = worlds("mixed")["tr"]
    one_slab = [x.numpy() for x in mixed.coverage(q, ql)]
    for lanes in (1 << 20, 1000, 1):  # one slab; four rows a slab; one row a slab
        monkeypatch.setattr(treadmap, "SLAB_LANES", lanes)
        for rm, ref in ((w["tr"], want), (mixed, one_slab)):
            for g, x in zip(rm.coverage(q, ql), ref):
                np.testing.assert_array_equal(g.numpy(), x)


def test_readmap_to_and_min_read_len_of_an_empty_readmap(worlds):
    w = worlds("sample")
    rm = w["br"]
    moved = rm.to("cpu")
    assert moved is not rm and moved.seqset is rm.seqset
    for name in treadmap._TENSOR_FIELDS:
        assert torch.equal(getattr(moved, name), getattr(rm, name))
    q, ql = w["queries"]
    np.testing.assert_array_equal(moved.coverage(q, ql)[0].numpy(), rm.coverage(q, ql)[0].numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rm.to("cuda")
    empty = treadmap.Readmap(
        seqset=rm.seqset, offsets=torch.zeros(rm.seqset.n_entries + 1, dtype=torch.int64),
        read_lengths=torch.zeros(0, dtype=torch.int32), is_forward=torch.zeros(0, dtype=torch.bool),
        mate_pair_ptr=torch.zeros(0, dtype=torch.int64), read_ids=torch.zeros(0, dtype=torch.int64),
    )
    assert empty.min_read_len == empty.max_read_len == 0 and empty.window_hash is None
    f, r = empty.coverage(q, ql)
    assert not f.any() and not r.any()


def test_uniform_test_uses_min_read_len_not_a_folded_initial(worlds):
    """The uniform route is picked by min_read_len == max_read_len ==
    depth; a min folded with 0 would never pick it."""
    rm = worlds("uniform")["tr"]
    assert rm.min_read_len == rm.max_read_len == rm.seqset.max_entry_len == 48
    with mock.patch.object(treadmap, "_uniform_hash_probe", wraps=treadmap._uniform_hash_probe) as probe:
        rm.coverage(*worlds("uniform")["queries"])
    assert probe.called
