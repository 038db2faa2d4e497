"""LtSearch and the seqset's widen family (truncate_ranges, pop_front_ranges,
push_front_drop) of the PyTorch port against the JAX package: the same
values and stores (numpy seeds, the stores built by JAX and carried across
with convert.seqset_from_numpy), the same queries.  Tolerance: exact
equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.core import dna
from biograph_tpu.index.seqset import SeqsetRanges as JRanges
from biograph_tpu.ops.ltsearch import LtSearch as JLt
from biograph_tpu_torch import convert
from biograph_tpu_torch.index.seqset import SeqsetRanges as TRanges
from biograph_tpu_torch.ops import ltsearch as tlt

INT32_MAX = np.iinfo(np.int32).max


def _both(values):
    values = np.asarray(values, np.int32)
    return JLt.build(values), tlt.LtSearch.build(torch.from_numpy(values))


def _assert_queries(values, pos_back, c_back, pos_fwd, c_fwd):
    j, t = _both(values)
    pos_back, pos_fwd = np.asarray(pos_back, np.int64), np.asarray(pos_fwd, np.int64)
    c_back, c_fwd = np.asarray(c_back, np.int32), np.asarray(c_fwd, np.int32)
    got = t.next_backward_lt(torch.from_numpy(pos_back), torch.from_numpy(c_back))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.next_backward_lt(jnp.asarray(pos_back), jnp.asarray(c_back))))
    got = t.next_forward_lt(torch.from_numpy(pos_fwd), torch.from_numpy(c_fwd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.next_forward_lt(jnp.asarray(pos_fwd), jnp.asarray(c_fwd))))
    return t


def _case(name, rng):
    """(values, back positions, back c, fwd positions, fwd c)."""
    if name == "random":
        n = 700
        vals = rng.integers(0, 8, n)
        c = rng.integers(0, 9, 300)
    elif name == "cross_block":  # matches many blocks away, as tests/test_ltsearch.py
        n = 2000
        vals = np.full(n, 100)
        vals[3], vals[1990] = 1, 2
        c = rng.choice([2, 3, 5, 101], 300)
    elif name == "none_below":
        n = 1300
        vals = rng.integers(10, 20, n)
        c = rng.integers(0, 11, 300)
    elif name == "long_walks":  # hundreds of blocks between the values below c
        n = 60000
        vals = np.full(n, 50)
        vals[[5, 777, 30000, 59990]] = [3, 1, 2, 0]
        c = rng.integers(0, 5, 300)
    elif name == "all_below":
        n = 1024  # a whole number of blocks: position n lies in a block past the end
        vals = rng.integers(0, 5, n)
        c = np.full(300, 6)
    else:  # one block, short
        n = 37
        vals = rng.integers(0, 40, n)
        c = rng.integers(0, 41, 300)
    edges = np.array([0, 1, n - 1, n])
    pos = np.concatenate([edges, rng.integers(0, n + 1, 300 - len(edges))])
    # next_forward_lt(end - 1) with end == 0 asks from position -1 (block -1)
    pos_fwd = np.concatenate([[-1, -1], edges, rng.integers(0, n, 300 - len(edges) - 2)])
    return vals, pos, c, pos_fwd, c


CASES = ["random", "cross_block", "none_below", "long_walks", "all_below", "one_block"]


@pytest.mark.parametrize("name", CASES)
def test_ltsearch_against_jax(name):
    rng = np.random.default_rng(CASES.index(name) + 3)
    vals, pos, c, pos_fwd, c_fwd = _case(name, rng)
    t = _assert_queries(vals, pos, c, pos_fwd, c_fwd)
    nb = -(-len(vals) // 256)
    assert t.n == len(vals) and t.values.shape == (nb * 256,) and t.block_min.shape == (nb,)
    assert (t.values[len(vals):] == INT32_MAX).all()
    # the walk's level tables: the minimum of 2^k blocks from each block on
    bmin = t.block_min.numpy()
    for direction, blocks in enumerate((bmin, bmin[::-1])):
        assert t.levels.shape[:2] == (2, max(nb - 1, 0).bit_length() + 1)
        for k in range(t.levels.shape[1]):
            want = [blocks[b : b + (1 << k)].min() for b in range(nb)]
            np.testing.assert_array_equal(t.levels[direction, k].numpy(), want)
    back = t.next_backward_lt(torch.from_numpy(pos), torch.from_numpy(c.astype(np.int32))).numpy()
    fwd = t.next_forward_lt(torch.from_numpy(pos_fwd), torch.from_numpy(c_fwd.astype(np.int32))).numpy()
    if name == "none_below":  # the sentinels
        below = c <= 10
        assert (back[below] == -1).all() and (fwd[below] == len(vals)).all()


def test_ltsearch_pinned_edges():
    vals = np.full(2000, 100, np.int32)
    vals[3], vals[1990] = 1, 2
    _, t = _both(vals)
    assert t.next_backward_lt(torch.tensor([1500, 2, 4, 0]), torch.tensor([5, 5, 2, 200])).tolist() == [3, -1, 3, -1]
    assert t.next_forward_lt(torch.tensor([10, 1995, 3, -1, 1999]), torch.tensor([5, 5, 1, 101, 101])).tolist() == [1990, 2000, 2000, 0, 2000]
    # a scalar threshold serves every lane
    assert t.next_forward_lt(torch.tensor([0, 5]), 3).tolist() == [3, 1990]


def test_ltsearch_walk_polls_and_chunks(monkeypatch):
    """Walks of every length, short ones in the first window and long ones
    by the descent, across lane chunks: the window and the chunk size change
    no answer."""
    rng = np.random.default_rng(8)
    vals = rng.integers(20, 40, 9000)
    vals[rng.choice(9000, 12, replace=False)] = rng.integers(0, 20, 12)
    pos = rng.integers(0, 9001, 700)
    c = rng.integers(0, 25, 700)
    want = _assert_queries(vals, pos, c, np.minimum(pos, 8999), c)
    ref = (want.next_backward_lt(torch.from_numpy(pos), torch.from_numpy(c)), want.next_forward_lt(torch.from_numpy(pos), torch.from_numpy(c)))
    monkeypatch.setattr(tlt, "WALK_FIRST", 1)
    monkeypatch.setattr(tlt, "LANE_CHUNK", 64)
    got = (want.next_backward_lt(torch.from_numpy(pos), torch.from_numpy(c)), want.next_forward_lt(torch.from_numpy(pos), torch.from_numpy(c)))
    for g, w in zip(got, ref):
        assert torch.equal(g, w)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 1500), hi=st.integers(1, 60), seed=st.integers(0, 2**31))
def test_ltsearch_any_values(n, hi, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, hi, n)
    pos = rng.integers(0, n + 1, 64)
    c = rng.integers(0, hi + 2, 64)
    _assert_queries(vals, pos, c, pos - 1, c)


# ---------------------------------------------------------------------------
# the widen family on a seqset
# ---------------------------------------------------------------------------


def _stores(codes, lens):
    js = jax_build_seqset(codes, lens)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    return js, convert.seqset_from_numpy(arrays, "cpu")


def _reads_to_arrays(reads):
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = dna.seq_to_codes(r)
        lens[i] = len(r)
    return codes, lens


def _eq_ranges(got, want):
    assert got.begin.dtype == got.end.dtype == torch.int64 and got.size.dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _find_both(js, ts, q, qlen):
    return (
        js.d.find(jnp.asarray(q), jnp.asarray(qlen)),
        ts.d.find(torch.from_numpy(q), torch.from_numpy(qlen)),
    )


def test_push_front_drop_walks_of_tests_ltsearch():
    """The chimera walks of tests/test_ltsearch.py, base by base, in both
    packages: every range after every push, and the drop it needs; at each
    step also the range popped, truncated to 3 bases, and pushed with a
    context floor of 4."""
    js, ts = _stores(*_reads_to_arrays(["ACGGCATTAA", "CATTAACCGG", "GGTTCCAAGG"]))
    sizes = []
    for s in ("ACGGCATTAACCGG", "TTTTGGTTCC"):
        jr = JRanges(jnp.zeros(1, jnp.int64), jnp.full(1, js.n_entries, jnp.int64), jnp.zeros(1, jnp.int32))
        tr = ts.ctx_begin()
        for ch in reversed(s):
            b = int(dna.seq_to_codes(ch)[0])
            _eq_ranges(ts.d.push_front_drop(tr, torch.tensor([b]), min_ctx=4), js.d.push_front_drop(jr, jnp.asarray([b], jnp.int32), min_ctx=4))
            jr = js.d.push_front_drop(jr, jnp.asarray([b], jnp.int32))
            tr = ts.d.push_front_drop(tr, torch.tensor([b]))
            _eq_ranges(tr, jr)
            _eq_ranges(ts.d.pop_front_ranges(tr), js.d.pop_front_ranges(jr))
            _eq_ranges(ts.d.truncate_ranges(tr, 3), js.d.truncate_ranges(jr, 3))
            assert int(tr.begin[0]) < int(tr.end[0])
            sizes.append(int(tr.size[0]))
    assert any(sizes[i + 1] <= sizes[i] for i in range(len(sizes) - 1))  # context was dropped


def test_pop_and_truncate_on_queries_of_tests_seqset():
    """The queries of tests/test_seqset.py::test_pop_front_ranges, popped and
    truncated to every length."""
    js, ts = _stores(*_reads_to_arrays(["ACGGCAT", "TTACGGC", "GCATTTT"]))
    q, qlen = _reads_to_arrays(["ACGG", "GCAT", "TTACGGC", "CA"])
    jr, tr = _find_both(js, ts, q, qlen)
    _eq_ranges(tr, jr)
    _eq_ranges(ts.d.pop_front_ranges(tr), js.d.pop_front_ranges(jr))
    for m in range(0, 8):
        _eq_ranges(ts.d.truncate_ranges(tr, m), js.d.truncate_ranges(jr, m))
    # one pop at a time down to the empty sequence: every entry
    for _ in range(8):
        jr, tr = js.d.pop_front_ranges(jr), ts.d.pop_front_ranges(tr)
        _eq_ranges(tr, jr)
    assert (tr.begin == 0).all() and (tr.end == ts.n_entries).all() and (tr.size == 0).all()


@pytest.fixture(scope="module")
def read_world():
    """A simulated read set: 40-base reads of a 3000-base genome at 20x, half
    reverse-complemented, some trimmed; queries that are reads, pieces of
    reads, and random sequences that are in no read."""
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    R, L = 1500, 40
    starts = rng.integers(0, 3000 - L, R)
    codes = genome[starts[:, None] + np.arange(L)]
    codes[: R // 2] = (3 - codes[: R // 2])[:, ::-1]
    lens = np.full(R, L, np.int32)
    lens[::5] = rng.integers(20, L, len(lens[::5]))
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    js, ts = _stores(codes, lens)
    Q = 400
    q = np.concatenate([codes[:200], rng.integers(0, 4, (Q - 200, L)).astype(np.uint8)])
    qlen = np.concatenate([lens[:200], rng.integers(1, L + 1, Q - 200)]).astype(np.int32)
    qlen[:100] = rng.integers(1, 30, 100)
    q = np.where(np.arange(L)[None, :] < qlen[:, None], q, 0).astype(np.uint8)
    jr, tr = _find_both(js, ts, q, qlen)
    return dict(js=js, ts=ts, jr=jr, tr=tr, rng=rng, genome=genome)


def test_truncate_and_pop_random_ranges(read_world):
    w = read_world
    jr, tr = w["jr"], w["tr"]
    _eq_ranges(tr, jr)
    assert 0 < int(tr.valid.sum()) < tr.begin.shape[0]  # found and absent lanes both
    for m in (1, 5, 12, 25, 39, 50):
        _eq_ranges(w["ts"].d.truncate_ranges(tr, m), w["js"].d.truncate_ranges(jr, m))
    per_lane = w["rng"].integers(0, 41, tr.begin.shape[0]).astype(np.int32)
    _eq_ranges(w["ts"].d.truncate_ranges(tr, torch.from_numpy(per_lane)), w["js"].d.truncate_ranges(jr, jnp.asarray(per_lane)))
    for _ in range(3):
        jr, tr = w["js"].d.pop_front_ranges(jr), w["ts"].d.pop_front_ranges(tr)
        _eq_ranges(tr, jr)


@pytest.mark.parametrize("min_ctx", [0, 15])
def test_push_front_drop_random_ranges(read_world, min_ctx):
    """Push a random base onto every lane (found and absent ranges), then
    walk 30 bases of the genome's complement from the whole set, with and
    without a context floor."""
    w = read_world
    rng = np.random.default_rng(min_ctx)
    b = rng.integers(0, 4, w["tr"].begin.shape[0])
    before = [x.clone() for x in w["tr"]]
    _eq_ranges(
        w["ts"].d.push_front_drop(w["tr"], torch.from_numpy(b), min_ctx=min_ctx),
        w["js"].d.push_front_drop(w["jr"], jnp.asarray(b, jnp.int32), min_ctx=min_ctx),
    )
    assert all(torch.equal(x, y) for x, y in zip(w["tr"], before))  # the caller's ranges stay
    B = 64
    jr = JRanges(jnp.zeros(B, jnp.int64), jnp.full(B, w["js"].n_entries, jnp.int64), jnp.zeros(B, jnp.int32))
    tr = TRanges(torch.zeros(B, dtype=torch.int64), torch.full((B,), w["ts"].n_entries), torch.zeros(B, dtype=torch.int32))
    starts = rng.integers(0, 2950, B)
    text = 3 - w["genome"]
    text[1000:1010] = rng.integers(0, 4, 10)  # a stretch in no read: pushes there must drop
    for i in range(30):
        base = text[starts + i]
        jr = w["js"].d.push_front_drop(jr, jnp.asarray(base, jnp.int32), min_ctx=min_ctx)
        tr = w["ts"].d.push_front_drop(tr, torch.from_numpy(base), min_ctx=min_ctx)
        _eq_ranges(tr, jr)


def test_size_read_len_ctx_begin_and_the_lazy_ltsearch(read_world):
    js, ts = read_world["js"], read_world["ts"]
    assert ts.size() == js.size() == ts.n_entries
    assert ts.read_len == js.read_len == 40
    jc, tc = js.ctx_begin(), ts.ctx_begin()
    _eq_ranges(tc, jc)
    assert tc.begin.device == ts.device
    # the engine builds its LtSearch at the first query that needs it, once
    d = ts.d
    fresh = type(d)(**{f: getattr(d, f) for f in ("fixed", "rank_blocks", "entry_sizes", "shared", "pop_sel", "n_entries")})
    assert "shared_lt" not in fresh.__dict__
    fresh.truncate_ranges(tc, 0)
    lt = fresh.__dict__["shared_lt"]
    np.testing.assert_array_equal(lt.values[: ts.n_entries].numpy(), ts.shared.numpy())
    np.testing.assert_array_equal(lt.block_min.numpy(), np.asarray(js.d.shared_lt.block_min))
    assert fresh.shared_lt is lt
