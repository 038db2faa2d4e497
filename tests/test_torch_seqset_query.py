"""Batched seqset queries of the PyTorch port against the JAX package, on a
store built by JAX and carried across with convert.seqset_from_numpy.
Tolerance: exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index import probes as jprobes
from biograph_tpu.index.seqset import SeqsetRanges as JRanges
from biograph_tpu_torch import convert
from biograph_tpu_torch.index import probes as tprobes
from biograph_tpu_torch.index.seqset import Seqset, SeqsetRanges as TRanges
from biograph_tpu_torch.ops import rank4 as trank4

L = 40
G = 1200


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, G).astype(np.uint8)
    R = 260
    starts = rng.integers(0, G - L, R)
    codes = genome[starts[:, None] + np.arange(L)]
    codes[: R // 2] = (3 - codes[: R // 2])[:, ::-1]
    lengths = rng.integers(25, L + 1, R).astype(np.int32)
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0).astype(np.uint8)
    js = jax_build_seqset(codes, lengths)
    jr = jax_build_readmap(js, codes, lengths, np.arange(R, dtype=np.int64) ^ 1)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    # queries: reads, substrings of reads, and sequences that are in no read
    q = np.concatenate([codes[:60], rng.integers(0, 4, (40, L)).astype(np.uint8)])
    qlen = np.concatenate([lengths[:60], rng.integers(1, L + 1, 40)]).astype(np.int32)
    qlen[:20] = rng.integers(1, 20, 20)
    q = np.where(np.arange(L)[None, :] < qlen[:, None], q, 0).astype(np.uint8)
    return dict(genome=genome, codes=codes, lengths=lengths, js=js, jr=jr, ts=ts, tr=tr, q=q, qlen=qlen, rng=rng)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want))


def _ranges(world):
    jr = world["js"].d.find(jnp.asarray(world["q"]), jnp.asarray(world["qlen"]))
    tr = world["ts"].d.find(torch.from_numpy(world["q"]), torch.from_numpy(world["qlen"]))
    return jr, tr


def test_round_trip_through_numpy(world):
    back = convert.seqset_to_numpy(world["ts"])
    for k, dt in convert.SEQSET_DTYPES.items():
        want = np.asarray(getattr(world["js"], k))
        assert back[k].dtype == dt == want.dtype
        _eq(back[k], want)


def test_find_and_find_existing(world):
    jr, tr = _ranges(world)
    for g, w in zip(tr, jr):
        _eq(g, w)
    assert tr.begin.dtype == tr.end.dtype == torch.int64 and tr.size.dtype == torch.int32
    valid = tr.valid.numpy()
    assert valid[:60].all()  # reads and their prefixes are found
    assert (~valid[60:]).any()  # absent sequences give begin >= end
    _eq(tr.valid, jr.valid)
    codes, lengths = world["codes"], world["lengths"]
    _eq(
        world["ts"].d.find_existing(torch.from_numpy(codes), torch.from_numpy(lengths)),
        world["js"].d.find_existing(jnp.asarray(codes), jnp.asarray(lengths)),
    )
    assert world["ts"].find_str("ACGT") == world["js"].find_str("ACGT")
    assert world["ts"].find_str("A" * 39) == world["js"].find_str("A" * 39)


def test_push_front_rank4_push4_sizes_at(world):
    jr, tr = _ranges(world)
    jd, td = world["js"].d, world["ts"].d
    rng = np.random.default_rng(1)
    b = rng.integers(0, 4, len(world["qlen"]))
    for g, w in zip(td.push_front(tr, torch.from_numpy(b)), jd.push_front(jr, jnp.asarray(b))):
        _eq(g, w)
    n = world["ts"].n_entries
    pos = np.concatenate([rng.integers(0, n + 1, 300), [0, n]]).astype(np.int64)
    got4 = td.rank4(torch.from_numpy(pos))
    _eq(got4, jd.rank4(jnp.asarray(pos)))
    ts = world["ts"]
    tiles = trank4.build_rank4_tiles(ts.prev_words, ts.prev_cum)  # the tiled table is its caller's to build
    assert torch.equal(trank4.rank4_tiled(tiles, torch.from_numpy(pos)), got4)
    for base in range(4):
        bb = np.full(len(pos), base)
        _eq(td.rank(torch.from_numpy(bb), torch.from_numpy(pos)), jd.rank(jnp.asarray(bb), jnp.asarray(pos)))
        _eq(got4[:, base], jd.rank(jnp.asarray(bb), jnp.asarray(pos)))
    nb, ne = td.push4(tr)
    jnb, jne = jd.push4(jr)
    _eq(nb, jnb)
    _eq(ne, jne)
    for base in range(4):  # column b equals push_front(r, b)
        one = td.push_front(tr, torch.full((len(b),), base))
        assert torch.equal(nb[:, base], one.begin) and torch.equal(ne[:, base], one.end)
    idx = np.concatenate([rng.integers(0, n + 50, 200), [0, n - 1, n]]).astype(np.int64)
    _eq(td.sizes_at(torch.from_numpy(idx)), jd.sizes_at(jnp.asarray(idx)))
    _eq(td.sizes_at(torch.from_numpy(idx.reshape(7, -1))), jd.sizes_at(jnp.asarray(idx.reshape(7, -1))))


def test_entry_primitives_and_sequences(world):
    jd, td = world["js"].d, world["ts"].d
    rng = np.random.default_rng(2)
    n = world["ts"].n_entries
    e = rng.integers(0, n, 250).astype(np.int64)
    b = rng.integers(0, 4, 250)
    te, tb = torch.from_numpy(e), torch.from_numpy(b)
    _eq(td.entry_has_front(te, tb), jd.entry_has_front(jnp.asarray(e), jnp.asarray(b)))
    _eq(td.entry_push_front(te, tb), jd.entry_push_front(jnp.asarray(e), jnp.asarray(b)))
    _eq(td.entry_first_base(te), jd.entry_first_base(jnp.asarray(e)))
    _eq(td.entry_pop_front(te), jd.entry_pop_front(jnp.asarray(e)))
    _eq(td.sequences(te, L), jd.sequences(jnp.asarray(e), L))
    assert world["ts"].entry_sequence(5) == world["js"].entry_sequence(5)
    assert world["ts"].entry_sequence(5, 7) == world["js"].entry_sequence(5, 7)
    assert world["ts"].n_entries == n == world["js"].n_entries


def test_engine_reads_the_rank_structure_through_the_block_table_only(world):
    """The query engine holds no stored pair: its rank structure is the
    rank-block table, equal to the one built from the stored pair."""
    ts = world["ts"]
    td = ts.d
    names = set(type(td).__dataclass_fields__)
    assert "rank_blocks" in names and not names & {"prev_words", "prev_cum", "rank4_tiles"}
    assert not hasattr(td, "prev_words") and not hasattr(td, "prev_cum")
    assert torch.equal(td.rank_blocks, trank4.build_rank_blocks(ts.prev_words, ts.prev_cum))
    assert td.rank_blocks.shape == (ts.prev_words.shape[1] // trank4.BLOCK_WORDS + 1, 4, 8)
    assert ts.device == td.device == ts.entry_sizes.device


@pytest.mark.parametrize("query", ["find", "find_existing", "push_front", "push4", "entry_has_front", "entry_push_front", "rank"])
def test_queries_of_an_engine_whose_seqset_lost_its_stored_pair(world, tmp_path, query):
    """Once the engine is built nothing reads prev_words / prev_cum: a seqset
    loaded from disk whose stored pair is then taken away answers as the JAX
    package does."""
    world["ts"].save(str(tmp_path / "ss.bgt"))
    ts = Seqset.load(str(tmp_path / "ss.bgt"), device="cpu")
    td = ts.d
    ts.prev_words = ts.prev_cum = None
    jd = world["js"].d
    q, qlen = world["q"], world["qlen"]
    rng = np.random.default_rng(7)
    n = ts.n_entries
    if query == "find":
        for g, w in zip(td.find(torch.from_numpy(q), torch.from_numpy(qlen)), jd.find(jnp.asarray(q), jnp.asarray(qlen))):
            _eq(g, w)
    elif query == "find_existing":
        codes, lengths = world["codes"], world["lengths"]
        _eq(td.find_existing(torch.from_numpy(codes), torch.from_numpy(lengths)), jd.find_existing(jnp.asarray(codes), jnp.asarray(lengths)))
    elif query in ("push_front", "push4"):
        jr = jd.find(jnp.asarray(q), jnp.asarray(qlen))
        tr = TRanges(*(torch.from_numpy(np.asarray(x).copy()) for x in jr))
        if query == "push4":
            for g, w in zip(td.push4(tr), jd.push4(jr)):
                _eq(g, w)
        else:
            b = rng.integers(0, 4, len(qlen))
            for g, w in zip(td.push_front(tr, torch.from_numpy(b)), jd.push_front(jr, jnp.asarray(b))):
                _eq(g, w)
    else:
        e = np.concatenate([rng.integers(0, n, 300), [0, n - 1]]).astype(np.int64)
        b = rng.integers(0, 4, len(e))
        te, tb, je, jb = torch.from_numpy(e), torch.from_numpy(b), jnp.asarray(e), jnp.asarray(b)
        if query == "rank":
            e[-1] = n
            _eq(td.rank(tb, torch.from_numpy(e)), jd.rank(jb, jnp.asarray(e)))
        else:
            _eq(getattr(td, query)(te, tb), getattr(jd, query)(je, jb))


def _text(world):
    genome = world["genome"]
    text = np.concatenate([genome, (3 - genome)[::-1]]).astype(np.uint8)
    pos = np.arange(0, len(text), 2).astype(np.int64)
    return text, pos, np.where(pos >= G, G, 0).astype(np.int64)


@pytest.mark.parametrize("depth", [12, 24])
def test_find_window(world, depth):
    text, pos, _ = _text(world)
    jd, td = world["js"].d, world["ts"].d
    rng = np.random.default_rng(depth)
    for m in (depth, rng.integers(0, depth + 1, len(pos)).astype(np.int32)):
        jm = jnp.asarray(m) if isinstance(m, np.ndarray) else m
        tm = torch.from_numpy(m) if isinstance(m, np.ndarray) else m
        want = jprobes.find_window(jd, jnp.asarray(text), jnp.asarray(pos), jm, depth)
        plain = tprobes.find_window(td, torch.from_numpy(text), torch.from_numpy(pos), tm, depth)
        auto = tprobes.find_window_auto(td, torch.from_numpy(text), torch.from_numpy(pos), tm, depth)
        for p, a, w in zip(plain, auto, want):
            _eq(p, w)
            _eq(a, w)


@pytest.mark.parametrize("depth,min_m,seeded", [(24, 0, False), (24, 10, False), (24, 10, True), (13, 0, False), (16, 16, False)])
def test_probe_exact(world, depth, min_m, seeded):
    text, pos, seg_lo = _text(world)
    jd, td = world["js"].d, world["ts"].d
    jt, jp, js_ = jnp.asarray(text), jnp.asarray(pos), jnp.asarray(seg_lo)
    tt, tp, tseg = torch.from_numpy(text), torch.from_numpy(pos), torch.from_numpy(seg_lo)
    jseed = tseed = None
    if seeded:
        w0 = np.minimum(depth, pos - seg_lo + 1)
        lo = np.minimum(min_m, w0).astype(np.int32)
        jseed = jprobes.find_window(jd, jt, jp, jnp.asarray(lo), depth)
        tseed = tprobes.find_window(td, tt, tp, torch.from_numpy(lo), depth)
    want = jprobes.probe_exact(jd, jt, jp, js_, depth, min_m, jseed)
    plain = tprobes.probe_exact(td, tt, tp, tseg, depth, min_m, tseed)
    kernel = tprobes.probe_exact_kernel(td, tt, tp, tseg, depth, min_m, tseed)
    for p, k, w in zip(plain, kernel, want):
        _eq(p, w)
        _eq(k, w)
    if min_m == 0:
        sizes = plain[2].numpy()
        assert sizes.max() == depth - 1 and sizes.min() < depth - 1


def test_readmap_queries(world):
    jr, tr = world["jr"], world["tr"]
    rng = np.random.default_rng(3)
    n = world["ts"].n_entries
    e = rng.integers(0, n, 200).astype(np.int64)
    for g, w in zip(tr.entry_read_range(torch.from_numpy(e)), jr.entry_read_range(jnp.asarray(e))):
        _eq(g, w)
    _eq(tr.entry_read_count(torch.from_numpy(e)), jr.entry_read_count(jnp.asarray(e)))
    ids = rng.integers(0, tr.num_entries, 200).astype(np.int64)
    tid, jid = torch.from_numpy(ids), jnp.asarray(ids)
    _eq(tr.get_rev_comp(tid), jr.get_rev_comp(jid))
    _eq(tr.get_mate(tid), jr.get_mate(jid))
    _eq(tr.has_mate(tid), jr.has_mate(jid))
    _eq(tr.entry_of_rm, jr.entry_of_rm)
    for g, w in zip(tr.length_groups, jr.length_groups):
        _eq(g, w)
    assert (tr.min_read_len, tr.max_read_len) == (jr.min_read_len, jr.max_read_len)
    assert tr.get_pair_stats() == jr.get_pair_stats()


@pytest.mark.parametrize("c", [1, 12, 25, 41])
def test_trunc_tables_and_trunc_gather(world, c):
    """The constant-threshold widen tables and the two-gather truncation on
    them, against the JAX package's; the tables hang on the seqset instance."""
    from biograph_tpu.variants import discover as jdisc
    from biograph_tpu_torch.variants import discover as tdisc

    js, ts = world["js"], world["ts"]
    jp, jn = jdisc._trunc_tables(js, c)
    tp, tn = tdisc._trunc_tables(ts, c)
    _eq(tp, jp)
    _eq(tn, jn)
    assert tp.dtype == tn.dtype == torch.int64
    assert ts.__dict__["_trunc_cache"][c][0] is tp and tdisc._trunc_tables(ts, c)[0] is tp
    assert not hasattr(tdisc, "_TRUNC_CACHE")
    rng = np.random.default_rng(c)
    n = js.n_entries
    begin = np.concatenate([rng.integers(0, n, 300), [0, n - 1, n, n + 3, -2]]).astype(np.int64)
    end = np.concatenate([begin[:300] + rng.integers(0, 40, 300), [n, n, n, n + 5, 3]]).astype(np.int64)
    want = js.d.trunc_gather(jp, jn, jnp.asarray(begin), jnp.asarray(end))
    got = ts.d.trunc_gather(tp, tn, torch.from_numpy(begin), torch.from_numpy(end))
    for g, w in zip(got, want):
        _eq(g, w)
