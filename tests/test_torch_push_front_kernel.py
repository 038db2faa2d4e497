"""K2's single-base entry, the fused push_front kernel, and the four-wide
gather_sizes loop, against the JAX package on the CPU.

The plain version ``push_front_blocks_plain`` and the port's
``Seqset.push_front``, ``find`` and ``find_window`` (which take it on CPU
tensors) against the JAX package's ``Seqset.push_front``, ``find`` and
``find_window``; csrc/push_front.cu and csrc/gather_sizes.cu replayed lane by
lane on the host against the plain versions.  The CUDA kernels themselves are
held against the plain versions on the card by chip_smoke.py.  Inputs come
from numpy seeds; tolerance: exact equality (everything is integer)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index import probes as jprobes
from biograph_tpu.index.seqset import Seqset as JSeqset, SeqsetRanges as JRanges
from biograph_tpu_torch import convert
from biograph_tpu_torch.index import probes as tprobes
from biograph_tpu_torch.index.seqset import SeqsetRanges as TRanges
from biograph_tpu_torch.ops import rank4 as trank4
from test_torch_rank_kernels import _locate_in_blocks_numpy as _locate, _rank_in_block_numpy as _rank_in_block

L = 30


@pytest.fixture(scope="module")
def store():
    """A small seqset built by the JAX package and the same store in the
    port (on the CPU); reads of mixed lengths, so entry sizes differ and the
    kick fires on some lanes and not on others."""
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, 700).astype(np.uint8)
    R = 220
    starts = rng.integers(0, len(genome) - L, R)
    codes = genome[starts[:, None] + np.arange(L)]
    codes[: R // 2] = (3 - codes[: R // 2])[:, ::-1]
    lengths = rng.integers(12, L + 1, R).astype(np.int32)
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0).astype(np.uint8)
    js = jax_build_seqset(codes, lengths)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    return dict(genome=genome, codes=codes, lengths=lengths, js=js, ts=ts)


def _ranges(kind, n, rng):
    """(begin, end, size) over a store of n entries: every entry with the
    next few (ends mostly in one block), wide and reversed ranges with ends
    at n, and the edges (the whole store, empty ranges, reversed ones)."""
    if kind == "entries":
        begin = np.arange(n + 1)
        end = np.minimum(begin + rng.integers(0, 9, n + 1), n)
    elif kind == "wide":
        begin = rng.integers(0, n + 1, 401)
        end = rng.integers(0, n + 1, 401)
        end[:30] = n
    else:
        begin = np.array([0, 0, n, 5, 5, 0, n - 1])
        end = np.array([n, 0, n, 5, 4, n, n])
    size = rng.integers(0, L + 3, len(begin)).astype(np.int32)
    size[::5] = 0
    return begin.astype(np.int64), end.astype(np.int64), size


def _port(ts):
    d = ts.d
    return d.rank_blocks, d.entry_sizes, d.fixed


# ---------------------------------------------------------------------------
# the kernel's loop, lane by lane on the host (csrc/push_front.cu)
# ---------------------------------------------------------------------------


def _push_front_kernel_in_numpy(blocks, sizes, fixed, begin, end, size, base):
    """push_front_kernel one lane at a time: the base asserted in [0, 4),
    an invalid range copied through, both ends' sectors read (the second only
    when end lies in another block), the size read only for a range that is
    not empty.  Returns (begin, end, size, lanes whose ends shared a block,
    sizes read, kicks)."""
    sectors = blocks.numpy().view(np.uint64).reshape(-1, 4)
    last_word = blocks.shape[0] * trank4.BLOCK_WORDS - 1
    n, B = len(sizes), len(begin)
    ob, oe, osz = np.zeros(B, np.int64), np.zeros(B, np.int64), np.zeros(B, np.int32)
    shared = gathers = kicks = 0
    for q in range(B):
        s, e, sz, b = int(begin[q]), int(end[q]), int(size[q]), int(base[q])
        assert 0 <= b < 4
        if s >= e:
            ob[q], oe[q], osz[q] = s, s, sz
            continue
        k0, r0 = _locate(s, last_word)
        k1, r1 = _locate(e, last_word)
        sector0 = sectors[4 * k0 + b]
        sector1 = sectors[4 * k1 + b] if k1 != k0 else sector0
        shared += k1 == k0
        nb = int(fixed[b]) + _rank_in_block(sector0, r0)
        ne = int(fixed[b]) + _rank_in_block(sector1, r1)
        if nb < ne:
            gathers += 1
            kick = int(sizes[min(nb, n - 1)]) < sz + 1
            kicks += kick
            nb += kick
        ob[q], oe[q], osz[q] = nb, ne, sz + 1
    return ob, oe, osz, shared, gathers, kicks


@pytest.mark.parametrize("b", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["entries", "wide", "edges"])
def test_push_front_plain_vs_jax_push_front(store, kind, b):
    js, ts = store["js"], store["ts"]
    n = ts.n_entries
    begin, end, size = _ranges(kind, n, np.random.default_rng(len(kind) + 10 * b))
    base = np.full(len(begin), b, np.int64)
    args = (*_port(ts), *(torch.from_numpy(x) for x in (begin, end, size, base)))
    got = trank4.push_front_blocks_plain(*args)
    assert [g.dtype for g in got] == [torch.int64, torch.int64, torch.int32]
    want = js.d.push_front(JRanges(jnp.asarray(begin), jnp.asarray(end), jnp.asarray(size)), jnp.asarray(base))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(trank4.push_front(*args), got):  # CPU tensors -> plain version
        assert torch.equal(g, w)
    stored = trank4.push_front_plain(ts.prev_words, ts.prev_cum, *args[1:])
    for g, w in zip(stored, got):
        assert torch.equal(g, w)
    invalid = begin >= end
    np.testing.assert_array_equal(got[0].numpy()[invalid], begin[invalid])
    np.testing.assert_array_equal(got[1].numpy()[invalid], begin[invalid])
    np.testing.assert_array_equal(got[2].numpy()[invalid], size[invalid])


@pytest.mark.parametrize("kind", ["entries", "wide", "edges"])
def test_push_front_kernel_loop_replayed_vs_plain(store, kind):
    ts = store["ts"]
    rng = np.random.default_rng(len(kind) + 100)
    begin, end, size = _ranges(kind, ts.n_entries, rng)
    base = rng.integers(0, 4, len(begin)).astype(np.int64)
    blocks, sizes, fixed = _port(ts)
    *got, shared, gathers, kicks = _push_front_kernel_in_numpy(blocks, sizes.numpy(), fixed.numpy(), begin, end, size, base)
    want = trank4.push_front_blocks_plain(blocks, sizes, fixed, *(torch.from_numpy(x) for x in (begin, end, size, base)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    valid = int((begin < end).sum())
    if kind == "entries":
        assert 0 < shared < valid  # ends in one block, and ends in two
        assert 0 < gathers < valid  # some pushed range is empty: no size read
    if kind != "edges":
        assert 0 < kicks < gathers  # the kick fires on some lanes and not on others


def test_push_front_clamps_a_pushed_begin_that_reaches_n():
    """A made-up store whose last base's pushed begin reaches n and passes
    it: the size is read at n - 1, by the JAX package, the plain version and
    the kernel's loop alike."""
    nw = 7
    n = 32 * nw
    rng = np.random.default_rng(3)
    words = np.full((4, nw), 0xFFFFFFFF, np.uint32)
    cum = np.tile(np.arange(nw, dtype=np.int64) * 32, (4, 1))
    sizes = rng.integers(1, 5, n).astype(np.int32)
    blocks = trank4.build_rank_blocks(torch.from_numpy(words.view(np.int32).copy()), torch.from_numpy(cum))
    begin = np.arange(n + 1, dtype=np.int64)
    end = np.full(n + 1, n, np.int64)
    size = np.full(n + 1, 2, np.int32)
    base = np.full(n + 1, 3, np.int64)
    for f3 in (0, 5, n - 1, n):
        fixed = np.array([0, 0, 0, f3, n], np.int64)
        js = JSeqset(n_entries=n, max_entry_len=4, fixed=fixed, prev_words=words, prev_cum=cum, entry_sizes=sizes,
                     shared=np.zeros(n, np.int32), pop_sel=np.zeros(n, np.int64))
        want = js.d.push_front(JRanges(jnp.asarray(begin), jnp.asarray(end), jnp.asarray(size)), jnp.asarray(base))
        got = trank4.push_front_blocks_plain(blocks, torch.from_numpy(sizes), torch.from_numpy(fixed),
                                             *(torch.from_numpy(x) for x in (begin, end, size, base)))
        replay = _push_front_kernel_in_numpy(blocks, sizes, fixed, begin, end, size, base)
        for g, r, w in zip(got, replay, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(r, np.asarray(w))
    assert int(got[0].max()) >= n


# ---------------------------------------------------------------------------
# the seqset's entry points on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def counted_calls(monkeypatch):
    """Calls of rank4.push_front and rank4.rank while a test runs, through
    the module attributes the seqset calls them by."""
    calls = {"push_front": 0, "rank": 0}
    for name in calls:
        real = getattr(trank4, name)

        def counting(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(trank4, name, counting)
    return calls


def test_seqset_push_front_is_one_kernel_call(store, counted_calls):
    js, ts = store["js"], store["ts"]
    rng = np.random.default_rng(21)
    begin, end, size = _ranges("wide", ts.n_entries, rng)
    base = rng.integers(0, 4, len(begin)).astype(np.int64)
    got = ts.d.push_front(TRanges(*(torch.from_numpy(x) for x in (begin, end, size))), torch.from_numpy(base))
    assert counted_calls == {"push_front": 1, "rank": 0}
    want = js.d.push_front(JRanges(jnp.asarray(begin), jnp.asarray(end), jnp.asarray(size)), jnp.asarray(base))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_find_vs_jax(store, counted_calls):
    js, ts = store["js"], store["ts"]
    rng = np.random.default_rng(22)
    q = np.concatenate([store["codes"][:80], rng.integers(0, 4, (30, L)).astype(np.uint8)])
    qlen = np.concatenate([store["lengths"][:80], rng.integers(1, L + 1, 30)]).astype(np.int32)
    qlen[:10] = rng.integers(1, 8, 10)
    q = np.where(np.arange(L)[None, :] < qlen[:, None], q, 0).astype(np.uint8)
    got = ts.d.find(torch.from_numpy(q), torch.from_numpy(qlen))
    assert counted_calls == {"push_front": L, "rank": 0}  # one push_front a step, no rank
    want = js.d.find(jnp.asarray(q), jnp.asarray(qlen))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = got.begin < got.end
    assert valid[:80].all() and not valid[80:].all()  # the reads are found, random queries mostly not


@pytest.mark.parametrize("depth", [9, 20])
def test_find_window_vs_jax(store, counted_calls, depth):
    js, ts = store["js"], store["ts"]
    genome = store["genome"]
    text = np.concatenate([genome, (3 - genome)[::-1]]).astype(np.uint8)
    rng = np.random.default_rng(depth)
    pos = rng.integers(0, len(text), 500).astype(np.int64)
    m = rng.integers(0, depth + 1, len(pos)).astype(np.int32)
    got = tprobes.find_window(ts.d, torch.from_numpy(text), torch.from_numpy(pos), torch.from_numpy(m), depth)
    assert counted_calls == {"push_front": depth, "rank": 0}
    want = jprobes.find_window(js.d, jnp.asarray(text), jnp.asarray(pos), jnp.asarray(m), depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] < got[1]).any() and (got[0] >= got[1]).any()


def test_push_front_rejects_what_the_kernel_does_not_take(store):
    blocks, sizes, fixed = _port(store["ts"])
    z = torch.zeros(4, dtype=torch.int64)
    s = torch.zeros(4, dtype=torch.int32)
    for bad in (
        (store["ts"].prev_words, sizes, fixed, z, z, s, z),  # the structure as stored is not the block table
        (blocks, sizes.to(torch.int64), fixed, z, z, s, z),
        (blocks, sizes, fixed[:4], z, z, s, z),
        (blocks, sizes, fixed.to(torch.int32), z, z, s, z),
        (blocks, sizes, fixed, z.to(torch.int32), z, s, z),
        (blocks, sizes, fixed, z, z[:3], s, z),
        (blocks, sizes, fixed, z, z, s.to(torch.int64), z),  # size is int32, converted nowhere
        (blocks, sizes, fixed, z, z, s, z.to(torch.uint8)),  # b is int64
        (blocks, sizes, fixed, z, z, s, z[:3]),
        (blocks, sizes, fixed, z[None], z[None], s[None], z[None]),
    ):
        with pytest.raises(TypeError):
            trank4.push_front(*bad)
    with pytest.raises(ValueError, match="empty"):
        trank4.push_front(blocks, sizes[:0], fixed, z, z, s, z)
    # a CPU/CUDA mix launches nothing and takes no plain version
    with pytest.raises(ValueError, match="unsupported device"):
        trank4.push_front(blocks.to("meta"), sizes, fixed, z, z, s, z)
    with pytest.raises(ValueError):
        trank4.push_front(blocks, sizes, fixed, z.to("meta"), z.to("meta"), s.to("meta"), z.to("meta"))
    assert trank4.push_front.launches == 0  # nothing launches on the CPU


# ---------------------------------------------------------------------------
# gather_sizes: the four-wide loop of csrc/gather_sizes.cu on the host
# ---------------------------------------------------------------------------

THREADS = 256


def _gather_sizes_kernel_in_numpy(sizes, idx, idx_addr, out_addr, threads_total):
    """bgt_gather_sizes and its kernel on the host: the head that puts the
    indices (8 bytes each) and the results (4 bytes each) on a 16-byte
    boundary together, or none; the grid-stride loop over 4-index groups of
    ``threads_total`` threads; the head and the B % 4 tail one index at a
    time.  Every index must be written exactly once.  Returns (out, head,
    groups)."""
    n, B = len(sizes), len(idx)
    h = ((16 - out_addr % 16) % 16) // 4
    aligned = idx_addr % 8 == 0 and out_addr % 4 == 0 and (idx_addr + 8 * h) % 16 == 0
    head = min(h, B) if aligned else B
    groups = (B - head) // 4
    out = np.full(B, -1, np.int64)
    written = np.zeros(B, np.int64)

    def one(i):
        at = int(idx[i])
        assert 0 <= at < n
        out[i] = sizes[at]
        written[i] += 1

    for t in range(threads_total):
        for g in range(t, groups, threads_total):
            first = head + 4 * g
            assert (idx_addr + 8 * first) % 16 == 0 and (out_addr + 4 * first) % 16 == 0
            for j in range(4):  # two 16-byte loads, four gathers, one 16-byte store
                one(first + j)
        tail = head + 4 * groups
        for s in range(t, head + (B - tail), threads_total):
            one(s if s < head else tail + (s - head))
    assert (written == 1).all()
    return out.astype(np.int32), head, groups


@pytest.mark.parametrize("rem", [0, 1, 2, 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_gather_sizes_four_wide_loop_replayed(rem, offset):
    rng = np.random.default_rng(4 * rem + offset)
    n = 5000
    sizes = rng.integers(0, 70000, n).astype(np.int32)
    base = rng.integers(0, n, 1200).astype(np.int64)
    B = 1000 + rem + offset  # a view `offset` indices into a fresh tensor, the results a fresh one
    idx = base[offset : offset + B]
    want = trank4.gather_sizes_plain(torch.from_numpy(sizes), torch.from_numpy(idx)).numpy()
    assert torch.equal(trank4.gather_sizes(torch.from_numpy(sizes), torch.from_numpy(idx)), torch.from_numpy(want))
    for threads_total in (THREADS, 7):  # one pass, and a grid that loops
        got, head, groups = _gather_sizes_kernel_in_numpy(sizes, idx, 4096 + 8 * offset, 8192, threads_total)
        np.testing.assert_array_equal(got, want)
        if offset % 2 == 0:  # a whole 16 bytes in: the vector body runs over all but the tail
            assert head == 0 and groups == B // 4
        else:  # 8 bytes off: no head aligns both, every index one by one
            assert groups == 0
    for out_offset in (1, 2, 3):  # results that start 4, 8 or 12 bytes in: a head of 3, 2 or 1
        idx_addr = 4096 + 8 * (out_offset % 2)
        got, head, groups = _gather_sizes_kernel_in_numpy(sizes, idx, idx_addr, 8192 + 4 * out_offset, 5)
        np.testing.assert_array_equal(got, want)
        assert head == 4 - out_offset and groups == (B - head) // 4


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 6, 7])
def test_gather_sizes_four_wide_loop_below_one_group(B):
    rng = np.random.default_rng(B)
    sizes = rng.integers(0, 300, 50).astype(np.int32)
    idx = rng.integers(0, 50, B).astype(np.int64)
    want = trank4.gather_sizes_plain(torch.from_numpy(sizes), torch.from_numpy(idx)).numpy()
    for out_addr in (8192, 8196, 8200, 8204):
        got, _, groups = _gather_sizes_kernel_in_numpy(sizes, idx, 4096 + (out_addr - 8192) // 4 % 2 * 8, out_addr, THREADS)
        np.testing.assert_array_equal(got, want)
