"""The plain PyTorch versions of the port's five kernels against the JAX
package: against its plain (XLA) paths and against its Pallas TPU kernels
run in interpret mode on the CPU.  On the CPU the port's wrappers take the
plain versions, so wrapper == plain version is checked here too; the CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.  Tolerance: exact equality (everything is integer)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index import probes as jprobes
from biograph_tpu.ops import pallas_rank as jrank_cum
from biograph_tpu.ops import rank4 as jrank4
from biograph_tpu_torch.index import probes as tprobes
from biograph_tpu_torch.ops import rank4 as trank4
from biograph_tpu_torch.ops import rank_cum as trank_cum


def _structure(seed, nw):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (4, nw), dtype=np.uint64).astype(np.uint32)
    pc = np.unpackbits(words.view(np.uint8)).reshape(4, nw, 32).sum(axis=2).astype(np.int64)
    return words, np.cumsum(pc, axis=1) - pc


def _i32(words_u32):
    return torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32).copy())


@pytest.mark.parametrize("nw", [1, 7, 300, 1000])
def test_rank4_plain_vs_xla_and_pallas(nw):
    words, cum = _structure(nw, nw)
    rng = np.random.default_rng(nw + 1)
    n = nw * 32
    pos = np.concatenate([rng.integers(0, n + 1, 500), [0, 1, 31, 32, 33, n - 1, n]]).clip(0).astype(np.int64)
    want = np.asarray(jrank4.rank4_xla(jnp.asarray(words), jnp.asarray(cum), jnp.asarray(pos)))
    tw, tc, tp = _i32(words), torch.from_numpy(cum), torch.from_numpy(pos)
    got = trank4.rank4_plain(tw, tc, tp)
    assert got.dtype == torch.int32 and got.shape == (len(pos), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    blocks = trank4.build_rank_blocks(tw, tc)
    assert torch.equal(trank4.rank4_blocks_plain(blocks, tp), got)  # the table's form == the stored form
    assert torch.equal(trank4.rank4(blocks, tp), got)  # CPU tensors -> plain version
    table = jrank4.build_rank4_table(words, cum)
    pallas = np.asarray(jrank4.rank4_pallas(table, jnp.asarray(pos), True))
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("n_entries", [64, 96, 3200])
def test_rank4_plain_position_past_the_structure(n_entries):
    """pos == 32*nw counts the whole last word (the `over` case of
    rank4_xla); the seqset's nw is n//32 + 1, a structure made elsewhere
    may have exactly n/32 words."""
    nw = n_entries // 32
    words, cum = _structure(n_entries, nw)
    pos = np.array([0, n_entries - 1, n_entries, 32 * nw], np.int64)
    want = np.asarray(jrank4.rank4_xla(jnp.asarray(words), jnp.asarray(cum), jnp.asarray(pos)))
    got = trank4.rank4_plain(_i32(words), torch.from_numpy(cum), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    totals = cum[:, -1] + np.unpackbits(words[:, -1:].view(np.uint8)).reshape(4, 32).sum(axis=1)
    np.testing.assert_array_equal(got.numpy()[-1], totals)
    b = np.array([0, 1, 2, 3], np.int64)
    single = trank4.rank_plain(_i32(words), torch.from_numpy(cum), torch.from_numpy(b), torch.from_numpy(np.full(4, 32 * nw)))
    np.testing.assert_array_equal(single.numpy(), totals)


@pytest.mark.parametrize("nw", [1, 7, 1023, 1024, 2500, 5000])
def test_rank4_tiled_plain_vs_xla_and_hbm_pallas(nw):
    """The tiled table and its plain version against the gather path and
    against the TPU's tiled kernel in interpret mode (its own table, its own
    tile width), boundary positions and clustered queries included."""
    words, cum = _structure(nw + 3, nw)
    rng = np.random.default_rng(nw + 4)
    n = nw * 32
    pos = np.concatenate([
        rng.integers(0, n + 1, 1500),
        np.clip(rng.normal(n // 2, 300, 800), 0, n).astype(np.int64),
        [0, 1, 31, 32, 33, n - 1, n],
    ]).astype(np.int64)
    want = np.asarray(jrank4.rank4_xla(jnp.asarray(words), jnp.asarray(cum), jnp.asarray(pos)))
    tw, tc, tp = _i32(words), torch.from_numpy(cum), torch.from_numpy(pos)
    tiles = trank4.build_rank4_tiles(tw, tc)
    n_tiles = -(-(nw + 1) // trank4.TILE_W)
    assert tiles.words.shape == tiles.rel.shape == (n_tiles * trank4.TILE_W, 4) and tiles.base.shape == (n_tiles, 4)
    assert (tiles.words.dtype, tiles.rel.dtype, tiles.base.dtype) == (torch.int32, torch.int16, torch.int64)
    assert int(tiles.rel.min()) >= 0  # rebased counts fit int16 without wrapping
    got = trank4.rank4_tiled_plain(tiles, tp)
    assert got.dtype == torch.int32 and got.shape == (len(pos), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(trank4.rank4_tiled(tiles, tp), got)  # CPU tensors -> plain version
    assert torch.equal(trank4.rank4_plain(tw, tc, tp), got)
    jtiles, jbase = jrank4.build_rank4_hbm_table(words, cum)
    pallas = np.asarray(jrank4.rank4_hbm_pallas(jtiles, jbase, jnp.asarray(pos), True))
    np.testing.assert_array_equal(got.numpy(), pallas)


def _rank4_tiled_kernel_in_numpy(tiles, pos, buckets=None):
    """The rank kernel of csrc/rank4_tiled.cu block by block on the host,
    over the plain bucketing (tile_buckets) or over ``buckets``: what each
    block reads and where it writes."""
    W, Q = trank4.TILE_W, trank4.Q_BLOCK
    n_tiles = tiles.base.shape[0]
    if buckets is None:
        buckets = (x.numpy() for x in trank4.tile_buckets(trank4.tile_of(tiles, pos), n_tiles))
    perm, bt, blk_first, q_first, q_count = buckets
    assert bt.dtype == np.int32 and len(bt) == -(-len(pos) // Q) + n_tiles
    # the scatter's records: a query's place inside its tile beside its index
    at = np.clip(pos.numpy(), 0, 32 * tiles.words.shape[0] - 1)[perm] % (32 * W)
    words = tiles.words.numpy().view(np.uint32)
    rel = np.ascontiguousarray(tiles.rel.numpy()).view(np.uint32)  # [ncol, 2]: two int16 a word
    base = tiles.base.numpy()
    out = np.full((len(pos), 4), -1, np.int64)
    served = 0
    for blk, t in enumerate(bt):
        if t >= n_tiles:
            continue
        k = blk - blk_first[t]
        start = q_first[t] + k * Q
        n = min(q_count[t] - k * Q, Q)
        assert n > 0
        for q in range(start, start + n):
            lw = int(at[q]) >> 5
            assert 0 <= lw < W
            mask = (1 << (int(at[q]) & 31)) - 1
            w = words[t * W + lw]
            c = rel[t * W + lw]
            r = [int(c[0]) & 0xFFFF, int(c[0]) >> 16, int(c[1]) & 0xFFFF, int(c[1]) >> 16]
            assert (out[perm[q]] == -1).all()  # every query written once
            out[perm[q]] = [base[t, b] + r[b] + bin(int(w[b]) & mask).count("1") for b in range(4)]
            served += 1
    assert served == len(pos)
    return out


@pytest.mark.parametrize("nw,B", [(5, 300), (1500, 1), (3000, 4000), (2047, 2500)])
def test_rank4_tiled_blocks_cover_every_query_once(nw, B):
    words, cum = _structure(nw + 9, nw)
    rng = np.random.default_rng(B)
    pos = np.concatenate([rng.integers(0, 32 * nw + 1, B - 1), [32 * nw]]).astype(np.int64)
    tw, tc, tp = _i32(words), torch.from_numpy(cum), torch.from_numpy(pos)
    tiles = trank4.build_rank4_tiles(tw, tc)
    got = _rank4_tiled_kernel_in_numpy(tiles, tp)
    np.testing.assert_array_equal(got, trank4.rank4_plain(tw, tc, tp).numpy())


@pytest.mark.parametrize("n,hi", [(100, 255), (5000, 255), (5000, 70000)])
def test_gather_sizes_plain(n, hi):
    rng = np.random.default_rng(n + hi)
    sizes = rng.integers(0, hi + 1, n).astype(np.int32)
    idx = rng.integers(0, n, (4, 333)).astype(np.int64)
    got = trank4.gather_sizes_plain(torch.from_numpy(sizes), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.take(jnp.asarray(sizes), jnp.asarray(idx))))
    assert torch.equal(trank4.gather_sizes(torch.from_numpy(sizes), torch.from_numpy(idx)), got)
    if hi <= 255:  # the TPU kernel clips at 255: compare where it is exact
        table = jrank4.build_bytes_table(sizes)
        pallas = np.asarray(jrank4.gather_bytes_pallas(table, jnp.asarray(idx.reshape(-1)), True))
        np.testing.assert_array_equal(got.numpy().reshape(-1), pallas)


@pytest.mark.parametrize("nw", [1, 100, 2048, 2049, 5000])
def test_rank_cum_plain_vs_reference_and_pallas(nw):
    words, _ = _structure(nw, nw)
    w = words[0]
    got = trank_cum.rank_cum_plain(_i32(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrank_cum.rank_cum_reference(jnp.asarray(w))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrank_cum.rank_cum_pallas(jnp.asarray(w), interpret=True)))
    assert torch.equal(trank_cum.rank_cum(_i32(w)), got)


@pytest.mark.parametrize("R,nw", [(1, 1), (4, 1), (4, 7), (1, 4097), (4, 4093), (4, 4096), (3, 9001)])
def test_rank_cum_rows_vs_reference_and_pallas(R, nw):
    """[R, nw]: every row scanned on its own, against the JAX reference and
    the TPU kernel in interpret mode row by row."""
    words = _structure(R * 1000 + nw, nw)[0][:R]
    got = trank_cum.rank_cum(_i32(words))  # CPU tensors -> plain version
    assert got.dtype == torch.int32 and got.shape == (R, nw)
    assert torch.equal(got, trank_cum.rank_cum_plain(_i32(words)))
    for r in range(R):
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(jrank_cum.rank_cum_reference(jnp.asarray(words[r]))))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(jrank_cum.rank_cum_pallas(jnp.asarray(words[r]), interpret=True)))
        assert torch.equal(trank_cum.rank_cum(_i32(words[r])), got[r])


def _popcount_u32(a):
    return np.unpackbits(np.ascontiguousarray(a, np.uint32).view(np.uint8)).reshape(-1, 32).sum(axis=1)


def _rank_cum_kernel_in_numpy(words, lead, seed, resident):
    """csrc/rank_cum.cu block by block on the host.  At most ``resident``
    blocks run at once and the running ones advance in an order shuffled by
    ``seed``; a block takes its tile by ticket when it starts.  Each block:
    the 16-byte groups its tile covers (``lead`` words of the buffers' start
    lie before a 16-byte boundary), the words outside the row masked, the
    local scan, AGGREGATE published, the look-back 32 descriptors at a time
    (spinning while one it needs is unset), INCLUSIVE published, the prefixes
    written.  Returns (out [R, nw], the most descriptors any look-back read)."""
    R, nw = words.shape
    T, TW = trank_cum.tiles_per_row(nw), trank_cum.TILE_WORDS
    flat = words.reshape(-1)
    out = np.full(R * nw, -1, np.int64)
    flag = np.zeros((R, T), np.int64)
    value = np.zeros((R, T), np.int64)
    rng = np.random.default_rng(seed)
    counter = [0]
    longest = [0]

    def block():
        ticket = counter[0]
        counter[0] += 1
        yield
        row, tile = divmod(ticket, T)
        row_lo, row_hi = row * nw, row * nw + nw
        first_group = ((row_lo + lead) & ~3) - lead
        assert (first_group + lead) % 4 == 0 and row_lo - 4 < first_group <= row_lo
        g = first_group + tile * TW + np.arange(TW)
        inside = (g >= row_lo) & (g < row_hi)
        pc = np.where(inside, _popcount_u32(flat[np.clip(g, 0, R * nw - 1)]), 0)
        total = int(pc.sum())
        yield
        prefix = 0
        if tile > 0:
            flag[row, tile], value[row, tile] = 1, total
            yield
            look, read = tile - 1, 0
            while True:
                at = look - np.arange(32)  # lane 0 reads the nearest
                live = at >= 0
                while (flag[row, at[live]] == 0).any():
                    yield  # a predecessor has not published yet
                flags = np.where(live, flag[row, np.clip(at, 0, None)], 2)  # left of the row: nothing
                values = np.where(live, value[row, np.clip(at, 0, None)], 0)
                ends = np.flatnonzero(flags == 2)
                last = ends[0] if len(ends) else 31
                prefix += int(values[: last + 1].sum())
                read += int(live[: last + 1].sum())
                if len(ends):
                    break
                look -= 32
                yield
            longest[0] = max(longest[0], read)
        flag[row, tile], value[row, tile] = 2, (prefix + total) & 0xFFFFFFFF
        yield
        assert (out[g[inside]] == -1).all()  # every word written once
        out[g[inside]] = prefix + (np.cumsum(pc) - pc)[inside]

    running, started, steps = [], 0, 0
    while started < R * T or running:
        steps += 1
        assert steps < 200 * R * T + 1000, "the scan does not finish"
        if started < R * T and len(running) < resident and (not running or rng.random() < 0.4):
            running.append(block())
            next(running[-1])  # a block takes its ticket as it starts
            started += 1
            continue
        i = int(rng.integers(len(running)))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
    assert (out >= 0).all() and (flag == 2).all()
    return out.reshape(R, nw), longest[0]


@pytest.mark.parametrize(
    "R,nw,lead,resident",
    [(1, 1, 0, 1), (4, 5, 0, 3), (4, 4093, 0, 2), (4, 4096, 0, 7), (4, 4097, 3, 4), (1, 9000, 1, 1), (3, 12289, 2, 5),
     (2, 4096 * 40 + 17, 0, 50), (1, 4096 * 70, 0, 3)],
)
def test_rank_cum_lookback_scan_replayed_in_any_order(R, nw, lead, resident):
    words = _structure(nw + R, nw)[0][:R]
    got, longest = _rank_cum_kernel_in_numpy(words, lead, seed=nw + resident, resident=resident)
    np.testing.assert_array_equal(got, trank_cum.rank_cum_plain(_i32(words)).numpy())
    T = trank_cum.tiles_per_row(nw)
    assert T == -(-(nw + 3) // trank_cum.TILE_WORDS) and longest <= T - 1
    if T > 33 and resident > 33:
        assert longest > 1  # some look-back added up aggregates


@pytest.fixture(scope="module")
def store():
    """A small seqset built by the JAX package, its TPU kernel tables, and
    the same store as the port's tensors; a text with stretches that are in
    the reads and stretches that are not."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 500).astype(np.uint8)
    reads = [genome[rng.integers(0, 470):][:30].copy() for _ in range(150)]
    reads = [((3 - r)[::-1].copy() if rng.random() < 0.5 else r) for r in reads]
    ss = jax_build_seqset(np.stack(reads), np.full(len(reads), 30, np.int32))
    text = np.concatenate([genome, rng.integers(0, 4, 200).astype(np.uint8)]).astype(np.uint8)
    port = dict(
        prev_words=_i32(np.asarray(ss.prev_words)),
        prev_cum=torch.from_numpy(np.asarray(ss.prev_cum).copy()),
        entry_sizes=torch.from_numpy(np.asarray(ss.entry_sizes, np.int32).copy()),
        fixed=torch.from_numpy(np.asarray(ss.fixed).copy()),
    )
    port["blocks"] = trank4.build_rank_blocks(port["prev_words"], port["prev_cum"])
    table = jrank4.build_rank4_table(np.asarray(ss.prev_words), np.asarray(ss.prev_cum))
    sizes_table = jrank4.build_bytes_table(np.asarray(ss.entry_sizes))
    return ss, table, sizes_table, port, text


@pytest.mark.parametrize("depth,m_kind", [(25, "mixed"), (25, "full"), (25, "zero"), (8, "mixed"), (32, "mixed")])
def test_chain_window_plain_vs_find_window_and_pallas(store, depth, m_kind):
    ss, table, sizes_table, port, text = store
    rng = np.random.default_rng(depth)
    pos = rng.integers(depth, len(text), 700).astype(np.int64)
    m = {
        "mixed": rng.integers(0, depth + 1, len(pos)),
        "full": np.full(len(pos), depth),
        "zero": np.zeros(len(pos)),
    }[m_kind].astype(np.int32)
    if m_kind == "mixed":
        m[:6] = (0, 1, depth, 0, 1, depth)
    want = [np.asarray(x) for x in jprobes.find_window_jit(ss.d, jnp.asarray(text), jnp.asarray(pos), jnp.asarray(m), depth)]
    if m_kind != "zero":
        assert (want[0] >= want[1]).any() and (want[0] < want[1]).any()  # lanes die midway, lanes survive
    win = tprobes._window_bases(torch.from_numpy(text), torch.from_numpy(pos), depth)
    assert win.dtype == torch.uint8
    np.testing.assert_array_equal(win.numpy(), np.asarray(jprobes._window_bases(jnp.asarray(text), jnp.asarray(pos), depth)))
    args = (port["blocks"], port["entry_sizes"], port["fixed"], win, torch.from_numpy(m), depth)
    got = trank4.chain_window_plain(*args)
    assert [g.dtype for g in got] == [torch.int64, torch.int64, torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(trank4.chain_window(*args), got):  # CPU tensors -> plain version
        assert torch.equal(g, w)
    win_t = jnp.asarray(win.numpy().T, jnp.float32)
    pallas = jrank4.chain_window_pallas(table, sizes_table, ss.fixed, win_t, jnp.asarray(m), depth, True)
    for g, w in zip(got, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_chain_fixed_vs_find_window(store):
    ss, _, _, port, text = store
    depth = 17
    P = len(text)
    want = jprobes.find_window_jit(ss.d, jnp.asarray(text), jnp.arange(P, dtype=jnp.int64), jnp.full((P,), depth, jnp.int32), depth)
    got = trank4.chain_fixed(port["blocks"], port["entry_sizes"], port["fixed"], torch.from_numpy(text), depth)
    keep = np.arange(P) >= depth - 1  # halo positions are caller-masked
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(w)[keep])


def test_wrappers_reject_what_the_kernels_do_not_take(store):
    _, _, _, port, _ = store
    pos = torch.zeros(4, dtype=torch.int64)
    blocks = port["blocks"]
    with pytest.raises(TypeError):  # the structure as stored is not the block table
        trank4.rank4(port["prev_words"], pos)
    with pytest.raises(TypeError):
        trank4.rank4(blocks.to(torch.int64), pos)
    with pytest.raises(TypeError):  # base-major is not the table's order
        trank4.rank4(blocks.transpose(0, 1).contiguous(), pos)
    with pytest.raises(TypeError):
        trank4.rank4(blocks[:0], pos)
    with pytest.raises(TypeError):
        trank4.rank4(blocks, pos.to(torch.int32))
    with pytest.raises(TypeError):
        trank4.rank4(blocks, pos[None, :])
    with pytest.raises(TypeError):
        trank4.rank(port["prev_cum"], pos, pos)
    with pytest.raises(TypeError):
        trank4.rank(blocks, pos.to(torch.int32), pos)
    with pytest.raises(TypeError):
        trank4.rank(blocks, pos, pos.to(torch.int32))
    with pytest.raises(TypeError):  # one base a query: the shapes must agree
        trank4.rank(blocks, pos[:2], pos)
    with pytest.raises(TypeError):
        trank4.rank(blocks, pos, pos, pos[:3])
    # a CPU/CUDA mix launches nothing and takes no plain version: a table that
    # is not on the CPU (here on no device at all) with positions that are
    meta = blocks.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trank4.rank4(meta, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        trank4.rank(meta, pos, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        trank4.rank4(blocks, pos.to("meta"))
    with pytest.raises(TypeError):
        trank4.gather_sizes(port["entry_sizes"].to(torch.int64), pos)
    with pytest.raises(TypeError):
        trank_cum.rank_cum(port["prev_cum"][0])
    with pytest.raises(TypeError):  # rows, not a stack of them
        trank_cum.rank_cum(port["prev_words"][None])
    with pytest.raises(TypeError):
        trank_cum.rank_cum(port["prev_words"][0, 0])
    with pytest.raises(ValueError, match="contiguous CUDA"):
        trank_cum.rank_cum(port["prev_words"].to("meta"))
    win = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        trank4.chain_window(blocks, port["entry_sizes"], port["fixed"], win, pos, 8)
    with pytest.raises(TypeError):  # the structure as stored is not the block table
        trank4.chain_window(port["prev_words"], port["entry_sizes"], port["fixed"], win, pos.to(torch.int32), 8)
    with pytest.raises(TypeError):
        trank4.chain_window(blocks.to(torch.int64), port["entry_sizes"], port["fixed"], win, pos.to(torch.int32), 8)
    tiles = trank4.build_rank4_tiles(port["prev_words"], port["prev_cum"])
    with pytest.raises(TypeError):
        trank4.rank4_tiled(tiles, pos.to(torch.int32))
    with pytest.raises(TypeError):
        trank4.rank4_tiled(tiles._replace(rel=tiles.rel.to(torch.int32)), pos)
    with pytest.raises(TypeError):
        trank4.rank4_tiled(tiles._replace(base=tiles.base[:0]), pos)
    with pytest.raises(ValueError, match="unsupported device"):  # the bucketing kernels have no CPU form but tile_buckets
        trank4.tile_buckets_kernel(tiles, pos)
    for fn in (trank4.rank4, trank4.rank, trank4.rank4_tiled, trank4.gather_sizes, trank4.chain_window, trank_cum.rank_cum):
        assert fn.launches == 0  # nothing launches on the CPU


# ---------------------------------------------------------------------------
# the rank-block table (what chain_window reads) and the bucketing kernels of
# rank4_tiled, replayed on the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nw", [1, 5, 6, 7, 193, 1025])
def test_rank_blocks_plain_vs_rank_plain_xla_and_pallas(nw):
    """One 32-byte block answers a rank: the table's plain ranks (one base
    and all four) against the structure as stored, the JAX gather path and
    the TPU kernel in interpret mode, block edges and pos == 32*nw included."""
    words, cum = _structure(nw + 40, nw)
    rng = np.random.default_rng(nw + 41)
    n = nw * 32
    edges = [0, 1, 31, 32, 33, 191, 192, 193, n - 1, n]
    pos = np.concatenate([rng.integers(0, n + 1, 600), np.clip(edges, 0, n)]).astype(np.int64)
    tw, tc, tp = _i32(words), torch.from_numpy(cum), torch.from_numpy(pos)
    blocks = trank4.build_rank_blocks(tw, tc)
    W = trank4.BLOCK_WORDS
    assert blocks.dtype == torch.int32 and blocks.shape == (nw // W + 1, 4, 8) and blocks.is_contiguous()
    assert blocks.shape[0] * W > nw  # a zero word past the structure: pos == 32*nw needs no special case
    want = np.asarray(jrank4.rank4_xla(jnp.asarray(words), jnp.asarray(cum), jnp.asarray(pos)))
    pallas = np.asarray(jrank4.rank4_pallas(jrank4.build_rank4_table(words, cum), jnp.asarray(pos), True))
    totals = cum[:, -1] + np.unpackbits(words[:, -1:].view(np.uint8)).reshape(4, 32).sum(axis=1)
    got4 = trank4.rank4_blocks_plain(blocks, tp)
    assert got4.dtype == torch.int32 and got4.shape == (len(pos), 4)
    np.testing.assert_array_equal(got4.numpy(), want)
    np.testing.assert_array_equal(got4.numpy(), pallas)
    assert torch.equal(got4, trank4.rank4_plain(tw, tc, tp))
    assert torch.equal(trank4.rank4(blocks, tp), got4)  # CPU tensors -> plain version
    for b in range(4):
        base = torch.full_like(tp, b)
        got = trank4.rank_blocks_plain(blocks, base, tp)
        assert got.dtype == torch.int64
        assert torch.equal(got, trank4.rank_plain(tw, tc, base, tp))
        assert torch.equal(trank4.rank(blocks, base, tp), got)  # CPU tensors -> plain version
        np.testing.assert_array_equal(got.numpy(), want[:, b])
        np.testing.assert_array_equal(got.numpy(), pallas[:, b])
        assert int(got[-1]) == totals[b]
        # 2-D positions, a negative one (reads as 0) and one past the table (the totals)
        odd = torch.tensor([[-3, 0], [n, n + 5000]])
        assert trank4.rank_blocks_plain(blocks, torch.full_like(odd, b), odd).tolist() == [[0, 0], [totals[b]] * 2]
        assert trank4.rank(blocks, torch.full_like(odd, b), odd).tolist() == [[0, 0], [totals[b]] * 2]
    assert trank4.rank4(blocks, torch.tensor([-3, n + 5000])).tolist() == [[0] * 4, totals.tolist()]
    # one base a query, both ends of a range in one call
    b = torch.from_numpy(rng.integers(0, 4, len(pos)))
    ends = tp.flip(0)
    r0, r1 = trank4.rank(blocks, b, tp, ends)
    assert torch.equal(r0, trank4.rank_plain(tw, tc, b, tp)) and torch.equal(r1, trank4.rank_plain(tw, tc, b, ends))
    np.testing.assert_array_equal(r0.numpy(), want[np.arange(len(pos)), b.numpy()])
    # the entry's own bit, read from the block's word slot
    e = tp.clamp(max=n - 1)
    stored = (words[b.numpy(), e.numpy() >> 5] >> (e.numpy() & 31).astype(np.uint32)) & 1
    np.testing.assert_array_equal(trank4.has_bit_blocks(blocks, b, e).numpy(), stored.astype(bool))


def _rank_in_block_numpy(sector, r):
    """rank_in_block of csrc/rank_blocks.cuh: the count, plus the set bits
    below bit r of the block's three 64-bit word pairs, by its masks."""
    all64 = (1 << 64) - 1
    m0 = all64 if r >= 64 else (1 << r) - 1
    m1 = all64 if r >= 128 else ((1 << (r - 64)) - 1 if r > 64 else 0)
    m2 = (1 << (r - 128)) - 1 if r > 128 else 0
    count, q0, q1, q2 = (int(x) for x in sector)
    return count + bin(q0 & m0).count("1") + bin(q1 & m1).count("1") + bin(q2 & m2).count("1")


def _locate_in_blocks_numpy(pos, last_word):
    """locate_in_blocks of csrc/rank_blocks.cuh: (block, bit inside it)."""
    pos = max(int(pos), 0)
    w = min(pos >> 5, last_word)
    k = w // trank4.BLOCK_WORDS
    return k, (w - k * trank4.BLOCK_WORDS) * 32 + (pos & 31)


def _rank_kernels_in_numpy(blocks, pos, b, pos_end):
    """csrc/rank4.cu thread by thread on the host: rank4 (thread t answers
    base t % 4 of query t / 4 from sector 4k + b of the table) and rank (one
    thread a query, the second end reusing the first one's sector when both
    lie in one block).  Returns (rank4 [B, 4], rank at pos, rank at pos_end,
    queries whose two ends shared a sector)."""
    sectors = blocks.numpy().view(np.uint64).reshape(-1, 4)  # sector 4k + b: count, words 0-1, 2-3, 4-5
    last_word = blocks.shape[0] * trank4.BLOCK_WORDS - 1
    B = len(pos)
    out4 = np.zeros(4 * B, np.int32)
    for t in range(4 * B):
        k, r = _locate_in_blocks_numpy(pos[t >> 2], last_word)
        out4[t] = _rank_in_block_numpy(sectors[4 * k + (t & 3)], r)
    out0, out1, shared = np.zeros(B, np.int64), np.zeros(B, np.int64), 0
    for q in range(B):
        base = int(b[q]) & 3
        k0, r0 = _locate_in_blocks_numpy(pos[q], last_word)
        sector0 = sectors[4 * k0 + base]
        out0[q] = _rank_in_block_numpy(sector0, r0)
        k1, r1 = _locate_in_blocks_numpy(pos_end[q], last_word)
        sector1 = sector0
        if k1 != k0:
            sector1 = sectors[4 * k1 + base]
        else:
            shared += 1
        out1[q] = _rank_in_block_numpy(sector1, r1)
    return out4.reshape(B, 4), out0, out1, shared


@pytest.mark.parametrize("nw", [1, 5, 6, 7, 193, 1023, 1024, 1025])
def test_rank_kernels_replayed_vs_plain_stored_and_xla(nw):
    """The rank4 and rank kernels' own arithmetic against their plain
    versions, the stored-form oracles and the JAX gather path: B not a
    multiple of anything, pos 0 / n / 32*nw, negative and past the table."""
    words, cum = _structure(nw + 70, nw)
    rng = np.random.default_rng(nw + 71)
    n = nw * 32
    edges = [0, 1, 31, 32, 63, 64, 65, 127, 128, 129, 191, 192, 193, n - 1, n, -1, -9, n + 1, n + 777, 1 << 40]
    pos = np.concatenate([rng.integers(0, n + 1, 211), edges]).astype(np.int64)
    near = np.clip(pos + rng.integers(0, 60, len(pos)), None, n)  # range ends: mostly in the same block
    b = rng.integers(0, 4, len(pos))
    tw, tc = _i32(words), torch.from_numpy(cum)
    blocks = trank4.build_rank_blocks(tw, tc)
    got4, got0, got1, shared = _rank_kernels_in_numpy(blocks, pos, b, near)
    tp, tn, tb = torch.from_numpy(pos), torch.from_numpy(near), torch.from_numpy(b)
    np.testing.assert_array_equal(got4, trank4.rank4_blocks_plain(blocks, tp).numpy())
    np.testing.assert_array_equal(got0, trank4.rank_blocks_plain(blocks, tb, tp).numpy())
    np.testing.assert_array_equal(got1, trank4.rank_blocks_plain(blocks, tb, tn).numpy())
    inside, inside_near = tp.clamp(0, n), tn.clamp(0, n)
    np.testing.assert_array_equal(got4, trank4.rank4_plain(tw, tc, inside).numpy())
    np.testing.assert_array_equal(got0, trank4.rank_plain(tw, tc, tb, inside).numpy())
    np.testing.assert_array_equal(got1, trank4.rank_plain(tw, tc, tb, inside_near).numpy())
    want = np.asarray(jrank4.rank4_xla(jnp.asarray(words), jnp.asarray(cum), jnp.asarray(inside.numpy())))
    np.testing.assert_array_equal(got4, want)
    assert 0 < shared <= len(pos)  # the shortcut was taken


def test_rank_blocks_keep_exact_int64_counts():
    """Counts past 2^31 stay exact: the block's count is a whole int64."""
    words, cum = _structure(77, 50)
    big = cum + (1 << 40)
    tw, tp = _i32(words), torch.arange(0, 1601, 7)
    blocks = trank4.build_rank_blocks(tw, torch.from_numpy(big))
    for b in range(4):
        base = torch.full_like(tp, b)
        got = trank4.rank_blocks_plain(blocks, base, tp)
        assert torch.equal(got, trank4.rank_plain(tw, torch.from_numpy(cum), base, tp) + (1 << 40))


def _chain_window_kernel_in_numpy(blocks, sizes, fixed, win, m, depth):
    """csrc/chain_window.cu lane by lane on the host: the window row in
    16-byte pieces, one block load per range end, the same-block shortcut,
    the rank from 64-bit masks, the early exit of an empty range.  Returns
    (begin, end, size, [block loads, steps that took the shortcut])."""
    sectors = blocks.numpy().view(np.uint64)  # [nblk, 4, 4]: count, words 0-1, 2-3, 4-5
    last_word = blocks.shape[0] * trank4.BLOCK_WORDS - 1
    n = len(sizes)
    vec16 = depth % 16 == 0

    out = np.zeros((3, len(m)), np.int64)
    loads = shortcuts = 0
    for q in range(len(m)):
        first_step = max(depth - int(m[q]), 0)
        begin, end, size, alive = 0, n, 0, True
        s0 = first_step & ~15
        while alive and s0 < depth:
            if vec16:
                chunk = win[q, s0 : s0 + 16]
                assert len(chunk) == 16
            else:
                chunk = [win[q, s0 + i] if s0 + i < depth else 0 for i in range(16)]
            for i in range(16):
                s = s0 + i
                if s < first_step or s >= depth:
                    continue
                if begin >= end:
                    end, alive = begin, False
                    break
                b = int(chunk[i]) & 3
                kb, rb = _locate_in_blocks_numpy(begin, last_word)
                ke, re = _locate_in_blocks_numpy(end, last_word)
                sector_b = sectors[kb, b]
                loads += 1
                if ke != kb:
                    sector_e = sectors[ke, b]
                    loads += 1
                else:
                    sector_e = sector_b
                    shortcuts += 1
                nb = int(fixed[b]) + _rank_in_block_numpy(sector_b, rb)
                ne = int(fixed[b]) + _rank_in_block_numpy(sector_e, re)
                first = min(max(nb, 0), n - 1)
                if nb < ne and sizes[first] < size + 1:
                    nb += 1
                begin, end, size = nb, ne, size + 1
            s0 += 16
        out[:, q] = begin, end, size
    return out[0], out[1], out[2].astype(np.int32), [loads, shortcuts]


@pytest.mark.parametrize(
    "depth,m_kind",
    [(25, "mixed"), (25, "full"), (25, "zero"), (8, "mixed"), (32, "mixed"), (16, "full"), (48, "mixed"), (1, "full")],
)
def test_chain_window_kernel_loop_replayed_vs_plain_and_find_window(store, depth, m_kind):
    ss, _, _, port, text = store
    rng = np.random.default_rng(depth + 100)
    pos = rng.integers(0, len(text), 300).astype(np.int64)
    m = {"mixed": rng.integers(0, depth + 1, len(pos)), "full": np.full(len(pos), depth), "zero": np.zeros(len(pos))}[m_kind].astype(np.int32)
    win = tprobes._window_bases(torch.from_numpy(text), torch.from_numpy(pos), depth)
    want = trank4.chain_window_plain(port["blocks"], port["entry_sizes"], port["fixed"], win, torch.from_numpy(m), depth)
    ref = jprobes.find_window_jit(ss.d, jnp.asarray(text), jnp.asarray(pos), jnp.asarray(m), depth)
    *got, (loads, shortcuts) = _chain_window_kernel_in_numpy(
        port["blocks"], port["entry_sizes"].numpy(), port["fixed"].numpy(), win.numpy(), m, depth
    )
    for g, w, r in zip(got, want, ref):
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(r))
    if m_kind == "zero":
        assert loads == 0
    elif depth >= 8:
        # the first pushes span the table (two loads a step), later ones sit in one block
        assert shortcuts > 0 and loads > shortcuts


SCATTER_THREADS, SCATTER_ITEMS, SMEM_TILES, COUNTER_STRIDE = 256, 8, 2048, 8  # csrc/rank4_tiled.cu


def _bucketing_kernels_in_numpy(tile, n_tiles, seed, smem_tiles=SMEM_TILES):
    """The histogram -> scan -> scatter kernels of csrc/rank4_tiled.cu on the
    host.  Blocks run, and atomics are served, in no fixed order: here in
    orders shuffled by ``seed``.  With at most ``smem_tiles`` tiles a block
    of the scatter lays its queries out run by run (the runs in the order
    (thread, j) of the tiles j * THREADS + thread) and takes each run's slots
    from the tile's cursor at once; with more, the counters lie
    COUNTER_STRIDE apart and the queries of one warp instruction that share
    a tile take neighbouring slots from one atomic."""
    Q = trank4.Q_BLOCK
    B = len(tile)
    n_blocks = -(-B // Q) + n_tiles
    rng = np.random.default_rng(seed)
    stride = COUNTER_STRIDE if n_tiles > smem_tiles else 1
    count = np.zeros(n_tiles * stride, np.int32)
    for t in tile:  # (a)
        count[t * stride] += 1
    q_count = count[::stride].copy()
    q_first = np.zeros(n_tiles, np.int32)
    blk_first = np.zeros(n_tiles, np.int32)
    bt = np.full(n_blocks, -1, np.int32)
    q_carry = b_carry = 0
    for t in range(n_tiles):  # (b)
        nb = (q_count[t] + Q - 1) // Q
        q_first[t], blk_first[t] = q_carry, b_carry
        bt[b_carry : b_carry + nb] = t
        q_carry, b_carry = q_carry + q_count[t], b_carry + nb
    bt[b_carry:] = n_tiles
    cursor = np.zeros(n_tiles * stride, np.int32)
    cursor[::stride] = q_first
    perm = np.full(B, -1, np.int32)
    chunk = SCATTER_THREADS * SCATTER_ITEMS
    for blk in rng.permutation(-(-B // chunk)):  # (c)
        mine = np.arange(blk * chunk, min((blk + 1) * chunk, B))
        if n_tiles > smem_tiles:
            for w0 in rng.permutation(np.arange(mine[0], mine[-1] + 1, 32)):  # one warp instruction
                lanes = np.arange(w0, min(w0 + 32, B))
                for t in rng.permutation(np.unique(tile[lanes])):
                    peers = lanes[tile[lanes] == t]  # in lane order
                    perm[cursor[t * stride] + np.arange(len(peers))] = peers
                    cursor[t * stride] += len(peers)
            continue
        mine = mine[rng.permutation(len(mine))]
        count = np.zeros(n_tiles, np.int64)
        r = {}
        for i in mine:
            r[i] = count[tile[i]]
            count[tile[i]] += 1
        run_start = np.zeros(n_tiles, np.int64)
        delta = np.zeros(n_tiles, np.int64)
        start = 0
        for thread in range(SCATTER_THREADS):
            for j in range(smem_tiles // SCATTER_THREADS):
                t = j * SCATTER_THREADS + thread
                if t < n_tiles and count[t]:
                    run_start[t], delta[t] = start, cursor[t] - start
                    cursor[t] += count[t]
                    start += count[t]
        assert start == len(mine)
        staged = np.full(len(mine), -1, np.int64)
        slot = np.zeros(len(mine), np.int64)
        for i in mine:
            at = run_start[tile[i]] + r[i]
            staged[at], slot[at] = i, delta[tile[i]] + at
        assert (staged >= 0).all()
        perm[slot] = staged
    assert (cursor[::stride] == q_first + q_count).all() and (perm >= 0).all() and (bt >= 0).all()
    return perm, bt, blk_first, q_first, q_count


def _check_bucketing(nw, pos, seed, smem_tiles=SMEM_TILES):
    words, cum = _structure(nw + 13, nw)
    tw, tc, tp = _i32(words), torch.from_numpy(cum), torch.from_numpy(pos)
    tiles = trank4.build_rank4_tiles(tw, tc)
    n_tiles = tiles.base.shape[0]
    tile = trank4.tile_of(tiles, tp)
    got = _bucketing_kernels_in_numpy(tile.numpy(), n_tiles, seed, smem_tiles)
    want = [x.numpy() for x in trank4.tile_buckets(tile, n_tiles)]
    for g, w, name in zip(got[1:], want[1:], ("bt", "blk_first", "q_first", "q_count")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the same queries in every bucket, whatever their order inside it
    key = np.repeat(np.arange(n_tiles), got[4])
    np.testing.assert_array_equal(got[0][np.lexsort((got[0], key))], want[0][np.lexsort((want[0], key))])
    ranks = _rank4_tiled_kernel_in_numpy(tiles, tp, got)
    return ranks, words, cum


@pytest.mark.parametrize(
    "nw,B,kind",
    [(5, 300, "random"), (1500, 1, "random"), (3000, 4000, "random"), (2047, 2500, "one tile"), (3000, 3000, "empty tile"),
     (2500, 1100, "sorted"), (3000, 4500, "global counters"), (300000, 5000, "many tiles")],
)
def test_rank4_tiled_bucketing_kernels_replayed_in_any_order(nw, B, kind):
    rng = np.random.default_rng(B + nw)
    pos = rng.integers(0, 32 * nw + 1, B).astype(np.int64)
    if kind == "one tile":
        pos %= 32 * trank4.TILE_W
    elif kind == "empty tile":  # nothing in the middle tile
        pos = np.where((pos >> 15) == 1, pos % 1000, pos)
    elif kind == "sorted":
        pos.sort()
    pos[-1] = 32 * nw
    ranks, words, cum = _check_bucketing(nw, pos, seed=B, smem_tiles=2 if kind == "global counters" else SMEM_TILES)
    want = np.asarray(jrank4.rank4_xla(jnp.asarray(words), jnp.asarray(cum), jnp.asarray(pos)))
    np.testing.assert_array_equal(ranks, want)


@settings(max_examples=15, deadline=None)
@given(nw=st.integers(1, 2600), B=st.integers(1, 5000), seed=st.integers(0, 2**31), smem_tiles=st.sampled_from([0, SMEM_TILES]))
def test_rank4_tiled_bucketing_kernels_any_shape_any_order(nw, B, seed, smem_tiles):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 32 * nw + 1, B).astype(np.int64)
    ranks, words, cum = _check_bucketing(nw, pos, seed, smem_tiles)
    want = np.asarray(jrank4.rank4_xla(jnp.asarray(words), jnp.asarray(cum), jnp.asarray(pos)))
    np.testing.assert_array_equal(ranks, want)


# ---------------------------------------------------------------------------
# push4: the four children of a range in one launch
# ---------------------------------------------------------------------------


def _push4_kernel_in_numpy(blocks, sizes, fixed, begin, end, size):
    """csrc/push4.cu thread by thread on the host: thread t answers base
    t % 4 of range t / 4; an invalid range leaves early, the second rank
    reuses the first one's sector when both ends share a block, and the size
    is gathered only when the child is not empty.  Returns (begin4, end4,
    sizes gathered, ranges whose ends shared a block)."""
    sectors = blocks.numpy().view(np.uint64).reshape(-1, 4)
    last_word = blocks.shape[0] * trank4.BLOCK_WORDS - 1
    n, B = len(sizes), len(begin)
    begin4, end4 = np.zeros(4 * B, np.int64), np.zeros(4 * B, np.int64)
    gathers = shared = 0
    for t in range(4 * B):
        q, b = t >> 2, t & 3
        s, e = int(begin[q]), int(end[q])
        if s >= e:
            begin4[t] = end4[t] = s
            continue
        k0, r0 = _locate_in_blocks_numpy(s, last_word)
        k1, r1 = _locate_in_blocks_numpy(e, last_word)
        sector0 = sectors[4 * k0 + b]
        sector1 = sector0
        if k1 != k0:
            sector1 = sectors[4 * k1 + b]
        else:
            shared += b == 0
        nb = int(fixed[b]) + _rank_in_block_numpy(sector0, r0)
        ne = int(fixed[b]) + _rank_in_block_numpy(sector1, r1)
        if nb < ne:
            gathers += 1
            nb += int(sizes[min(nb, n - 1)]) < int(size[q]) + 1
        begin4[t], end4[t] = nb, ne
    return begin4.reshape(B, 4), end4.reshape(B, 4), gathers, shared


def _push4_ranges(kind, n, rng):
    """(begin, end, size) test ranges over a store of n entries."""
    if kind == "entries":  # every entry with the next few: ends mostly in one block
        begin = np.arange(n + 1)
        end = np.minimum(begin + rng.integers(0, 9, n + 1), n)
    elif kind == "wide":  # ends far apart, some reversed (invalid), some at n
        begin = rng.integers(0, n + 1, 301)
        end = rng.integers(0, n + 1, 301)
        end[:20] = n
    else:  # the whole store and empty ranges
        begin = np.array([0, 0, n, 5, 5])
        end = np.array([n, 0, n, 5, 4])
    size = rng.integers(0, 34, len(begin)).astype(np.int32)  # entries are 30 long: the kick on and off
    return begin.astype(np.int64), end.astype(np.int64), size


@pytest.mark.parametrize("kind", ["entries", "wide", "edges"])
def test_push4_plain_and_replayed_kernel_vs_jax_and_push_front(store, kind):
    ss, _, _, port, _ = store
    begin, end, size = _push4_ranges(kind, ss.n_entries, np.random.default_rng(len(kind)))
    tb, te, tsz = torch.from_numpy(begin), torch.from_numpy(end), torch.from_numpy(size)
    args = (port["blocks"], port["entry_sizes"], port["fixed"], tb, te, tsz)
    got = trank4.push4_plain(*args)
    assert [g.dtype for g in got] == [torch.int64, torch.int64] and got[0].shape == (len(begin), 4)
    from biograph_tpu.index.seqset import SeqsetRanges as JRanges

    want = ss.d.push4(JRanges(jnp.asarray(begin), jnp.asarray(end), jnp.asarray(size)), use_kernel=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(trank4.push4(*args), got):  # CPU tensors -> plain version
        assert torch.equal(g, w)
    for b in range(4):
        nb, ne, _ = trank4.push_front_plain(port["prev_words"], port["prev_cum"], port["entry_sizes"], port["fixed"], tb, te, tsz, torch.full_like(tb, b))
        assert torch.equal(got[0][:, b], nb) and torch.equal(got[1][:, b], ne)
    begin4, end4, gathers, shared = _push4_kernel_in_numpy(port["blocks"], port["entry_sizes"].numpy(), port["fixed"].numpy(), begin, end, size)
    np.testing.assert_array_equal(begin4, got[0].numpy())
    np.testing.assert_array_equal(end4, got[1].numpy())
    valid = begin < end
    if kind != "edges":  # (the whole store has four children)
        assert 0 < gathers < 4 * valid.sum()  # the shortcut was taken: some child was empty
    if kind == "entries":
        assert 0 < shared < valid.sum()  # ends in one block, and ends in two


def test_push4_clamps_a_pushed_begin_that_reaches_n():
    """A made-up store whose pushed begin reaches n and passes it: the size
    is read at n - 1, by the plain version and by the kernel's loop."""
    nw = 7
    n = 32 * nw
    ones = torch.full((4, nw), -1, dtype=torch.int32)
    cum = torch.arange(nw, dtype=torch.int64)[None, :].expand(4, -1) * 32
    blocks = trank4.build_rank_blocks(ones, cum.contiguous())
    sizes = torch.from_numpy(np.random.default_rng(3).integers(1, 5, n).astype(np.int32))
    begin = torch.arange(n + 1)
    end = torch.full_like(begin, n)
    size = torch.full((n + 1,), 2, dtype=torch.int32)
    for f3 in (0, 5, n - 1, n):
        fixed = torch.tensor([0, 0, 0, f3, n])
        got = trank4.push4_plain(blocks, sizes, fixed, begin, end, size)
        replay = _push4_kernel_in_numpy(blocks, sizes.numpy(), fixed.numpy(), begin.numpy(), end.numpy(), size.numpy())
        np.testing.assert_array_equal(replay[0], got[0].numpy())
        np.testing.assert_array_equal(replay[1], got[1].numpy())
    assert int(got[0][:, 3].max()) >= n


def test_push4_rejects_what_the_kernel_does_not_take(store):
    _, _, _, port, _ = store
    blocks, sizes, fixed = port["blocks"], port["entry_sizes"], port["fixed"]
    b = torch.zeros(4, dtype=torch.int64)
    s = torch.zeros(4, dtype=torch.int32)
    for bad in (
        (port["prev_words"], sizes, fixed, b, b, s),  # the structure as stored is not the block table
        (blocks, sizes.to(torch.int64), fixed, b, b, s),
        (blocks, sizes, fixed[:4], b, b, s),
        (blocks, sizes, fixed.to(torch.int32), b, b, s),
        (blocks, sizes, fixed, b.to(torch.int32), b, s),
        (blocks, sizes, fixed, b, b[:3], s),
        (blocks, sizes, fixed, b, b, s.to(torch.int64)),
        (blocks, sizes, fixed, b[None], b[None], s[None]),
    ):
        with pytest.raises(TypeError):
            trank4.push4(*bad)
    with pytest.raises(ValueError, match="empty"):
        trank4.push4(blocks, sizes[:0], fixed, b, b, s)
    # a CPU/CUDA mix launches nothing and takes no plain version
    with pytest.raises(ValueError, match="unsupported device"):
        trank4.push4(blocks.to("meta"), sizes, fixed, b, b, s)
    with pytest.raises(ValueError):
        trank4.push4(blocks, sizes, fixed, b.to("meta"), b.to("meta"), s.to("meta"))
    assert trank4.push4.launches == 0  # nothing launches on the CPU
