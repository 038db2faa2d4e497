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
    assert torch.equal(trank4.rank4(tw, tc, tp), got)  # CPU tensors -> plain version
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


def _rank4_tiled_kernel_in_numpy(tiles, pos):
    """csrc/rank4_tiled.cu block by block on the host, over the wrapper's
    own sort and cut into blocks: what each block reads and where it writes."""
    W, Q = trank4.TILE_W, trank4.Q_BLOCK
    n_tiles = tiles.base.shape[0]
    tile = ((pos >> 5).clamp(0, tiles.words.shape[0] - 1) // W).to(torch.int32)
    perm, bt, blk_first, q_first, q_count = (x.numpy() for x in trank4.tile_buckets(tile, n_tiles))
    assert bt.dtype == np.int32 and len(bt) == -(-len(pos) // Q) + n_tiles
    words = tiles.words.numpy().view(np.uint32)
    rel = np.ascontiguousarray(tiles.rel.numpy()).view(np.uint32)  # [ncol, 2]: two int16 a word
    base = tiles.base.numpy()
    pos_sorted = pos.numpy()[perm]
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
            p = max(int(pos_sorted[q]), 0)
            lw = min((p >> 5) - t * W, W - 1)
            assert lw >= 0
            mask = (1 << (p & 31)) - 1
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
    args = (port["prev_words"], port["prev_cum"], port["entry_sizes"], port["fixed"], win, torch.from_numpy(m), depth)
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
    got = trank4.chain_fixed(port["prev_words"], port["prev_cum"], port["entry_sizes"], port["fixed"], torch.from_numpy(text), depth)
    keep = np.arange(P) >= depth - 1  # halo positions are caller-masked
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[keep], np.asarray(w)[keep])


def test_wrappers_reject_what_the_kernels_do_not_take(store):
    _, _, _, port, _ = store
    pos = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        trank4.rank4(port["prev_words"].to(torch.int64), port["prev_cum"], pos)
    with pytest.raises(TypeError):
        trank4.rank4(port["prev_words"], port["prev_cum"], pos.to(torch.int32))
    with pytest.raises(TypeError):
        trank4.gather_sizes(port["entry_sizes"].to(torch.int64), pos)
    with pytest.raises(TypeError):
        trank_cum.rank_cum(port["prev_cum"][0])
    win = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        trank4.chain_window(port["prev_words"], port["prev_cum"], port["entry_sizes"], port["fixed"], win, pos, 8)
    tiles = trank4.build_rank4_tiles(port["prev_words"], port["prev_cum"])
    with pytest.raises(TypeError):
        trank4.rank4_tiled(tiles, pos.to(torch.int32))
    with pytest.raises(TypeError):
        trank4.rank4_tiled(tiles._replace(rel=tiles.rel.to(torch.int32)), pos)
    with pytest.raises(TypeError):
        trank4.rank4_tiled(tiles._replace(base=tiles.base[:0]), pos)
    for fn in (trank4.rank4, trank4.rank4_tiled, trank4.gather_sizes, trank4.chain_window, trank_cum.rank_cum):
        assert fn.launches == 0  # nothing launches on the CPU
