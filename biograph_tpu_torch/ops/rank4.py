"""The seqset's rank kernels: rank4 and rank, gather_sizes and push4,
chain_window, rank4_tiled (K1-K3, K5).

They replace the TPU kernels of ``biograph_tpu/ops/rank4.py``:

  * ``rank4``, ``rank`` <- ``rank4_pallas`` (``_rank4_kernel``)
  * ``rank4_tiled``  <- ``rank4_hbm_pallas`` (``_rank4_hbm_kernel``), over
    ``build_rank4_tiles`` <- ``build_rank4_hbm_table``
  * ``gather_sizes`` <- ``gather_bytes_pallas`` (``_gather_bytes_kernel``)
  * ``push4`` <- the same gather where the seqset uses it, the kick test of
    ``_SeqsetDevice.push4``, fused with that function's rank4 and the tensor
    code around the two: all four children of a range in one launch
  * ``chain_window`` <- ``chain_window_pallas`` (``_chain_window_kernel``),
    with ``chain_fixed`` <- ``chain_fixed_pallas`` over contiguous positions

The TPU kernels turn the gathers into one-hot matrix products over
byte-limb tables, because random gathers are what that machine lacks; that
brought an entry cap and a 24-bit count cap.  A GPU gathers directly, so
these kernels carry no cap:

    rank_b(pos) = cum[b, pos>>5] + popcount(words[b, pos>>5] & low(pos&31))

All are bound by 32-byte sectors gathered at random, not by arithmetic, so
the layout they read decides their time.  The query engine's one form of the
rank structure is the rank-block table (``build_rank_blocks``): 32-byte
blocks of one int64 count and six words, one aligned sector a rank, the four
bases' blocks of a position side by side in one aligned 128-byte line.
``rank4`` (four lanes a query, one a base), ``rank`` (one base a query, both
ends of a range in one launch), ``push4`` (four lanes a range, both ends
ranked and the child's first entry size gathered by the lane that needs it)
and ``chain_window`` (the whole dependent chain of a lane in registers, no
second sector when both range ends share a block) read nothing else of the
structure.

``rank4_tiled`` computes the same [B, 4] ranks as ``rank4`` from a table of
its own (``Rank4Tiles``: a word column's four words and four tile-relative
counts side by side, 24 bytes), its queries bucketed by tile (a histogram, a
scan and a scatter, kernels of the same call) so that a block reads its tile
once, coalesced, into shared memory.  It is the counterpart of the TPU's
tiled kernel; the table is built by whoever calls it, not by the seqset.

The structure as stored (``prev_words`` ``torch.int32`` [4, nw] holding the
words' bits reinterpreted, ``prev_cum`` int64 [4, nw]) is what ``save``
writes and what the tables are built from.  ``rank_plain``, ``rank4_plain``
and ``push_front_plain`` over it are the oracles the table forms are held
against; no query reads it.  The kernels take ``__popc`` of the bits; the
plain versions widen to int64, mask with ``& 0xFFFFFFFF`` and count by SWAR.

Each wrapper takes its plain version only for CPU tensors; CUDA tensors
launch the kernel or raise.  ``<wrapper>.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from biograph_tpu_torch.core.bitvector import low_bits_mask, popcount32
from biograph_tpu_torch.core.dna import MASK32, i32_to_u32
from biograph_tpu_torch.ops import _build

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _word_and_mask(pos: torch.Tensor, nw: int):
    """(clamped word index, AND mask) of rank positions; a position whose
    word index is past the structure (pos == 32*nw) counts the whole last
    word."""
    pos = pos.to(torch.int64)
    w = pos >> 5
    mask = torch.where(w >= nw, MASK32, low_bits_mask(pos & 31))
    return w.clamp(max=nw - 1), mask


def rank_plain(prev_words, prev_cum, b, pos) -> torch.Tensor:
    """rank of prev[base b] at positions pos (b and pos the same shape):
    int64."""
    nw = prev_words.shape[1]
    w, mask = _word_and_mask(pos, nw)
    flat = b.to(torch.int64) * nw + w
    word = i32_to_u32(prev_words.reshape(-1)[flat])
    return prev_cum.reshape(-1)[flat] + popcount32(word & mask)


def rank4_plain(prev_words, prev_cum, pos) -> torch.Tensor:
    """Plain version of ``rank4``: int32 [B, 4]."""
    nw = prev_words.shape[1]
    w, mask = _word_and_mask(pos, nw)
    word = i32_to_u32(prev_words[:, w])  # [4, B]
    out = prev_cum[:, w] + popcount32(word & mask[None, :])
    return out.T.to(torch.int32).contiguous()


BLOCK_WORDS = 6  # 32-bit words in a block of the rank-block table


def build_rank_blocks(prev_words, prev_cum) -> torch.Tensor:
    """The rank-block table of a rank structure, on the structure's device:
    int32 [nblk, 4, 8] with nblk = nw // 6 + 1.

    Block k of base b, ``blocks[k, b]``, is one aligned 32-byte sector: the
    int64 count of the set bits before word 6k (in the first two int32,
    little-endian), then words 6k .. 6k+5; the four bases' blocks of one k are
    one aligned 128-byte line.  Words past the structure are zero and the
    blocks there carry the totals, so a position equal to 32*nw is answered
    like any other; the table always holds at least one such word."""
    _check_structure("build_rank_blocks", prev_words, prev_cum)
    nw = prev_words.shape[1]
    nblk = nw // BLOCK_WORDS + 1
    if nblk * BLOCK_WORDS >= 1 << 32:
        raise ValueError("build_rank_blocks: word indices must fit 32 bits")
    totals = prev_cum[:, -1] + popcount32(i32_to_u32(prev_words[:, -1]))
    blocks = torch.zeros((nblk, 4, 8), dtype=torch.int32, device=prev_words.device)
    padded = blocks.new_zeros((4, nblk * BLOCK_WORDS))
    padded[:, :nw] = prev_words
    blocks[:, :, 2:] = padded.view(4, nblk, BLOCK_WORDS).transpose(0, 1)
    counts = torch.cat([prev_cum, totals[:, None]], dim=1)[:, ::BLOCK_WORDS]
    blocks.view(torch.int64)[:, :, 0] = counts.T
    return blocks


def _check_blocks(name, blocks):
    if (
        blocks.dtype != torch.int32
        or blocks.dim() != 3
        or blocks.shape[0] == 0
        or blocks.shape[1] != 4
        or blocks.shape[2] != 8
    ):
        raise TypeError(f"{name}: the rank-block table must be int32 [nblk>0, 4, 8]")


def _locate(blocks, b, pos):
    """(sector of base b's block, word inside the block, pos as int64
    clamped to >= 0) for rank positions pos; b and pos broadcast."""
    pos = pos.to(torch.int64).clamp(min=0)
    word = (pos >> 5).clamp(max=blocks.shape[0] * BLOCK_WORDS - 1)
    blk = word // BLOCK_WORDS
    return blk * 4 + b.to(torch.int64), word - blk * BLOCK_WORDS, pos


def rank_blocks_plain(blocks, b, pos) -> torch.Tensor:
    """Plain version of ``rank``: the rank of prev[base b] at positions pos
    (b and pos broadcast against each other) from the rank-block table:
    int64, the same values as ``rank_plain`` on the structure the table was
    built from."""
    sector, at, pos = _locate(blocks, b, pos)
    count = blocks.view(torch.int64).reshape(-1, 4)[sector, 0]
    words = i32_to_u32(blocks.reshape(-1, 8)[sector][..., 2:])  # [..., 6]
    at = at[..., None]
    j = torch.arange(BLOCK_WORDS, device=blocks.device)
    partial = low_bits_mask(pos & 31)[..., None]
    mask = torch.where(j < at, MASK32, torch.where(j == at, partial, 0))
    return count + popcount32(words & mask).sum(dim=-1)


def rank4_blocks_plain(blocks, pos) -> torch.Tensor:
    """Plain version of ``rank4``: int32 [B, 4] from the rank-block table,
    the same values as ``rank4_plain`` on the structure it was built from."""
    b = torch.arange(4, device=pos.device)
    return rank_blocks_plain(blocks, b[None, :], pos[:, None]).to(torch.int32)


def has_bit_blocks(blocks, b, pos) -> torch.Tensor:
    """Bit pos of prev[base b], read from its block's word slot: bool of the
    broadcast shape.  pos in [0, 32*nw)."""
    sector, at, pos = _locate(blocks, b, pos)
    word = i32_to_u32(blocks.reshape(-1, 8)[sector, 2 + at])
    return ((word >> (pos & 31)) & 1).to(torch.bool)


TILE_W = 1024  # word columns per tile of the tiled rank table
Q_BLOCK = 1024  # queries a block of the rank4_tiled kernel serves
COUNTER_INTS = 19  # ints of counters a tile takes in the bucketing kernels' scratch


class Rank4Tiles(NamedTuple):
    """The rank structure cut into tiles of TILE_W word columns.

    A tile's counts are rebased to its first column, so they fit int16
    (at most 32 * (TILE_W - 1)).  Columns past the structure hold a zero
    word and the totals: a position equal to 32*nw reads them."""

    words: torch.Tensor  # int32 [n_tiles * TILE_W, 4] — bits reinterpreted
    rel: torch.Tensor  # int16 [n_tiles * TILE_W, 4] — cum - base[tile]
    base: torch.Tensor  # int64 [n_tiles, 4] — cum at the tile's first column


def build_rank4_tiles(prev_words, prev_cum) -> Rank4Tiles:
    """The tiled rank table of a rank structure, on the structure's device."""
    _check_structure("build_rank4_tiles", prev_words, prev_cum)
    nw = prev_words.shape[1]
    n_tiles = -(-(nw + 1) // TILE_W)
    ncol = n_tiles * TILE_W
    totals = prev_cum[:, -1] + popcount32(i32_to_u32(prev_words[:, -1]))
    cum = torch.cat([prev_cum, totals[:, None].expand(4, ncol - nw)], dim=1)
    words = torch.zeros((ncol, 4), dtype=torch.int32, device=prev_words.device)
    words[:nw] = prev_words.T
    base = cum[:, ::TILE_W]  # [4, n_tiles]
    rel = cum.reshape(4, n_tiles, TILE_W) - base[:, :, None]
    return Rank4Tiles(
        words=words,
        rel=rel.reshape(4, ncol).T.to(torch.int16).contiguous(),
        base=base.T.contiguous(),
    )


def rank4_tiled_plain(tiles: Rank4Tiles, pos) -> torch.Tensor:
    """Plain version of ``rank4_tiled``: int32 [B, 4] from the tiled table,
    in the caller's order."""
    ncol = tiles.words.shape[0]
    pos = pos.to(torch.int64)
    col = (pos >> 5).clamp(max=ncol - 1)
    word = i32_to_u32(tiles.words[col])  # [B, 4]
    part = popcount32(word & low_bits_mask(pos & 31)[:, None])
    out = tiles.base[col // TILE_W] + tiles.rel[col].to(torch.int64) + part
    return out.to(torch.int32)


def tile_of(tiles: Rank4Tiles, pos) -> torch.Tensor:
    """The tile each position's word column lies in: int32 [B]."""
    ncol = tiles.words.shape[0]
    return ((pos >> 5).clamp(0, ncol - 1) // TILE_W).to(torch.int32)


def tile_buckets(tile: torch.Tensor, n_tiles: int):
    """Plain version of the bucketing kernels of ``rank4_tiled``
    (``tile_buckets_kernel``): the queries' tile ids [B] sorted and cut into
    the rank kernel's blocks: (perm, bt, blk_first, q_first, q_count).

    ``perm`` [B] sorts the queries by tile.  Tile t's bucket is the sorted
    queries [q_first[t], q_first[t] + q_count[t]), served by the blocks
    blk_first[t] .. in steps of Q_BLOCK queries; ``bt`` int32 [n_blocks]
    names each block's tile and is >= n_tiles for the blocks past the last
    bucket.  n_blocks is the bound ceil(B / Q_BLOCK) + n_tiles, fixed by the
    shapes, so nothing here waits for the device.  The order inside a bucket
    is left open, here as in the kernels."""
    B = tile.shape[0]
    dev = tile.device
    tile_s, perm = torch.sort(tile)
    bounds = torch.searchsorted(
        tile_s, torch.arange(n_tiles + 1, dtype=tile.dtype, device=dev)
    )
    q_first = bounds[:-1].contiguous()
    q_count = bounds[1:] - q_first
    blk_end = torch.cumsum((q_count + (Q_BLOCK - 1)) // Q_BLOCK, 0)
    blk_first = torch.cat([blk_end.new_zeros(1), blk_end[:-1]])
    n_blocks = -(-B // Q_BLOCK) + n_tiles
    bt = torch.searchsorted(
        blk_end, torch.arange(n_blocks, device=dev), right=True
    ).to(torch.int32)
    return perm, bt, blk_first, q_first, q_count


def gather_sizes_plain(entry_sizes, idx) -> torch.Tensor:
    """Plain version of ``gather_sizes``: entry_sizes[idx], int32."""
    return entry_sizes[idx.to(torch.int64)]


def push4_plain(blocks, entry_sizes, fixed, begin, end, size):
    """Plain version of ``push4``: (begin4, end4) int64 [B, 4], column b the
    (begin, end) of push_front(range, b); one stacked four-base rank over both
    range ends and one gather of the children's first entry sizes."""
    B = begin.shape[0]
    n = entry_sizes.shape[0]
    r4 = rank4_blocks_plain(blocks, torch.cat([begin, end])).to(torch.int64)
    nb = fixed[None, :4] + r4[:B]
    ne = fixed[None, :4] + r4[B:]
    new_size = (size + 1)[:, None]
    sizes_nb = gather_sizes_plain(entry_sizes, nb.clamp(max=n - 1))
    kick = (nb < ne) & (sizes_nb < new_size)
    nb = nb + kick.to(nb.dtype)
    was_valid = (begin < end)[:, None]
    return (
        torch.where(was_valid, nb, begin[:, None]),
        torch.where(was_valid, ne, begin[:, None]),
    )


def push_front_over(rank_ends, entry_sizes, fixed, begin, end, size, b):
    """One batched push_front step over ``rank_ends(b, begin, end)``, which
    ranks both ends of every range; lanes with begin >= end come back as
    (begin, begin, size)."""
    n = entry_sizes.shape[0]
    fixed_b = fixed[b.to(torch.int64)]
    rank_begin, rank_end = rank_ends(b, begin, end)
    nb = fixed_b + rank_begin
    ne = fixed_b + rank_end
    new_size = size + 1
    # kick begin forward if the first entry is too short to hold b+S
    sizes_nb = entry_sizes[nb.clamp(0, n - 1)]
    kick = (nb < ne) & (sizes_nb < new_size)
    nb = nb + kick.to(nb.dtype)
    was_valid = begin < end
    return (
        torch.where(was_valid, nb, begin),
        torch.where(was_valid, ne, begin),
        torch.where(was_valid, new_size, size),
    )


def push_front_plain(prev_words, prev_cum, entry_sizes, fixed, begin, end,
                     size, b):
    """One batched push_front step against the structure as stored."""

    def rank_ends(b, begin, end):
        return (rank_plain(prev_words, prev_cum, b, begin),
                rank_plain(prev_words, prev_cum, b, end))

    return push_front_over(rank_ends, entry_sizes, fixed, begin, end, size, b)


def chain_window_plain(blocks, entry_sizes, fixed, win, m, depth: int):
    """Plain version of ``chain_window``: the find-window loop of push_front
    steps, the ranks read from the rank-block table."""
    P = win.shape[0]
    dev = win.device
    n = entry_sizes.shape[0]
    m = torch.as_tensor(m, device=dev).to(torch.int32)
    begin = torch.zeros(P, dtype=torch.int64, device=dev)
    end = torch.full((P,), n, dtype=torch.int64, device=dev)
    size = torch.zeros(P, dtype=torch.int32, device=dev)

    def rank_ends(b, begin, end):
        return rank_blocks_plain(blocks, b, begin), rank_blocks_plain(blocks, b, end)

    for s in range(depth):
        started = s >= (depth - m)
        nb, ne, ns = push_front_over(
            rank_ends, entry_sizes, fixed, begin, end, size,
            win[:, s].to(torch.int64),
        )
        begin = torch.where(started, nb, begin)
        end = torch.where(started, ne, end)
        size = torch.where(started, ns, size)
    return begin, end, size


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_structure(name, prev_words, prev_cum):
    if (
        prev_words.dtype != torch.int32
        or prev_cum.dtype != torch.int64
        or prev_words.dim() != 2
        or prev_words.shape[0] != 4
        or prev_words.shape[1] == 0
        or prev_cum.shape != prev_words.shape
    ):
        raise TypeError(
            f"{name}: prev_words must be int32 [4, nw>0] and prev_cum int64 "
            "of the same shape"
        )


def _check_cuda(name, ref, *tensors):
    """All tensors contiguous and on the CUDA device of ``ref``."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    for t in (ref, *tensors):
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: every tensor must be contiguous and on {ref.device}"
            )


def rank4(blocks, pos) -> torch.Tensor:
    """All-four-bases rank at each position: int32 [B, 4].

    blocks int32 [nblk, 4, 8], the rank-block table (``build_rank_blocks``);
    pos int64 [B]: a negative position reads as 0, one past the structure
    as 32*nw."""
    _check_blocks("rank4", blocks)
    if pos.dtype != torch.int64 or pos.dim() != 1:
        raise TypeError("rank4: pos must be a 1-D int64 tensor")
    if pos.device.type == "cpu" and blocks.device.type == "cpu":
        return rank4_blocks_plain(blocks, pos)
    _check_cuda("rank4", pos, blocks)
    _build.check_constants("rank4", _KERNEL_CONSTANTS["rank4"])
    B = pos.shape[0]
    out = torch.empty((B, 4), dtype=torch.int32, device=pos.device)
    if B == 0:
        return out
    _build.launch(
        "rank4", "bgt_rank4", [_VP] * 3 + [_LL, _LL], pos.device,
        _build.ptr(blocks), _build.ptr(pos), _build.ptr(out), blocks.shape[0], B,
    )
    rank4.launches += 1
    return out


rank4.launches = 0


def rank(blocks, b, pos, pos_end=None):
    """The rank of prev[base b] at positions pos, one base a query: int64 of
    pos's shape, from the same table and the same source as ``rank4``.  With
    ``pos_end`` both ends of each range are ranked in the one launch and the
    pair (rank at pos, rank at pos_end) comes back.

    blocks int32 [nblk, 4, 8]; b int64 in [0, 4) and pos, pos_end int64, all
    of one shape."""
    _check_blocks("rank", blocks)
    ends = (pos,) if pos_end is None else (pos, pos_end)
    for t in (b, *ends):
        if t.dtype != torch.int64 or t.shape != b.shape:
            raise TypeError("rank: b and the positions must be int64 tensors of one shape")
    if b.device.type == "cpu" and blocks.device.type == "cpu":
        out = tuple(rank_blocks_plain(blocks, b, p) for p in ends)
        return out[0] if pos_end is None else out
    _check_cuda("rank", b, blocks, *ends)
    _build.check_constants("rank4", _KERNEL_CONSTANTS["rank4"])
    out = tuple(torch.empty_like(p) for p in ends)
    if b.numel():
        _build.launch(
            "rank4", "bgt_rank", [_VP] * 6 + [_LL, _LL], b.device,
            _build.ptr(blocks), _build.ptr(b), _build.ptr(pos),
            _build.ptr(pos_end) if pos_end is not None else None,
            _build.ptr(out[0]), _build.ptr(out[-1]), blocks.shape[0], b.numel(),
        )
        rank.launches += 1
    return out[0] if pos_end is None else out


rank.launches = 0


def _check_tiles(name, tiles: Rank4Tiles, pos):
    words, rel, base = tiles
    if (
        words.dtype != torch.int32
        or rel.dtype != torch.int16
        or base.dtype != torch.int64
        or words.dim() != 2
        or words.shape[1] != 4
        or rel.shape != words.shape
        or base.dim() != 2
        or base.shape[1] != 4
        or words.shape[0] != base.shape[0] * TILE_W
        or base.shape[0] == 0
    ):
        raise TypeError(
            f"{name}: want words int32 [n_tiles*TILE_W, 4], rel int16 of "
            "the same shape, base int64 [n_tiles>0, 4]"
        )
    if pos.dtype != torch.int64 or pos.dim() != 1:
        raise TypeError(f"{name}: pos must be a 1-D int64 tensor")
    if pos.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: at most 2^31 - 1 positions a call")


_KERNEL_CONSTANTS = {
    "rank4": (("bgt_rank4_block_words", BLOCK_WORDS),),
    "rank4_tiled": (
        ("bgt_rank4_tiled_tile_w", TILE_W), ("bgt_rank4_tiled_q_block", Q_BLOCK),
        ("bgt_rank4_tiled_counter_ints", COUNTER_INTS),
    ),
    "push4": (("bgt_push4_block_words", BLOCK_WORDS),),
    "chain_window": (("bgt_chain_window_block_words", BLOCK_WORDS),),
}


def _bucket_scratch(n_tiles: int, B: int, dev):
    """(scratch, n_blocks) for one call of the bucketing kernels: one int32
    buffer holding q_count, q_first and blk_first [3, n_tiles], the
    kernels' working counters, the block map bt [n_blocks] and, 8-byte
    aligned, the B query records of 8 bytes.  Nothing in it is set here."""
    n_blocks = -(-B // Q_BLOCK) + n_tiles
    used = COUNTER_INTS * n_tiles + n_blocks
    scratch = torch.empty(used + (used & 1) + 2 * B, dtype=torch.int32, device=dev)
    return scratch, n_blocks


def tile_buckets_kernel(tiles: Rank4Tiles, pos):
    """The bucketing kernels of ``rank4_tiled`` alone, for CUDA tensors:
    (at, perm, bt, blk_first, q_first, q_count), all int32.  Slot s of the
    buckets holds query perm[s], which lies at position at[s] of its tile;
    the last five are, but for the order inside a bucket, the values of
    ``tile_buckets``.  ``rank4_tiled`` queues the same kernels itself; this
    entry is for checks and timing."""
    _check_tiles("tile_buckets_kernel", tiles, pos)
    _check_cuda("tile_buckets_kernel", pos)
    _build.check_constants("rank4_tiled", _KERNEL_CONSTANTS["rank4_tiled"])
    B, n_tiles = pos.shape[0], tiles.base.shape[0]
    scratch, n_blocks = _bucket_scratch(n_tiles, B, pos.device)
    _build.launch(
        "rank4_tiled", "bgt_tile_buckets", [_VP, _VP] + [_LL] * 4, pos.device,
        _build.ptr(pos), _build.ptr(scratch), B, tiles.words.shape[0],
        n_tiles, n_blocks,
    )
    q_count, q_first, blk_first = scratch[: 3 * n_tiles].view(3, n_tiles)
    bt = scratch[COUNTER_INTS * n_tiles :][:n_blocks]
    recs = scratch[scratch.shape[0] - 2 * B :].view(B, 2)  # little-endian halves
    return recs[:, 1], recs[:, 0], bt, blk_first, q_first, q_count


def rank4_tiled(tiles: Rank4Tiles, pos) -> torch.Tensor:
    """All-four-bases rank at each position against the tiled table: int32
    [B, 4], the same values as ``rank4`` on the structure the table was
    built from.

    pos int64 [B] in [0, 32*nw].  One call queues the bucketing of the
    queries by tile (histogram, scan, scatter) and the rank kernel, which
    writes each result to its query's own place."""
    _check_tiles("rank4_tiled", tiles, pos)
    if pos.device.type == "cpu":
        return rank4_tiled_plain(tiles, pos)
    words, rel, base = tiles
    _check_cuda("rank4_tiled", pos, words, rel, base)
    _build.check_constants("rank4_tiled", _KERNEL_CONSTANTS["rank4_tiled"])
    B, n_tiles = pos.shape[0], base.shape[0]
    out = torch.empty((B, 4), dtype=torch.int32, device=pos.device)
    if B == 0:
        return out
    scratch, n_blocks = _bucket_scratch(n_tiles, B, pos.device)
    _build.launch(
        "rank4_tiled", "bgt_rank4_tiled", [_VP] * 6 + [_LL] * 4, pos.device,
        _build.ptr(words), _build.ptr(rel), _build.ptr(base), _build.ptr(pos),
        _build.ptr(scratch), _build.ptr(out), B, words.shape[0], n_tiles,
        n_blocks,
    )
    rank4_tiled.launches += 1
    return out


rank4_tiled.launches = 0


def gather_sizes(entry_sizes, idx) -> torch.Tensor:
    """entry_sizes[idx], exact: int32 of idx's shape.

    entry_sizes int32 [n]; idx int64 [...] already clamped into [0, n)."""
    if entry_sizes.dtype != torch.int32 or entry_sizes.dim() != 1:
        raise TypeError("gather_sizes: entry_sizes must be a 1-D int32 tensor")
    if idx.dtype != torch.int64:
        raise TypeError("gather_sizes: idx must be an int64 tensor")
    if entry_sizes.shape[0] == 0:
        raise ValueError("gather_sizes: entry_sizes is empty")
    if idx.device.type == "cpu":
        return gather_sizes_plain(entry_sizes, idx)
    _check_cuda("gather_sizes", idx, entry_sizes)
    out = torch.empty(idx.shape, dtype=torch.int32, device=idx.device)
    if idx.numel() == 0:
        return out
    _build.launch(
        "gather_sizes", "bgt_gather_sizes", [_VP, _VP, _VP, _LL, _LL],
        idx.device, _build.ptr(entry_sizes), _build.ptr(idx), _build.ptr(out),
        entry_sizes.shape[0], idx.numel(),
    )
    gather_sizes.launches += 1
    return out


gather_sizes.launches = 0


def push4(blocks, entry_sizes, fixed, begin, end, size):
    """The children of each range for all four pushed bases, in one launch:
    (begin4, end4) int64 [B, 4], column b the (begin, end) of
    push_front((begin, end, size), b).  A range with begin >= end comes back
    as (begin, begin) in every column.

    blocks int32 [nblk, 4, 8], the rank-block table; entry_sizes int32 [n>0];
    fixed int64 [5]; begin, end int64 [B]; size int32 [B].  Counts are below
    2^31, as for ``rank4``."""
    _check_blocks("push4", blocks)
    if (
        begin.dtype != torch.int64
        or begin.dim() != 1
        or end.dtype != torch.int64
        or end.shape != begin.shape
        or size.dtype != torch.int32
        or size.shape != begin.shape
        or fixed.dtype != torch.int64
        or fixed.shape != (5,)
        or entry_sizes.dtype != torch.int32
        or entry_sizes.dim() != 1
    ):
        raise TypeError(
            "push4: want begin, end int64 [B], size int32 [B], fixed int64 "
            "[5], entry_sizes int32 [n]"
        )
    if entry_sizes.shape[0] == 0:
        raise ValueError("push4: entry_sizes is empty")
    devices = {t.device.type for t in (blocks, entry_sizes, fixed, begin, end, size)}
    if devices == {"cpu"}:
        return push4_plain(blocks, entry_sizes, fixed, begin, end, size)
    _check_cuda("push4", begin, blocks, entry_sizes, fixed, end, size)
    _build.check_constants("push4", _KERNEL_CONSTANTS["push4"])
    B = begin.shape[0]
    begin4 = torch.empty((B, 4), dtype=torch.int64, device=begin.device)
    end4 = torch.empty((B, 4), dtype=torch.int64, device=begin.device)
    if B == 0:
        return begin4, end4
    _build.launch(
        "push4", "bgt_push4", [_VP] * 8 + [_LL] * 3, begin.device,
        _build.ptr(blocks), _build.ptr(entry_sizes), _build.ptr(fixed),
        _build.ptr(begin), _build.ptr(end), _build.ptr(size),
        _build.ptr(begin4), _build.ptr(end4), blocks.shape[0],
        entry_sizes.shape[0], B,
    )
    push4.launches += 1
    return begin4, end4


push4.launches = 0


def chain_window(blocks, entry_sizes, fixed, win, m, depth: int):
    """find_window over pre-built complemented window rows, the whole chain
    in one launch.

    blocks int32 [nblk, 4, 8], the rank-block table (``build_rank_blocks``);
    win uint8 [P, depth] (``probes._window_bases``); m int32 [P] per-lane
    window length; fixed int64 [5].  Returns (begin int64 [P], end int64
    [P], size int32 [P]): the contract of ``probes.find_window``."""
    return _chain(chain_window, blocks, entry_sizes, fixed, win, m, depth)


chain_window.launches = 0


def contig_windows(text: torch.Tensor, depth: int) -> torch.Tensor:
    """Complemented window rows for the contiguous positions [0, P):
    win[j, s] = 3 - text[j - depth + 1 + s], reading 0 (so pushing 3) left
    of the text.  uint8 [P, depth]."""
    P = text.shape[0]
    padded = torch.cat([text.new_zeros(depth - 1), text])
    return (3 - padded.unfold(0, depth, 1)[:P]).to(torch.uint8).contiguous()


def chain_fixed(blocks, entry_sizes, fixed, text, depth: int):
    """(begin, end, size) of the depth-length window ending at every text
    position: the ``chain_window`` kernel over the contiguous windows, one
    launch, counted in ``chain_fixed.launches`` alone.  Positions p <
    depth-1 read a zero halo: callers mask them."""
    m = torch.full((text.shape[0],), depth, dtype=torch.int32, device=text.device)
    return _chain(chain_fixed, blocks, entry_sizes, fixed, contig_windows(text, depth), m, depth)


def _chain(entry, blocks, entry_sizes, fixed, win, m, depth: int):
    """The chain_window kernel behind both entries: its plain version on CPU
    tensors, else one launch, counted in ``entry.launches``."""
    _check_blocks("chain_window", blocks)
    if (
        win.dtype != torch.uint8
        or win.dim() != 2
        or win.shape[1] != depth
        or m.dtype != torch.int32
        or m.shape != (win.shape[0],)
        or fixed.dtype != torch.int64
        or fixed.shape != (5,)
        or entry_sizes.dtype != torch.int32
        or entry_sizes.dim() != 1
    ):
        raise TypeError(
            "chain_window: want win uint8 [P, depth], m int32 [P], fixed "
            "int64 [5], entry_sizes int32 [n]"
        )
    if win.device.type == "cpu":
        return chain_window_plain(blocks, entry_sizes, fixed, win, m, depth)
    _check_cuda("chain_window", win, blocks, entry_sizes, fixed, m)
    _build.check_constants("chain_window", _KERNEL_CONSTANTS["chain_window"])
    P = win.shape[0]
    dev = win.device
    begin = torch.empty(P, dtype=torch.int64, device=dev)
    end = torch.empty(P, dtype=torch.int64, device=dev)
    size = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return begin, end, size
    _build.launch(
        "chain_window", "bgt_chain_window",
        [_VP] * 8 + [_LL, _LL, _LL, ctypes.c_int], dev,
        _build.ptr(blocks), _build.ptr(entry_sizes), _build.ptr(fixed),
        _build.ptr(win), _build.ptr(m), _build.ptr(begin), _build.ptr(end),
        _build.ptr(size), blocks.shape[0], entry_sizes.shape[0], P, depth,
    )
    entry.launches += 1
    return begin, end, size


chain_fixed.launches = 0
