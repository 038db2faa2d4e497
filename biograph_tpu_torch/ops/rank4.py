"""The seqset's rank kernels: rank4, gather_sizes, chain_window, rank4_tiled
(K1-K3, K5).

They replace the TPU kernels of ``biograph_tpu/ops/rank4.py``:

  * ``rank4``        <- ``rank4_pallas`` (``_rank4_kernel``)
  * ``rank4_tiled``  <- ``rank4_hbm_pallas`` (``_rank4_hbm_kernel``), over
    ``build_rank4_tiles`` <- ``build_rank4_hbm_table``
  * ``gather_sizes`` <- ``gather_bytes_pallas`` (``_gather_bytes_kernel``)
  * ``chain_window`` <- ``chain_window_pallas`` (``_chain_window_kernel``),
    with ``chain_fixed`` <- ``chain_fixed_pallas`` over contiguous positions

The TPU kernels turn the gathers into one-hot matrix products over
byte-limb tables, because random gathers are what that machine lacks; that
brought an entry cap and a 24-bit count cap.  A GPU gathers directly, so
these kernels read the rank structure as the seqset stores it and carry no
table and no cap:

    rank_b(pos) = cum[b, pos>>5] + popcount(words[b, pos>>5] & low(pos&31))

All three are bound by bytes gathered at random (a 32-byte sector per
4- or 8-byte value), not by arithmetic.  The design is one thread per query
or lane with every load independent (rank4, gather_sizes) or the whole
dependent chain kept in registers (chain_window); the rank structure of a
seqset is a few MB and is served from L2 after first touch.

``rank4`` and ``rank4_tiled`` compute the same [B, 4] ranks and differ in
what they read.  ``rank4`` gathers from the structure as stored, eight
sectors a query, in the caller's order: the form for positions in any order
and any number.  ``rank4_tiled`` is the bulk form under ``push4``: its table
(``Rank4Tiles``) keeps a word column's four words and four tile-relative
counts side by side (24 bytes, two sectors, half the stored structure's
bytes), and its queries are sorted by tile so that a block reads its tile
once, coalesced, into shared memory.  Neither has a size gate.

Representation: ``prev_words`` is ``torch.int32`` [4, nw] holding the
words' bits reinterpreted; ``prev_cum`` is int64 [4, nw].  The kernels take
``__popc`` of the 32 bits; the plain versions widen to int64, mask with
``& 0xFFFFFFFF`` and count by SWAR.

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


TILE_W = 1024  # word columns per tile of the tiled rank table
Q_BLOCK = 1024  # queries a block of the rank4_tiled kernel serves


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


def tile_buckets(tile: torch.Tensor, n_tiles: int):
    """The queries' tile ids [B] sorted and cut into the rank4_tiled kernel's
    blocks: (perm, bt, blk_first, q_first, q_count).

    ``perm`` [B] sorts the queries by tile.  Tile t's bucket is the sorted
    queries [q_first[t], q_first[t] + q_count[t]), served by the blocks
    blk_first[t] .. in steps of Q_BLOCK queries; ``bt`` int32 [n_blocks]
    names each block's tile and is >= n_tiles for the blocks past the last
    bucket.  n_blocks is the bound ceil(B / Q_BLOCK) + n_tiles, fixed by the
    shapes, so nothing here waits for the device."""
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


def push_front_plain(prev_words, prev_cum, entry_sizes, fixed, begin, end,
                     size, b):
    """One batched push_front step; lanes with begin >= end come back as
    (begin, begin, size)."""
    n = entry_sizes.shape[0]
    fixed_b = fixed[b.to(torch.int64)]
    nb = fixed_b + rank_plain(prev_words, prev_cum, b, begin)
    ne = fixed_b + rank_plain(prev_words, prev_cum, b, end)
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


def chain_window_plain(prev_words, prev_cum, entry_sizes, fixed, win, m,
                       depth: int):
    """Plain version of ``chain_window``: the find-window loop over
    push_front."""
    P = win.shape[0]
    dev = win.device
    n = entry_sizes.shape[0]
    m = torch.as_tensor(m, device=dev).to(torch.int32)
    begin = torch.zeros(P, dtype=torch.int64, device=dev)
    end = torch.full((P,), n, dtype=torch.int64, device=dev)
    size = torch.zeros(P, dtype=torch.int32, device=dev)
    for s in range(depth):
        started = s >= (depth - m)
        nb, ne, ns = push_front_plain(
            prev_words, prev_cum, entry_sizes, fixed, begin, end, size,
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


def rank4(prev_words, prev_cum, pos) -> torch.Tensor:
    """All-four-bases rank at each position: int32 [B, 4].

    prev_words int32 [4, nw]; prev_cum int64 [4, nw]; pos int64 [B] in
    [0, 32*nw]."""
    _check_structure("rank4", prev_words, prev_cum)
    if pos.dtype != torch.int64 or pos.dim() != 1:
        raise TypeError("rank4: pos must be a 1-D int64 tensor")
    if pos.device.type == "cpu":
        return rank4_plain(prev_words, prev_cum, pos)
    _check_cuda("rank4", pos, prev_words, prev_cum)
    B = pos.shape[0]
    out = torch.empty((B, 4), dtype=torch.int32, device=pos.device)
    if B == 0:
        return out
    _build.launch(
        "rank4", "bgt_rank4", [_VP] * 4 + [_LL, _LL], pos.device,
        _build.ptr(prev_words), _build.ptr(prev_cum), _build.ptr(pos),
        _build.ptr(out), prev_words.shape[1], B,
    )
    rank4.launches += 1
    return out


rank4.launches = 0


def rank4_tiled(tiles: Rank4Tiles, pos) -> torch.Tensor:
    """All-four-bases rank at each position against the tiled table: int32
    [B, 4], the same values as ``rank4`` on the structure the table was
    built from.

    pos int64 [B] in [0, 32*nw].  The sort of the queries by tile and the
    cut into blocks are tensor code (``tile_buckets``); the rank itself,
    the un-permute included, is the kernel."""
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
            "rank4_tiled: want words int32 [n_tiles*TILE_W, 4], rel int16 of "
            "the same shape, base int64 [n_tiles>0, 4]"
        )
    if pos.dtype != torch.int64 or pos.dim() != 1:
        raise TypeError("rank4_tiled: pos must be a 1-D int64 tensor")
    if pos.device.type == "cpu":
        return rank4_tiled_plain(tiles, pos)
    _check_cuda("rank4_tiled", pos, words, rel, base)
    for symbol, value in (
        ("bgt_rank4_tiled_tile_w", TILE_W), ("bgt_rank4_tiled_q_block", Q_BLOCK)
    ):
        if _build.function("rank4_tiled", symbol, [])() != value:
            raise RuntimeError(f"rank4_tiled: {symbol} differs from the wrapper's")
    B = pos.shape[0]
    n_tiles = base.shape[0]
    out = torch.empty((B, 4), dtype=torch.int32, device=pos.device)
    if B == 0:
        return out
    tile = ((pos >> 5).clamp(0, words.shape[0] - 1) // TILE_W).to(torch.int32)
    perm, bt, blk_first, q_first, q_count = tile_buckets(tile, n_tiles)
    pos_sorted = pos[perm]
    _build.launch(
        "rank4_tiled", "bgt_rank4_tiled", [_VP] * 10 + [_LL, _LL], pos.device,
        _build.ptr(words), _build.ptr(rel), _build.ptr(base),
        _build.ptr(pos_sorted), _build.ptr(perm), _build.ptr(bt),
        _build.ptr(blk_first), _build.ptr(q_first), _build.ptr(q_count),
        _build.ptr(out), n_tiles, bt.shape[0],
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


def chain_window(prev_words, prev_cum, entry_sizes, fixed, win, m, depth: int):
    """find_window over pre-built complemented window rows, the whole chain
    in one launch.

    win uint8 [P, depth] (``probes._window_bases``); m int32 [P] per-lane
    window length; fixed int64 [5].  Returns (begin int64 [P], end int64
    [P], size int32 [P]): the contract of ``probes.find_window``."""
    _check_structure("chain_window", prev_words, prev_cum)
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
        return chain_window_plain(
            prev_words, prev_cum, entry_sizes, fixed, win, m, depth
        )
    _check_cuda(
        "chain_window", win, prev_words, prev_cum, entry_sizes, fixed, m
    )
    P = win.shape[0]
    dev = win.device
    begin = torch.empty(P, dtype=torch.int64, device=dev)
    end = torch.empty(P, dtype=torch.int64, device=dev)
    size = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return begin, end, size
    _build.launch(
        "chain_window", "bgt_chain_window",
        [_VP] * 9 + [_LL, _LL, _LL, ctypes.c_int], dev,
        _build.ptr(prev_words), _build.ptr(prev_cum), _build.ptr(entry_sizes),
        _build.ptr(fixed), _build.ptr(win), _build.ptr(m), _build.ptr(begin),
        _build.ptr(end), _build.ptr(size), prev_words.shape[1],
        entry_sizes.shape[0], P, depth,
    )
    chain_window.launches += 1
    return begin, end, size


chain_window.launches = 0


def contig_windows(text: torch.Tensor, depth: int) -> torch.Tensor:
    """Complemented window rows for the contiguous positions [0, P):
    win[j, s] = 3 - text[j - depth + 1 + s], reading 0 (so pushing 3) left
    of the text.  uint8 [P, depth]."""
    P = text.shape[0]
    padded = torch.cat([text.new_zeros(depth - 1), text])
    return (3 - padded.unfold(0, depth, 1)[:P]).to(torch.uint8).contiguous()


def chain_fixed(prev_words, prev_cum, entry_sizes, fixed, text, depth: int):
    """(begin, end, size) of the depth-length window ending at every text
    position.  Positions p < depth-1 read a zero halo: callers mask them."""
    P = text.shape[0]
    m = torch.full((P,), depth, dtype=torch.int32, device=text.device)
    return chain_window(
        prev_words, prev_cum, entry_sizes, fixed,
        contig_windows(text, depth), m, depth,
    )
