"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT.json]

Builds the CUDA kernels of ``biograph_tpu_torch`` from the sources in this
checkout, holds each against its plain PyTorch version on the card (exact
equality: everything is integer), then drives the port's create-and-query
path at a real size: 120 000 reads of 100 bases over a 2 Mb genome with
4000 planted SNPs, half of them reverse-complemented, generated in-process
from seed 12345.  The path is build_seqset -> build_readmap -> save/load ->
find of all 240 000 oriented reads -> rank4 at the found ranges' ends (and
the same through rank4_tiled over a tiled table the caller builds) -> push4
(and sizes_at at the children it returns) -> probe_exact (depth 32) over every
position of the doubled fwd+rc genome text.  Then variant discovery runs on the
same store, from the read store to records (prescreen, chain-kernel front end,
anchor scan, beam wavefront, extract + affine DP), cold and warm, and is held
to the genome, to the planted SNPs and, over a region, to the same call on a
CPU copy of the store, where every kernel's plain version runs; the call is
then replayed stage by stage with push4, rank and chain_window each held
against its plain version on the very lanes discovery hands it; a small
genome with an insertion, a deletion and a block substitution is discovered on
the card and on the CPU with identical records, which takes the affine DP to
the card.  Then discovery runs with the readmap the path built and loaded
(scoring by read coverage, the min_alt_support filter, the pair gate), cold
and warm, and its records are held to the JAX package's CPU leg on the same
workload (``tests/data/torch_scaled_leg_records.tsv``) and written as VCF and
read back; over a region the same call runs on a CPU copy of the store and
the readmap; coverage of a slab of the scored rows runs without the hash
index, through chain_fixed, held against its plain version and against the
hash route; a paired library (a 400-base insertion, mates at fragment 260)
is discovered on the card and on a CPU copy with identical records, and its
insertion culled on both by a gate that asks for more pairs than exist; so is
coverage on a library of mixed read lengths (its general route: probe_ranges,
then the chain kernel).  The scored call then runs twice more, cold and
warm, each held to the same records: by the dense front end
(``discover.NO_PRESCREEN``: the restart chain through rank over every
position, the filter and the bisection through chain_window over the lanes
that restarted), with rank and push4 then held against their plain versions
on its lanes; and with a memory plan that leaves no room for the trunc
tables (``discover.BUDGET_BYTES``), so each beam step truncates through the
seqset's LtSearch.  The widen family (truncate_ranges, pop_front_ranges,
push_front_drop) runs over the ranges find gave every oriented read, and
LtSearch on 2^20 random queries, on the card and on a CPU copy of the store
with identical answers; a .bgt of the store and the readmap is opened with
BioGraph on the card and on the CPU, and find, SeqsetEntry.pop_front and
truncate and read iteration on a sample of reads give identical answers.
Last, the rank kernels are timed side by side on a
rank structure that outgrows the card's L2 cache, where the rank-block table
and the bucketing kernels of rank4_tiled are held against their plain
versions too.

Any failure raises and the exit code is non-zero; there is no CPU fallback.
Stage times are host-clock times read after ``torch.cuda.synchronize()``;
kernel times are CUDA-event times over repeated launches.  The last line of
standard output is ``{"ok": true, "device": {...}}``.  With ``--profile`` the
main path runs twice more, warm and then with each stage under
``torch.profiler``, and each stage's cold and warm time, the device's busy
time and its heaviest kernels go to OUT.json; the ``kernels`` and
``rank_past_l2`` lines then also split a ``rank4_tiled`` call into its
kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from biograph_tpu_torch.build.readmap_build import build_readmap
from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.convert import reference_from_numpy
from biograph_tpu_torch.index import probes
from biograph_tpu_torch.index import readmap as readmap_mod
from biograph_tpu_torch.index.readmap import Readmap
from biograph_tpu_torch.io.vcf import read_vcf
from biograph_tpu_torch.index.seqset import Seqset, SeqsetRanges
from biograph_tpu_torch.ops import _build, rank4 as rank4_ops, rank_cum as rank_cum_ops
from biograph_tpu_torch.ops.ltsearch import LtSearch
from biograph_tpu_torch.variants import discover as disc

SEED = 12345
GENOME, READ_LEN, READS, SNPS = 2_000_000, 100, 120_000, 4000
DEPTH = 32
PROBE_CHUNK = 1 << 20
# a rank structure past the 50 MB L2: 2^24 words a base, 805 MB as stored
BIG_NW, BIG_QUERIES = 1 << 24, 1 << 22

# NVIDIA H100 SXM data-sheet peaks: device memory rate, and the float32 rate
# outside the tensor cores, taken as the rate of the 32-bit integer lanes.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Integer operations that one push_front step of one lane needs, whatever the
# rank layout: two ranks (word index, mask, popcount, the adds) plus the
# window base, the gate, the size compare and the kick.
CHAIN_OPS_PER_STEP = 48

WRAPPERS = {
    "rank4": rank4_ops.rank4,
    "rank": rank4_ops.rank,
    "rank4_tiled": rank4_ops.rank4_tiled,
    "gather_sizes": rank4_ops.gather_sizes,
    "push4": rank4_ops.push4,
    "chain_window": rank4_ops.chain_window,
    "chain_fixed": rank4_ops.chain_fixed,
    "rank_cum": rank_cum_ops.rank_cum,
}
# the kernels of the create-and-query path: chain_fixed is coverage's (its
# uniform route without the hash index), which scored_checks drives
MAIN_PATH_KERNELS = tuple(name for name in WRAPPERS if name != "chain_fixed")
SOURCES = {"rank": "rank4", "chain_fixed": "chain_window"}  # kernels whose source is not named after them
REPLACES = {
    "rank4": "biograph_tpu/ops/rank4.py:134",
    "rank": "biograph_tpu/ops/rank4.py:134",
    "rank4_tiled": "biograph_tpu/ops/rank4.py:559",
    "gather_sizes": "biograph_tpu/ops/rank4.py:202",
    "push4": "biograph_tpu/ops/rank4.py:202",
    "chain_window": "biograph_tpu/ops/rank4.py:359",
    "chain_fixed": "biograph_tpu/ops/rank4.py:407",
    "rank_cum": "biograph_tpu/ops/pallas_rank.py:89",
}


def say(**kw):
    print(json.dumps(kw), flush=True)


PROFILE = None  # {stage: {...}} while a --profile run is on


def timed(fn, stage=None):
    """(result, seconds) of fn(), the device drained before and after.  In
    a --profile run a named stage also runs under torch.profiler, which
    gives the time the device was busy and its heaviest kernels."""
    torch.cuda.synchronize()
    if PROFILE is not None and stage is not None:
        return _profiled(fn, stage)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profiled(fn, stage):
    from torch.profiler import ProfilerActivity, profile

    # discovery is tens of thousands of launches: its trace keeps the device
    # side only
    activities = [ProfilerActivity.CUDA] if stage.startswith("discover") else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        out = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    PROFILE[stage] = {
        "device_busy_s": sum(_device_us(e) for e in kernels) / 1e6,
        "launches": sum(e.count for e in kernels),
        "top": [[e.key[:80], e.count, _device_us(e) / 1e3] for e in kernels[:8]],
    }
    return out, seconds


def _device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernels_us(fn, reps: int = 10) -> dict:
    """Mean device microseconds of every kernel that one fn() launches, by
    the kernel's name (cut at its argument list), under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:48]: _device_us(e) / reps for e in prof.key_averages() if _device_us(e)}


def event_ms(fn, reps: int, warm: int = 2, stall=None) -> float:
    """Mean CUDA-event time of one fn() over ``reps`` back-to-back calls.

    With ``stall`` (a callable that queues some tens of milliseconds of
    device work) the calls are enqueued while the device is still busy, so
    the events bracket device time alone; without it the time includes
    whatever the host needs to issue each call."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if stall is not None:
        stall()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_stall(dev):
    """A callable that queues some tens of milliseconds of device work."""
    a = torch.randn(8192, 8192, device=dev)

    def stall():
        for _ in range(4):
            torch.mm(a, a)

    return stall


def max_abs_err(got, want) -> int:
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype differ: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel():
            worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


def require_equal(name, got, want):
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel and plain version differ (max abs {err})")
    return err


def make_workload(genome_len: int, n_reads: int, n_snps: int, read_len: int):
    """(genome, codes [R, L], lengths [R]): reads of a SNP-carrying donor,
    the first half reverse-complemented."""
    return simulate(genome_len, n_reads, n_snps, read_len)[:3]


def simulate(genome_len: int, n_reads: int, n_snps: int, read_len: int):
    """The workload and its truth: (genome, codes, lengths, SNP positions,
    donor, read starts)."""
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    donor = genome.copy()
    snp = rng.choice(np.arange(200, genome_len - 200), n_snps, replace=False)
    donor[snp] = (donor[snp] + 1 + rng.integers(0, 3, n_snps)) % 4
    starts = rng.integers(0, genome_len - read_len, n_reads)
    codes = donor[starts[:, None] + np.arange(read_len)]
    half = n_reads // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    return genome, codes.astype(np.uint8), np.full(n_reads, read_len, np.int32), snp, donor, starts


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def check_rank_blocks(name, words, cum, blocks, pos):
    """The rank-block table, its two plain versions and its two kernels
    against the structure as stored.  ``pos`` may lie outside [0, 32*nw]:
    the table's forms clamp it, the stored form is asked the clamped one."""
    inside = pos.clamp(0, 32 * words.shape[1])
    for b in range(4):
        base = torch.full_like(pos, b)
        require_equal(f"rank_blocks {name} base {b}", rank4_ops.rank_blocks_plain(blocks, base, pos),
                      rank4_ops.rank_plain(words, cum, base, inside))
    got4 = rank4_ops.rank4(blocks, pos)
    require_equal(f"rank4 {name}", got4, rank4_ops.rank4_blocks_plain(blocks, pos))
    require_equal(f"rank4 {name} vs the structure as stored", got4, rank4_ops.rank4_plain(words, cum, inside))
    b = (pos * 2654435761 >> 7) & 3  # a base a query, in no pattern
    ends = pos.flip(0).contiguous()
    got = rank4_ops.rank(blocks, b, pos)
    require_equal(f"rank {name}", got, rank4_ops.rank_blocks_plain(blocks, b, pos))
    require_equal(f"rank {name} vs the structure as stored", got, rank4_ops.rank_plain(words, cum, b, inside))
    require_equal(f"rank {name}, both ends of a range", rank4_ops.rank(blocks, b, pos, ends),
                  (got, rank4_ops.rank_blocks_plain(blocks, b, ends)))
    return got4


def check_buckets(name, tiles, pos):
    """The bucketing kernels of rank4_tiled against tile_buckets: the same
    buckets and block map, and the same queries in every bucket (the order
    inside a bucket is left open on both sides)."""
    n_tiles = tiles.base.shape[0]
    at, perm, *got = rank4_ops.tile_buckets_kernel(tiles, pos)
    want_perm, *want = rank4_ops.tile_buckets(rank4_ops.tile_of(tiles, pos), n_tiles)
    for what, g, w in zip(("bt", "blk_first", "q_first", "q_count"), got, want):
        require_equal(f"tile_buckets {name} {what}", g.to(torch.int64), w.to(torch.int64))
    perm = perm.to(torch.int64)
    in_tile = pos.clamp(0, 32 * tiles.words.shape[0] - 1) % (32 * rank4_ops.TILE_W)
    require_equal(f"tile_buckets {name} place in the tile", at.to(torch.int64), in_tile[perm])
    # every query once, and each bucket's slots hold that bucket's queries:
    # perm and tile_buckets' perm are then equal once sorted inside each bucket
    bucket = torch.repeat_interleave(torch.arange(n_tiles, device=pos.device), want[3])
    tile = rank4_ops.tile_of(tiles, pos).to(torch.int64)
    require_equal(f"tile_buckets {name} perm is a permutation", perm.sort().values, torch.arange(pos.shape[0], device=pos.device))
    require_equal(f"tile_buckets {name} bucket of each slot", tile[perm], bucket)
    require_equal(f"tile_buckets {name} plain bucket of each slot", tile[want_perm], bucket)


def chain_block_edges(dev, g, words, blocks, nw):
    """chain_window on a made-up store whose range ends sit on the edges of
    the rank blocks: the first step ranks 0 and n for n at a block's last
    entry, the next block's first, and 32*nw; later steps rank wherever
    those land."""
    depth = 3
    win = torch.randint(0, 4, (64, depth), generator=g).to(torch.uint8).to(dev)
    m = torch.full((64,), depth, dtype=torch.int32, device=dev)
    m[::5] = 1
    sizes_all = torch.randint(1, 5, (32 * nw,), generator=g).to(torch.int32).to(dev)
    for n in sorted({1, 191, 192, 193, 32 * nw - 1, 32 * nw}):
        if n > 32 * nw:
            continue
        fixed = torch.tensor([0, 0, 0, 0, n], device=dev)
        args = (blocks, sizes_all[:n].contiguous(), fixed, win, m, depth)
        require_equal(f"chain_window block edge nw={nw} n={n}", rank4_ops.chain_window(*args), rank4_ops.chain_window_plain(*args))


def random_words(shape, dev, g):
    """int32 words with every bit random, from the CPU generator g."""
    words64 = torch.randint(0, 1 << 32, shape, generator=g)
    return torch.where(words64 >= 1 << 31, words64 - (1 << 32), words64).to(torch.int32).to(dev)


def rank_cum_edges(dev, g):
    """rank_cum at every small size, around the multiples of the words a
    block takes (a row's first 16-byte group may start up to three words
    before the row), as one row and as four, on whole allocations and on row
    views that start off a 16-byte boundary, and on a row whose total passes
    2^30."""
    T = rank_cum_ops.TILE_WORDS
    sizes = [*range(1, 70), 127, 128, 129, 1000, 1023, 1024, 1025, 3000]
    sizes += [k * T + o for k in (1, 2, 3) for o in (-4, -3, -2, -1, 0, 1, 2, 3)]
    for nw in sizes:
        words = random_words((4, nw), dev, g)
        want = rank_cum_ops.rank_cum_plain(words)
        require_equal(f"rank_cum [4, {nw}]", rank_cum_ops.rank_cum(words), want)
        require_equal(f"rank_cum [1, {nw}]", rank_cum_ops.rank_cum(words[:1]), want[:1])
        for r in range(4):
            require_equal(f"rank_cum [{nw}], row {r} as a view", rank_cum_ops.rank_cum(words[r]), want[r])
    ones = torch.full(((1 << 25) + T + 3,), -1, dtype=torch.int32, device=dev)
    got = rank_cum_ops.rank_cum(ones)
    if int(got[-1]) <= 1 << 30:
        raise AssertionError("rank_cum: the long row's total does not pass 2^30")
    require_equal("rank_cum, total past 2^30", got, rank_cum_ops.rank_cum_plain(ones))


def push4_unfused(d, r):
    """push4 as it was before the push4 kernel: the rank4 kernel over both
    range ends stacked, the gather_sizes kernel, and tensor code around
    them.  Kept here as the yardstick the fused kernel is timed against."""
    B = r.begin.shape[0]
    r4 = rank4_ops.rank4(d.rank_blocks, torch.cat([r.begin, r.end])).to(torch.int64)
    nb = d.fixed[None, :4] + r4[:B]
    ne = d.fixed[None, :4] + r4[B:]
    sizes_nb = rank4_ops.gather_sizes(d.entry_sizes, nb.clamp(max=d.n_entries - 1))
    kick = (nb < ne) & (sizes_nb < (r.size + 1)[:, None])
    nb = nb + kick.to(nb.dtype)
    was_valid = (r.begin < r.end)[:, None]
    return torch.where(was_valid, nb, r.begin[:, None]), torch.where(was_valid, ne, r.begin[:, None])


def push4_edges(dev, g, ss):
    """push4 against push4_plain and against four push_front calls over the
    structure as stored: every range of a small seqset's entry pairs, B not a
    multiple of the block, empty and reversed ranges, begin and end in one
    rank block and in different ones, end == n, sizes that do and do not
    trigger the kick, and a made-up store whose pushed begin reaches n (the
    min(nb, n - 1) clamp)."""
    d = ss.d
    n = ss.n_entries
    words, cum = ss.prev_words.to(dev), ss.prev_cum.to(dev)

    def check(name, begin, end, size):
        args = (d.rank_blocks, d.entry_sizes, d.fixed, begin.contiguous(), end.contiguous(), size.contiguous())
        got = rank4_ops.push4(*args)
        require_equal(f"push4 {name}", got, rank4_ops.push4_plain(*args))
        for b in range(4):
            want = rank4_ops.push_front_plain(words, cum, d.entry_sizes, d.fixed, begin, end, size, torch.full_like(begin, b))
            require_equal(f"push4 {name} column {b} vs push_front as stored", (got[0][:, b], got[1][:, b]), want[:2])

    entry = torch.arange(n + 1, device=dev)
    for width in (0, 1, 2, 7, 191, 192, 193, 1000):
        end = (entry + width).clamp(max=n)
        for size in (0, 1, 24, 39, 40):  # below, at and above the entries' sizes: the kick on and off
            check(f"every entry, width {width}, size {size}", entry, end, torch.full_like(entry, size, dtype=torch.int32))
    B = 1003  # not a multiple of the block
    begin = torch.randint(0, n + 1, (B,), generator=g).to(dev)
    end = torch.randint(0, n + 1, (B,), generator=g).to(dev)  # about half reversed: invalid
    size = torch.randint(0, 45, (B,), generator=g).to(torch.int32).to(dev)
    check("random ends", begin, end, size)
    check("whole store", torch.zeros(5, dtype=torch.int64, device=dev), torch.full((5,), n, device=dev), torch.arange(5, dtype=torch.int32, device=dev))
    check("one range", begin[:1], begin[:1] + 1, size[:1])
    # a store whose last base's first child begins at n: fixed[3] + rank == n
    # needs every bit of prev[3] below `begin` set and fixed[3] = n - begin;
    # made up, so only the two push4 forms are compared
    nw = 7
    n2 = 32 * nw
    ones = torch.full((4, nw), -1, dtype=torch.int32, device=dev)
    blocks = rank4_ops.build_rank_blocks(ones, rank_cum_ops.rank_cum_plain(ones).to(torch.int64))
    sizes = torch.randint(1, 5, (n2,), generator=g).to(torch.int32).to(dev)
    begin = torch.arange(n2 + 1, device=dev)
    end = torch.full_like(begin, n2)
    for f3 in (0, 5, n2 - 1, n2):
        fixed = torch.tensor([0, 0, 0, f3, n2], device=dev)
        args = (blocks, sizes, fixed, begin, end, torch.full_like(begin, 2, dtype=torch.int32))
        got = rank4_ops.push4(*args)
        require_equal(f"push4 pushed begin up to n, fixed[3]={f3}", got, rank4_ops.push4_plain(*args))
    if not bool((got[0][:, 3] >= n2).any()):
        raise AssertionError("push4: the made-up store never pushed a begin to n")


def edge_checks(dev):
    """Small and ragged shapes: B not a multiple of the block, pos == 0,
    pos == n, pos == 32*nw, pos < 0, m == 0, m == depth, scan sizes around the
    multiples of the scan's tile, rank blocks that end inside the structure's
    last word group, buckets that are empty, single or hold every query."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    rank_cum_edges(dev, g)
    for nw in (1, 5, 6, 7, 193, 1000, 1023, 1024, 1025, 3000):
        words = random_words((4, nw), dev, g)
        cum = rank_cum_ops.rank_cum_plain(words).to(torch.int64)
        n = 32 * nw - 5
        pos = torch.cat([
            torch.randint(0, n + 1, (1003,), generator=g),
            torch.tensor([0, 1, 31, 32, 191, 192, n - 1, n, 32 * nw - 1, 32 * nw]).clamp(0, 32 * nw),
        ]).to(dev)
        want = rank4_ops.rank4_plain(words, cum, pos)
        # the rank-block table (nw that is and is not a multiple of the
        # block), with positions before the structure and past it as well
        blocks = rank4_ops.build_rank_blocks(words, cum)
        outside = torch.tensor([-1, -7, -(1 << 40), 32 * nw + 1, 32 * nw + 200, 1 << 40], device=dev)
        check_rank_blocks(f"nw={nw}", words, cum, blocks, torch.cat([pos, outside]))
        # rank4_tiled: a dense bucket (its tile staged in shared memory), a
        # sparse one (read in place), one query, and every query in one tile
        tiles = rank4_ops.build_rank4_tiles(words, cum)
        require_equal(f"rank4_tiled table nw={nw}", rank4_ops.rank4_tiled_plain(tiles, pos), want)
        middle = (pos >> 15) == 1  # the queries of the second tile, sent to the first: an empty tile
        for name, sel in (("dense", pos), ("sparse", pos[-40:].contiguous()), ("one", pos[-1:].contiguous()),
                          ("one tile", (pos % min(n + 1, 32 * 1024)).contiguous()),
                          ("empty tile", torch.where(middle, pos % 1000, pos))):
            require_equal(f"rank4_tiled {name} nw={nw}", rank4_ops.rank4_tiled(tiles, sel),
                          rank4_ops.rank4_plain(words, cum, sel))
            check_buckets(f"{name} nw={nw}", tiles, sel)
        chain_block_edges(dev, g, words, blocks, nw)
    sizes = torch.randint(1, 70000, (777,), generator=g).to(torch.int32).to(dev)
    idx = torch.randint(0, 777, (5, 201), generator=g).to(dev)
    require_equal("gather_sizes", rank4_ops.gather_sizes(sizes, idx), rank4_ops.gather_sizes_plain(sizes, idx))

    _, codes, lengths = make_workload(6000, 900, 30, 40)
    lengths = lengths.copy()
    lengths[::7] = 25
    ss = build_seqset(codes, lengths, device=dev)
    rng = np.random.default_rng(SEED)
    text = torch.from_numpy(rng.integers(0, 4, 6000, dtype=np.uint8)).to(dev)
    text[:3000] = torch.from_numpy(codes[:75].reshape(-1)).to(dev)
    d = ss.d
    check_rank_blocks("seqset", ss.prev_words, ss.prev_cum, d.rank_blocks, torch.arange(ss.n_entries + 1, device=dev))
    push4_edges(dev, g, ss)
    entry = torch.arange(ss.n_entries, device=dev)
    for b in range(4):  # the entry's bit, from the block's word slot and from the stored word
        stored = (ss.prev_words[b, entry >> 5].to(torch.int64) >> (entry & 31)) & 1
        require_equal(f"entry_has_front base {b}", d.entry_has_front(entry, torch.full_like(entry, b)), stored.to(torch.bool))
    # depths whose rows the kernel fetches 16 bytes at a time (16, 32, 48) and byte by byte (1, 17)
    for depth in (1, 16, 17, 32, 48):
        pos = torch.arange(0, 6000, 3, device=dev)[:1999]
        mixed = torch.randint(0, depth + 1, (pos.shape[0],), generator=g).to(torch.int32).to(dev)
        mixed[:5] = 0
        mixed[5:10] = depth
        win = probes._window_bases(text, pos, depth)
        for name, m in (("mixed m", mixed), ("m == depth", torch.full_like(mixed, depth)), ("m == 0", torch.zeros_like(mixed))):
            args = (d.rank_blocks, d.entry_sizes, d.fixed, win, m, depth)
            require_equal(f"chain_window depth={depth} {name}", rank4_ops.chain_window(*args), rank4_ops.chain_window_plain(*args))
    got = rank4_ops.chain_fixed(d.rank_blocks, d.entry_sizes, d.fixed, text, 17)
    want = probes.find_window(d, text, torch.arange(6000, device=dev), 17, 17)
    keep = torch.arange(6000, device=dev) >= 16
    require_equal("chain_fixed", tuple(x[keep] for x in got), tuple(x[keep] for x in want))
    torch.cuda.synchronize()


def chain_sectors(d, win, m, depth):
    """What one chain_window call asks of the memory system, counted by
    replaying its steps with tensor code: (steps, sectors, sectors as
    stored).  A live step asks for one 32-byte sector of the rank-block
    table for ``begin``, one more when ``end`` lies in another block, and one
    of entry_sizes when the pushed range is not empty; against the structure
    as stored the two ranks ask for four (a word and a count each)."""
    blocks, n = d.rank_blocks, d.n_entries
    last_word = blocks.shape[0] * rank4_ops.BLOCK_WORDS - 1
    begin, end, size = probes._start(d, win.shape[0])
    steps = sectors = stored = 0
    for s in range(depth):
        live = (s >= depth - m) & (begin < end)
        dead = (s >= depth - m) & (begin >= end)
        kb = (begin >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS
        ke = (end >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS
        b = win[:, s].to(torch.int64)
        nb = d.fixed[b] + rank4_ops.rank_blocks_plain(blocks, b, begin)
        ne = d.fixed[b] + rank4_ops.rank_blocks_plain(blocks, b, end)
        reads_size = live & (nb < ne)
        kick = reads_size & (d.entry_sizes[nb.clamp(0, n - 1)] < size + 1)
        steps += int(live.sum())
        sectors += int(live.sum()) + int((live & (ke != kb)).sum()) + int(reads_size.sum())
        stored += 4 * int(live.sum()) + int(reads_size.sum())
        begin = torch.where(live, nb + kick, begin)
        end = torch.where(live, ne, torch.where(dead, begin, end))
        size = torch.where(live, size + 1, size)
    return steps, sectors, stored, (begin, end, size)


# One 32-byte sector: what a random read of 4 or 8 bytes moves.
SECTOR = 32


def kernel_table(ss, launches, find_ranges, probe_text, probe_pos, probe_m, probe_m_mixed, coverage_slab, breakdown=False):
    """Each kernel at the main path's shapes: equality with the plain
    version, times, and the least time the card could take.  ``ms``,
    ``plain_ms`` and ``library_ms`` are device times (calls queued behind a
    stall); ``call_ms`` is the kernel wrapper's time per call as a caller
    issuing it in a loop sees it, host cost included.  coverage_slab: (text,
    depth) of the slab of scored rows that scored_checks ran through
    chain_fixed."""
    rows = []
    d = ss.d
    dev = d.device
    stall = make_stall(dev)

    def row(name, kernel, plain, bytes_moved, operations, library=None, plain_reps=3):
        got, want = kernel(), plain()
        err = require_equal(name, got, want)
        bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
        ops_ms = operations / PEAK_OPS_PER_S * 1e3
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"biograph_tpu_torch/csrc/{SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": err,
            "ms": event_ms(kernel, 20, stall=stall),
            "call_ms": event_ms(kernel, 20),
            "plain_ms": event_ms(plain, plain_reps, warm=1, stall=stall),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": event_ms(library, 20, stall=stall) if library else None,
        })
        return rows[-1]

    # the structure as stored, brought to the card as the oracle of the table's forms
    words, cum = ss.prev_words.to(dev), ss.prev_cum.to(dev)
    nw = words.shape[1]
    n = d.n_entries
    blocks = d.rank_blocks
    blocks_bytes = blocks.numel() * 4

    # rank4 as push4 calls it: both ends of every find range, stacked, against
    # the rank-block table.  A query asks for four sectors of the table, a
    # quarter of one for its position and half of one for its result.
    pos = torch.cat([find_ranges.begin, find_ranges.end]).contiguous()
    B = pos.shape[0]
    require_equal("rank4 vs the structure as stored", rank4_ops.rank4(blocks, pos), rank4_ops.rank4_plain(words, cum, pos))
    r = row(
        "rank4",
        lambda: rank4_ops.rank4(blocks, pos),
        lambda: rank4_ops.rank4_blocks_plain(blocks, pos),
        B * 8 + B * 16 + min(B * 4 * SECTOR, blocks_bytes),
        B * 24,
    )
    r["sectors"] = B * 4 + B * (8 + 16) // SECTOR
    r["sectors_per_s"] = r["sectors"] / r["ms"] * 1e3

    # rank as find's push_front calls it: one base a query, both ends of each
    # range in one launch (two sectors, or one when they share a block)
    b = torch.randint(0, 4, find_ranges.begin.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED + 3))
    ends = (find_ranges.begin.contiguous(), find_ranges.end.contiguous())
    require_equal("rank vs the structure as stored", rank4_ops.rank(blocks, b, *ends),
                  tuple(rank4_ops.rank_plain(words, cum, b, p) for p in ends))
    row(
        "rank",
        lambda: rank4_ops.rank(blocks, b, *ends),
        lambda: tuple(rank4_ops.rank_blocks_plain(blocks, b, p) for p in ends),
        B // 2 * (8 + 16 + 16) + min(B * SECTOR, blocks_bytes),
        B * 6,
    )

    # rank4_tiled as a bulk caller calls it: the same positions against the
    # tiled table; the time is the whole call (the bucketing kernels and the
    # rank kernel, one C call), prologue_ms the bucketing kernels alone and
    # plain_prologue_ms their plain version (a sort, two searches, a scan)
    tiles = rank4_ops.build_rank4_tiles(words, cum)
    table_bytes = tiles.words.numel() * 4 + tiles.rel.numel() * 2 + tiles.base.numel() * 8
    check_buckets("main path", tiles, pos)

    def plain_prologue():
        return pos[rank4_ops.tile_buckets(rank4_ops.tile_of(tiles, pos), tiles.base.shape[0])[0]]

    row(
        "rank4_tiled",
        lambda: rank4_ops.rank4_tiled(tiles, pos),
        lambda: rank4_ops.rank4_tiled_plain(tiles, pos),
        B * 8 + B * 16 + min(B * 24, table_bytes),
        B * 28,
    )
    rows[-1]["prologue_ms"] = event_ms(lambda: rank4_ops.tile_buckets_kernel(tiles, pos), 20, stall=stall)
    rows[-1]["plain_prologue_ms"] = event_ms(plain_prologue, 20, stall=stall)
    if breakdown:
        rows[-1]["kernels_us"] = kernels_us(lambda: rank4_ops.rank4_tiled(tiles, pos))
    require_equal("rank4_tiled vs rank4", rank4_ops.rank4_tiled(tiles, pos), rank4_ops.rank4(blocks, pos))

    # gather_sizes as push4 calls it: the [B/2, 4] pushed begins.  The byte
    # bound counts 4 bytes a gathered size; a read of 4 bytes at a random
    # place moves a whole sector, so beside it stand the sectors the call asks
    # for (one an index, plus the indices read and the sizes written), the
    # distinct sectors of entry_sizes among them, and two floors: those
    # sectors' bytes at the device-memory rate, and, since entry_sizes sits in
    # L2, the sectors over the rate at which chain_window below is served them.
    nb4, _ = d.push4(find_ranges)
    idx = nb4.clamp(max=n - 1).contiguous()
    gather = row(
        "gather_sizes",
        lambda: rank4_ops.gather_sizes(d.entry_sizes, idx),
        lambda: rank4_ops.gather_sizes_plain(d.entry_sizes, idx),
        idx.numel() * (8 + 4) + min(idx.numel() * 4, n * 4),
        idx.numel() * 2,
        library=lambda: torch.index_select(d.entry_sizes, 0, idx.reshape(-1)),
        plain_reps=20,
    )
    gather["sectors"] = idx.numel() + idx.numel() * (8 + 4) // SECTOR
    gather["distinct_sectors_gathered"] = int(torch.unique(idx >> 3).numel())
    gather["sector_bytes_ms"] = gather["sectors"] * SECTOR / PEAK_BYTES_PER_S * 1e3

    # push4 as the main path calls it: the children of every find range.  A
    # range asks for the 128-byte line of begin's four blocks, another when end
    # lies in another block, its 20 bytes of input and 64 of output, and one
    # sector of entry_sizes for every child that is not empty.  Beside it,
    # unfused_ms: the form push4 had before this kernel (the rank4 and
    # gather_sizes kernels and tensor code around them), on the same ranges.
    r = SeqsetRanges(find_ranges.begin.contiguous(), find_ranges.end.contiguous(), find_ranges.size.contiguous())
    R = r.begin.shape[0]
    p4 = (blocks, d.entry_sizes, d.fixed, r.begin, r.end, r.size)
    require_equal("push4 vs its unfused form", rank4_ops.push4(*p4), push4_unfused(d, r))
    valid = r.begin < r.end
    last_word = blocks.shape[0] * rank4_ops.BLOCK_WORDS - 1
    two_lines = valid & ((r.begin >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS != (r.end >> 5).clamp(max=last_word) // rank4_ops.BLOCK_WORDS)
    r4 = rank4_ops.rank4(blocks, torch.cat([r.begin, r.end])).to(torch.int64)
    gathered = int((valid[:, None] & (r4[:R] < r4[R:])).sum())  # children not empty before the kick
    lines = int(valid.sum()) + int(two_lines.sum())
    fused = row(
        "push4",
        lambda: rank4_ops.push4(*p4),
        lambda: rank4_ops.push4_plain(*p4),
        R * (8 + 8 + 4) + R * 64 + min(lines * 4 * SECTOR, blocks_bytes) + min(gathered * 4, n * 4) + 40,
        2 * R * 24 + R * 16,
    )
    fused["sectors"] = lines * 4 + gathered + R * (20 + 64) // SECTOR
    fused["sectors_per_s"] = fused["sectors"] / fused["ms"] * 1e3
    fused["children_not_empty"] = gathered
    fused["unfused_ms"] = event_ms(lambda: push4_unfused(d, r), 20, stall=stall)
    fused["unfused_call_ms"] = event_ms(lambda: push4_unfused(d, r), 20)
    if breakdown:
        fused["unfused_kernels_us"] = kernels_us(lambda: push4_unfused(d, r))
    # and at the widths the beam wavefront calls it, where the time is the launch's
    fused["ms_by_ranges"] = {
        str(k): event_ms(lambda: rank4_ops.push4(*p4[:3], r.begin[:k], r.end[:k], r.size[:k]), 20, stall=stall)
        for k in (512, 4096, 32768)
    }
    fused["call_ms_by_ranges"] = {
        str(k): event_ms(lambda: rank4_ops.push4(*p4[:3], r.begin[:k], r.end[:k], r.size[:k]), 20)
        for k in (512, 4096, 32768)
    }
    fused["unfused_call_ms_by_ranges"] = {
        str(k): event_ms(lambda: push4_unfused(d, SeqsetRanges(r.begin[:k], r.end[:k], r.size[:k])), 20)
        for k in (512, 4096, 32768)
    }

    # chain_window as a probe_exact round calls it, twice: every lane at
    # full depth, and the per-lane lengths the bisection's third round tests.
    # The byte bound counts each input once (rows, lengths, the block table,
    # the sizes touched) and the outputs.  The operation bound counts the
    # steps this run's data needs (every push of a lane whose range was not
    # empty, the one that empties it included: the sum of the sizes that
    # come back) at CHAIN_OPS_PER_STEP integer operations: what a push_front
    # step needs by its definition, whatever the layout.
    # Beside it: the sectors this run's steps ask for, which is what the
    # kernel's time follows while everything sits in L2.
    win = probes._window_bases(probe_text, probe_pos, DEPTH)
    P = probe_pos.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    check_rank_blocks("main path", words, cum, blocks, torch.randint(0, 32 * nw + 1, (1 << 20,), device=dev, generator=g))
    for case, m in (("m == depth", probe_m), ("mixed m: round 3 of probe_exact", probe_m_mixed)):
        args = (d.rank_blocks, d.entry_sizes, d.fixed, win, m, DEPTH)
        steps, sectors, stored, replayed = chain_sectors(d, win, m, DEPTH)
        got = rank4_ops.chain_window(*args)
        require_equal(f"chain_window replay, {case}", got, replayed)
        if steps != int(got[2].sum()):
            raise AssertionError(f"chain_window {case}: the replay's steps are not the pushes the kernel counted")
        row(
            "chain_window",
            lambda: rank4_ops.chain_window(*args),
            lambda: rank4_ops.chain_window_plain(*args),
            P * DEPTH + P * 4 + P * 20 + blocks_bytes + min(steps * 4, n * 4) + 40,
            steps * CHAIN_OPS_PER_STEP,
            plain_reps=2,
        )
        ms = rows[-1]["ms"]
        rows[-1].update({
            "case": case,
            "steps": steps,
            "sectors": sectors,
            "sectors_per_step": sectors / max(steps, 1),
            "sectors_as_stored": stored,
            "sectors_per_s": sectors / ms * 1e3,
            "sector_bytes_per_s": sectors * 32 / ms * 1e3,
            "mean_m": float(m.to(torch.float64).mean()),
            # the same call on the first 1/16 and 1/4 of the lanes: time that
            # follows the lanes is throughput, time that does not is latency
            "ms_by_lanes": {
                str(k): event_ms(lambda: rank4_ops.chain_window(*args[:3], win[:k], m[:k], DEPTH), 20, stall=stall)
                for k in (P // 16, P // 4, P)
            },
        })

    # chain_fixed as coverage's uniform route without the hash calls it: the
    # depth-long window ending at every position of a slab of scored rows
    # (the window rows built inside the call).  The byte bound counts the
    # text, the outputs, the block table and the sizes touched; the
    # operations, this run's pushes (the sum of the sizes that come back) at
    # CHAIN_OPS_PER_STEP.
    cov_text, cov_depth = coverage_slab
    PC = cov_text.shape[0]
    cov_m = torch.full((PC,), cov_depth, dtype=torch.int32, device=dev)
    cov_steps = int(rank4_ops.chain_fixed(blocks, d.entry_sizes, d.fixed, cov_text, cov_depth)[2].to(torch.int64).sum())
    row(
        "chain_fixed",
        lambda: rank4_ops.chain_fixed(blocks, d.entry_sizes, d.fixed, cov_text, cov_depth),
        lambda: rank4_ops.chain_window_plain(blocks, d.entry_sizes, d.fixed, rank4_ops.contig_windows(cov_text, cov_depth), cov_m, cov_depth),
        PC + PC * 20 + blocks_bytes + min(cov_steps * 4, n * 4) + 40,
        cov_steps * CHAIN_OPS_PER_STEP,
        plain_reps=2,
    )
    rows[-1].update(
        lanes=PC, depth=cov_depth, steps=cov_steps, launches_counted_in="scored_checks",
        windows_ms=event_ms(lambda: rank4_ops.contig_windows(cov_text, cov_depth), 20, stall=stall),
    )

    # the sector floor of gather_sizes in L2, at the rate this run's
    # chain_window (m == depth) is served its sectors
    l2_sectors_per_s = next(r["sectors_per_s"] for r in rows if r["name"] == "chain_window")
    gather["sector_floor_ms"] = gather["sectors"] / l2_sectors_per_s * 1e3

    # rank_cum as the build calls it: the four base rows in one launch
    row(
        "rank_cum",
        lambda: rank_cum_ops.rank_cum(words),
        lambda: rank_cum_ops.rank_cum_plain(words),
        4 * nw * 8,
        4 * nw * 16,
        plain_reps=20,
    )
    rows[-1]["one_row_ms"] = event_ms(lambda: rank_cum_ops.rank_cum(words[0]), 20, stall=stall)
    if breakdown:  # the scan kernel and the memset of its descriptors, apart
        rows[-1]["kernels_us"] = kernels_us(lambda: rank_cum_ops.rank_cum(words))
    return rows


def bisection_lengths(d, text, pos, seg_lo, depth, round_no):
    """The per-lane window lengths that round ``round_no`` (from 1) of
    probe_exact's bisection hands to chain_window."""
    win = probes._window_bases(text, pos, depth)
    lo_m, hi_m = probes._bracket(pos, seg_lo, depth, 0)
    best = probes._start(d, pos.shape[0])
    for _ in range(round_no - 1):
        mid = probes._exact_mid(lo_m, hi_m)
        lo_m, hi_m, *best = probes._exact_round(lo_m, hi_m, mid, *best, *probes._chain(d, win, mid, depth))
    return probes._exact_mid(lo_m, hi_m).to(torch.int32).contiguous()


def rank_past_l2(dev, stall, breakdown=False):
    """rank4, rank and rank4_tiled side by side on a random rank structure
    that outgrows the L2 cache, at uniformly random positions: equality with
    the plain versions, and device time per call; with ``breakdown`` also the
    time of each kernel inside a rank4_tiled call.  The structure's counts
    come from one rank_cum call on its four rows of 2^24 words."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    words = torch.randint(-(1 << 31), 1 << 31, (4, BIG_NW), dtype=torch.int32, device=dev, generator=g)
    cum32 = rank_cum_ops.rank_cum(words)
    require_equal("rank_cum past L2", cum32, rank_cum_ops.rank_cum_plain(words))
    copy_to = torch.empty_like(words)
    times = {
        "rank_cum_ms": event_ms(lambda: rank_cum_ops.rank_cum(words), 10, stall=stall),
        "rank_cum_one_row_ms": event_ms(lambda: rank_cum_ops.rank_cum(words[0]), 10, stall=stall),
        "rank_cum_bound_ms": words.numel() * 8 / PEAK_BYTES_PER_S * 1e3,
        "rank_cum_plain_ms": event_ms(lambda: rank_cum_ops.rank_cum_plain(words), 3, warm=1, stall=stall),
        # a yardstick: one copy of as many bytes in and out
        "copy_same_bytes_ms": event_ms(lambda: copy_to.copy_(words), 10, stall=stall),
    }
    del copy_to
    cum = cum32.to(torch.int64)
    del cum32
    tiles = rank4_ops.build_rank4_tiles(words, cum)
    blocks = rank4_ops.build_rank_blocks(words, cum)
    pos = torch.randint(0, 32 * BIG_NW + 1, (BIG_QUERIES,), device=dev, generator=g)
    want = check_rank_blocks("past L2", words, cum, blocks, pos)
    require_equal("rank4_tiled past L2", rank4_ops.rank4_tiled(tiles, pos), want)
    check_buckets("past L2", tiles, pos)
    pos_sorted = pos.sort().values
    require_equal("rank4 past L2, sorted positions", rank4_ops.rank4(blocks, pos_sorted), rank4_ops.rank4_plain(words, cum, pos_sorted))
    # many tiles: warps whose queries all share a tile, and warps where half do
    check_buckets("past L2, sorted", tiles, pos_sorted)
    half = BIG_QUERIES // 2
    check_buckets("past L2, every other sorted", tiles, torch.stack([pos_sorted[:half], pos[:half]], dim=1).reshape(-1))
    # few tiles, thousands of blocks each: the block map filled by whole warps
    pos_one_tile = pos % (32 * rank4_ops.TILE_W)
    for name, sel in (("one tile", pos_one_tile), ("three tiles", pos % (3 * 32 * rank4_ops.TILE_W))):
        check_buckets(f"past L2, {name}", tiles, sel)
        require_equal(f"rank4_tiled past L2, {name}", rank4_ops.rank4_tiled(tiles, sel), rank4_ops.rank4_plain(words, cum, sel))
    split = {
        "rank4_tiled_kernels_us": kernels_us(lambda: rank4_ops.rank4_tiled(tiles, pos)),
        "rank4_tiled_sorted_positions_kernels_us": kernels_us(lambda: rank4_ops.rank4_tiled(tiles, pos_sorted)),
    } if breakdown else {}
    b = pos & 3
    ends = (pos[:half].contiguous(), pos[half:].contiguous())
    return {
        **split,
        **times,
        "words_per_base": BIG_NW,
        "positions": BIG_QUERIES,
        "structure_bytes": words.numel() * 4 + cum.numel() * 8,
        "table_bytes": tiles.words.numel() * 4 + tiles.rel.numel() * 2 + tiles.base.numel() * 8,
        "rank_blocks_bytes": blocks.numel() * 4,
        "tiles": tiles.base.shape[0],
        "rank4_tiled_buckets_ms": event_ms(lambda: rank4_ops.tile_buckets_kernel(tiles, pos), 10, stall=stall),
        "rank4_ms": event_ms(lambda: rank4_ops.rank4(blocks, pos), 10, stall=stall),
        "rank4_tiled_ms": event_ms(lambda: rank4_ops.rank4_tiled(tiles, pos), 10, stall=stall),
        "rank4_sorted_positions_ms": event_ms(lambda: rank4_ops.rank4(blocks, pos_sorted), 10, stall=stall),
        "rank4_tiled_sorted_positions_ms": event_ms(lambda: rank4_ops.rank4_tiled(tiles, pos_sorted), 10, stall=stall),
        "rank4_tiled_one_tile_ms": event_ms(lambda: rank4_ops.rank4_tiled(tiles, pos_one_tile), 10, stall=stall),
        "rank4_tiled_one_tile_buckets_ms": event_ms(lambda: rank4_ops.tile_buckets_kernel(tiles, pos_one_tile), 10, stall=stall),
        "rank_one_position_ms": event_ms(lambda: rank4_ops.rank(blocks, b, pos), 10, stall=stall),
        "rank_both_ends_ms": event_ms(lambda: rank4_ops.rank(blocks, b[:half].contiguous(), *ends), 10, stall=stall),
        "plain_ms": event_ms(lambda: rank4_ops.rank4_blocks_plain(blocks, pos), 3, warm=1, stall=stall),
    }


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def main_path(dev, genome, codes, lengths, depth=DEPTH):
    """reads -> seqset -> readmap -> save/load -> find -> rank4 ->
    rank4_tiled -> push4 -> sizes_at -> probe_exact.  Returns (stage stats, what the
    later checks need)."""
    R = codes.shape[0]
    stats = {}
    ss, stats["build_s"] = timed(lambda: build_seqset(codes, lengths, device=dev), "build")
    rm, stats["readmap_s"] = timed(lambda: build_readmap(ss, codes, lengths, device=dev), "readmap")

    def save_load():
        with tempfile.TemporaryDirectory() as tmp:
            ss.save(tmp + "/seqset.bgt")
            rm.save(tmp + "/readmap.bgt")
            ss2 = Seqset.load(tmp + "/seqset.bgt", device=dev)
            return ss2, Readmap.load(tmp + "/readmap.bgt", ss2, device=dev)

    (ss2, rm2), stats["save_load_s"] = timed(save_load)
    for name in ("fixed", "prev_words", "prev_cum", "entry_sizes", "shared", "pop_sel"):
        if not torch.equal(getattr(ss, name).cpu(), getattr(ss2, name).cpu()):
            raise AssertionError(f"seqset field {name} changed across save/load")
    del ss, rm
    # the query engine reads the rank structure through the rank-block table
    # alone, built here from the stored pair, which stays where load put it
    d, stats["rank_blocks_s"] = timed(lambda: ss2.d)
    d.rank4(torch.zeros(1, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    held = [ss2.fixed, ss2.entry_sizes, ss2.shared, ss2.pop_sel, d.rank_blocks]
    stats["memory"] = {
        "allocated_after_load_and_first_query_bytes": torch.cuda.memory_allocated() if dev.type == "cuda" else None,
        "seqset_on_device_bytes": sum(t.numel() * t.element_size() for t in held),
        "stored_pair_bytes": sum(t.numel() * t.element_size() for t in (ss2.prev_words, ss2.prev_cum)),
        "stored_pair_on": ss2.prev_words.device.type,
        "rank_blocks_bytes": d.rank_blocks.numel() * 4,
    }

    codes_dev = torch.from_numpy(codes).to(dev)
    lens_dev = torch.from_numpy(lengths).to(dev)
    from biograph_tpu_torch.core.dna import revcomp_codes

    oriented = torch.cat([codes_dev, revcomp_codes(codes_dev, lens_dev)])
    olens = torch.cat([lens_dev, lens_dev])
    found, stats["find_s"] = timed(lambda: d.find(oriented, olens), "find")
    if not bool(found.valid.all()):
        raise AssertionError(f"{int((~found.valid).sum())} of {2 * R} oriented reads not found")
    if not bool((found.size == olens).all()):
        raise AssertionError("find: a range's size differs from its read's length")
    # each read's range contains the seqset entry its readmap entry hangs on
    oriented_id = rm2.read_ids + (~rm2.is_forward).to(torch.int64) * R
    entry_of = torch.empty(2 * R, dtype=torch.int64, device=dev)
    entry_of[oriented_id] = rm2.entry_of_rm
    if not bool(((found.begin <= entry_of) & (entry_of < found.end)).all()):
        raise AssertionError("a read's find range does not contain its readmap entry")

    ranked, stats["rank4_s"] = timed(lambda: d.rank4(torch.cat([found.begin, found.end])), "rank4")
    # the same ranks as a bulk caller of rank4_tiled gets them: the tiled
    # table is that caller's to build, from the stored pair
    tiles, stats["rank4_tiles_s"] = timed(lambda: rank4_ops.build_rank4_tiles(ss2.prev_words.to(dev), ss2.prev_cum.to(dev)))
    stats["memory"]["rank4_tiles_bytes"] = tiles.words.numel() * 4 + tiles.rel.numel() * 2 + tiles.base.numel() * 8
    ranked_tiled, stats["rank4_tiled_s"] = timed(lambda: rank4_ops.rank4_tiled(tiles, torch.cat([found.begin, found.end])), "rank4_tiled")
    if not torch.equal(ranked_tiled, ranked):
        raise AssertionError("rank4_tiled differs from rank4 on the find ranges' ends")
    del tiles, ranked_tiled
    (nb4, ne4), stats["push4_s"] = timed(lambda: d.push4(found), "push4")
    # the children's first entries, through sizes_at (the gather_sizes kernel):
    # after the kick, a child that is not empty begins at an entry long enough
    # to hold the pushed base and the range's sequence
    child_sizes, stats["sizes_at_s"] = timed(lambda: d.sizes_at(nb4), "sizes_at")
    if not bool(((nb4 >= ne4) | (child_sizes > found.size[:, None])).all()):
        raise AssertionError("push4: a child begins at an entry shorter than its sequence")

    text = torch.from_numpy(np.concatenate([genome, (3 - genome)[::-1]])).to(dev)
    G = genome.shape[0]

    def probe_all():
        outs = []
        for p0 in range(0, 2 * G, PROBE_CHUNK):
            pos = torch.arange(p0, min(p0 + PROBE_CHUNK, 2 * G), device=dev)
            seg_lo = torch.where(pos >= G, G, 0)
            outs.append(probes.probe_exact_kernel(d, text, pos, seg_lo, depth))
        return tuple(torch.cat(x) for x in zip(*outs))

    probed, stats["probe_exact_s"] = timed(probe_all, "probe_exact")
    stats["probe_positions"] = 2 * G
    stats["n_entries"] = ss2.n_entries
    stats["reads"] = R
    stats["genome"] = G
    return stats, (ss2, rm2, found, ranked, (nb4, ne4), text, probed)


def check_results(dev, genome, codes, ss, found, ranked, pushed, text, probed, depth=DEPTH, sample=4096, host_sample=128):
    """Sampled lanes recomputed with the plain versions on the card, and an
    independent numpy/bytes check on the host."""
    d = ss.d
    G = genome.shape[0]
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    if int(d.fixed[4]) != ss.n_entries:
        raise AssertionError("fixed[4] != n_entries")
    if int(ss.entry_sizes.max()) != codes.shape[1] or ss.max_entry_len != codes.shape[1]:
        raise AssertionError("longest entry is not a whole read")

    # rank4 and push4 (kernels over the rank-block table) against the plain
    # versions over the structure as stored: column b == rank(b, .) at both
    # ends of the range, and == push_front(r, b); d.rank and d.push_front (the
    # rank kernel) against the same
    words, cum = ss.prev_words.to(dev), ss.prev_cum.to(dev)
    pick = torch.randint(0, found.begin.shape[0], (sample,), generator=g).to(dev)
    r = SeqsetRanges(found.begin[pick], found.end[pick], found.size[pick])
    B = found.begin.shape[0]
    for b in range(4):
        base = torch.full((sample,), b, device=dev)
        want_begin, want_end = (rank4_ops.rank_plain(words, cum, base, p) for p in (r.begin, r.end))
        if not (torch.equal(ranked[pick, b].to(torch.int64), want_begin) and torch.equal(ranked[B + pick, b].to(torch.int64), want_end)):
            raise AssertionError(f"rank4 column {b} differs from rank over the structure as stored")
        if not (torch.equal(d.rank(base, r.begin), want_begin) and torch.equal(d.rank(base, r.end), want_end)):
            raise AssertionError(f"rank of base {b} differs from rank over the structure as stored")
        want = rank4_ops.push_front_plain(words, cum, d.entry_sizes, d.fixed, r.begin, r.end, r.size, base)
        if not (torch.equal(pushed[0][pick, b], want[0]) and torch.equal(pushed[1][pick, b], want[1])):
            raise AssertionError(f"push4 column {b} differs from push_front over the structure as stored")
        if not all(torch.equal(x, y) for x, y in zip(d.push_front(r, base), want)):
            raise AssertionError(f"push_front of base {b} differs from push_front over the structure as stored")

    # probe_exact through chain_window == the loop of push_front steps
    pos = torch.randint(0, 2 * G, (sample,), generator=g).to(dev)
    seg_lo = torch.where(pos >= G, G, 0)
    want = probes.probe_exact(d, text, pos, seg_lo, depth)
    for got_x, want_x in zip(probed, want):
        if not torch.equal(got_x[pos], want_x):
            raise AssertionError("probe_exact: the chain_window path differs from the push_front loop")

    # host: a window reported present is a substring of some read or its
    # reverse complement, and one base longer (still inside the search
    # bracket, whose upper end is exclusive) is not
    both = np.concatenate([codes, (3 - codes)[:, ::-1]])
    sep = np.full((both.shape[0], 1), 255, np.uint8)
    haystack = np.concatenate([both, sep], axis=1).tobytes()
    text_h = text.cpu().numpy()
    pos_h = pos[:host_sample].cpu().numpy()
    size_h = probed[2][pos[:host_sample]].cpu().numpy()
    valid_h = (probed[0] < probed[1])[pos[:host_sample]].cpu().numpy()
    for p, s, ok in zip(pos_h, size_h, valid_h):
        lo = G if p >= G else 0
        if s > 0 and not ok:
            raise AssertionError("probe_exact: nonempty window with an empty range")
        if s > 0 and haystack.find(text_h[p - s + 1 : p + 1].tobytes()) < 0:
            raise AssertionError(f"window of {s} bases ending at {p} reported present but is in no read")
        if s + 1 < min(depth, p - lo + 1) and haystack.find(text_h[p - s : p + 1].tobytes()) >= 0:
            raise AssertionError(f"window ending at {p}: {s + 1} bases exist but {s} was reported longest")
    return {"sampled_lanes": sample, "host_checked_windows": int(len(pos_h))}


# ---------------------------------------------------------------------------
# discovery: from the read store to records
# ---------------------------------------------------------------------------

DISCOVER_KERNELS = ("push4", "rank", "chain_window")
DISCOVER_OPT = dict(min_alt_support=5)
REGION = (0, 32768)  # held against the plain versions on a CPU copy of the store
MIN_READS_OVER_SNP = 5
# the least share of the well-covered planted SNPs that discovery must find
MIN_SNP_SHARE = 0.99


def run_discover(ss, reference, stage=None, **kw):
    """One discover_variants call with every kernel's count set to 0 just
    before it and read just after: (records, stats, seconds, launches)."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    for fn in WRAPPERS.values():
        fn.launches = 0
    stats = {}
    records, seconds = timed(lambda: disc.discover_variants(ss, reference, opt=opt, stats=stats, **kw), stage)
    return records, stats, seconds, {name: fn.launches for name, fn in WRAPPERS.items()}


def discover_phase(ss, reference):
    """discover_variants over the whole genome on the card, cold (the
    prescreen bitmap and the trunc tables are built and cached on the
    seqset) and warm.  Fails if a kernel of the path was launched no time."""
    out = {}
    for run in ("cold", "warm"):
        records, stats, seconds, launches = run_discover(ss, reference)
        missing = [name for name in DISCOVER_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"discovery launched no {missing} kernel")
        out[run] = {
            "seconds": seconds,
            "stage_s": stats["stage_s"],
            "launches": launches,
        }
    out.update(
        records=len(records),
        prescreen_probed=stats["prescreen_probed"],
        anchors_found=stats["anchors_found"],
        anchors_truncated=stats["anchors_truncated"],
        assemblies_truncated=stats["assemblies_truncated"],
        beam_steps=stats.get("wave_steps", 0),
        compactions=stats.get("wave_compactions", 0),
        branch_retry_rescued=stats.get("branch_retry_rescued", 0),
        memory_plan=stats["memory_plan"],
    )
    return records, out


def key_of(r):
    return (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"], r["ref_support"])


def discover_checks(dev, ss, ss_cpu, reference, genome, records, snp, donor, starts, read_len, min_share=MIN_SNP_SHARE):
    """(a) every record's ref allele is the genome's at its position; (b) the
    planted SNPs that at least MIN_READS_OVER_SNP reads cover together with
    min_anchor_ctx bases before and rejoin_k + 1 after are found, at
    ``min_share`` of them or more; (c) over REGION the card and ss_cpu, a CPU
    copy of the store (every kernel's plain version), give identical
    records."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    G = genome.shape[0]
    code_of = {c: i for i, c in enumerate("ACGT")}
    for r in records:
        want = genome[r["pos"] - 1 : r["pos"] - 1 + len(r["ref"])]
        if [code_of[c] for c in r["ref"]] != want.tolist():
            raise AssertionError(f"record at {r['pos']}: ref allele {r['ref']} is not the genome's")
    # reads that hold [p - min_anchor_ctx, p + rejoin_k + 1]
    before, after = opt.min_anchor_ctx, opt.rejoin_k + 1
    sorted_starts = np.sort(starts)
    over = np.searchsorted(sorted_starts, snp - before, side="right") - np.searchsorted(sorted_starts, snp + after - read_len + 1, side="left")
    covered = over >= MIN_READS_OVER_SNP
    called = {(r["pos"] - 1, r["ref"], r["alt"]) for r in records}
    found = np.array([(int(p), "ACGT"[genome[p]], "ACGT"[donor[p]]) in called for p in snp])
    share = float(found[covered].mean())
    result = {
        "planted": int(len(snp)), "well_covered": int(covered.sum()), "found_of_well_covered": int(found[covered].sum()),
        "share": share, "missed": int((covered & ~found).sum()), "found_of_all": int(found.sum()),
    }
    if share < min_share:
        raise AssertionError(f"discovery found {share:.4f} of the well-covered planted SNPs, under {min_share}: {result}")
    # (c) the same region on the card and on a CPU copy of the store
    on_card, _, result["region_card_s"], launches = run_discover(ss, reference, region=REGION)
    on_cpu = disc.discover_variants(ss_cpu, reference, region=REGION, opt=opt)
    if not on_card or list(map(key_of, on_card)) != list(map(key_of, on_cpu)):
        raise AssertionError(f"discovery over {REGION}: {len(on_card)} records on the card, {len(on_cpu)} on the CPU copy, or they differ")
    result.update(region=list(REGION), region_records=len(on_card), region_launches=launches)
    return result


class HeldEngine:
    """A seqset's query engine whose push4 and push_front hold the kernel
    under them against its plain version on the very tensors the caller
    hands in, at every call; everything else is the engine's own.  ``held``
    counts the calls by kernel and lane count."""

    def __init__(self, d):
        self._d = d
        self.held = {"push4": {}, "rank": {}}

    def __getattr__(self, name):
        return getattr(self._d, name)

    def _count(self, kernel, lanes):
        self.held[kernel][lanes] = self.held[kernel].get(lanes, 0) + 1

    def push4(self, r):
        d = self._d
        got = d.push4(r)
        require_equal(
            f"push4 in discovery, {r.begin.shape[0]} lanes", got,
            rank4_ops.push4_plain(d.rank_blocks, d.entry_sizes, d.fixed, r.begin, r.end, r.size),
        )
        self._count("push4", r.begin.shape[0])
        return got

    def push_front(self, r, b):
        d = self._d
        b = b.to(torch.int64).contiguous()
        require_equal(
            f"rank in discovery, {b.shape[0]} lanes",
            rank4_ops.rank(d.rank_blocks, b, r.begin.contiguous(), r.end.contiguous()),
            (rank4_ops.rank_blocks_plain(d.rank_blocks, b, r.begin), rank4_ops.rank_blocks_plain(d.rank_blocks, b, r.end)),
        )
        self._count("rank", b.shape[0])
        return d.push_front(r, b)


def discover_kernel_holds(ss, reference, anchors_found=None):
    """Every kernel of the discovery path against its plain version on the
    inputs discovery gives it.  The whole-genome call is replayed stage by
    stage through the package's own functions: the filter and every bisection
    round hold chain_window at depth probe_ctx over all candidate lanes; the
    anchor scan holds push4 on those lanes; the first beam group of each
    orientation, seeded and driven to its end, holds rank on the seed and
    push4 at every beam step, at the full and at every compacted width."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    d, dev = ss.d, ss.device
    held = HeldEngine(d)
    G = len(reference.flat)
    ref2_dev = torch.from_numpy(np.concatenate([reference.flat, (3 - reference.flat[::-1]).astype(np.uint8)])).to(dev)
    stats = {}
    hit_pos, pos, cap, ctx = disc._candidate_lanes(ss, ref2_dev, disc._segments(opt, 0, G, G), opt, stats)
    win = probes._window_bases(ref2_dev, pos, opt.probe_ctx)
    chains = []

    def find(m):
        args = (d.rank_blocks, d.entry_sizes, d.fixed, win, m.to(torch.int32).contiguous(), opt.probe_ctx)
        got = rank4_ops.chain_window(*args)
        require_equal(f"chain_window in discovery, chain {len(chains)}", got, rank4_ops.chain_window_plain(*args))
        chains.append(float(m.float().mean()) if m.numel() else 0.0)
        return got

    seed = find(torch.full_like(pos, opt.min_anchor_ctx, dtype=torch.int32))
    b2, e2, s2 = probes._probe_exact(d, pos, ctx, opt.probe_ctx, opt.min_anchor_ctx, seed, find)
    n_raw, stacked = disc._anchor_scan_at(held, ref2_dev, pos, b2, e2, s2, opt.min_anchor_ctx, opt.min_branch_width, cap)
    if anchors_found is not None and n_raw != anchors_found:
        raise AssertionError(f"the replayed front end found {n_raw} anchors, discover_variants {anchors_found}")
    live = stacked.cpu().numpy()
    trunc = disc._trunc_tables(ss, opt.probe_ctx)
    for rev_half in (False, True):
        half = (live[0] >= G) == rev_half
        c = disc._asm_start(held, tuple(col[half][: disc.WAVE_LANES] for col in live), opt, 2 * G if rev_half else G, ref2_dev)
        if c is not None:
            disc._drive(held, c, trunc, stats)
    for kernel, calls in held.held.items():
        if not calls:
            raise AssertionError(f"the replayed discovery path never reached {kernel}")
    return {
        "lanes": int(pos.shape[0]), "anchors": n_raw, "chain_window_depth": opt.probe_ctx, "chain_window_mean_m": chains,
        "push4_calls_by_lanes": held.held["push4"], "rank_calls_by_lanes": held.held["rank"],
        "beam_steps": stats.get("wave_steps", 0), "compactions": stats.get("wave_compactions", 0),
    }


def small_genome_checks(dev):
    """What the scaled workload, SNPs only, does not reach on the card: an
    insertion, a deletion and a block substitution (a complex block, so the
    batched affine DP of ops/align_dp.py runs) on a 6000-base genome at 30x,
    discovered on the card and on a CPU copy of the store with identical
    records; and the aligner alone on block pairs full of score ties, the
    card's op lists against the CPU's."""
    from biograph_tpu_torch.ops.align_dp import align_blocks_batch

    rng = np.random.default_rng(SEED + 7)
    n = 6000
    ref = rng.integers(0, 4, n, dtype=np.uint8)
    block = (ref[[3300, 3303, 3306]] + 1) % 4  # three bases for seven, differing at both ends
    donor = np.concatenate([
        ref[:700], [(ref[700] + 1) % 4], ref[701:1501], rng.integers(0, 4, 5, dtype=np.uint8),
        ref[1501:2400], ref[2407:3300], block, ref[3307:],
    ]).astype(np.uint8)
    starts = rng.integers(0, len(donor) - 40, len(donor) * 30 // 40)
    codes = donor[starts[:, None] + np.arange(40)]
    half = len(starts) // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    ss = build_seqset(codes, np.full(len(starts), 40, np.int32), device=dev)
    reference = reference_from_numpy(ref, np.zeros(n, bool), [("chr1", 0, n)])
    on_card = disc.discover_variants(ss, reference)
    on_cpu = disc.discover_variants(ss.to("cpu"), reference)
    if list(map(key_of, on_card)) != list(map(key_of, on_cpu)):
        raise AssertionError(f"small genome: {len(on_card)} records on the card, {len(on_cpu)} on the CPU copy, or they differ")
    kinds = {len(r["alt"]) - len(r["ref"]) for r in on_card}
    in_block = [r for r in on_card if 3295 <= r["pos"] <= 3310]
    if not {0, 5, -7} <= kinds or not in_block:
        raise AssertionError(f"small genome: planted events not all found: length changes {sorted(kinds)}, {len(in_block)} records in the block")
    refs, alts = [], []
    for _ in range(64):  # homopolymer runs and their stretched or cut copies: a gap has many equally cheap places
        runs = [np.full(rng.integers(1, 9), rng.integers(0, 4), np.uint8) for _ in range(rng.integers(1, 12))]
        refs.append(np.concatenate(runs))
        alts.append(np.concatenate([np.resize(r, max(1, len(r) + rng.integers(-3, 4))) for r in runs if rng.random() > 0.15] or [runs[0]]))
    if align_blocks_batch(refs, alts, dev) != align_blocks_batch(refs, alts, "cpu"):
        raise AssertionError("align_blocks_batch: the card's op lists differ from the CPU's")
    return {"records": len(on_card), "records_in_the_block": len(in_block), "length_changes": sorted(kinds), "aligned_pairs": len(refs)}


def beam_step_profile(ss, reference, steps=8):
    """One beam group of the warm discovery, stepped by hand under
    torch.profiler: kernel launches and device microseconds a beam step, and
    the step's wall time."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    d, dev = ss.d, ss.device
    G = len(reference.flat)
    ref2_dev = torch.from_numpy(np.concatenate([reference.flat, (3 - reference.flat[::-1]).astype(np.uint8)])).to(dev)
    stats = {"anchors_found": 0, "anchors_truncated": 0}
    parts, _ = disc._find_anchors(ss, ref2_dev, disc._segments(opt, 0, G, G), opt, stats, disc._StageClock(dev, {}), G)
    anchors = tuple(c[: disc.WAVE_LANES] for c in parts[False])
    trunc = disc._trunc_tables(ss, opt.probe_ctx)
    c = disc._asm_start(d, anchors, opt, G, ref2_dev)

    def step():
        c["st"] = disc._wavefront_body(d, c["packed"], *trunc, c["n_packed"], c["st"], c["step"], c["MAXP"], c["k"], c["min_w"], c["probe_ctx"], c["pos_bits"])
        c["step"] += 1

    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _device_us(e)]
    kernels.sort(key=_device_us, reverse=True)
    return {
        "lanes": int(c["st"]["begin"].shape[0]),
        "launches_a_step": sum(e.count for e in kernels) / steps,
        "device_us_a_step": sum(_device_us(e) for e in kernels) / steps,
        "wall_us_a_step_under_the_profiler": seconds / steps * 1e6,
        "wall_us_a_step": event_ms(step, steps, warm=0) * 1e3,
        "top": [[e.key.split("(")[0][:60], e.count / steps, _device_us(e) / steps] for e in kernels[:6]],
    }


# ---------------------------------------------------------------------------
# discovery with the readmap: scoring, the pair gate, VCF
# ---------------------------------------------------------------------------

RECORDS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "torch_scaled_leg_records.tsv")


def read_records_file(path=RECORDS_FILE):
    """The JAX package's records of this workload with its readmap, on the
    CPU (the file's header names the command that made it): (chrom, pos,
    ref, alt, support, ref_support) tuples."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            chrom, pos, ref, alt, sup, rsup = line.rstrip("\n").split("\t")
            out.append((chrom, int(pos), ref, alt, int(sup), int(rsup)))
    return out


def require_records(name, records, want):
    """The records must be ``want``, the JAX CPU leg's, tuple for tuple; the
    first six of each difference are printed."""
    got = [key_of(r) for r in records]
    if got != want:
        lost, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        raise AssertionError(
            f"{name}: {len(got)} records, the JAX CPU leg {len(want)}; {len(lost)} of its records "
            f"missing (first {lost[:6]}), {len(extra)} not among them (first {extra[:6]})"
        )


def discover_scored_phase(ss, rm, reference, want, build_s, reads):
    """discover_variants with the readmap over the whole genome on the card,
    cold (the window hash index is built and cached on the readmap) and
    warm; its records must be the JAX CPU leg's.  The VCF of them is written
    and read back.  Fails if a kernel of the path was launched no time.
    Returns (records, the scored assemblies, what to print)."""
    out = {}
    for run in ("cold", "warm"):
        asms = []
        records, stats, seconds, launches = run_discover(ss, reference, readmap=rm, out_assemblies=asms)
        missing = [name for name in DISCOVER_KERNELS if launches[name] == 0]
        if missing:
            raise AssertionError(f"scored discovery launched no {missing} kernel")
        out[run] = {"seconds": seconds, "stage_s": stats["stage_s"], "launches": launches}
    require_records("scored discovery", records, want)
    with tempfile.TemporaryDirectory() as tmp:
        disc.write_discovery_vcf(tmp + "/scored.vcf", reference, records, opt=disc.DiscoverOptions(**DISCOVER_OPT))
        back = read_vcf(tmp + "/scored.vcf")
    by_site = {(r["chrom"], r["pos"], r["ref"], r["alt"]): r for r in records}
    for v in back:
        r = by_site[(v.chrom, v.pos, v.ref, v.alt)]
        if (int(v.info["SUP"]), int(v.info["RSUP"])) != (r["support"], r["ref_support"]):
            raise AssertionError(f"VCF record {v.chrom}:{v.pos} does not carry its record's support")
    if not back:
        raise AssertionError("no record passed the genotype filter into the VCF")
    out.update(
        records=len(records), want_records=len(want), pair_gated=stats.get("pair_gated", 0),
        assemblies_scored=len(asms), anchors_found=stats["anchors_found"],
        vcf_records_passing_genotype_filter=len(back), build_and_readmap_s=build_s,
        reads_per_s_build_and_warm_call=reads / (build_s + out["warm"]["seconds"]),
        reads_per_s_build_and_cold_call=reads / (build_s + out["cold"]["seconds"]),
    )
    return records, asms, out


def coverage_slab(rm, asms, ref):
    """The first slab of the coverage batch that scoring builds for asms:
    (q, ql, Lp) with as many rows as one slab of the coverage walk holds."""
    _, q, ql = disc._score_rows(ref, asms, rm.max_read_len + 2)
    Lp = max(64, -(-q.shape[1] // 64) * 64)
    rows = 1 << ((readmap_mod.SLAB_LANES // Lp).bit_length() - 1)
    return q[:rows], ql[:rows], Lp


def coverage_text(q, Lp):
    """The text the coverage walk hands its probes for these rows: each row
    padded to Lp bases, the row count to a power of two, flattened."""
    Bp = 1 << max((q.shape[0] - 1).bit_length(), 0)
    cp = np.zeros((Bp, Lp), np.uint8)
    cp[: q.shape[0], : q.shape[1]] = q
    return cp.reshape(-1)


def paired_library(rng, donor, n_pairs=1500, L=60, frag=260):
    """Mates at fragment 260, the second reverse-complemented: the library
    of tests/test_pair_gate.py, at 1500 pairs."""
    s = rng.integers(0, len(donor) - frag, n_pairs)
    first = donor[s[:, None] + np.arange(L)]
    second = (3 - donor[(s + frag - L)[:, None] + np.arange(L)])[:, ::-1]
    codes = np.stack([first, second], axis=1).reshape(2 * n_pairs, L).astype(np.uint8)
    mate = np.arange(2 * n_pairs)
    mate[0::2] += 1
    mate[1::2] -= 1
    return codes, np.full(2 * n_pairs, L, np.int32), mate


def card_and_cpu(name, ss, rm, rm_cpu, reference, opt, **kw):
    """discover_variants with the readmap on the card and on rm_cpu, a CPU
    copy of the store and the readmap: the same records and pair_gated, or
    fail.  Returns the card's (records, stats) and the scored, gated
    assemblies of both, card first."""
    runs = []
    for on_ss, on_rm in ((ss, rm), (rm_cpu.seqset, rm_cpu)):
        stats, asms = {}, []
        runs.append((disc.discover_variants(on_ss, reference, opt=opt, readmap=on_rm, stats=stats, out_assemblies=asms, **kw), stats, asms))
    (on_card, card_stats, card_asms), (on_cpu, cpu_stats, cpu_asms) = runs
    if list(map(key_of, on_card)) != list(map(key_of, on_cpu)):
        raise AssertionError(f"{name}: {len(on_card)} records on the card, {len(on_cpu)} on the CPU copy, or they differ")
    require_same_gate(name, card_stats, cpu_stats)
    return on_card, card_stats, (card_asms, cpu_asms)


def require_same_gate(name, card_stats, cpu_stats):
    if card_stats.get("pair_gated") != cpu_stats.get("pair_gated"):
        raise AssertionError(f"{name}: pair_gated {card_stats.get('pair_gated')} on the card, {cpu_stats.get('pair_gated')} on the CPU copy")


def region_check(ss, rm, rm_cpu, reference):
    """Over REGION, scored discovery on the card and on rm_cpu, a CPU copy of
    the store and the readmap, gives the same records, and some."""
    on_card, _, _ = card_and_cpu("scored discovery over REGION", ss, rm, rm_cpu, reference, disc.DiscoverOptions(**DISCOVER_OPT), region=REGION)
    if not on_card:
        raise AssertionError(f"scored discovery over {REGION}: no record")
    return len(on_card)


def chain_fixed_check(dev, ss, rm, reference, asms):
    """Coverage of a slab of the scored rows through the uniform route
    without the hash index launches chain_fixed, which is held against its
    plain version on the same windows, and gives the hash route's coverage.
    Returns (what to print, the slab as (text, depth))."""
    q, ql, Lp = coverage_slab(rm, asms, reference.flat)
    for fn in WRAPPERS.values():
        fn.launches = 0
    chained = rm._coverage_full(q, ql, 16, use_hash=False)
    launches = rank4_ops.chain_fixed.launches
    if launches == 0:
        raise AssertionError("coverage without the hash index launched no chain_fixed kernel")
    hashed = rm._coverage_full(q, ql, 16)
    require_equal("coverage through chain_fixed vs the hash route", tuple(chained), tuple(hashed))
    d = ss.d
    depth = min(ss.max_entry_len, Lp)
    text = torch.from_numpy(coverage_text(q, Lp)).to(dev)
    m = torch.full((text.shape[0],), depth, dtype=torch.int32, device=dev)
    require_equal(
        "chain_fixed on the scored slab",
        rank4_ops.chain_fixed(d.rank_blocks, d.entry_sizes, d.fixed, text, depth),
        rank4_ops.chain_window_plain(d.rank_blocks, d.entry_sizes, d.fixed, rank4_ops.contig_windows(text, depth), m, depth),
    )
    return {
        "rows": int(q.shape[0]), "lanes": int(text.shape[0]), "depth": depth, "launches": launches,
        "read_ends_counted": int(hashed[3].sum()),
    }, (text, depth)


def paired_check(dev, seed=SEED + 11, n_pairs=1500):
    """A 6000-base genome whose donor carries a novel 400-base insertion,
    read as pairs: discovered with its readmap (read placement and the pair
    gate) on the card and on a CPU copy with the same records; the
    insertion is kept, and culled on both by a gate that asks for more pairs
    than exist."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 6000, dtype=np.uint8)
    ins = rng.integers(0, 4, 400, dtype=np.uint8)
    codes, lens, mate = paired_library(rng, np.concatenate([genome[:3000], ins, genome[3000:]]), n_pairs)
    ss = build_seqset(codes, lens, device=dev)
    rm = build_readmap(ss, codes, lens, mate_of=mate, device=dev)
    reference = reference_from_numpy(genome, np.zeros(6000, bool), [("chr1", 0, 6000)])
    rm_cpu = rm.to("cpu")
    kept, kstats, (card_asms, cpu_asms) = card_and_cpu("paired library", ss, rm, rm_cpu, reference, disc.DiscoverOptions(min_alt_support=5, max_path=480))
    strict = disc.DiscoverOptions(min_alt_support=5, max_path=480, min_pair_evidence=10**6)
    cstats, cpu_cstats = {}, {}
    culled = disc.pair_gate_assemblies(rm, genome, card_asms, strict, cstats) + disc.pair_gate_assemblies(rm_cpu, genome, cpu_asms, strict, cpu_cstats)
    require_same_gate("paired library, strict gate", cstats, cpu_cstats)
    if [len(r["alt"]) - len(r["ref"]) for r in kept] != [400] or culled or not cstats.get("pair_gated"):
        raise AssertionError(f"paired library: the 400-base insertion not kept by the gate and culled by a strict one: {kept}, {culled}, {cstats}")
    return {
        "records": len(kept), "pair_gated": kstats.get("pair_gated", 0), "strict_gate_pair_gated": cstats["pair_gated"],
        "proper_pairs": int(len(rm.__dict__[("_ref_pair_spans", 1000)][0])),
    }


def mixed_lengths_check(dev, seed=SEED + 13, genome_len=6000, n_reads=1800):
    """Reads of 100 bases, about half trimmed by 1-20: coverage (both strands
    and the start/end events) of windows along the genome takes the general
    route (probe_ranges through rank, then chain_window), launches both
    kernels and equals that of a CPU copy of the store and the readmap."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    donor = genome.copy()
    snp = rng.choice(np.arange(200, genome_len - 200), 40, replace=False)
    donor[snp] = (donor[snp] + 1 + rng.integers(0, 3, 40)) % 4
    starts = rng.integers(0, genome_len - 100, n_reads)
    codes = donor[starts[:, None] + np.arange(100)]
    half = n_reads // 2
    codes[:half] = (3 - codes[:half])[:, ::-1]
    lens = np.full(n_reads, 100, np.int32)
    lens[1::2] -= rng.integers(1, 21, n_reads - half).astype(np.int32)
    codes = np.where(np.arange(100)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    ss = build_seqset(codes, lens, device=dev)
    rm = build_readmap(ss, codes, lens, device=dev)
    windows = np.stack([genome[i : i + 500] for i in range(0, genome_len - 500, 700)])  # 8 rows, no padding row
    wlens = np.full(len(windows), 500, np.int32)
    for fn in WRAPPERS.values():
        fn.launches = 0
    got = rm._coverage_full(windows, wlens)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    require_equal("coverage, general route, card vs CPU copy", tuple(x.cpu() for x in got), rm.to("cpu")._coverage_full(windows, wlens))
    if launches["rank"] == 0 or launches["chain_window"] == 0:
        raise AssertionError(f"coverage's general route launched {launches}: no rank or no chain_window")
    return {"read_lengths": [rm.min_read_len, rm.max_read_len], "windows": len(windows),
            "read_ends_counted": int(got[3].sum()), "coverage_launches": {k: v for k, v in launches.items() if v}}


def scored_checks(dev, ss, rm, rm_cpu, reference, asms):
    """The scored path's checks beyond the records: the region on a CPU copy,
    chain_fixed on coverage's path, a paired library and a library of mixed
    read lengths.  Returns (what to print, the chain_fixed slab as (text,
    depth), chain_fixed's launches)."""
    (chained, slab), chained["seconds"] = timed(lambda: chain_fixed_check(dev, ss, rm, reference, asms))
    region, region_s = timed(lambda: region_check(ss, rm, rm_cpu, reference))
    paired, paired["seconds"] = timed(lambda: paired_check(dev))
    mixed, mixed["seconds"] = timed(lambda: mixed_lengths_check(dev))
    result = {"region_records": region, "region_s": region_s, "chain_fixed": chained, "paired": paired, "mixed_lengths": mixed}
    return result, slab, chained["launches"]


# ---------------------------------------------------------------------------
# the dense front end, the wavefront without trunc tables, the widen family,
# the SDK
# ---------------------------------------------------------------------------

TINY_BUDGET_BYTES = 1 << 16  # a memory plan with no room for the trunc tables
WIDEN_SIZES = (25, 1)  # truncate_ranges targets: probe_ctx, and the longest walks
LT_QUERIES = 1 << 20


@contextlib.contextmanager
def discovery_constants(**values):
    """The discovery module's constants set as given, restored after."""
    saved = {k: getattr(disc, k) for k in values}
    try:
        for k, v in values.items():
            setattr(disc, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(disc, k, v)


def scored_calls(ss, rm, reference, want, name, **constants):
    """The scored call (discovery with the readmap) cold and warm with the
    discovery module's constants set as given (``discovery_constants``).
    Each call's records must be the JAX CPU leg's, tuple for tuple, and each
    must launch every kernel of DISCOVER_KERNELS.  Returns (what to print,
    the last call's stats)."""
    out = {}
    with discovery_constants(**constants):
        for run in ("cold", "warm"):
            records, stats, seconds, launches = run_discover(ss, reference, readmap=rm)
            require_records(name, records, want)
            missing = [k for k in DISCOVER_KERNELS if launches[k] == 0]
            if missing:
                raise AssertionError(f"{name} launched no {missing} kernel")
            out[run] = {"seconds": seconds, "stage_s": stats["stage_s"], "launches": launches}
    out.update(records=len(want), anchors_found=stats["anchors_found"], memory_plan=stats["memory_plan"],
               beam_steps=stats.get("wave_steps", 0))
    return out, stats


def dense_kernel_holds(ss, reference):
    """The dense front end's first batch replayed with rank held against its
    plain version at every step of the restart chain (1 M lanes a step) and
    push4 on the dense anchor scan's lanes."""
    opt = disc.DiscoverOptions(**DISCOVER_OPT)
    dev = ss.device
    held = HeldEngine(ss.d)
    G = len(reference.flat)
    ref2_dev = torch.from_numpy(np.concatenate([reference.flat, (3 - reference.flat[::-1]).astype(np.uint8)])).to(dev)
    batches, P = disc._dense_batches(disc._segments(opt, 0, G, G), opt, 0, G)
    (_, _, p0, _, seg_hi), = first = batches[:1]
    (b, e, s), = disc._dense_probes(held, ref2_dev, first, P, opt, disc._StageClock(dev, {}))
    lane = torch.arange(P, device=dev)
    n_raw, _ = disc._anchor_scan_at(held, ref2_dev, p0 + lane, b, e, s, opt.min_anchor_ctx, opt.min_branch_width,
                                    torch.full_like(lane, min(seg_hi, p0 + P)))
    if not held.held["rank"] or not held.held["push4"]:
        raise AssertionError(f"the replayed dense front end never reached a kernel: {held.held}")
    return {"batches": len(batches), "lanes_a_batch": P, "first_batch_anchors": n_raw,
            "rank_calls_by_lanes": held.held["rank"], "push4_calls_by_lanes": held.held["push4"]}


def discover_dense_phase(ss, rm, reference, want):
    """The scored call with the dense front end forced (``NO_PRESCREEN``),
    cold and warm, its records held to the JAX CPU leg's; then rank and
    push4 held against their plain versions on the dense route's lanes."""
    out, _ = scored_calls(ss, rm, reference, want, "dense front end", NO_PRESCREEN=True)
    out["holds"], out["holds"]["seconds"] = timed(lambda: dense_kernel_holds(ss, reference))
    out["holds"]["max_abs_err"] = 0
    return out


def discover_no_trunc_phase(ss, rm, reference, want, with_tables):
    """The scored call with a memory plan that drops the trunc tables (the
    wavefront truncates through the seqset's LtSearch), cold and warm, its
    records held to the JAX CPU leg's; the wavefront's seconds beside those
    of ``with_tables``, the warm call with them."""
    out, stats = scored_calls(ss, rm, reference, want, "discovery without trunc tables", BUDGET_BYTES=TINY_BUDGET_BYTES)
    if stats["memory_plan"]["use_trunc_tables"]:
        raise AssertionError(f"the tiny budget kept the trunc tables: {stats['memory_plan']}")
    out["wavefront_s"] = {"without_tables_warm": out["warm"]["stage_s"]["wavefront"],
                          "with_tables_warm": with_tables["stage_s"]["wavefront"]}
    return out


def require_same(name, card, cpu):
    if not isinstance(card, tuple):
        card, cpu = (card,), (cpu,)
    require_equal(name, tuple(x.cpu() for x in card), tuple(cpu))


def widen_checks(ss, ss_cpu, found):
    """The widen family on the full store, over the ranges find gave every
    oriented read, and LtSearch on LT_QUERIES random (pos, c): each on the
    card and on ss_cpu, a CPU copy of the store, with identical answers.
    Each timed on both; the card's LtSearch is built by its first query."""
    d, dc = ss.d, ss_cpu.d
    dev = ss.device
    cpu = SeqsetRanges(*(x.cpu() for x in found))
    g = torch.Generator(device="cpu").manual_seed(SEED + 21)
    bases = torch.randint(0, 4, found.begin.shape, generator=g)
    out = {"ranges": int(found.begin.shape[0]), "n_entries": ss.n_entries}
    lt, out["ltsearch_build_s"] = timed(lambda: LtSearch.build(d.shared))
    out["ltsearch_bytes"] = sum(t.numel() * t.element_size() for t in (lt.values, lt.block_min, lt.levels))
    calls = [(f"truncate_ranges_to_{m}", lambda d, r, b, m=m: d.truncate_ranges(r, m)) for m in WIDEN_SIZES]
    calls += [
        ("pop_front_ranges", lambda d, r, b: d.pop_front_ranges(r)),
        ("push_front_drop", lambda d, r, b: d.push_front_drop(r, b)),
        ("push_front_drop_min_ctx_60", lambda d, r, b: d.push_front_drop(r, b, min_ctx=60)),
    ]
    for name, fn in calls:
        got, out[name + "_s"] = timed(lambda: fn(d, found, bases.to(dev)))
        t0 = time.perf_counter()
        want = fn(dc, cpu, bases)
        out[name + "_cpu_s"] = time.perf_counter() - t0
        require_same(name, tuple(got), tuple(want))
        out[name + "_valid"] = int(got.valid.sum())
    n = ss.n_entries
    pos = torch.randint(0, n + 1, (LT_QUERIES,), generator=g)
    c = torch.randint(0, 101, (LT_QUERIES,), generator=g).to(torch.int32)
    lt, lt_cpu = d.shared_lt, dc.shared_lt
    for name in ("next_backward_lt", "next_forward_lt"):
        got, out[f"ltsearch_{name}_s"] = timed(lambda: getattr(lt, name)(pos.to(dev), c.to(dev)))
        t0 = time.perf_counter()
        want = getattr(lt_cpu, name)(pos, c)
        out[f"ltsearch_{name}_cpu_s"] = time.perf_counter() - t0
        require_same(f"LtSearch {name}", got, want)
    out["ltsearch_queries"] = LT_QUERIES
    return out


def sdk_checks(dev, ss, rm, codes, genome):
    """BioGraph on a .bgt of the store and the readmap, opened on the card
    and on the CPU: find, SeqsetEntry.pop_front and truncate, and the read
    iteration methods on a sample of reads, with identical answers."""
    from biograph_tpu_torch.api import BioGraph

    from biograph_tpu_torch.core import dna

    rng = np.random.default_rng(SEED + 23)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(tmp + "/sample.bgt")
        ss.save(tmp + "/sample.bgt/seqset")
        rm.save(tmp + "/sample.bgt/readmap")
        bg, out["open_s"] = timed(lambda: BioGraph(tmp + "/sample.bgt", device=dev))
        bg_cpu = BioGraph(tmp + "/sample.bgt", device="cpu")
    if not bg.num_reads == bg_cpu.num_reads == codes.shape[0]:
        raise AssertionError(f"BioGraph: {bg.num_reads} reads on the card, {bg_cpu.num_reads} on the CPU")
    sample = rng.choice(codes.shape[0], 16, replace=False)
    overlap_at = dict(zip(sample.tolist(), rng.integers(0, genome.shape[0] - 150, 16).tolist()))

    def entry_tuple(e):
        return (e.begin, e.end, e.size)

    def walk(g):
        res = []
        for i in sample:
            e = g.find(dna.codes_to_seq(codes[i]))
            res.append(entry_tuple(e))
            res += [entry_tuple(e.pop_front()), entry_tuple(e.truncate(30)), entry_tuple(e.truncate(1))]
            res.append(g.readmap.get_prefix_reads(e))
            res.append(g.readmap.get_reads_containing(codes[i][30:60]))
            p = overlap_at[int(i)]
            res.append(g.readmap.find_overlap_reads(genome[p : p + 150], min_overlap=60))
        return res

    on_card, out["queries_s"] = timed(lambda: walk(bg))
    on_cpu = walk(bg_cpu)
    if on_card != on_cpu:
        diff = next(i for i, (a, b) in enumerate(zip(on_card, on_cpu)) if a != b)
        raise AssertionError(f"BioGraph: the card and the CPU differ at answer {diff}: {on_card[diff]} vs {on_cpu[diff]}")
    if not all(r[0] < r[1] for r in on_card[::7]):
        raise AssertionError("BioGraph: a sampled read was not found")
    out.update(reads_sampled=len(sample), answers=len(on_card),
               reads_containing=sum(len(x) for x in on_card[5::7]), overlap_reads=sum(len(x) for x in on_card[6::7]))
    return out


def main():
    global PROFILE
    profile_to = None
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile_to = sys.argv[2]
    elif len(sys.argv) != 1:
        sys.exit("usage: python3 chip_smoke.py [--profile OUT.json]")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs only on a GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    say(torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    say(phase="build_kernels", built=built, seconds=time.perf_counter() - t0)

    _, seconds = timed(lambda: edge_checks(dev))
    say(phase="edge_checks", ok=True, seconds=seconds)

    genome, codes, lengths, snp, donor, starts = simulate(GENOME, READS, SNPS, READ_LEN)
    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats, (ss, rm, found, ranked, pushed, text, probed) = main_path(dev, genome, codes, lengths)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    missing = [name for name in MAIN_PATH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")
    if ss.n_entries < 1_000_000:
        raise AssertionError(f"n_entries {ss.n_entries} is below the real-size floor of 1M")
    say(phase="main_path", card=card, **stats)

    checks, seconds = timed(lambda: check_results(dev, genome, codes, ss, found, ranked, pushed, text, probed))
    say(phase="checks", ok=True, seconds=seconds, **checks)

    # variant discovery on the store just built and loaded: the counts of its
    # kernels are set to 0 before each call and read after it
    reference = reference_from_numpy(genome, np.zeros(GENOME, bool), [("chr1", 0, GENOME)])
    records, found_by = discover_phase(ss, reference)
    say(phase="discover", card=card, **found_by)
    rm_cpu = rm.to("cpu")  # one CPU copy of the store and the readmap for every region check
    checks, seconds = timed(lambda: discover_checks(dev, ss, rm_cpu.seqset, reference, genome, records, snp, donor, starts, READ_LEN))
    say(phase="discover_checks", ok=True, seconds=seconds, **checks)
    holds, seconds = timed(lambda: discover_kernel_holds(ss, reference, found_by["anchors_found"]))
    say(phase="discover_kernel_holds", ok=True, max_abs_err=0, seconds=seconds, **holds)
    small, seconds = timed(lambda: small_genome_checks(dev))
    say(phase="small_genome_checks", ok=True, seconds=seconds, **small)

    # discovery with the readmap the main path built and loaded, held to the
    # JAX package's CPU leg (its reference names the contig as bench.py does)
    scored_reference = reference_from_numpy(genome, np.zeros(GENOME, bool), [("chr", 0, GENOME)])
    want = read_records_file()
    _, scored_asms, scored = discover_scored_phase(ss, rm, scored_reference, want, stats["build_s"] + stats["readmap_s"], READS)
    say(phase="discover_scored", card=card, **scored)
    (checked, cov_slab, chain_fixed_launches), seconds = timed(lambda: scored_checks(dev, ss, rm, rm_cpu, reference, scored_asms))
    say(phase="scored_checks", ok=True, max_abs_err=0, seconds=seconds, **checked)

    # the scored call by the dense front end and without the trunc tables,
    # each held to the same records; the widen family and the SDK on the
    # full store, each against its CPU copy
    dense = discover_dense_phase(ss, rm, scored_reference, want)
    say(phase="discover_dense", card=card, **dense)
    no_trunc = discover_no_trunc_phase(ss, rm, scored_reference, want, scored["warm"])
    say(phase="discover_no_trunc", card=card, **no_trunc)
    widened, seconds = timed(lambda: widen_checks(ss, rm_cpu.seqset, found))
    say(phase="widen_checks", ok=True, card=card, seconds=seconds, **widened)
    sdk, seconds = timed(lambda: sdk_checks(dev, ss, rm, codes, genome))
    say(phase="sdk_checks", ok=True, seconds=seconds, **sdk)

    probe_pos = torch.arange(PROBE_CHUNK, device=dev)
    probe_m = torch.full((PROBE_CHUNK,), DEPTH, dtype=torch.int32, device=dev)
    probe_m_mixed = bisection_lengths(ss.d, text, probe_pos, torch.zeros_like(probe_pos), DEPTH, 3)
    breakdown = profile_to is not None
    launches["chain_fixed"] = chain_fixed_launches
    rows = kernel_table(ss, launches, found, text, probe_pos, probe_m, probe_m_mixed, cov_slab, breakdown)
    for r in rows:
        r["launches_discover"] = found_by["warm"]["launches"][r["name"]]
        r["launches_discover_scored"] = scored["warm"]["launches"][r["name"]]
        r["launches_discover_dense"] = dense["warm"]["launches"][r["name"]]
        r["launches_discover_no_trunc"] = no_trunc["warm"]["launches"][r["name"]]
    past_l2, seconds = timed(lambda: rank_past_l2(dev, make_stall(dev), breakdown))
    say(phase="rank_past_l2", card=card, seconds=seconds, **past_l2)
    if profile_to is not None:
        # the main path twice more: once as it is, with the allocator and
        # the kernels warm, and once with each stage under torch.profiler:
        # [kernel name, calls, device ms] for the heaviest kernels, and the
        # share of the warm stage time in which the device sat idle
        del found, ranked, pushed, text, probed
        warm, _ = main_path(dev, genome, codes, lengths)
        PROFILE = {}
        main_path(dev, genome, codes, lengths)
        run_discover(ss, reference, stage="discover")
        PROFILE["discover"].update(
            cold_s=found_by["cold"]["seconds"], warm_s=found_by["warm"]["seconds"],
            stage_s_warm=found_by["warm"]["stage_s"], beam_step=beam_step_profile(ss, reference),
        )
        run_discover(ss, scored_reference, stage="discover_scored", readmap=rm)
        PROFILE["discover_scored"].update(
            cold_s=scored["cold"]["seconds"], warm_s=scored["warm"]["seconds"], stage_s_warm=scored["warm"]["stage_s"],
        )
        for stage, constants, calls in (("discover_dense", {"NO_PRESCREEN": True}, dense),
                                        ("discover_no_trunc", {"BUDGET_BYTES": TINY_BUDGET_BYTES}, no_trunc)):
            with discovery_constants(**constants):
                run_discover(ss, scored_reference, stage=stage, readmap=rm)
            PROFILE[stage].update(cold_s=calls["cold"]["seconds"], warm_s=calls["warm"]["seconds"], stage_s_warm=calls["warm"]["stage_s"])
        # the score stage's coverage batch alone, on the warm call's
        # assemblies: host- or device-bound
        opt = disc.DiscoverOptions(**DISCOVER_OPT)
        again = [disc.Assembly(a.chunk_start, a.anchor, a.rejoin, a.seq, a.support) for a in scored_asms]
        _, score_s = timed(lambda: disc.score_assemblies(rm, genome, again, opt))
        timed(lambda: disc.score_assemblies(rm, genome, again, opt), "score")
        PROFILE["score"].update(cold_s=scored["warm"]["stage_s"]["score"], warm_s=score_s, assemblies=len(again))
        for stage, seen in PROFILE.items():
            seen.setdefault("cold_s", stats.get(stage + "_s"))
            seen.setdefault("warm_s", warm.get(stage + "_s"))
            seen["device_idle_share"] = max(0.0, 1 - seen["device_busy_s"] / seen["warm_s"])
        with open(profile_to, "w") as f:
            json.dump({"card": card, "stages": PROFILE}, f, indent=1)
        say(phase="profile", written=profile_to, card=card,
            stages={k: {x: v[x] for x in ("cold_s", "warm_s", "device_busy_s", "device_idle_share", "launches")} for k, v in PROFILE.items()},
            beam_step=PROFILE["discover"]["beam_step"])
        PROFILE = None
    say(total_s=time.perf_counter() - t_start)
    print(card, flush=True)
    say(kernels=rows)
    say(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
