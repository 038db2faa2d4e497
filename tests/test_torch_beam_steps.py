"""Discovery's beam step as one kernel: csrc/beam_steps.cu replayed lane by
lane on the host against its plain version, which is ``_wavefront_body``
stepped block by block, and the beam loop's choice of route.

The replay follows the kernel's loop: a quad of threads a lane, each ranking
one pushed base as push4 does, the widths shuffled to every thread of the
quad, ``best`` picked in the stable descending order, the truncation through
the trunc tables, and the quad's (4 * PROBES + 1)-way searches of K and
key2.  Each block is held three ways, with exact equality of all 14 state
tensors: the body stepped with the span table's real rows as an int (the
dense table) or a 0-d tensor (the compact one), ``beam_steps`` on CPU
tensors (its plain version) with them as a 0-d tensor, and the replay.  The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.  Everything is integer."""

import re

import numpy as np
import pytest
import torch

from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.convert import reference_from_numpy
from biograph_tpu_torch.ops import _build
from biograph_tpu_torch.ops import rank4 as trank4
from biograph_tpu_torch.parallel.mesh import Mesh
from biograph_tpu_torch.parallel.sharded_discovery import ShardedDiscoveryEngine
from biograph_tpu_torch.variants import discover as tdisc
from test_torch_rank_kernels import _locate_in_blocks_numpy as _locate, _rank_in_block_numpy as _rank_in_block

G = 6000
SOURCE = open(_build.source_path("beam_steps")).read()
PROBES = int(re.search(r"constexpr int PROBES = (\d+);", SOURCE).group(1))
SPLIT = 4 * PROBES + 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """A 6000-base genome with SNPs, an insertion and a deletion, 40-base
    reads at 30x from its donor, the store on the CPU, the doubled
    reference, and the prescreened anchors of the forward half."""
    rng = np.random.default_rng(19)
    ref = rng.integers(0, 4, G, dtype=np.uint8)
    donor = np.concatenate([
        ref[:900], [(ref[900] + 1) % 4], ref[901:2500], [(ref[2500] + 2) % 4], ref[2501:3100],
        rng.integers(0, 4, 6, dtype=np.uint8), ref[3100:4400], ref[4407:],
    ]).astype(np.uint8)
    starts = rng.integers(0, len(donor) - 40, len(donor) * 30 // 40)
    codes = donor[starts[:, None] + np.arange(40)]
    codes[: len(starts) // 2] = (3 - codes[: len(starts) // 2])[:, ::-1]
    ss = build_seqset(codes, np.full(len(starts), 40, np.int32), device="cpu")
    ref2 = torch.from_numpy(np.concatenate([ref, 3 - ref[::-1]]).astype(np.uint8))
    opt = tdisc.DiscoverOptions(max_path=100)
    stats = {"anchors_found": 0, "anchors_truncated": 0}
    segments = tdisc._segments(opt, 0, G, G)
    parts, hit_pos = tdisc._find_anchors(ss, ref2, segments, opt, stats, tdisc._StageClock(ss.device, {}), G)
    reference = reference_from_numpy(ref, np.zeros(G, bool), [("chr1", 0, G)])
    return dict(ss=ss, ref2=ref2, opt=opt, anchors=parts[False], hit_pos=hit_pos, reference=reference)


def _group(world, route):
    """A beam group of the forward anchors, seeded, with the dense span
    table (its real rows the span's k-mers) or the compact one over the
    prescreen's hits (pad rows past its real rows)."""
    opt, ref2 = world["opt"], world["ref2"]
    span_shared = None
    if route == "compact":
        k = opt.rejoin_k
        pos = world["anchors"][0]
        lo = int(pos.min())
        span = min(int(pos.max()) + opt.max_path + k + 3, G) - lo
        K, key2, n_real = tdisc._span_kmers_compact_dev(ref2, lo, span, k, pos_abs=world["hit_pos"] - (k - 1))
        assert int(n_real) < K.shape[0]
        span_shared = ((K, key2), lo, n_real)
    c = tdisc._asm_start(world["ss"].d, world["anchors"], opt, G, ref2, span_shared)
    assert c["n_packed"].dim() == 0 and int(c["n_packed"]) <= c["packed"][0].shape[0]
    return c


def _clone(st):
    return {name: v.clone() for name, v in st.items()}


def _equal(got, want, what):
    assert set(got) == set(want) == set(trank4.BEAM_STATE)
    for name in trank4.BEAM_STATE:
        g, w = got[name], want[name]
        g = g if isinstance(g, np.ndarray) else g.numpy()
        w = w if isinstance(w, np.ndarray) else w.numpy()
        assert g.dtype == w.dtype, f"{what}: {name} {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# the kernel's loop, lane by lane on the host (csrc/beam_steps.cu)
# ---------------------------------------------------------------------------


def _quad_lower_bound(table, x):
    """quad_lower_bound: (first row >= x, rounds).  Probe g of a round lies
    at lo + len * (g + 1) / SPLIT; the c probes below x fix the interval."""
    lo, hi, rounds = 0, len(table), 0
    while lo < hi:
        ln = hi - lo
        c = sum(int(table[lo + ln * (g + 1) // SPLIT]) < x for g in range(4 * PROBES))
        nxt = lo + ln * c // SPLIT + 1 if c > 0 else lo
        if c < 4 * PROBES:
            hi = lo + ln * (c + 1) // SPLIT
        lo = nxt
        rounds += 1
    return lo, rounds


def _beam_kernel_in_numpy(blocks, sizes, fixed, prev_lt, next_lt, K, key2, n_packed, st, step0, steps, k, min_w, probe_ctx, pos_bits):
    """beam_steps_kernel one lane at a time.  Returns (the state after the
    block as numpy arrays, counts of the cases the block met)."""
    sectors = blocks.numpy().view(np.uint64).reshape(-1, 4)
    last_word = blocks.shape[0] * trank4.BLOCK_WORDS - 1
    sizes, fixed, prev_lt, next_lt = (t.numpy().tolist() for t in (sizes, fixed, prev_lt, next_lt))
    K, key2 = K.numpy().tolist(), key2.numpy().tolist()
    n, npk, n_packed = len(sizes), len(K), int(n_packed)
    kmask, window = (1 << (2 * k)) - 1, 1 << pos_bits
    out = {name: v.numpy().copy() for name, v in st.items()}
    seen = dict.fromkeys(("done_truncated", "empty", "ties", "junction_clamped", "searches", "rejoins",
                          "missed_past_n_packed", "missed_window", "kicks"), 0)
    for q in range(len(out["begin"])):
        begin, end, size = int(out["begin"][q]), int(out["end"][q]), int(out["size"][q])
        path_len, support, nj = int(out["path_len"][q]), int(out["support"][q]), int(out["n_junction"][q])
        roll, done, rejoin = int(out["roll"][q]), bool(out["done"][q]), int(out["rejoin"][q])
        out_len, out_support = int(out["out_len"][q]), int(out["out_support"][q])
        policy, min_local = int(out["policy"][q]), int(out["min_local"][q])
        q_low = min(max(min_local, 0), (1 << 32) - 1)

        def trunc(begin, end):
            wb = prev_lt[min(max(begin, 0), n - 1)]
            return max(wb, 0), (n if end >= n else next_lt[max(end, 0)])

        for step in range(step0, step0 + steps):
            if done:
                if size > probe_ctx:
                    begin, end = trunc(begin, end)
                    size = probe_ctx
                    seen["done_truncated"] += 1
                break
            nb4, ne4 = [begin] * 4, [begin] * 4  # thread b: the child of base b
            if begin < end:
                k0, r0 = _locate(begin, last_word)
                k1, r1 = _locate(end, last_word)
                for b in range(4):
                    nb = fixed[b] + _rank_in_block(sectors[4 * k0 + b], r0)
                    ne = fixed[b] + _rank_in_block(sectors[4 * k1 + b], r1)
                    if nb < ne and sizes[min(nb, n - 1)] < size + 1:
                        nb += 1
                        seen["kicks"] += 1
                    nb4[b], ne4[b] = nb, ne
            else:
                seen["empty"] += 1
            W = [ne4[3 - j] - nb4[3 - j] for j in range(4)]  # column j: thread 3 - j
            n_viable = sum(w >= min_w for w in W)
            first = max(range(4), key=lambda j: (W[j], -j))
            second = max((j for j in range(4) if j != first), key=lambda j: (W[j], -j))
            seen["ties"] += W[first] == W[second] >= min_w
            seen["junction_clamped"] += nj >= 30 and n_viable > 1
            take = (policy >> min(nj, 30)) & 1 if n_viable > 1 else 0
            best = second if take else first
            bw = W[best]
            ext = bw >= min_w
            nj += n_viable > 1
            base = best if ext else 0
            if ext:
                begin, end, size = nb4[3 - base], ne4[3 - base], size + 1
            need = size > probe_ctx
            if ext:
                out["path"][q, step] = base
                path_len = step + 1
                support = min(support, bw)
                roll = ((roll << 2) | base) & kmask
            else:
                done = True
            if ext and path_len > k:
                seen["searches"] += 1
                run, _ = _quad_lower_bound(K, roll)
                idx, _ = _quad_lower_bound(key2, (run << 32) | q_low)
                idxc = min(idx, npk - 1)
                jpos = key2[idxc] & 0xFFFFFFFF
                same = K[idxc] == roll
                found = idx < n_packed and same and jpos - min_local < window
                seen["missed_past_n_packed"] += same and idx >= n_packed
                seen["missed_window"] += same and idx < n_packed and jpos - min_local >= window
                if found and rejoin < 0:
                    seen["rejoins"] += 1
                    done, rejoin, out_len, out_support = True, jpos, path_len, support
            if need:
                begin, end = trunc(begin, end)
                size = probe_ctx
        for name, v in (("begin", begin), ("end", end), ("size", size), ("path_len", path_len),
                        ("support", support), ("n_junction", nj), ("roll", roll), ("done", done),
                        ("rejoin", rejoin), ("out_len", out_len), ("out_support", out_support)):
            out[name][q] = v
    return out, seen


def _three_ways(d, trunc, K, key2, n_packed, st, step0, steps, k, min_w, probe_ctx, pos_bits):
    """One block held three ways; returns (the state after it, the replay's
    counts).  The body takes n_packed as it is given, an int or a 0-d
    tensor; the wrapper and the replay take it as a 0-d tensor."""
    n_t = torch.as_tensor(n_packed, dtype=torch.int64)
    body = _clone(st)
    for step in range(step0, step0 + steps):
        body = tdisc._wavefront_body(d, (K, key2), *trunc, n_packed, body, step, st["path"].shape[1], k, min_w,
                                     probe_ctx, pos_bits)
    tables = (d.rank_blocks, d.entry_sizes, d.fixed, *trunc, K, key2, n_t)
    replay, seen = _beam_kernel_in_numpy(*tables, st, step0, steps, k, min_w, probe_ctx, pos_bits)
    wrapped = _clone(st)
    assert trank4.beam_steps(*tables, wrapped, step0, steps, k, min_w, probe_ctx, pos_bits) is wrapped
    _equal(wrapped, body, "beam_steps against the body")
    _equal(replay, body, "the kernel's replay against the body")
    return body, seen


# ---------------------------------------------------------------------------
# the replay against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["dense", "compact"])
def test_kernel_replay_drives_a_real_group_to_max_path(world, route):
    """A real group from its seed to max_path, block by block: blocks of 48
    steps and a last one of 3 that ends at MAXP; lanes die, rejoin, meet
    junctions and ties, and enter later blocks done."""
    ss, opt = world["ss"], world["opt"]
    c = _group(world, route)
    trunc = tdisc._trunc_tables(ss, opt.probe_ctx)
    st, step, total = c["st"], c["step"], dict.fromkeys(("searches", "rejoins", "kicks"), 0)
    ends = []
    while step < c["MAXP"]:
        steps = min(tdisc.CHECK_EVERY, c["MAXP"] - step)
        # the body takes the dense table's real rows as the int they were
        n_packed = int(c["n_packed"]) if route == "dense" else c["n_packed"]
        st, seen = _three_ways(ss.d, trunc, *c["packed"], n_packed, st, step, steps, c["k"], c["min_w"],
                               c["probe_ctx"], c["pos_bits"])
        for key in total:
            total[key] += seen[key]
        step += steps
        ends.append(step)
    assert ends == [49, 97, 100]
    assert total["rejoins"] > 0 and total["searches"] > total["rejoins"]
    assert int((st["rejoin"] >= 0).sum()) == total["rejoins"] and bool(st["done"].any())


def _made_up(world, route, rng, A=192):
    """A state of made-up lanes on the real store and a span table made for
    them: ranges at random (some empty), sizes past probe_ctx, lanes done on
    entry, junction counts about 30, random policies, min_local near 2^32
    on a third of the lanes, and every possible next k-mer of each lane in
    the table at positions about the edge of the rejoin window.  For the
    compact route n_packed cuts off the last of the table's real rows."""
    ss, opt = world["ss"], world["opt"]
    n, k, pos_bits = ss.n_entries, opt.rejoin_k, 6
    begin = rng.integers(0, n + 1, A)
    end = np.minimum(begin + rng.integers(0, 40, A), n)
    end[:12] = begin[:12]  # empty
    end[12:16] = begin[12:16] - 1  # reversed
    size = rng.integers(opt.probe_ctx - 3, opt.probe_ctx + 3, A).astype(np.int32)
    done = rng.random(A) < 0.2
    done[:4] = False
    min_local = rng.integers(1, 1 << 20, A)
    min_local[A // 3 : 2 * A // 3] = (1 << 32) - rng.integers(0, 1 << (pos_bits + 1), A // 3)
    min_local[-4:] = [(1 << 32) + 3, (1 << 32) - 1, 1 << 33, (1 << 32) - (1 << pos_bits)]
    roll = rng.integers(0, 1 << (2 * k), A)
    MAXP = 40
    st = {
        "begin": begin, "end": end, "size": size,
        "path": rng.integers(0, 4, (A, MAXP)).astype(np.uint8),
        "path_len": np.full(A, 30, np.int32), "support": rng.integers(1, 60, A),
        "n_junction": rng.integers(27, 40, A).astype(np.int32), "roll": roll, "done": done,
        "policy": rng.integers(0, 1 << 31, A).astype(np.int32), "min_local": min_local,
        "rejoin": np.where(rng.random(A) < 0.1, 77, -1), "out_len": np.zeros(A, np.int32),
        "out_support": np.zeros(A, np.int64),
    }
    st = {name: torch.from_numpy(np.asarray(v)).to(trank4.BEAM_STATE[name]).contiguous() for name, v in st.items()}
    kmask = (1 << (2 * k)) - 1
    kmers, pos = [], []
    edge = 1 << pos_bits
    for q in range(A):
        for b in range(4):
            # before and at min_local; just inside the window; just past it
            for off in ((-1, 0), (edge - 1,), (edge,))[q % 3]:
                p = int(min_local[q]) + off
                if 0 <= p < 1 << 32:
                    kmers.append(((int(roll[q]) << 2) | b) & kmask)
                    pos.append(p)
    npk = 1 << (len(kmers) + 64).bit_length()
    pad = npk - len(kmers)
    K, key2 = tdisc._sorted_span_table(
        torch.tensor(kmers + [tdisc._SENTINEL] * pad), torch.tensor(pos + [tdisc._SENTINEL] * pad), k
    )
    n_real = npk - pad
    n_packed = n_real if route == "dense" else torch.tensor(n_real - 40)
    return st, K, key2, n_packed, pos_bits


@pytest.mark.parametrize("route", ["dense", "compact"])
def test_kernel_replay_on_made_up_lanes(world, route):
    """Lanes done on entry (truncated once, then left), empty and reversed
    ranges, n_junction at and past 30, min_local near 2^32 (clamped in the
    query), matches on either side of the 2^pos_bits window's edge, and, on
    the compact route, matches in rows past n_packed; a block of 10 steps
    that ends at MAXP."""
    ss, opt = world["ss"], world["opt"]
    rng = np.random.default_rng(5 if route == "dense" else 6)
    st, K, key2, n_packed, pos_bits = _made_up(world, route, rng)
    assert bool((key2[1:] >= key2[:-1]).all()) and bool((K[1:] >= K[:-1]).all())
    trunc = tdisc._trunc_tables(ss, opt.probe_ctx)
    after, seen = _three_ways(ss.d, trunc, K, key2, n_packed, st, 30, 10, opt.rejoin_k, opt.min_extend_width,
                              opt.probe_ctx, pos_bits)
    assert seen["done_truncated"] > 0 and seen["empty"] > 0 and seen["junction_clamped"] > 0 and seen["ties"] > 0
    assert seen["kicks"] > 0
    assert seen["rejoins"] > 0 and seen["missed_window"] > 0
    if route == "compact":
        assert seen["missed_past_n_packed"] > 0
    near = st["min_local"] >= (1 << 32) - (1 << pos_bits)
    assert bool((after["rejoin"][near] >= 0).any())  # found near the top of 32 bits


def test_quad_search_is_searchsorted():
    """The quad's search against torch.searchsorted: runs of equal keys,
    sentinel pads, keys below and above every row, tables of 1 to 3000
    rows; its rounds against the (4 * PROBES + 1)-way bound."""
    rng = np.random.default_rng(11)
    for rows in (1, 2, 3, 8, 9, 10, 17, 100, 1000, 3000):
        table = np.sort(rng.integers(0, rows // 2 + 2, rows)).astype(np.int64)
        if rows >= 5:
            table[-(rows // 5) :] = tdisc._SENTINEL
        xs = sorted({v + d for v in table.tolist() for d in (-1, 0, 1) if v + d <= tdisc._SENTINEL} | {-1, 0})
        want = torch.searchsorted(torch.from_numpy(table), torch.tensor(xs)).tolist()
        for x, w in zip(xs, want):
            got, rounds = _quad_lower_bound(table.tolist(), x)
            assert got == w, (rows, x)
            assert rounds <= int(np.ceil(np.log(rows + 1) / np.log(SPLIT - 1))) + 1


# ---------------------------------------------------------------------------
# the route _drive takes
# ---------------------------------------------------------------------------


def test_drive_fuses_blocks_on_the_single_engine_with_trunc_tables(world, monkeypatch):
    """The single engine with trunc tables: every block of beam steps is one
    beam_steps call, and wave_fused_steps == wave_steps in a whole call.  A
    group driven so ends in the state the per-step body gives it when the
    engine shows no rank-block table."""
    ss, reference, opt = world["ss"], world["reference"], tdisc.DiscoverOptions()
    calls = []
    real = trank4.beam_steps

    def counting(*args):
        calls.append(args[10])
        return real(*args)

    monkeypatch.setattr(trank4, "beam_steps", counting)
    stats = {}
    assert tdisc.discover_variants(ss, reference, opt=opt, stats=stats)
    assert stats["wave_steps"] > 0 and stats["wave_fused_steps"] == stats["wave_steps"] == sum(calls)
    assert max(calls) == tdisc.CHECK_EVERY

    class Unfused:
        def __init__(self, d):
            self._d = d

        def __getattr__(self, name):
            if name == "rank_blocks":
                raise AttributeError(name)
            return getattr(self._d, name)

    trunc = tdisc._trunc_tables(ss, world["opt"].probe_ctx)
    fused, stepped = _group(world, "dense"), _group(world, "dense")
    calls.clear()
    fused_stats, stepped_stats = {}, {}
    tdisc._drive(ss.d, fused, trunc, fused_stats)
    n_calls = len(calls)
    tdisc._drive(Unfused(ss.d), stepped, trunc, stepped_stats)
    assert n_calls > 0 and len(calls) == n_calls and "wave_fused_steps" not in stepped_stats
    assert fused_stats["wave_fused_steps"] == fused_stats["wave_steps"] == stepped_stats["wave_steps"]
    _equal(fused["st"], stepped["st"], "a group driven fused and step by step")


@pytest.mark.parametrize("route", ["no_trunc_tables", "sharded"])
def test_drive_steps_the_body_without_trunc_tables_and_on_the_sharded_engine(world, monkeypatch, route):
    """The route without trunc tables (truncate_ranges through LtSearch) and
    the sharded engine (collectives in push4 and the truncation) run
    _wavefront_body each step: no beam_steps call, no fused step, the same
    results as the single engine's fused blocks."""
    ss, reference, ref2, opt = world["ss"], world["reference"], world["ref2"], world["opt"]
    calls = []
    real = trank4.beam_steps
    monkeypatch.setattr(trank4, "beam_steps", lambda *a: calls.append(a) or real(*a))
    stats = {}
    if route == "sharded":
        want = tdisc.discover_variants(ss, reference, opt=opt)
        calls.clear()
        eng = ShardedDiscoveryEngine(ss, Mesh.build({"model": -1}, 1, 0, 3, "cpu"))
        got = tdisc.discover_variants(ss, reference, opt=opt, stats=stats, engine=eng)
    else:
        args = (ss, world["anchors"], opt, ref2, world["hit_pos"])
        want = tdisc.wavefront_assemble(*args, stats={}, ref_limit=G)
        assert calls
        calls.clear()
        got = tdisc.wavefront_assemble(*args, stats=stats, ref_limit=G, trunc=False)
    assert not calls and stats["wave_steps"] > 0 and "wave_fused_steps" not in stats
    if route == "sharded":
        assert got and got == want
    else:
        assert got and [_asm_key(a) for a in got] == [_asm_key(a) for a in want]


def _asm_key(a):
    return (a.chunk_start, a.anchor, a.rejoin, a.seq.tolist(), a.support, a.ref_support)


def test_chip_smoke_beam_leg_at_toy_size_on_the_cpu(monkeypatch):
    """chip_smoke.py's beam_steps_checks on CPU tensors at a toy size: the
    block on a toy store, 512 anchors (2048 lanes) in blocks of 8 steps; the
    whole drive on a small insertion library, whose insertion lanes outlive
    the SNPs' and are compacted; without the card's times."""
    import chip_smoke

    monkeypatch.setattr(tdisc, "CHECK_EVERY", 8)
    genome, codes, lengths, *_ = chip_smoke.simulate(8000, 600, 16, 100)
    ss = build_seqset(codes, lengths, device="cpu")
    reference = reference_from_numpy(genome, np.zeros(8000, bool), [("chr1", 0, 8000)])
    drive_world = chip_smoke.insertion_library("cpu", genome_len=6000, ins_len=40, n_snps=6, read_len=50)
    got = chip_smoke.beam_steps_checks(ss, reference, drive_world, fill=512)
    assert got["lanes"] == 2048 and got["steps"] == 8 and "ms" not in got
    drive = got["drive"]
    assert drive["wave_compactions"] > 0 and drive["wave_fused_steps"] == drive["wave_steps"] > 48
    assert max(drive["alt_lengths"]) == 40
