"""The port's SV engine (``biograph_tpu_torch/variants/pop_tracer.py``)
against the JAX package's, on the CPU.

``tests/test_pop_tracer.py``'s synthetic worlds (a 5 kb deletion, a 300-base
insertion, clean reads, unpaired spanning support, a 49 kb deletion, a 2 kb
novel insertion that only the breakend walk assembles) go through both
packages' ``discover_structural`` with identical records; so does the
sharded scan against the single pass.  The engine's arrays (split
placement, the k-mer edge table, the scan's events and clips) equal the
JAX package's; the batched walk equals the host oracle and the JAX batch;
ties are built on purpose for the diagonal vote (``mode_diag``) and the
walk's heaviest edge; ``Readmap.forward_reads`` on a paired store, whole
and sliced, against the JAX package's ``reads_from_readmap``; an unpaired
library's mates, every read its own, give the records of none;
``utils.find_breakpoint_variants`` on ``tests/test_sdk_helpers.py``'s
breakpoint world.  Tolerance: exact equality.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_pop_tracer import _mk_reference, _sample_pairs  # noqa: E402

from biograph_tpu.variants import pop_tracer as jp  # noqa: E402
from biograph_tpu.variants.align import RefKmerIndex as JIndex  # noqa: E402
from biograph_tpu_torch import convert  # noqa: E402
from biograph_tpu_torch.variants import pop_tracer as tp  # noqa: E402
from biograph_tpu_torch.variants.align import RefKmerIndex as TIndex  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_ref(ref):
    return convert.reference_from_numpy(ref.flat, ref.is_n, [(c.name, c.start, c.length) for c in ref.contigs])


def _world(name):
    """(JAX reference, codes, lengths, mate_of or None, event) of one of
    tests/test_pop_tracer.py's worlds, from its seed."""
    rng = np.random.default_rng(12345)
    if name == "del_5kb":
        ref = _mk_reference(rng, 30000)
        donor = np.concatenate([ref.flat[:12000], ref.flat[17000:]])
        return (ref, *_sample_pairs(rng, donor), (12000, -5000))
    if name == "ins_300":
        ref = _mk_reference(rng, 20000)
        donor = np.concatenate([ref.flat[:9000], rng.integers(0, 4, 300).astype(np.uint8), ref.flat[9000:]])
        return (ref, *_sample_pairs(rng, donor), (9000, 300))
    if name == "clean":
        ref = _mk_reference(rng, 15000)
        return (ref, *_sample_pairs(rng, ref.flat), None)
    if name in ("unpaired_60", "unpaired_60_self_mates"):
        ref = _mk_reference(rng, 12000)
        donor = np.concatenate([ref.flat[:6000], ref.flat[6060:]])
        codes, lens, _ = _sample_pairs(rng, donor)
        mate = np.arange(len(lens)) if name.endswith("self_mates") else None  # as forward_reads gives it
        return ref, codes, lens, mate, (6000, -60)
    if name == "del_49kb":
        ref = _mk_reference(rng, 120000)
        donor = np.concatenate([ref.flat[:40000], ref.flat[89000:]])
        return (ref, *_sample_pairs(rng, donor, cov=25), (40000, -49000))
    if name == "novel_ins_2kb":
        ref = _mk_reference(rng, 30000)
        donor = np.concatenate([ref.flat[:14000], rng.integers(0, 4, 2000).astype(np.uint8), ref.flat[14000:]])
        return (ref, *_sample_pairs(rng, donor, cov=40), (14000, 2000))
    raise KeyError(name)


WORLDS = ("del_5kb", "ins_300", "clean", "unpaired_60", "unpaired_60_self_mates", "del_49kb", "novel_ins_2kb")


@pytest.mark.parametrize("name", WORLDS)
def test_discover_structural_equals_jax(name):
    ref, codes, lens, mate, event = _world(name)
    # the JAX package reads an unpaired library as mate_of None
    want = jp.discover_structural(ref, codes, lens, mate_of=None if name.endswith("self_mates") else mate)
    stats = {}
    got = tp.discover_structural(_port_ref(ref), codes, lens, mate_of=mate, device="cpu", stats=stats)
    assert got == want
    if event is None:
        assert got == [] and stats["unplaced_reads"] == 0
        return
    at, svlen = event
    hits = [r for r in got if r["svlen"] == svlen and abs(r["pos"] - at) <= 8]
    assert len(hits) == 1 and hits[0]["support"] >= 3, [(r["pos"], r["svlen"]) for r in got]
    assert stats["unplaced_reads"] > 0 and stats["split_events"] + stats["clip_candidates"] > 0
    if name == "novel_ins_2kb":  # only the walk assembles it
        assert stats["breakend_lanes"] >= 1 and stats["walk_steps"] >= 2000 and hits[0]["pair_support"] > 0


@pytest.fixture(scope="module")
def del_world():
    ref, codes, lens, mate, _ = _world("del_5kb")
    opt = jp.SvOptions()
    return ref, codes, lens, mate, JIndex.build(np.asarray(ref.flat), opt.k, is_n=ref.is_n), TIndex.build(ref.flat, opt.k, is_n=ref.is_n, device="cpu")


def test_scan_arrays_equal_jax(del_world):
    """split_place's arrays over the unplaced reads in both orientations,
    the edge table, and the scan's events and clips."""
    ref, codes, lens, mate, ji, ti = del_world
    opt = jp.SvOptions()
    jpl, jev, jcl, jek, jec = jp._sv_scan_reads(ji, codes, lens, opt)
    tpl, tev, tcl, tek, tec = tp._sv_scan_reads(ti, codes, lens, tp.SvOptions())
    np.testing.assert_array_equal(tpl.pos, jpl.pos)
    np.testing.assert_array_equal(tpl.is_rc, jpl.is_rc)
    assert tev == jev and len(tev) > 0
    assert [(l, o) for l, _, o in tcl] == [(l, o) for l, _, o in jcl]
    for (_, a, _), (_, b, _) in zip(tcl, jcl):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tek, jek)
    np.testing.assert_array_equal(tec, jec)
    unplaced = np.nonzero(jpl.pos < 0)[0]
    rc = (3 - codes[unplaced])[:, ::-1]  # every read here is 100 bases
    reads2 = np.concatenate([codes[unplaced], rc]).astype(np.uint8)
    lens2 = np.concatenate([lens[unplaced], lens[unplaced]])
    want = jp.split_place(ji, reads2, lens2, opt)
    got = tp.split_place(ti, reads2, lens2, tp.SvOptions())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for got, want in zip(tp._kmer_edge_table(torch.from_numpy(reads2), torch.from_numpy(lens2), 16), jp._kmer_edge_table(reads2, lens2, 16)):
        np.testing.assert_array_equal(got, want)


def test_sharded_scan_matches_single_pass(del_world):
    """Disjoint read slices scanned apart, merged and finalized give the
    single pass's records (and the JAX package's)."""
    ref, codes, lens, mate, _, ti = del_world
    tref = _port_ref(ref)
    opt = tp.SvOptions()
    single = tp.discover_structural(tref, codes, lens, mate_of=mate, index=ti)
    assert single == jp.discover_structural(ref, codes, lens, mate_of=mate) and single
    R = len(lens)
    cuts = [0, R // 3, (2 * R) // 3, R]
    pos, rc, tables, events, clips = [], [], [], [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        pl, ev, cl, ek, ec = tp._sv_scan_reads(ti, codes[a:b], lens[a:b], opt, owner_base=a)
        pos.append(pl.pos)
        rc.append(pl.is_rc)
        tables.append((ek, ec))
        events += ev
        clips += cl
    ek, ec = tp.merge_edge_tables(tables)
    jek, jec = jp.merge_edge_tables([(k.astype(np.uint64), c) for k, c in tables])
    np.testing.assert_array_equal(ek, jek)
    np.testing.assert_array_equal(ec, jec)
    merged = tp._sv_finalize(tref, ti, events, clips, ek, ec, np.concatenate(pos), np.concatenate(rc), lens, mate, opt)
    assert merged == single


def _junction_world():
    """tests/test_pop_tracer.py::test_breakend_batch_matches_host_oracle's
    world: a 120-base novel insertion at 3000 with reads tiled over it, the
    true junction's cluster and a decoy that cannot anchor."""
    rng = np.random.default_rng(12345)
    ref = _mk_reference(rng, 8000)
    ins = rng.integers(0, 4, 120).astype(np.uint8)
    donor = np.concatenate([ref.flat[:3000], ins, ref.flat[3000:]])
    reads = np.stack([donor[s : s + 70] for s in range(2900, 3150, 3)]).astype(np.uint8)
    lens = np.full(len(reads), 70, np.int32)
    cases = [(3000, [donor[3000 : 3000 + 50 + j] for j in range(3)]), (500, [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(3)])]
    return ref, reads, lens, cases


def _walks(ji, ti, ek, ec, cases, opt_j, opt_t):
    """Every cluster's walk four ways: JAX oracle, JAX batch, port oracle,
    port batch."""
    seeds = [tp._seed_consensus(tails, 16) for _, tails in cases]
    assert seeds == [int(jp._seed_consensus(tails, 16)) for _, tails in cases]
    lefts = np.array([left for left, _ in cases], np.int64)
    j_or = [jp._assemble_breakend(tails, ek.astype(np.uint64), ec, ji, left, opt_j) for left, tails in cases]
    j_b = jp._assemble_breakends_batch(np.array(seeds, np.uint64), lefts, ek.astype(np.uint64), ec, ji, opt_j)
    t_or = [tp._assemble_breakend(tails, ek, ec, ti, left, opt_t) for left, tails in cases]
    stats = {}
    t_b = tp._assemble_breakends_batch(np.array(seeds, np.int64), lefts, ek, ec, ti, opt_t, stats=stats)
    return j_or, j_b, t_or, t_b, stats


def _same(results):
    first = results[0]
    for other in results[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
                assert int(a[1]) == int(b[1])


def test_breakend_walk_equals_host_oracle_and_jax():
    ref, reads, lens, cases = _junction_world()
    ji, ti = JIndex.build(np.asarray(ref.flat), 16, is_n=ref.is_n), TIndex.build(ref.flat, 16, is_n=ref.is_n, device="cpu")
    ek, ec = tp._kmer_edge_table(torch.from_numpy(reads), torch.from_numpy(lens), 16)
    jek, jec = jp._kmer_edge_table(reads, lens, 16)
    np.testing.assert_array_equal(ek, jek)
    np.testing.assert_array_equal(ec, jec)
    *results, stats = _walks(ji, ti, ek, ec, cases, jp.SvOptions(), tp.SvOptions())
    _same(results)
    assert results[3][0] is not None and results[3][1] is None  # the junction assembles, the decoy does not
    assert 110 <= len(results[3][0][0]) <= 120 and stats["walk_steps"] >= 110  # the insertion, less any junction homology


def _greedy_node(ek, ec, seed, steps, k=16):
    """The k-mer the walk stands on after ``steps`` greedy steps from seed."""
    mask = (1 << (2 * k)) - 1
    cur = seed
    for _ in range(steps):
        keys = ((cur << 2) & (mask << 2)) | np.arange(4, dtype=np.int64)
        i = np.searchsorted(ek, keys).clip(0, len(ek) - 1)
        counts = np.where(ek[i] == keys, ec[i], 0)
        cur = ((cur << 2) | int(counts.argmax())) & mask
    return cur


@pytest.mark.parametrize("steps", [0, 7, 40])
@pytest.mark.parametrize("side", ["below", "above"])
def test_walk_edge_ties_take_the_first_base(steps, side):
    """A sibling edge with the heaviest edge's count, at the seed or deeper
    along the walk: every walk takes the first maximum, so a sibling with a
    smaller base turns the walk and one with a larger base does not."""
    ref, reads, lens, cases = _junction_world()
    ji, ti = JIndex.build(np.asarray(ref.flat), 16, is_n=ref.is_n), TIndex.build(ref.flat, 16, is_n=ref.is_n, device="cpu")
    ek, ec = tp._kmer_edge_table(torch.from_numpy(reads), torch.from_numpy(lens), 16)
    seed = tp._seed_consensus(cases[0][1], 16)
    node = _greedy_node(ek, ec, seed, steps)
    keys = (((node << 2) & (((1 << 32) - 1) << 2))) | np.arange(4, dtype=np.int64)
    i = np.searchsorted(ek, keys).clip(0, len(ek) - 1)
    counts = np.where(ek[i] == keys, ec[i], 0)
    best = int(counts.argmax())
    others = [b for b in range(4) if (b < best if side == "below" else b > best)]
    if not others:
        others = [b for b in range(4) if b != best]
    table = dict(zip(ek.tolist(), ec.tolist()))
    table.update({int(keys[b]): int(counts[best]) for b in others})
    ek2 = np.array(sorted(table), np.int64)
    ec2 = np.array([table[x] for x in ek2.tolist()], np.int64)
    *results, _ = _walks(ji, ti, ek2, ec2, cases[:1], jp.SvOptions(), tp.SvOptions())
    _same(results)


def _fake_index(mod, pos, hit, ref_codes, k=16):
    """An index whose lookup returns crafted hits: the diagonal votes of
    split_place are then the test's to choose."""

    class Fake:
        pass

    f = Fake()
    f.k = k
    f.ref_codes = ref_codes
    if mod is jp:
        f.kmers = np.zeros(1, np.uint64)
        f.lookup = lambda km, max_hits: (pos, hit)
    else:
        f.lookup = lambda km, max_hits: (torch.from_numpy(pos), torch.from_numpy(hit))
    return f


def test_mode_diag_ties():
    """Prefix and suffix diagonal votes with ties built on purpose: equal
    runs (the smaller diagonal wins), singletons (the second smallest wins,
    the vote never takes column 0 alone when a later one exists), a lone
    diagonal, none at all, and random small diagonal sets."""
    rng = np.random.default_rng(5)
    R, L, k, H = 40, 60, 16, 4
    nwin = L - k + 1
    offs = np.arange(nwin)[None, :, None]
    diag = np.full((R, nwin, H), 500, np.int64)
    hit = np.zeros((R, nwin, H), bool)
    crafted = [
        [100, 100, 100, 200, 200, 200],  # equal runs
        [300, 100, 200],  # singletons
        [300, 300, 100, 100, 200],  # two runs of two and a singleton
        [250],  # alone
        [],  # none
    ]
    for r, diags in enumerate(crafted):
        for j, d in enumerate(diags):  # prefix windows 0.. and suffix windows from the end
            diag[r, j, 0], hit[r, j, 0] = d, True
            diag[r, nwin - 1 - j, 1], hit[r, nwin - 1 - j, 1] = d + 7, True
    for r in range(len(crafted), R):
        hit[r] = rng.random((nwin, H)) < 0.3
        diag[r] = rng.choice([100, 101, 150, 400], size=(nwin, H))
    pos = np.where(hit, diag + offs, -1)
    reads = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lens = np.full(R, L, np.int32)
    ref = rng.integers(0, 4, 1000).astype(np.uint8)
    opt = jp.SvOptions(min_run=1)
    want = jp.split_place(_fake_index(jp, pos, hit, ref), reads, lens, opt)
    got = tp.split_place(_fake_index(tp, pos, hit, torch.from_numpy(ref)), reads, lens, tp.SvOptions(min_run=1))
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert got["d_pre"][:4].tolist() == [100, 200, 100, 250] and not got["have_pre"][4]
    assert got["d_suf"][:4].tolist() == [107, 207, 107, 257]


def test_mode_diag_ties_on_a_repeat():
    """Reads whose prefix lies in two copies of a repeat: both packages
    vote the same diagonal."""
    rng = np.random.default_rng(9)
    seg = rng.integers(0, 4, 60).astype(np.uint8)
    flat = np.concatenate([rng.integers(0, 4, 1000), seg, rng.integers(0, 4, 1500), seg, rng.integers(0, 4, 1000)]).astype(np.uint8)
    reads = np.stack([np.concatenate([seg[s:], flat[2620:2700]])[:80] for s in range(20)]).astype(np.uint8)
    lens = np.full(len(reads), 80, np.int32)
    is_n = np.zeros(len(flat), bool)
    want = jp.split_place(JIndex.build(flat, 16, is_n=is_n), reads, lens, jp.SvOptions())
    got = tp.split_place(TIndex.build(flat, 16, is_n=is_n, device="cpu"), reads, lens, tp.SvOptions())
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert want["have_pre"].all()


@pytest.fixture(scope="module")
def paired_store():
    from biograph_tpu.build.readmap_build import build_readmap
    from biograph_tpu.build.seqset_build import build_seqset

    rng = np.random.default_rng(31)
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    codes, lens, mate = _sample_pairs(rng, genome, read_len=50, frag=200, cov=6)
    lens = np.where(rng.random(len(lens)) < 0.3, lens - rng.integers(1, 10, len(lens)), lens).astype(np.int32)
    codes = np.where(np.arange(50)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    mate = mate.copy()
    mate[-6:] = np.arange(len(mate) - 6, len(mate))  # three pairs broken into unpaired reads
    mate = np.where(mate == np.arange(len(mate)), -1, mate)
    js = build_seqset(codes, lens)
    jr = build_readmap(js, codes, lens, mate)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    return jr, tr


def test_reads_from_readmap_paired_whole_and_sliced(paired_store, monkeypatch):
    """``Readmap.forward_reads`` against the JAX package's
    ``reads_from_readmap``, in launches of 97 reads, whole and sliced."""
    from biograph_tpu_torch.index import readmap as treadmap

    jr, tr = paired_store
    monkeypatch.setattr(treadmap, "READ_CHUNK", 97)
    full, lens, mate = tr.forward_reads()
    jfull, jlens, jmate = jp.reads_from_readmap(jr)
    assert full.dtype == jfull.dtype and lens.dtype == jlens.dtype and mate.dtype == np.int64
    np.testing.assert_array_equal(full, jfull)
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_array_equal(mate, np.arange(len(mate)) if jmate is None else jmate)
    assert (mate != np.arange(len(mate))).sum() > 0 and (mate == np.arange(len(mate))).sum() == 6
    R = len(lens)
    parts = []
    for lo, hi in ((0, 0), (0, R // 3), (R // 3, R)):
        c, l, m = tr.forward_reads(read_slice=(lo, hi))
        jc, _, _ = jp.reads_from_readmap(jr, read_slice=(lo, hi))
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(l, lens)
        np.testing.assert_array_equal(m, mate)
        parts.append(c)
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_find_breakpoint_variants_equals_jax():
    """tests/test_sdk_helpers.py's breakpoint world: a 500-base deletion
    between approximate breakpoints, unpaired reads of 100 bases every 3."""
    import biograph_tpu.utils as jutils
    import biograph_tpu_torch.utils as tutils
    from biograph_tpu.build.readmap_build import build_readmap
    from biograph_tpu.build.seqset_build import build_seqset
    from biograph_tpu.index.reference import Contig, Reference

    rng = np.random.default_rng(12345)
    G = 6000
    flat = rng.integers(0, 4, G).astype(np.uint8)
    ref = Reference(flat=flat, is_n=np.zeros(G, bool), contigs=[Contig("chr1", 0, G)])
    donor = np.concatenate([flat[:3000], flat[3500:]])
    codes = np.stack([donor[s : s + 100] for s in range(0, len(donor) - 100, 3)]).astype(np.uint8)
    lens = np.full(len(codes), 100, np.int32)
    js = build_seqset(codes, lens)
    jr = build_readmap(js, codes, lens)

    class JBG:
        seqset, readmap = js, jr

    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")

    class TBG:
        seqset = ts
        readmap = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")

    found = {}
    for span, kw in (((3000, 3500), {}), ((2990, 3510), {"buf_len": 50}), ((100, 900), {})):
        want = jutils.find_breakpoint_variants(JBG, ref, "chr1", *span, **kw)
        got = tutils.find_breakpoint_variants(TBG, _port_ref(ref), "chr1", *span, **kw)
        assert (got.chrom, got.start, got.end, got.variants) == (want.chrom, want.start, want.end, want.variants)
        found[span] = [v["svlen"] for v in got.variants]
    assert found[(3000, 3500)].count(-500) == 1 and found[(100, 900)] == []
    with pytest.raises(ValueError, match="start must be"):
        tutils.find_breakpoint_variants(TBG, _port_ref(ref), "chr1", 10, 10)
