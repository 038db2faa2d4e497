"""Variant discovery of the PyTorch port against the JAX package, without a
readmap: the same simulated genomes and reads (numpy seeds) go through both
``discover_variants``, the seqset built by the JAX package and carried
across with ``convert.seqset_from_numpy``; then the stages one by one
(prescreen, anchors, span tables, one beam step, the assembled paths).
Tolerance: exact equality everywhere."""

import unittest.mock as mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index.reference import Contig as JContig
from biograph_tpu.variants import discover as jdisc
from biograph_tpu_torch import convert
from biograph_tpu_torch.variants import discover as tdisc

G = 6000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is many small tensor operations; run
    beside other test workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_jax_text_hashes():
    """The JAX package caches a text's rolling-hash prefix sums under the
    text's id(), which a later array of the same length can reuse: its CPU
    discovery would then filter with another genome's hashes.  Every test
    starts without them."""
    from biograph_tpu.index import probes as _jprobes

    _jprobes._TEXT_HASH_CACHE.clear()


class _JaxRef:
    def __init__(self, codes):
        self.flat = np.asarray(codes, np.uint8)
        self.is_n = np.zeros(len(codes), bool)
        self.contigs = [JContig(name="chr1", start=0, length=len(codes))]


def _sim(rng, G, snps=(), insertions=(), deletions=()):
    """ref + donor with the planted edits (the simulator of
    tests/test_discover.py)."""
    ref = rng.integers(0, 4, size=G, dtype=np.uint8)
    parts = []
    edits = [("S", p, None) for p in snps] + [("I", p, ln) for p, ln in insertions] + [("D", p, ln) for p, ln in deletions]
    edits.sort(key=lambda e: e[1])
    prev = 0
    for kind, p, ln in edits:
        parts.append(ref[prev:p])
        if kind == "S":
            parts.append(np.array([(ref[p] + 1 + rng.integers(0, 3)) % 4], np.uint8))
            prev = p + 1
        elif kind == "I":
            parts += [np.array([ref[p]], np.uint8), rng.integers(0, 4, size=ln, dtype=np.uint8)]
            prev = p + 1
        else:
            parts.append(np.array([ref[p]], np.uint8))
            prev = p + 1 + ln
    parts.append(ref[prev:])
    return ref, np.concatenate(parts)


def _reads_from(donor, rng, L=40, coverage=30):
    n = int(len(donor) * coverage / L)
    starts = rng.integers(0, len(donor) - L, size=n)
    codes = np.stack([donor[s : s + L] for s in starts])
    codes[: n // 2] = (3 - codes[: n // 2])[:, ::-1]
    return codes, np.full(n, L, np.int32)


def _world(ref, codes, lens):
    """The store in both packages, and the reference for both."""
    js = jax_build_seqset(codes, lens)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tref = convert.reference_from_numpy(ref, np.zeros(len(ref), bool), [("chr1", 0, len(ref))])
    return dict(js=js, ts=ts, jref=_JaxRef(ref), tref=tref, ref=ref)


GENOMES = {
    "snps": dict(snps=(900, 2500, 4200)),
    "indels": dict(insertions=((1500, 5),), deletions=((3200, 7),)),
    "mixed": dict(snps=(700, 1900, 5200), insertions=((1200, 4), (3900, 11)), deletions=((4600, 5),)),
    "clean": dict(),
}


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(name):
        if name not in made:
            rng = np.random.default_rng(sorted(GENOMES).index(name) + 99)
            ref, donor = _sim(rng, G, **GENOMES[name])
            made[name] = _world(ref, *_reads_from(donor, rng))
        return made[name]

    return get


KEYS = ("chrom", "pos", "ref", "alt", "support", "ref_support")


def _keyed(records):
    return [tuple(r[k] for k in KEYS) for r in records]


@pytest.mark.parametrize("name", sorted(GENOMES))
def test_records_identical_without_a_readmap(worlds, name):
    w = worlds(name)
    jstats, tstats = {}, {}
    want = jdisc.discover_variants(w["js"], w["jref"], opt=jdisc.DiscoverOptions(min_alt_support=5), stats=jstats)
    got = tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(min_alt_support=5), stats=tstats)
    assert _keyed(got) == _keyed(want)
    edits = GENOMES[name]
    if name == "clean":
        assert got == []
    else:
        assert {r["pos"] for r in got} >= {p + 1 for p in edits.get("snps", ())}
        assert {len(r["alt"]) - len(r["ref"]) for r in got} >= {ln for _, ln in edits.get("insertions", ())} | {-ln for _, ln in edits.get("deletions", ())}
    for k in ("anchors_found", "anchors_truncated", "assemblies_truncated", "prescreen_probed"):
        assert tstats[k] == jstats[k], k
    # the plan budgets what the port's engine holds, not the JAX layout
    plan, ts = tstats["memory_plan"], w["ts"]
    held = [ts.d.fixed, ts.d.rank_blocks, ts.d.entry_sizes, ts.d.shared, ts.d.pop_sel, ts.prev_words, ts.prev_cum]
    lt = ts.d.shared_lt  # counted whether or not a query has built it
    held += [lt.values, lt.block_min, lt.levels]
    assert plan["core_bytes"] == sum(t.numel() * t.element_size() for t in held) + 4**12
    assert plan["trunc_bytes"] == 16 * ts.n_entries and plan["ref2_bytes"] == 2 * G
    assert plan["use_trunc_tables"] and plan["span_table_cap"] == tdisc.SPAN_TABLE_CAP
    assert set(tstats["stage_s"]) == {"probe_filter", "probe_exact", "anchors", "wavefront", "extract"}


def test_region_and_single_orientation_records_identical(worlds):
    w = worlds("mixed")
    for kw in (dict(region=(1000, 4200)), dict(opt_kw=dict(skip_trace_rev=True)), dict(opt_kw=dict(skip_trace_fwd=True), region=(0, 3000))):
        opt_kw = kw.pop("opt_kw", {})
        want = jdisc.discover_variants(w["js"], w["jref"], opt=jdisc.DiscoverOptions(**opt_kw), **kw)
        got = tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(**opt_kw), **kw)
        assert got and _keyed(got) == _keyed(want)
    assert tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(skip_trace_fwd=True, bidir=False)) == []


def test_small_groups_caps_and_an_empty_region(worlds):
    """Several beam groups an orientation give the records of one; the
    assembly cap cuts where the JAX package cuts; the anchor cap counts what
    it drops; a region whose hits all lack context runs no lane."""
    w = worlds("mixed")
    full = tdisc.discover_variants(w["ts"], w["tref"])
    with mock.patch.object(tdisc, "WAVE_LANES", 2), mock.patch.object(jdisc, "WAVE_LANES", 2):
        stats = {}
        got = tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(beam_width=2), stats=stats)
        assert _keyed(got) == _keyed(full) and stats["wave_steps"] > 96 * 2  # more than one group a side
        jstats, tstats = {}, {}
        kw = dict(beam_width=2, max_assemblies=2)
        with pytest.warns(UserWarning, match="assembly cap 2 hit"):
            got = tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(**kw), stats=tstats)
        with pytest.warns(UserWarning, match="assembly cap 2 hit"):
            want = jdisc.discover_variants(w["js"], w["jref"], opt=jdisc.DiscoverOptions(**kw), stats=jstats)
        assert _keyed(got) == _keyed(want) and 0 < len(got) < len(full)
        assert tstats["assemblies_truncated"] == jstats["assemblies_truncated"] > 0
    with mock.patch.object(tdisc, "MAXA", 4), pytest.warns(UserWarning, match="anchors over the 4 cap"):
        stats = {}
        tdisc.discover_variants(w["ts"], w["tref"], stats=stats)
    assert stats["anchors_found"] == 12 and stats["anchors_truncated"] == 8
    assert tdisc.discover_variants(w["ts"], w["tref"], region=(0, 15)) == jdisc.discover_variants(w["js"], w["jref"], region=(0, 15)) == []


def test_options_field_for_field():
    jopt, topt = jdisc.DiscoverOptions(), tdisc.DiscoverOptions()
    assert vars(jopt) == vars(topt)
    assert (tdisc.MAXA, tdisc.CHECK_EVERY, tdisc.WAVE_LANES, tdisc.WAVE_COMPACT_MIN, tdisc.SPAN_TABLE_CAP) == (
        jdisc.MAXA, jdisc.CHECK_EVERY, jdisc.WAVE_LANES, jdisc.WAVE_COMPACT_MIN, jdisc.SPAN_TABLE_CAP)


def test_span_kmers_rejects_k_over_31():
    with pytest.raises(ValueError, match="31 bases"):
        tdisc._span_kmers_dev(torch.zeros(100, dtype=torch.uint8), 0, 100, 64, 32)


# ---------------------------------------------------------------------------
# stage by stage
# ---------------------------------------------------------------------------


def _ref2(ref):
    return np.concatenate([ref, (3 - ref[::-1]).astype(np.uint8)])


def test_prescreen_bitmap_and_hit_positions(worlds):
    w = worlds("mixed")
    ref2 = _ref2(w["ref"])
    jbm = jdisc._prescreen_bitmap_jit(w["js"].d)
    tbm = tdisc._prescreen_bitmap(w["ts"])
    assert tbm.dtype == torch.uint8 and tbm.shape == (1 << 24,)
    np.testing.assert_array_equal(tbm.numpy(), np.asarray(jbm))
    assert w["ts"].__dict__["_prescreen_bitmap"] is tbm and tdisc._prescreen_bitmap(w["ts"]) is tbm  # on the instance
    thit = tdisc._hit_mask(tbm, torch.from_numpy(ref2))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jdisc._hit_mask(jbm, jnp.asarray(ref2))))
    n_hits = int(thit.sum())
    assert n_hits == int(jdisc._hit_count(jbm, jnp.asarray(ref2))) and 0 < n_hits < len(ref2)
    for Pc in (1024, 16384, 1 << 15):  # fewer than the hits, and more (padded with -1)
        want = np.asarray(jdisc._hit_positions_jit(jbm, jnp.asarray(ref2), Pc))
        np.testing.assert_array_equal(tdisc._hit_positions(thit, Pc).numpy(), want)


def _jax_anchors(w, opt, monkeypatch):
    """The anchors the JAX package's front end hands to its wavefront, by
    orientation, taken where ``_discover_compact`` passes them on."""
    seen = {}

    def grab(ss, reference, ref, ref2, ref2_dev, opt, stats, stage_s, anchor_parts, *a, **kw):
        seen["parts"] = {half: tuple(np.concatenate(cols) for cols in zip(*parts)) for half, parts in anchor_parts.items()}
        seen["prescreen"] = kw["prescreen"]
        return []

    monkeypatch.setattr(jdisc, "_finish_from_anchors", grab)
    jdisc.discover_variants(w["js"], w["jref"], opt=opt)
    monkeypatch.undo()
    return seen["parts"], np.asarray(seen["prescreen"]["pos"])


def _port_anchors(w, opt):
    ref2_dev = torch.from_numpy(_ref2(w["ref"]))
    stats = {"anchors_found": 0, "anchors_truncated": 0}
    parts, hit_pos = tdisc._find_anchors(
        w["ts"], ref2_dev, tdisc._segments(opt, 0, G, G), opt, stats, tdisc._StageClock(ref2_dev.device, {}), G
    )
    return parts, hit_pos, stats


def _sorted_columns(cols):
    cols = np.stack([np.asarray(c, np.int64) for c in cols])
    return cols[:, np.lexsort(cols[::-1])]


@pytest.mark.parametrize("name", ["mixed", "indels"])
def test_anchors_identical_after_sorting(worlds, monkeypatch, name):
    """The five anchor columns, by orientation.  Sorted, since the JAX CPU
    route compacts its lanes to the filter's survivors and the port runs
    every prescreened lane."""
    w = worlds(name)
    want, jpos = _jax_anchors(w, jdisc.DiscoverOptions(), monkeypatch)
    got, tpos, stats = _port_anchors(w, tdisc.DiscoverOptions())
    assert set(got) == set(want) == {False, True}
    for half in (False, True):
        np.testing.assert_array_equal(_sorted_columns(got[half]), _sorted_columns(want[half]))
        assert (np.asarray(got[half][0]) >= G).all() == half
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    assert stats["anchors_found"] == sum(len(p[0]) for p in got.values()) > 0


def _as_int64_table(x):
    """A JAX span-table column (uint64, all-ones pads) as the port carries
    it (int64, the largest int64 as the pad)."""
    x = np.asarray(x)
    out = x.view(np.int64).copy()
    out[x == np.uint64(0xFFFFFFFFFFFFFFFF)] = np.iinfo(np.int64).max
    return out


@pytest.mark.parametrize("lo,span_len,npk,k", [(0, G, 16384, 23), (1234, 700, 16384, 23), (G, G, 16384, 12), (5000, 90, 1024, 31), (0, 10, 64, 23)])
def test_span_kmers_dev(worlds, lo, span_len, npk, k):
    ref2 = _ref2(worlds("mixed")["ref"])
    jK, jkey2 = jdisc._span_kmers_dev(jnp.asarray(ref2), jnp.asarray(lo, jnp.int64), jnp.asarray(span_len, jnp.int64), npk, k)
    tK, tkey2 = tdisc._span_kmers_dev(torch.from_numpy(ref2), lo, span_len, npk, k)
    assert tK.dtype == tkey2.dtype == torch.int64
    np.testing.assert_array_equal(tK.numpy(), _as_int64_table(jK))
    np.testing.assert_array_equal(tkey2.numpy(), _as_int64_table(jkey2))
    assert bool((tK[1:] >= tK[:-1]).all()) and bool((tkey2[1:] >= tkey2[:-1]).all())  # the pad sorts last


@pytest.mark.parametrize("lo,span_len,k", [(0, G, 23), (2000, 1500, 23), (G + 10, G - 10, 12)])
def test_span_kmers_compact_dev(worlds, lo, span_len, k):
    w = worlds("mixed")
    ref2 = _ref2(w["ref"])
    thit = tdisc._hit_mask(tdisc._prescreen_bitmap(w["ts"]), torch.from_numpy(ref2))
    pos = tdisc._hit_positions(thit, 16384)
    pos_abs = (pos - (k - 1)).numpy()  # pads and early hits go negative
    jK, jkey2, jn = jdisc._span_kmers_compact_dev(
        jnp.asarray(ref2), jnp.asarray(lo, jnp.int64), jnp.asarray(span_len, jnp.int64), len(pos_abs), k, pos_abs=jnp.asarray(pos_abs)
    )
    tK, tkey2, tn = tdisc._span_kmers_compact_dev(torch.from_numpy(ref2), lo, span_len, k, torch.from_numpy(pos_abs))
    np.testing.assert_array_equal(tK.numpy(), _as_int64_table(jK))
    np.testing.assert_array_equal(tkey2.numpy(), _as_int64_table(jkey2))
    assert int(tn) == int(jn) > 0


def _state_to_numpy(st):
    out = {}
    for name, v in st.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[name] = v.view(np.int64) if v.dtype == np.uint64 else v
    return out


def _assert_states_equal(tst, jst):
    tst, jst = _state_to_numpy(tst), _state_to_numpy(jst)
    assert set(tst) == set(jst)
    for name in jst:
        assert tst[name].dtype == jst[name].dtype or name in ("roll",), name
        np.testing.assert_array_equal(tst[name], jst[name], err_msg=name)


def test_wavefront_seed_and_body_steps(worlds):
    """The seed from real anchors, then beam steps on a state whose policy,
    junction counts, done flags and rejoin floors were redrawn at random, in
    both packages: every tensor of the state after every step."""
    w = worlds("mixed")
    opt = tdisc.DiscoverOptions()
    parts, _, _ = _port_anchors(w, opt)
    a_pos, ab, a_begin, a_end, a_size = parts[False]
    rng = np.random.default_rng(17)
    A = 128
    pick = rng.integers(0, len(a_pos), A)
    MAXP, k = 40, opt.rejoin_k
    ref2 = _ref2(w["ref"])
    lo = int(a_pos.min())
    seed = dict(
        begin=a_begin[pick], end=a_end[pick], size=a_size[pick].astype(np.int32), ab=ab[pick].astype(np.int32),
        policy=rng.integers(0, 8, A).astype(np.int32), min_local=(a_pos[pick] - lo + 1).astype(np.int64),
    )
    seed["end"][:5] = seed["begin"][:5]  # dead on arrival
    jst = jdisc._wavefront_seed(w["js"].d, {n: jnp.asarray(v) for n, v in seed.items()}, MAXP)
    tseed = {n: torch.from_numpy(v.astype(np.int64) if n == "ab" else v) for n, v in seed.items()}
    tst = tdisc._wavefront_seed(w["ts"].d, tseed, MAXP)
    _assert_states_equal(tst, jst)
    npk = 16384
    span_len = G - lo
    jtab = jdisc._span_kmers_dev(jnp.asarray(ref2), jnp.asarray(lo, jnp.int64), jnp.asarray(span_len, jnp.int64), npk, k)
    ttab = tdisc._span_kmers_dev(torch.from_numpy(ref2), lo, span_len, npk, k)
    n_packed = span_len - k + 1
    jtr, ttr = jdisc._trunc_tables(w["js"], opt.probe_ctx), tdisc._trunc_tables(w["ts"], opt.probe_ctx)
    for step_i in range(1, 36):
        if step_i == 8:  # redraw what a longer run would have made of the lanes
            redraw = dict(
                n_junction=rng.integers(0, 4, A).astype(np.int32), done=rng.random(A) < 0.2,
                min_local=rng.integers(0, span_len, A).astype(np.int64),
            )
            jst = {**jst, **{n: jnp.asarray(v) for n, v in redraw.items()}}
            tst = {**tst, **{n: torch.from_numpy(v) for n, v in redraw.items()}}
        jst = jdisc._wavefront_body(w["js"].d, jtab, jtr[0], jtr[1], jnp.asarray(n_packed, jnp.int64), jst, jnp.int32(step_i), MAXP, k, 1, opt.probe_ctx, False, 18)
        tst = tdisc._wavefront_body(w["ts"].d, ttab, ttr[0], ttr[1], n_packed, tst, step_i, MAXP, k, 1, opt.probe_ctx, 18)
        _assert_states_equal(tst, jst)
    assert bool((tst["rejoin"] >= 0).any()) and bool(tst["done"].all() or (tst["path_len"] > 30).any())


def test_compaction_keeps_the_state(worlds):
    """A driven group whose state is shrunk along the way ends as one that
    never was: done-lane compaction changes no lane."""
    w = worlds("mixed")
    opt = tdisc.DiscoverOptions(max_path=60)
    parts, _, _ = _port_anchors(w, opt)
    ref2_dev = torch.from_numpy(_ref2(w["ref"]))
    d = w["ts"].d
    trunc = tdisc._trunc_tables(w["ts"], opt.probe_ctx)
    # many copies of the SNP anchors (done first), a few of the short indels,
    # one of the long insertion: the live lanes fall by 4x or more twice
    a_pos = parts[False][0]
    copies = np.where(np.isin(a_pos, [699, 1899, 5199]), 20, np.where(a_pos == 3900, 1, 4))
    anchors = tuple(np.repeat(x, copies) for x in parts[False])
    assert sorted(set(copies)) == [1, 4, 20]
    finished = []
    for compact_min, every in ((tdisc.WAVE_COMPACT_MIN, tdisc.CHECK_EVERY), (2, 3)):
        with mock.patch.object(tdisc, "WAVE_COMPACT_MIN", compact_min), mock.patch.object(tdisc, "CHECK_EVERY", every):
            c = tdisc._asm_start(d, anchors, opt, G, ref2_dev)
            stats = {}
            tdisc._drive(d, c, trunc, stats)
            asms, ok, branchy = tdisc._asm_finish(c)
        finished.append((stats.get("wave_compactions", 0), [(a.anchor, a.rejoin, a.seq.tobytes(), a.support) for a in asms], ok, branchy))
    assert finished[0][0] == 0 and finished[1][0] >= 2  # shrunk, and shrunk again
    assert finished[0][1:] == finished[1][1:] and finished[0][1]


@pytest.fixture(scope="module")
def decoy_world():
    """The donor of tests/test_discover.py::test_branch_retry_rescues_beam_misses:
    decoy haplotype families share the alt path past a SNP and are WIDER
    than the true continuation, so a width-1 beam dead-ends."""
    rng = np.random.default_rng(5)
    G4, X, L = 4000, 2000, 40
    ref = rng.integers(0, 4, G4, dtype=np.uint8)
    donor = ref.copy()
    donor[X] = (donor[X] + 1) % 4
    codes, lens = _reads_from(donor, rng, L=L, coverage=25)
    fams = []
    for j in (4, 8, 12):
        hap = np.concatenate([donor[X - 80 : X + j + 1], rng.integers(0, 4, 80, dtype=np.uint8)])
        rows = np.stack([hap[s : s + L] for s in range(0, len(hap) - L, 1)]).copy()
        rows[: len(rows) // 2] = (3 - rows[: len(rows) // 2])[:, ::-1]
        fams.append(rows)
    codes2 = np.concatenate([codes] + fams).astype(np.uint8)
    lens2 = np.concatenate([lens, np.full(sum(len(f) for f in fams), L, np.int32)])
    return dict(_world(ref, codes2, lens2), X=X, G=G4)


@pytest.mark.parametrize("retries", [0, 1])
def test_wavefront_assemble_with_and_without_the_branch_retry(decoy_world, retries):
    """The assembled paths of the forward orientation from the same anchors
    in both packages; the retry round rescues the SNP the width-1 beam
    misses."""
    w = decoy_world
    G4, X = w["G"], w["X"]
    kw = dict(min_alt_support=5, branch_clones=1, branch_retry_rounds=retries, skip_trace_rev=True)
    topt = tdisc.DiscoverOptions(**kw)
    ref2 = _ref2(w["ref"])
    ref2_dev = torch.from_numpy(ref2)
    stats = {"anchors_found": 0, "anchors_truncated": 0, "assemblies_truncated": 0}
    parts, hit_pos = tdisc._find_anchors(w["ts"], ref2_dev, tdisc._segments(topt, 0, G4, G4), topt, stats, tdisc._StageClock(ref2_dev.device, {}), G4)
    anchors = parts[False]
    got = tdisc.wavefront_assemble(w["ts"], anchors, topt, ref2_dev, hit_pos, stats=stats, ref_limit=G4)
    jstats = {"assemblies_truncated": 0}
    want = jdisc.wavefront_assemble(
        w["js"], ref2, anchors, jdisc.DiscoverOptions(**kw), stats=jstats, ref_limit=G4,
        ref_dev=jnp.asarray(ref2), prescreen={"pos": jnp.asarray(hit_pos.numpy())},
    )
    flat = lambda asms: [(a.chunk_start, a.anchor, a.rejoin, a.seq.tobytes(), a.support, a.ref_support) for a in asms]
    assert flat(got) == flat(want) and bool(got) == bool(retries)
    assert stats.get("branch_retry_rescued", 0) == jstats.get("branch_retry_rescued", 0)
    assert (stats.get("branch_retry_rescued", 0) >= 1) == bool(retries)
    recs = tdisc.extract_variants(got, w["ref"], w["tref"], topt, device="cpu")
    assert any(r["pos"] == X + 1 for r in recs) == bool(retries)
    jrecs = jdisc.extract_variants(want, w["ref"], w["jref"], jdisc.DiscoverOptions(**kw))
    assert _keyed(recs) == _keyed(jrecs)
