"""Discovery's dense front end and its wavefront without trunc tables, in the
PyTorch port against the JAX package: the same simulated genomes and reads
(numpy seeds) go through both ``discover_variants``, the store and readmap
built by the JAX package and carried across with ``convert``.  The dense
route runs for min_anchor_ctx < 12, or is forced by ``NO_PRESCREEN`` (the
JAX package's BGT_NO_PRESCREEN); the trunc tables go when the memory plan's
budget (``BUDGET_BYTES``, the JAX package's BGT_HBM_BUDGET_BYTES) leaves no
room for them.  Tolerance: exact equality everywhere."""

import numpy as np
import pytest
import torch

from biograph_tpu.build.readmap_build import build_readmap as jax_build_readmap
from biograph_tpu.build.seqset_build import build_seqset as jax_build_seqset
from biograph_tpu.index.reference import Contig as JContig
from biograph_tpu.variants import discover as jdisc
from biograph_tpu_torch import convert
from biograph_tpu_torch.variants import discover as tdisc

G = 6000
KEYS = ("chrom", "pos", "ref", "alt", "support", "ref_support")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor operations: more threads only contend for the
    cores beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_jax_text_hashes():
    """The JAX package caches a text's rolling-hash prefix sums under the
    text's id(), which a later array of the same length can reuse; every
    test starts without them."""
    from biograph_tpu.index import probes as _jprobes

    _jprobes._TEXT_HASH_CACHE.clear()


class _JaxRef:
    def __init__(self, codes):
        self.flat = np.asarray(codes, np.uint8)
        self.is_n = np.zeros(len(codes), bool)
        self.contigs = [JContig(name="chr1", start=0, length=len(codes))]


def _sim(rng, G, snps=(), insertions=(), deletions=()):
    """ref + donor with the planted edits (tests/test_discover.py's
    simulator)."""
    ref = rng.integers(0, 4, size=G, dtype=np.uint8)
    parts = []
    edits = sorted([("S", p, None) for p in snps] + [("I", p, ln) for p, ln in insertions] + [("D", p, ln) for p, ln in deletions], key=lambda e: e[1])
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
    js = jax_build_seqset(codes, lens)
    jr = jax_build_readmap(js, codes, lens)
    arrays = {k: np.asarray(getattr(js, k)) for k in convert.SEQSET_DTYPES}
    arrays.update(n_entries=js.n_entries, max_entry_len=js.max_entry_len)
    ts = convert.seqset_from_numpy(arrays, "cpu")
    tr = convert.readmap_from_numpy({k: np.asarray(getattr(jr, k)) for k in convert.READMAP_DTYPES}, ts, "cpu")
    tref = convert.reference_from_numpy(ref, np.zeros(len(ref), bool), [("chr1", 0, len(ref))])
    return dict(js=js, jr=jr, ts=ts, tr=tr, jref=_JaxRef(ref), tref=tref, ref=ref)


GENOMES = {
    "snps": (100, dict(snps=(900, 2500, 4200))),
    "indels": (101, dict(insertions=((1500, 5),), deletions=((3200, 7),))),
    # tests/test_discover.py::test_discovery_under_tiny_hbm_budget's genome
    "tiny_budget": (99, dict(snps=(900, 2500, 4200), insertions=((3300, 5),), deletions=((1700, 4),))),
}


@pytest.fixture(scope="module")
def worlds():
    made = {}

    def get(name):
        if name not in made:
            seed, edits = GENOMES[name]
            rng = np.random.default_rng(seed)
            ref, donor = _sim(rng, G, **edits)
            made[name] = _world(ref, *_reads_from(donor, rng))
        return made[name]

    return get


def _keyed(records):
    return [tuple(r[k] for k in KEYS) for r in records]


def _both(w, readmap, jopt=None, topt=None, **kw):
    """(port records, JAX records, port stats, JAX stats) of one call."""
    jstats, tstats = {}, {}
    want = jdisc.discover_variants(w["js"], w["jref"], opt=jopt or jdisc.DiscoverOptions(min_alt_support=5), readmap=w["jr"] if readmap else None, stats=jstats, **kw)
    got = tdisc.discover_variants(w["ts"], w["tref"], opt=topt or tdisc.DiscoverOptions(min_alt_support=5), readmap=w["tr"] if readmap else None, stats=tstats, **kw)
    return got, want, tstats, jstats


@pytest.mark.parametrize("readmap", [False, True], ids=["no_readmap", "readmap"])
@pytest.mark.parametrize("ctx", [11, 8])
@pytest.mark.parametrize("name", ["snps", "indels"])
def test_records_at_low_min_anchor_ctx(worlds, name, ctx, readmap):
    w = worlds(name)
    kw = dict(min_alt_support=5, min_anchor_ctx=ctx)
    got, want, tstats, jstats = _both(w, readmap, jdisc.DiscoverOptions(**kw), tdisc.DiscoverOptions(**kw))
    assert got and _keyed(got) == _keyed(want)
    for k in ("anchors_found", "anchors_truncated", "assemblies_truncated"):
        assert tstats[k] == jstats[k], k
    assert "prescreen_probed" not in tstats
    assert set(tstats["stage_s"]) >= {"probe_dispatch", "probe_masks", "probe_filter", "probe_exact", "anchors", "wavefront", "extract"}
    edits = GENOMES[name][1]
    assert {r["pos"] for r in got} >= {p + 1 for p in edits.get("snps", ())}


@pytest.mark.parametrize("readmap", [False, True], ids=["no_readmap", "readmap"])
def test_dense_route_forced_at_the_defaults(worlds, monkeypatch, readmap):
    """tests/test_discover.py::test_prescreen_identity in both packages: the
    dense route at the default options gives the prescreened records, and
    JAX's dense records."""
    w = worlds("indels")
    prescreened = tdisc.discover_variants(w["ts"], w["tref"], opt=tdisc.DiscoverOptions(min_alt_support=5), readmap=w["tr"] if readmap else None)
    monkeypatch.setattr(tdisc, "NO_PRESCREEN", True)
    monkeypatch.setenv("BGT_NO_PRESCREEN", "1")
    assert not tdisc.use_prescreen(tdisc.DiscoverOptions()) and not jdisc.use_prescreen(jdisc.DiscoverOptions())
    got, want, tstats, _ = _both(w, readmap)
    assert got and _keyed(got) == _keyed(prescreened) == _keyed(want)
    assert "probe_dispatch" in tstats["stage_s"] and "prescreen_probed" not in tstats


def _jax_dense_probes(w, opt, monkeypatch):
    """The JAX package's per-batch probe arrays after waves 1-5, taken where
    its dense route hands them to ``_discover_finish``."""
    seen = {}

    def grab(ss, reference, ref, ref2, ref2_dev, batches, probe_h, *a, **kw):
        seen["batches"] = [b[:5] for b in batches]
        seen["P"] = batches[0][5]
        seen["probes"] = [tuple(np.asarray(x) for x in h[:3]) for h in probe_h]
        return []

    monkeypatch.setattr(jdisc, "_discover_finish", grab)
    jdisc.discover_variants(w["js"], w["jref"], opt=opt)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("ctx", [11, 8])
def test_each_batch_after_waves_1_to_5(worlds, monkeypatch, ctx):
    w = worlds("indels")
    want = _jax_dense_probes(w, jdisc.DiscoverOptions(min_anchor_ctx=ctx), monkeypatch)
    opt = tdisc.DiscoverOptions(min_anchor_ctx=ctx)
    batches, P = tdisc._dense_batches(tdisc._segments(opt, 0, G, G), opt, 0, G)
    assert batches == want["batches"] and P == want["P"] == 8192 and len(batches) == 2
    ref2 = torch.from_numpy(np.concatenate([w["ref"], (3 - w["ref"][::-1]).astype(np.uint8)]))
    stage_s = {}
    got = tdisc._dense_probes(w["ts"].d, ref2, batches, P, opt, tdisc._StageClock(ref2.device, stage_s))
    assert set(stage_s) == {"probe_dispatch", "probe_masks", "probe_filter", "probe_exact"}
    for (b, e, s), (jb, je, js) in zip(got, want["probes"]):
        assert b.dtype == e.dtype == torch.int64 and s.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), jb)
        np.testing.assert_array_equal(e.numpy(), je)
        np.testing.assert_array_equal(s.numpy(), js)
    # the exact recompute moved some lanes past their restart chain's state
    from biograph_tpu_torch.index import probes as tprobes

    chain = tprobes.probe_ranges(w["ts"].d, ref2, batches[0][2], 0, P, opt.probe_ctx)
    assert (got[0][2] != chain[2]).any()


def test_discovery_without_trunc_tables(worlds, monkeypatch):
    """tests/test_discover.py::test_discovery_under_tiny_hbm_budget in both
    packages: at a 64 KiB budget the plan drops the trunc tables and the
    shared span table, and the records equal the port's with the tables and
    the JAX package's at BGT_HBM_BUDGET_BYTES=65536."""
    w = worlds("tiny_budget")
    opt = tdisc.DiscoverOptions(min_alt_support=5)
    base_stats = {}
    base = tdisc.discover_variants(w["ts"], w["tref"], opt=opt, readmap=w["tr"], stats=base_stats)
    assert base_stats["memory_plan"]["use_trunc_tables"]
    monkeypatch.setattr(tdisc, "BUDGET_BYTES", 1 << 16)
    monkeypatch.setenv("BGT_HBM_BUDGET_BYTES", str(1 << 16))
    calls = []
    truncate = type(w["ts"].d).truncate_ranges
    monkeypatch.setattr(type(w["ts"].d), "truncate_ranges", lambda self, r, m: calls.append(m) or truncate(self, r, m))
    got, want, tstats, jstats = _both(w, True)
    plan = tstats["memory_plan"]
    assert not plan["use_trunc_tables"] and plan["span_table_cap"] == 0 and plan["budget_bytes"] == 1 << 16
    assert not jstats["memory_plan"]["use_trunc_tables"] and jstats["memory_plan"]["span_table_cap"] == 0
    assert calls and set(calls) == {opt.probe_ctx}  # every beam step truncated through the LtSearch
    assert got and _keyed(got) == _keyed(base) == _keyed(want)
    # the dense route without the tables, too
    monkeypatch.setattr(tdisc, "NO_PRESCREEN", True)
    assert _keyed(tdisc.discover_variants(w["ts"], w["tref"], opt=opt, readmap=w["tr"])) == _keyed(base)


def test_wavefront_steps_without_trunc_tables(worlds):
    """Beam steps truncating through truncate_ranges give the state the
    trunc tables give, step for step."""
    w = worlds("snps")
    opt = tdisc.DiscoverOptions()
    ref2 = torch.from_numpy(np.concatenate([w["ref"], (3 - w["ref"][::-1]).astype(np.uint8)]))
    stats = {"anchors_found": 0, "anchors_truncated": 0}
    parts, _ = tdisc._find_anchors(w["ts"], ref2, tdisc._segments(opt, 0, G, G), opt, stats, tdisc._StageClock(ref2.device, {}), G)
    d = w["ts"].d
    states = []
    for trunc in (tdisc._trunc_tables(w["ts"], opt.probe_ctx), (None, None)):
        c = tdisc._asm_start(d, parts[False], opt, G, ref2)
        for _ in range(40):
            c["st"] = tdisc._wavefront_body(d, c["packed"], *trunc, c["n_packed"], c["st"], c["step"], c["MAXP"], c["k"], c["min_w"], c["probe_ctx"], c["pos_bits"])
            c["step"] += 1
            states.append(c["st"])
    half = len(states) // 2
    for a, b in zip(states[:half], states[half:]):
        for name in a:
            assert torch.equal(a[name], b[name]), name
    assert (states[-1]["size"] == opt.probe_ctx).any()
