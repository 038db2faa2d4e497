"""The port's entry-sharded seqset (``biograph_tpu_torch/parallel/``) in one
process, against the JAX package's and against the port's single-device
engine, on the CPU.

The worlds are those of ``tests/test_sharded_wavefront.py`` (a 2 kb genome,
rows of 50 every 3 bases) and ``tests/test_sharded.py`` (60 random reads of
30); the port builds the seqset and the JAX package's sharded functions are
given the same arrays.  A process holding S shards sums them itself (no
process group): ``ShardedRankArrays.build`` array for array, the collective
rank and entry_push_front against JAX ``make_sharded_rank`` on the 8-device
mesh, ``make_sharded_seqset_ops`` against JAX's on a (1, 4) mesh and the
single device in every lane, the shard-local device's primitives against
``_SeqsetDevice``, and ``initialize`` / ``global_mesh`` at one process.
``tests/test_torch_parallel_mp.py`` holds the runs over processes.
Tolerance: exact equality everywhere.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from biograph_tpu.parallel import distributed as jdist
from biograph_tpu.parallel import sharded_seqset as jss
from biograph_tpu_torch.build.seqset_build import build_seqset
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.index.seqset import SeqsetRanges
from biograph_tpu_torch.parallel import distributed as tdist
from biograph_tpu_torch.parallel import sharded_seqset as tss
from biograph_tpu_torch.parallel.mesh import Mesh, make_mesh
from biograph_tpu_torch.parallel.sharded_discovery import ShardedDiscoveryEngine, _ShardLocalDevice
from biograph_tpu_torch.variants import discover as tdisc


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wave():
    """The world of tests/test_sharded_wavefront.py: (seqset, reference)."""
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 2000).astype(np.uint8)
    donor = ref.copy()
    donor[1000] = (donor[1000] + 1) % 4
    codes = np.stack([donor[s : s + 50] for s in range(0, len(donor) - 50, 3)]).astype(np.uint8)
    return build_seqset(codes, np.full(len(codes), 50, np.int32), device="cpu"), ref


@pytest.fixture(scope="module")
def small():
    """The world of tests/test_sharded.py: (seqset, codes, lengths)."""
    rng = np.random.default_rng(5)
    reads = ["".join(rng.choice(list("ACGT"), size=30)) for _ in range(60)]
    codes = np.stack([dna.seq_to_codes(r) for r in reads]).astype(np.uint8)
    lens = np.full(len(reads), 30, np.int32)
    return build_seqset(codes, lens, device="cpu"), codes, lens


def _jax_fields(ss):
    """The seqset's arrays as the JAX package's ShardedRankArrays.build
    reads them (words as uint32)."""
    return SimpleNamespace(
        prev_words=ss.prev_words.numpy().view(np.uint32), fixed=ss.fixed.numpy(), n_entries=ss.n_entries,
        shared=ss.shared.numpy(), entry_sizes=ss.entry_sizes.numpy(), pop_sel=ss.pop_sel.numpy(),
    )


def _np(t):
    return np.asarray(t.cpu().numpy() if torch.is_tensor(t) else t)


def _ranges_from_reads(ss, rng, B=32, plen=12):
    """Ranges of random entries' prefixes (tests/test_sharded_wavefront.py)."""
    ids = torch.from_numpy(rng.integers(0, ss.n_entries, B))
    return ss.d.find(ss.d.sequences(ids, plen), torch.full((B,), plen, dtype=torch.int32))


def _same(got, want, what):
    for name, g, w in zip(("begin", "end", "size"), got, want):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{what}: {name}")


@pytest.mark.parametrize("S", [1, 3, 4, 8])
def test_rank_arrays_equal_jax(wave, S):
    """ShardedRankArrays.build array for array the JAX package's, S dividing
    the word count or not; a subset of shards is the same rows."""
    ss, _ = wave
    want = jss.ShardedRankArrays.build(_jax_fields(ss), S)
    got = tss.ShardedRankArrays.build(ss, S)
    np.testing.assert_array_equal(_np(got.words).view(np.uint32), want.words)
    for name in ("cum", "lo", "fixed", "shared", "sizes", "pop_sel", "elo"):
        a, b = _np(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.cum.dtype == torch.int64 and got.n_entries == want.n_entries
    sub = list(range(S // 2, S))
    part = tss.ShardedRankArrays.build(ss, S, shards=sub)
    for name in ("words", "cum", "lo", "shared", "sizes", "pop_sel", "elo"):
        np.testing.assert_array_equal(_np(getattr(part, name)), _np(getattr(got, name))[sub], err_msg=name)


def _rank_positions(arrays, n):
    """0, lo +- 1 of every shard, 32 R and n_entries."""
    R = arrays.words.shape[2]
    lo = _np(arrays.lo)
    pos = {0, 32 * R, n}
    for x in lo:
        pos |= {int(x) - 1, int(x), int(x) + 1}
    return np.array(sorted(p for p in pos if p >= 0), np.int64)


@pytest.mark.parametrize("S", [3, 8])
def test_sharded_rank_equals_jax_and_single_device(wave, S):
    """The collective rank with S local shards: equal to JAX make_sharded_rank
    on the conftest's 8-device mesh (S = 8) and to the single device."""
    ss, _ = wave
    arrays = tss.ShardedRankArrays.build(ss, S)
    rank = tss.make_sharded_rank(arrays)
    pos = _rank_positions(arrays, ss.n_entries)
    assert len(pos) >= 3 * S
    if S == 8:
        jarr = jss.ShardedRankArrays.build(_jax_fields(ss), S)
        jrank = jss.make_sharded_rank(JMesh(np.array(jax.devices()[:8]), ("model",)), "model")
    for b in range(4):
        bb = np.full(len(pos), b, np.int64)
        got = _np(rank(torch.from_numpy(bb), torch.from_numpy(pos)))
        np.testing.assert_array_equal(got, _np(ss.d.rank(torch.from_numpy(bb), torch.from_numpy(pos))), err_msg=f"base {b}")
        if S == 8:
            want = jrank(jnp.asarray(jarr.words), jnp.asarray(jarr.cum), jnp.asarray(jarr.lo), jnp.asarray(bb.astype(np.int32)), jnp.asarray(pos))
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"base {b}")


def test_sharded_entry_push_front_chain(small):
    """find_existing's chain of entry_push_front through the collective rank
    over 8 local shards (tests/test_sharded.py), equal to the JAX
    package's sharded chain and to the single device."""
    ss, codes, lens = small
    arrays = tss.ShardedRankArrays.build(ss, 8)
    rank = tss.make_sharded_rank(arrays)
    jarr = jss.ShardedRankArrays.build(_jax_fields(ss), 8)
    jrank = jss.make_sharded_rank(JMesh(np.array(jax.devices()[:8]), ("model",)), "model")
    B, L = codes.shape
    entry = torch.zeros(B, dtype=torch.int64)
    jentry = jnp.zeros((B,), jnp.int64)
    for i in range(L):
        pos = lens - 1 - i
        bidx = codes[np.arange(B), np.maximum(pos, 0)].astype(np.int64)
        nxt = tss.sharded_entry_push_front(rank, arrays, entry, bidx)
        entry = torch.where(torch.from_numpy(pos >= 0), nxt, entry)
        jnxt = jss.sharded_entry_push_front(jrank, jarr, jentry, jnp.asarray(bidx.astype(np.int32)))
        jentry = jnp.where(jnp.asarray(pos >= 0), jnxt, jentry)
    np.testing.assert_array_equal(_np(entry), np.asarray(jentry))
    np.testing.assert_array_equal(_np(entry), _np(ss.d.find_existing(torch.from_numpy(codes), torch.from_numpy(lens))))


def test_collective_ops_equal_jax_and_single_device(wave):
    """push_front for the four bases, truncate at three targets and the
    40-step drop walk along the reference (tests/test_sharded_wavefront.py):
    make_sharded_seqset_ops over 4 local shards against JAX's on a (1, 4)
    mesh and against the single device, every lane of every step."""
    ss, ref = wave
    S = 4
    ops = tss.make_sharded_seqset_ops(tss.ShardedRankArrays.build(ss, S))
    jarr = jss.ShardedRankArrays.build(_jax_fields(ss), S)
    jops = jss.make_sharded_seqset_ops(JMesh(np.array(jax.devices("cpu")[:S]).reshape(1, S), ("data", "model")), ss.n_entries)
    jargs = jarr.device_args() + (jnp.asarray(jarr.fixed),)
    rng = np.random.default_rng(12345)
    r = _ranges_from_reads(ss, rng)
    jr = tuple(jnp.asarray(_np(x)) for x in r)

    for b in range(4):
        bb = torch.full(r.begin.shape, b, dtype=torch.int64)
        got = ops["push_front"](*r, bb)
        _same(got, ss.d.push_front(r, bb), f"push_front {b}")
        _same(got, jops["push_front"](*jargs, *jr, jnp.asarray(_np(bb).astype(np.int32))), f"push_front {b} (JAX)")
    for tgt in (3, 8, 11):
        new = torch.full(r.size.shape, tgt, dtype=torch.int32)
        got = ops["truncate"](*r, new)
        _same(got, ss.d.truncate_ranges(r, tgt), f"truncate {tgt}")
        _same(got, jops["truncate"](*jargs, *jr, jnp.asarray(_np(new))), f"truncate {tgt} (JAX)")

    B = 16
    lane = SeqsetRanges(torch.zeros(B, dtype=torch.int64), torch.full((B,), ss.n_entries, dtype=torch.int64), torch.zeros(B, dtype=torch.int32))
    starts = rng.integers(0, len(ref) - 60, B)
    for i in range(40):
        bases = torch.from_numpy(3 - ref[starts + i].astype(np.int64))
        want = ss.d.push_front_drop(lane, bases)
        got = ops["push_front_drop"](*lane, bases)
        _same(got, want, f"drop walk step {i}")
        _same(got, jops["push_front_drop"](*jargs, *(jnp.asarray(_np(x)) for x in lane), jnp.asarray(_np(bases).astype(np.int32))), f"drop walk step {i} (JAX)")
        lane = want
    assert bool((lane.begin < lane.end).any())


@pytest.mark.parametrize("S", [1, 3, 5])
def test_shard_local_device_equals_single_device(wave, S):
    """rank, rank4, sizes_at, push_front, push4 and trunc_gather of the
    shard-local device (every shard local) against _SeqsetDevice, at random
    positions and ranges with the ends 0 and n among them."""
    ss, _ = wave
    n = ss.n_entries
    eng = ShardedDiscoveryEngine(ss, Mesh.build({"model": -1}, 1, 0, S, "cpu"))
    d, one = eng.d, ss.d
    assert isinstance(d, _ShardLocalDevice) and not hasattr(d, "rank_blocks") and eng.shards == list(range(S))
    g = np.random.default_rng(3)
    pos = torch.from_numpy(np.concatenate([[0, 1, n - 1, n], g.integers(0, n + 1, 400)]).astype(np.int64))
    b = torch.from_numpy(g.integers(0, 4, pos.shape[0]))
    np.testing.assert_array_equal(_np(d.rank(b, pos)), _np(one.rank(b, pos)))
    np.testing.assert_array_equal(_np(d.rank4(pos)), _np(one.rank4(pos)))
    assert d.rank4(pos).dtype == one.rank4(pos).dtype
    np.testing.assert_array_equal(_np(d.sizes_at(pos)), _np(one.sizes_at(pos)))
    begin = torch.from_numpy(g.integers(0, n + 1, 404))
    end = torch.from_numpy(np.concatenate([[n, n, 0, 1], g.integers(0, n + 1, 400)]))
    size = torch.from_numpy(g.integers(0, 40, 404).astype(np.int32))
    r = SeqsetRanges(begin, end, size)
    _same(d.push_front(r, b[:404]), one.push_front(r, b[:404]), "push_front")
    for got, want in zip(d.push4(r), one.push4(r)):
        np.testing.assert_array_equal(_np(got), _np(want))
    for c in (25, 7):
        plt, nlt = eng.trunc_tables(c)
        assert plt.shape == (S, -(-n // S))
        for got, want in zip(d.trunc_gather(plt, nlt, begin, end), one.trunc_gather(*tdisc._trunc_tables(ss, c), begin, end)):
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=f"trunc_gather {c}")


def test_widen_past_the_last_entry_follows_the_local_engine(wave):
    """Truncating an empty range at n: the JAX package's sharded search
    counts the pad rows past n (shared -1) and answers [n, n); the port's
    sharded device, like both single-device engines, answers the run of
    entries before n."""
    ss, _ = wave
    n = ss.n_entries
    r = SeqsetRanges(torch.tensor([n]), torch.tensor([n]), torch.tensor([30], dtype=torch.int32))
    got = tss.make_sharded_seqset_ops(tss.ShardedRankArrays.build(ss, 4))["truncate"](*r, torch.tensor([5], dtype=torch.int32))
    want = ss.d.truncate_ranges(r, 5)
    _same(got, want, "truncate at n")
    assert int(want.begin[0]) < n == int(want.end[0])
    jarr = jss.ShardedRankArrays.build(_jax_fields(ss), 4)
    jops = jss.make_sharded_seqset_ops(JMesh(np.array(jax.devices("cpu")[:4]).reshape(1, 4), ("data", "model")), n)
    jb, je, _ = jops["truncate"](*jarr.device_args(), jnp.asarray(jarr.fixed), *(jnp.asarray(_np(x)) for x in r), jnp.asarray([5], jnp.int32))
    assert (int(jb[0]), int(je[0])) == (n, n)


def test_initialize_and_global_mesh_at_one_process(monkeypatch):
    """initialize is a no-op at one process (JAX
    tests/test_sharded_wavefront.py::test_distributed_init_single_process);
    global_mesh infers its -1 axis from the shards and rejects a shape that
    does not tile them."""
    ctx = tdist.initialize(num_processes=1, device="cpu")
    jctx = jdist.initialize(num_processes=1)
    assert (ctx.num_processes, ctx.process_id, ctx.initialized) == (jctx.num_processes, jctx.process_id, jctx.initialized) == (1, 0, False)
    assert ctx.device == torch.device("cpu")
    mesh = tdist.global_mesh({"data": -1, "model": 4}, shards_per_rank=8, device="cpu")
    jmesh = jdist.global_mesh({"data": -1, "model": 4})
    assert mesh.shape == dict(jmesh.shape) and mesh.size == jmesh.devices.size == 8
    assert mesh.process_sizes == (1, 1) and mesh.device_mesh is None and mesh.group("model") is None
    assert mesh.local_coords("model") == [0, 1, 2, 3] and mesh.local_coords("data") == [0, 1]
    assert make_mesh(4, device="cpu").shape == {"data": 4}
    with pytest.raises(ValueError, match="!= 8 shards"):
        tdist.global_mesh({"data": 3, "model": -1}, shards_per_rank=8, device="cpu")
    with pytest.raises(ValueError, match="at most one axis"):
        tdist.global_mesh({"data": -1, "model": -1}, device="cpu")
    # four processes of two shards: the model axis within a process, data across
    m = Mesh.build({"data": -1, "model": 2}, 4, 3, 2, "cpu")
    assert m.process_sizes == (4, 1) and m.local_coords("data") == [3] and m.local_coords("model") == [0, 1]
    with pytest.raises(ValueError, match="do not tile"):
        Mesh.build({"a": 2, "b": 3}, 3, 0, 2, "cpu")
    # the default device is the card, and there is no fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdist.initialize(num_processes=1)


def test_chip_smoke_sharded_leg_at_toy_size_on_the_cpu(tmp_path, monkeypatch):
    """Leg 7 of ``chip_smoke.py`` rehearsed on CPU tensors, one rank of a
    gloo process group: the engine's discovery over a region against the
    single device's routes and the distributed call at one rank, the kept
    rank, rank4, gather_sizes and rank_cum calls held against their plain
    versions (the wrappers take those on the CPU and count no launch), the
    collective ops and the drop walk, the pileup against its copy."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_torch_cli import _chip_smoke

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "PILEUP_READS", 512)
    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.convert import reference_from_numpy

    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 4000).astype(np.uint8)
    donor = ref.copy()
    for p in (700, 1900, 3100):
        donor[p] = (donor[p] + 1) % 4
    starts = rng.integers(0, len(donor) - 40, 2600)
    codes = np.stack([donor[s : s + 40] for s in starts]).astype(np.uint8)
    codes[::2] = (3 - codes[::2])[:, ::-1]
    lens = np.full(len(codes), 40, np.int32)
    ss = build_seqset(codes, lens, device="cpu")
    rm = build_readmap(ss, codes, lens, device="cpu")
    reference = reference_from_numpy(ref, np.zeros(len(ref), bool), [("chr", 0, len(ref))])
    region = (1500, 3500)
    want = [cs.key_of(r) for r in tdisc.discover_variants(ss, reference, opt=tdisc.DiscoverOptions(**cs.DISCOVER_OPT), readmap=rm)]
    found = ss.d.find(torch.from_numpy(codes), torch.from_numpy(lens))
    out, launches = cs.sharded_phase(torch.device("cpu"), ss, rm, reference, want, found, str(tmp_path), region=region,
                                     lanes=64, steps=cs.SHARDED_DROP_STEPS, inside=200, backend="gloo")
    assert not torch.distributed.is_initialized()
    assert not any(launches.values())
    assert out["records"] == 2 and out["committed_inside"] == out["committed_inside_reproduced"] == 2
    assert set(out["kernel_holds"]["sharded"]) == set(cs.SHARDED_KERNELS)
    assert out["all_reduce_calls"] > 100 and out["rank_shards"] == [0, 1, 2, 3] and out["drop_walk_valid_lanes"] > 0
    assert len(out["shard_bytes"]) == 4 and sum(out["shard_bytes"]) > out["whole_bytes"] > 0
