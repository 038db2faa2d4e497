"""The port's multi-process paths on two gloo processes, against the JAX
package and the port's single-process calls, on the CPU.

Each test's workers are this file run as a script (``python
tests/test_torch_parallel_mp.py <role> <rank> <world> <store>``), one
process a rank, rendezvous through a file in ``<store>``; they import the
port only, build the same worlds from the same seeds and write their
outputs to ``<store>``, which the test compares in this process.  Role
``run``, two processes of two entry shards each (S = 4): (d) the collective
ops of ``tests/test_sharded_wavefront.py``'s world, (e)
``discover_variants(engine=)`` on ``tests/test_sharded_discovery.py``'s
synthetic world, (g) ``discover_variants_distributed`` on that world and
``discover_structural_distributed`` on a paired world with a 300-base
deletion, (h) ``sharded_pileup_step`` on a (2, 4) mesh
(``tests/test_sharded.py``'s world).  Role ``cli``: (j) ``discovery
--dist-dir`` on a store of the paired world.  ``chip_multi_gpu.py`` is
rehearsed on two gloo processes of its own.  The JAX package's functions
run unchanged here, its multi-host calls on one process with
``jax.process_count``/``process_index`` and the barrier patched.
Tolerance: exact equality everywhere.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240
GLOO_TIMEOUT_S = 120
S_PER_RANK = 2
DROP_STEPS = 40
TRUNC_TARGETS = (3, 8, 11)


# ---------------------------------------------------------------------------
# the worlds, numpy only (the workers import no JAX)
# ---------------------------------------------------------------------------


def wave_world():
    """tests/test_sharded_wavefront.py's world: (ref, codes, lengths)."""
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 2000).astype(np.uint8)
    donor = ref.copy()
    donor[1000] = (donor[1000] + 1) % 4
    codes = np.stack([donor[s : s + 50] for s in range(0, len(donor) - 50, 3)]).astype(np.uint8)
    return ref, codes, np.full(len(codes), 50, np.int32)


def engine_world():
    """tests/test_sharded_discovery.py's synthetic world: three SNPs and a
    4-base insertion, 2600 reads of 40, half reverse-complemented."""
    rng = np.random.default_rng(7)
    G = 4000
    ref = rng.integers(0, 4, G).astype(np.uint8)
    donor = ref.copy()
    for p in (700, 1900, 3100):
        donor[p] = (donor[p] + 1) % 4
    donor = np.concatenate([donor[:2500], rng.integers(0, 4, 4).astype(np.uint8), donor[2500:]])
    starts = rng.integers(0, len(donor) - 40, 2600)
    codes = np.stack([donor[s : s + 40] for s in starts])
    codes[::2] = (3 - codes[::2])[:, ::-1]
    return ref, codes, np.full(len(codes), 40, np.int32), None


def sv_world():
    """Paired 100-base reads (fragments of 300, mates on the reverse strand,
    tests/test_pop_tracer.py's sampler) at 20x over a 12 kb genome with
    three SNPs and a 300-base deletion at 6500."""
    rng = np.random.default_rng(12345)
    ref = rng.integers(0, 4, 12000).astype(np.uint8)
    donor = ref.copy()
    for p in (2000, 5000, 9000):
        donor[p] = (donor[p] + 1) % 4
    donor = np.concatenate([donor[:6500], donor[6800:]])
    n_pairs = len(donor) * 20 // 200
    starts = rng.integers(0, len(donor) - 300, n_pairs)
    codes = np.zeros((2 * n_pairs, 100), np.uint8)
    for i, s in enumerate(starts):
        codes[2 * i] = donor[s : s + 100]
        codes[2 * i + 1] = (3 - donor[s + 200 : s + 300])[::-1]
    mate = np.arange(2 * n_pairs) ^ 1
    return ref, codes, np.full(2 * n_pairs, 100, np.int32), mate


def pileup_world():
    """tests/test_sharded.py::test_sharded_pileup_2d_mesh's world."""
    rng = np.random.default_rng(2)
    G = 2048
    ref = rng.integers(0, 4, size=G, dtype=np.uint8)
    starts = rng.integers(0, G - 32, size=16)
    codes = np.stack([ref[s : s + 32] for s in starts]).astype(np.uint8)
    return ref, codes, np.full(16, 32, np.int32)


def drop_walk_inputs(ref, n_entries, B=16):
    """Start lanes (the empty sequence) and each step's bases of the drop
    walk along the reference."""
    starts = np.random.default_rng(12345).integers(0, len(ref) - 60, B)
    bases = np.stack([3 - ref[starts + i].astype(np.int64) for i in range(DROP_STEPS)])
    return bases


def query_ranges(ss, B=32, plen=12):
    """Ranges of random entries' prefixes (tests/test_sharded_wavefront.py)."""
    ids = torch.from_numpy(np.random.default_rng(11).integers(0, ss.n_entries, B))
    return ss.d.find(ss.d.sequences(ids, plen), torch.full((B,), plen, dtype=torch.int32))


def port_store(world):
    """The port's seqset, readmap and reference of a world, on the CPU."""
    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.build.seqset_build import build_seqset
    from biograph_tpu_torch.convert import reference_from_numpy

    ref, codes, lens, mate = world
    ss = build_seqset(codes, lens, device="cpu")
    rm = build_readmap(ss, codes, lens, mate_of=mate, device="cpu")
    return ss, rm, reference_from_numpy(ref, np.zeros(len(ref), bool), [("chr1", 0, len(ref))])


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------


def _ops_outputs(ss, ref, ops_or_device):
    """push_front (four bases), truncate (TRUNC_TARGETS) and the drop walk,
    by the sharded ops or (``ops_or_device`` a query engine) the single
    device: {name: int64 [3, B]}."""
    from biograph_tpu_torch.index.seqset import SeqsetRanges

    if isinstance(ops_or_device, dict):
        ops = ops_or_device
    else:
        d = ops_or_device
        ops = dict(push_front=lambda *a: tuple(d.push_front(SeqsetRanges(*a[:3]), a[3])),
                   truncate=lambda *a: tuple(d.truncate_ranges(SeqsetRanges(*a[:3]), a[3])),
                   push_front_drop=lambda *a: tuple(d.push_front_drop(SeqsetRanges(*a[:3]), a[3])))
    out = {}

    def keep(name, r):
        out[name] = torch.stack([x.to(torch.int64) for x in r]).numpy()

    r = query_ranges(ss)
    for b in range(4):
        keep(f"push_front_{b}", ops["push_front"](*r, torch.full(r.begin.shape, b, dtype=torch.int64)))
    for t in TRUNC_TARGETS:
        keep(f"truncate_{t}", ops["truncate"](*r, torch.full(r.size.shape, t, dtype=torch.int32)))
    bases = drop_walk_inputs(ref, ss.n_entries)
    B = bases.shape[1]
    lane = (torch.zeros(B, dtype=torch.int64), torch.full((B,), ss.n_entries, dtype=torch.int64), torch.zeros(B, dtype=torch.int32))
    for i in range(DROP_STEPS):
        lane = ops["push_front_drop"](*lane, torch.from_numpy(bases[i]))
        keep(f"drop_{i}", lane)
    return out


def _worker_run(rank, world, store):
    from biograph_tpu_torch.parallel import discovery as pdisc
    from biograph_tpu_torch.parallel.distributed import global_mesh, initialize, shutdown
    from biograph_tpu_torch.parallel.mesh import sharded_pileup_step
    from biograph_tpu_torch.parallel.sharded_discovery import ShardedDiscoveryEngine
    from biograph_tpu_torch.parallel.sharded_seqset import ShardedRankArrays, make_sharded_seqset_ops
    from biograph_tpu_torch.variants.align import RefKmerIndex
    from biograph_tpu_torch.variants.discover import DiscoverOptions, discover_variants

    ctx = initialize(f"file://{store}/rendezvous", world, rank, device="cpu", timeout_s=GLOO_TIMEOUT_S)
    assert ctx.initialized and ctx.num_processes == world and ctx.process_id == rank
    mesh = global_mesh({"model": -1}, shards_per_rank=S_PER_RANK, device="cpu")
    out = {}
    # (d) the collective ops
    wref, wcodes, wlens = wave_world()
    from biograph_tpu_torch.build.seqset_build import build_seqset

    wss = build_seqset(wcodes, wlens, device="cpu")
    arrays = ShardedRankArrays.build(wss, mesh.shape["model"], shards=mesh.local_coords("model"))
    ops = make_sharded_seqset_ops(arrays, mesh.group("model"))
    np.savez(os.path.join(store, f"ops_{rank}.npz"), **_ops_outputs(wss, wref, ops))
    # (e) discovery over the sharded engine; (g) the distributed calls
    ss, rm, reference = port_store(engine_world())
    opt = DiscoverOptions(min_alt_support=5)
    out["engine"] = discover_variants(ss, reference, opt=opt, readmap=rm, engine=ShardedDiscoveryEngine(ss, mesh))
    out["distributed"] = pdisc.discover_variants_distributed(ss, reference, os.path.join(store, "dist"), opt=opt, readmap=rm)
    _, svrm, svref = port_store(sv_world())
    out["structural"] = pdisc.discover_structural_distributed(svrm, svref, os.path.join(store, "dist"))
    # (h) the pileup on a (2, 4) mesh
    pref, pcodes, plens = pileup_world()
    pmesh = global_mesh({"data": -1, "model": 4}, shards_per_rank=4, device="cpu")
    out["pileup_process_sizes"] = list(pmesh.process_sizes)
    idx = RefKmerIndex.build(pref, 16, device="cpu")
    step = sharded_pileup_step(pmesh, idx.kmers, idx.positions, torch.from_numpy(pref), 16)
    counts = step(idx.kmers, idx.positions, torch.from_numpy(pref), torch.from_numpy(pcodes), torch.from_numpy(plens))
    out["pileup"] = counts.tolist()
    with open(os.path.join(store, f"run_{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown(ctx)


def _worker_cli(rank, world, store):
    from biograph_tpu_torch import cli

    with open(os.path.join(store, "cli_args.json")) as f:
        argv = json.load(f)
    cli.main(argv + ["--coordinator", f"file://{store}/rendezvous", "--num-processes", str(world), "--process-id", str(rank),
                     "--out", os.path.join(store, f"cli_{rank}.vcf")])


def _spawn(role, store, world=2):
    """Run the role on ``world`` processes of this file; kill them all and
    fail if one fails or they outlast WORKER_TIMEOUT_S."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), role, str(r), str(world), str(store)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{role} workers outlasted {WORKER_TIMEOUT_S} s")
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{role} worker {r} exited {p.returncode}:\n{text[-4000:]}"
    return outs


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' outputs of role ``run``."""
    store = tmp_path_factory.mktemp("mp_run")
    _spawn("run", store)
    out = []
    for r in range(2):
        with open(store / f"run_{r}.json") as f:
            got = json.load(f)
        got["ops"] = dict(np.load(store / f"ops_{r}.npz"))
        out.append(got)
    return out


@pytest.fixture(scope="module")
def engine_side():
    """The engine world in both packages: the port's store and JAX's, the
    JAX package's local records and the port's."""
    from biograph_tpu.build.readmap_build import build_readmap as jbuild_readmap
    from biograph_tpu.build.seqset_build import build_seqset as jbuild_seqset
    from biograph_tpu.variants import discover as jdisc
    from biograph_tpu_torch.variants.discover import DiscoverOptions, discover_variants

    world = engine_world()
    ref, codes, lens, _ = world
    jss = jbuild_seqset(codes, lens)
    jrm = jbuild_readmap(jss, codes, lens)
    jref = _JaxRef(ref)
    want = jdisc.discover_variants(jss, jref, opt=jdisc.DiscoverOptions(min_alt_support=5), readmap=jrm)
    ss, rm, reference = port = port_store(world)
    local = discover_variants(ss, reference, opt=DiscoverOptions(min_alt_support=5), readmap=rm)
    assert list(map(_key, local)) == list(map(_key, want))
    return dict(port=port, jss=jss, jrm=jrm, jref=jref, want=want, local=local)


class _JaxRef:
    def __init__(self, codes):
        from biograph_tpu.index.reference import Contig

        self.flat = np.asarray(codes, np.uint8)
        self.is_n = np.zeros(len(codes), bool)
        self.contigs = [Contig(name="chr1", start=0, length=len(codes))]

    def contig_by_name(self, name):
        return self.contigs[0]


def _json(records):
    """Records as a JSON round trip gives them back (numpy ints as int)."""
    return json.loads(json.dumps(records, default=int))


def _key(r):
    return (r["chrom"], r["pos"], r["ref"], r["alt"], r["support"], r["ref_support"])


def _one_process(monkeypatch, nproc, pid):
    """The JAX package's multi-host calls as process pid of nproc, in this
    one process: its barrier passes at once."""
    import jax
    from jax.experimental import multihost_utils

    monkeypatch.setattr(jax, "process_count", lambda: nproc)
    monkeypatch.setattr(jax, "process_index", lambda: pid)
    monkeypatch.setattr(multihost_utils, "sync_global_devices", lambda name: None)


def _jax_two_processes(monkeypatch, fn, run_dir, *args, **kw):
    """fn as rank 1 (its part published before its wait; with a short
    timeout it raises, part 0 absent) and then as rank 0, which merges both
    parts: rank 0's records."""
    with monkeypatch.context() as m:
        _one_process(m, 2, 1)
        with pytest.raises(TimeoutError):
            fn(*args, run_dir, barrier_timeout_s=0.2, **kw)
    with monkeypatch.context() as m:
        _one_process(m, 2, 0)
        return fn(*args, run_dir, **kw)


def test_collective_ops_on_two_processes(run):
    """(d) push_front, truncate and the 40-step drop walk over 2 processes x
    2 shards: every lane of every step the single device's, on both ranks."""
    from biograph_tpu_torch.build.seqset_build import build_seqset

    ref, codes, lens = wave_world()
    ss = build_seqset(codes, lens, device="cpu")
    want = _ops_outputs(ss, ref, ss.d)
    assert len(want) == 4 + len(TRUNC_TARGETS) + DROP_STEPS
    for rank in (0, 1):
        got = run[rank]["ops"]
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"rank {rank}: {name}")


def test_engine_discovery_one_process(engine_side):
    """(e) discover_variants(engine=) with 4 entry shards in one process:
    the JAX package's local records and the port's local call's."""
    from biograph_tpu_torch.parallel.mesh import Mesh
    from biograph_tpu_torch.parallel.sharded_discovery import ShardedDiscoveryEngine
    from biograph_tpu_torch.variants.discover import DiscoverOptions, discover_variants

    ss, rm, reference = engine_side["port"]
    stats = {}
    eng = ShardedDiscoveryEngine(ss, Mesh.build({"model": -1}, 1, 0, 4, "cpu"))
    got = discover_variants(ss, reference, opt=DiscoverOptions(min_alt_support=5), readmap=rm, engine=eng, stats=stats)
    assert list(map(_key, got)) == list(map(_key, engine_side["local"])) == list(map(_key, engine_side["want"]))
    assert {701, 1901, 3101} <= {r["pos"] for r in got}
    assert stats["memory_plan"]["use_trunc_tables"] and stats["memory_plan"]["core_bytes"] == eng.d.nbytes()


def test_engine_discovery_on_two_processes(run, engine_side):
    """(e) the same call over 2 processes x 2 shards: the same records on
    both ranks."""
    want = list(map(_key, engine_side["want"]))
    assert want
    for rank in (0, 1):
        assert list(map(_key, run[rank]["engine"])) == want, rank


def test_discover_variants_distributed_on_two_processes(run, engine_side, monkeypatch, tmp_path):
    """(g) the region split over 2 processes: both ranks return the JAX
    package's two-process records.  They agree with the port's
    single-process call in every field but ``aid``, the assembly id, which
    each process numbers over its own slice."""
    from biograph_tpu.parallel import discovery as jpdisc
    from biograph_tpu.variants import discover as jdisc

    want = _jax_two_processes(monkeypatch, jpdisc.discover_variants_distributed, str(tmp_path / "jax"),
                              engine_side["jss"], engine_side["jref"], opt=jdisc.DiscoverOptions(min_alt_support=5),
                              readmap=engine_side["jrm"])
    assert want
    for rank in (0, 1):
        assert run[rank]["distributed"] == _json(want), rank
    assert list(map(_key, run[0]["distributed"])) == list(map(_key, engine_side["local"]))


def test_discover_structural_distributed_on_two_processes(run, monkeypatch, tmp_path):
    """(g) the SV scan split by read slice over 2 processes: both ranks
    return the JAX package's two-process records, which hold the 300-base
    deletion, and the port's single-process call's."""
    from biograph_tpu.build.readmap_build import build_readmap as jbuild_readmap
    from biograph_tpu.build.seqset_build import build_seqset as jbuild_seqset
    from biograph_tpu.parallel import discovery as jpdisc
    from biograph_tpu_torch.parallel.discovery import discover_structural_distributed

    world = sv_world()
    ref, codes, lens, mate = world
    jss = jbuild_seqset(codes, lens)
    jrm = jbuild_readmap(jss, codes, lens, mate_of=mate)
    want = _jax_two_processes(monkeypatch, jpdisc.discover_structural_distributed, str(tmp_path / "jax"), jrm, _JaxRef(ref))
    assert any(r["svlen"] == -300 for r in want), want
    for rank in (0, 1):
        assert run[rank]["structural"] == _json(want), rank
    _, rm, reference = port_store(world)
    assert _json(discover_structural_distributed(rm, reference, str(tmp_path / "single"))) == run[0]["structural"]


def test_sharded_pileup_on_two_processes(run):
    """(h) sharded_pileup_step over a (2, 4) mesh of 2 processes x 4 shards
    (a DeviceMesh of (2, 1) processes): the JAX package's step on its 2-D
    mesh of 8 devices (tests/test_sharded.py)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from biograph_tpu.parallel.mesh import sharded_pileup_step as jstep
    from biograph_tpu.variants.align import RefKmerIndex as JIndex

    ref, codes, lens = pileup_world()
    idx = JIndex.build(ref, 16)
    mesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    step = jstep(mesh, jnp.asarray(idx.kmers), jnp.asarray(idx.positions), jnp.asarray(ref), 16)
    want = np.asarray(step(jnp.asarray(idx.kmers), jnp.asarray(idx.positions), jnp.asarray(ref), jnp.asarray(codes), jnp.asarray(lens)))
    assert want.sum() == codes.size
    for rank in (0, 1):
        assert run[rank]["pileup_process_sizes"] == [2, 1]
        np.testing.assert_array_equal(np.asarray(run[rank]["pileup"], np.int32), want, err_msg=f"rank {rank}")


def test_cli_dist_dir_on_two_processes(tmp_path):
    """(j) ``discovery --mode assemble --dist-dir`` on 2 processes (the
    wavefront region-sharded, the SV pass read-sliced) writes the VCF of a
    single-process ``discovery``; only process 0 writes."""
    from biograph_tpu_torch import cli
    from biograph_tpu_torch.core import dna

    ss, rm, _ = port_store(sv_world())
    bgt = tmp_path / "sample.bgt"
    bgt.mkdir()
    ss.save(str(bgt / "seqset"))
    rm.save(str(bgt / "readmap"))
    fa = tmp_path / "ref.fa"
    fa.write_text(f">chr1\n{dna.codes_to_seq(sv_world()[0])}\n")
    argv = ["discovery", "--mode", "assemble", "--biograph", str(bgt), "--ref", str(fa), "--min-depth", "5", "--device", "cpu"]
    cli.main(argv + ["--out", str(tmp_path / "single.vcf")])
    store = tmp_path / "store"
    store.mkdir()
    (store / "cli_args.json").write_text(json.dumps(argv + ["--dist-dir", str(tmp_path / "run")]))
    printed = _spawn("cli", store)
    single = (tmp_path / "single.vcf").read_text()
    assert (store / "cli_0.vcf").read_text() == single and not (store / "cli_1.vcf").exists()
    body = [line.split("\t") for line in single.splitlines() if not line.startswith("#")]
    assert {"2001", "5001", "9001"} <= {c[1] for c in body} and any("SVLEN=-300" in c[7] for c in body)
    assert "discovery:" in printed[0] and "discovery:" not in printed[1]
    assert sorted(os.listdir(tmp_path / "run")) == ["discovery_part_00000.json", "discovery_part_00001.json", "sv_part_00000.npz", "sv_part_00001.npz"]


def test_chip_multi_gpu_at_toy_size_on_two_gloo_processes():
    """``chip_multi_gpu.py`` rehearsed with ``--device cpu`` on two
    processes at a toy size: every rank's holds pass and it prints one line
    a rank and the closing ``ok`` line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_multi_gpu.py"), "--device", "cpu", "--world", "2", "--genome", "12000",
         "--reads", "1000", "--region", "2000", "10000", "--lanes", "64"],
        capture_output=True, text=True, timeout=WORKER_TIMEOUT_S, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [x.get("rank") for x in lines[:2]] == [0, 1] and lines[-1]["ok"] and lines[-1]["world"] == 2
    for x in lines[:2]:
        assert x["records"] > 0 and x["whole_records"] >= x["records"] and x["all_reduce_calls"] > 0
        assert set(x["kernel_holds"]["sharded"]) == {"rank", "rank4", "gather_sizes", "rank_cum"}


if __name__ == "__main__":
    _role, _rank, _world, _store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, REPO)
    {"run": _worker_run, "cli": _worker_cli}[_role](_rank, _world, _store)
