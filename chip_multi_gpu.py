"""The port's multi-GPU paths on every card of one host, one process a card.

    python3 chip_multi_gpu.py [--world N] [--device cuda|cpu] [--genome G] [--reads R] [--region LO HI]

Starts N processes of this script (default: one a card), each a rank of an
NCCL process group (gloo with ``--device cpu``) that meets through a file in
a temp dir, and holds what ``chip_smoke.py``'s leg 7 holds on one rank, now
across ranks.  Every rank simulates the scaled workload of
``chip_smoke.py`` from its seed (120 000 reads of 100 bases over a 2 Mb
genome) and builds the store on its own card; then

  * the engine, the store cut into N entry shards, one a rank:
    ``discover_variants(engine=...)`` with the readmap over a region, cold
    and warm, whose records must equal the rank's single-device call by the
    dense front end and by the prescreen; its rank, rank4, gather_sizes and
    rank_cum calls kept and held against their plain versions, its
    all_reduce calls counted and timed;
  * push_front, truncate and the 40-step drop walk on 4096 lanes, equal to
    the single device in every lane;
  * ``discover_variants_distributed`` over the whole genome, the region
    split over the ranks through a run dir: every record field but the
    assembly id equal to the single-device call's;
  * ``sharded_pileup_step`` with the reads on the data axis across the
    ranks, equal to the rank's own single-process pileup.

Each rank prints one JSON line; the parent prints them, the cards' names and
power limits, and as its last line ``{"ok": true, ...}``, or exits non-zero
if a rank failed or outlasted the time limit (every rank is then killed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TIMEOUT_S = 420  # seconds a rank, and each of its collectives, may take


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=None, help="processes (default: the cards of the host)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--genome", type=int, default=None, help="genome bases (default chip_smoke.py's)")
    p.add_argument("--reads", type=int, default=None, help="reads (default chip_smoke.py's)")
    p.add_argument("--region", type=int, nargs=2, default=None, help="flat region of the engine's call (default chip_smoke.py's)")
    p.add_argument("--lanes", type=int, default=None, help="lanes of the collective ops (default chip_smoke.py's)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _fence(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    _fence(dev)
    t0 = time.perf_counter()
    out = fn()
    _fence(dev)
    return out, time.perf_counter() - t0


def rank_main(a):
    """One rank: the checks of the docstring; prints its JSON line."""
    import chip_smoke as cs
    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.build.seqset_build import build_seqset
    from biograph_tpu_torch.convert import reference_from_numpy
    from biograph_tpu_torch.parallel import discovery as pdisc
    from biograph_tpu_torch.parallel.distributed import global_mesh, initialize, shutdown
    from biograph_tpu_torch.parallel.sharded_discovery import ShardedDiscoveryEngine
    from biograph_tpu_torch.variants import discover as disc

    ctx = initialize(f"file://{a.store}/rendezvous", a.world, a.rank, device=a.device, timeout_s=TIMEOUT_S)
    dev = ctx.device
    out = {"rank": ctx.process_id, "world": ctx.num_processes, "device": str(dev)}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    G = a.genome or cs.GENOME
    genome, codes, lengths, _, _, _ = cs.simulate(G, a.reads or cs.READS, cs.SNPS * G // cs.GENOME, cs.READ_LEN)
    (ss, rm), out["store_s"] = _timed(dev, lambda: (lambda s: (s, build_readmap(s, codes, lengths, device=dev)))(build_seqset(codes, lengths, device=dev)))
    reference = reference_from_numpy(genome, np.zeros(G, bool), [("chr", 0, G)])
    region = tuple(a.region or cs.SHARDED_REGION)
    lanes = a.lanes or cs.SHARDED_LANES
    opt = disc.DiscoverOptions(**cs.DISCOVER_OPT)

    def call(**kw):
        return disc.discover_variants(ss, reference, opt=opt, readmap=rm, **kw)

    # the engine: one entry shard a rank
    for fn in cs.WRAPPERS.values():
        fn.launches = 0
    with cs.kept_calls(cs.SHARDED_CALL_SITES, ["sharded"]) as kept, cs.counted_all_reduce() as reduces:
        eng, out["engine_build_s"] = _timed(dev, lambda: ShardedDiscoveryEngine(ss, global_mesh({"model": -1}, device=dev)))
        got, out["engine_cold_s"] = _timed(dev, lambda: call(region=region, engine=eng))
    out["launches"] = {k: cs.WRAPPERS[k].launches for k in cs.SHARDED_KERNELS}
    out["kernel_holds"] = cs.hold_calls(kept, cs.SHARDED_CALL_SITES, "the engine's")
    del kept
    out.update(all_reduce_calls=reduces["calls"], all_reduce_s=reduces["seconds"], shards=eng.shards, shard_bytes=cs.shard_bytes(ss, eng)[0][0])
    again, out["engine_warm_s"] = _timed(dev, lambda: call(region=region, engine=eng))
    with cs.discovery_constants(NO_PRESCREEN=True):
        dense, out["single_dense_s"] = _timed(dev, lambda: call(region=region))
    plain, out["single_prescreen_s"] = _timed(dev, lambda: call(region=region))
    keys = list(map(cs.key_of, got))
    for name, other in (("the warm call", again), ("the dense route", dense), ("the prescreen", plain)):
        if list(map(cs.key_of, other)) != keys:
            raise AssertionError(f"rank {a.rank}: {len(got)} records by the engine, {len(other)} by {name}, or they differ")
    out["records"] = len(got)
    # the collective ops
    found = ss.d.find(torch.from_numpy(codes[:lanes]).to(dev), torch.from_numpy(lengths[:lanes]).to(dev))
    _, out["ops_s"] = _timed(dev, lambda: cs.sharded_ops_checks(ss, eng, found, lanes))
    out["drop_walk_valid_lanes"], out["drop_walk_s"] = _timed(dev, lambda: cs.sharded_drop_walk(ss, eng, genome, lanes))
    # the region split over the ranks, the whole genome
    spread, out["distributed_s"] = _timed(dev, lambda: pdisc.discover_variants_distributed(ss, reference, os.path.join(a.store, "run"), opt=opt, readmap=rm))
    whole, out["single_whole_s"] = _timed(dev, lambda: call())
    if list(map(cs.key_of, spread)) != list(map(cs.key_of, whole)):
        raise AssertionError(f"rank {a.rank}: {len(spread)} records over the ranks, {len(whole)} on one card, or they differ")
    out["whole_records"] = len(whole)
    # the pileup, reads split over the ranks on the data axis
    pile, out["pileup_s"] = _timed(dev, lambda: cs.sharded_pileup(genome, dev))
    shutdown(ctx)
    alone = cs.sharded_pileup(genome, dev)  # no process group now: this rank alone
    cs.require_equal("sharded_pileup_step across the ranks", pile, alone)
    print(json.dumps(out), flush=True)


def main():
    a = _args()
    if a.rank is not None:
        return rank_main(a)
    if a.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("chip_multi_gpu: CUDA is not available")
    world = a.world or (torch.cuda.device_count() if a.device.startswith("cuda") else 2)
    if a.device.startswith("cuda"):
        from biograph_tpu_torch.ops import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             check=True, capture_output=True, text=True).stdout.strip(), flush=True)
        _build.build_all()  # once, before the ranks load the libraries
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        argv = [sys.executable, os.path.abspath(__file__), "--world", str(world), "--device", a.device, "--store", store]
        for flag in ("genome", "reads", "lanes"):
            if getattr(a, flag) is not None:
                argv += [f"--{flag}", str(getattr(a, flag))]
        if a.region:
            argv += ["--region", *map(str, a.region)]
        # on the host the ranks share its cores: one thread each
        env = dict(os.environ, OMP_NUM_THREADS="1") if a.device == "cpu" else None
        procs = [subprocess.Popen(argv + ["--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(world)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            sys.exit(f"chip_multi_gpu: the ranks outlasted {TIMEOUT_S} s")
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            print(text[-6000:], file=sys.stderr)
            sys.exit(f"chip_multi_gpu: rank {r} exited {p.returncode}")
        print(text.strip().splitlines()[-1], flush=True)
    print(json.dumps({"ok": True, "world": world, "device": a.device, "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
