"""Distributed discovery: region- and read-sliced calling across processes
(torch).

Counterpart of ``biograph_tpu/parallel/discovery.py``.  Every process of a
``torch.distributed`` run traces an overlapping slice of the region with its
own copy of the seqset, and the processes' records meet through the run
directory (files on shared storage, ``runtime/storage``), merged and
deduplicated the same way on every process.  The SV pass splits its O(reads)
scan by read slice and runs its deterministic finalize on every process.

Slice ownership: a record belongs to the slice whose half-open [lo, hi)
range holds its anchor position; slices are traced with ``overlap`` extra
bases each side, so an owned record sees its whole assembly context.  A run
of one process (no process group, or a group of one) is the plain call.
"""

from __future__ import annotations

import json
import time
from typing import List

import numpy as np
import torch.distributed as dist

from biograph_tpu_torch.parallel.distributed import process_count, process_index
from biograph_tpu_torch.runtime import storage


def _slices(lo: int, hi: int, n: int) -> List[tuple]:
    """n contiguous half-open owned ranges covering [lo, hi)."""
    edges = np.linspace(lo, hi, n + 1).astype(np.int64)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(n)]


def _await_file(st, path: str, deadline: float):
    while not st.exists(path):
        # shared-storage visibility can lag the barrier on network mounts
        if time.time() > deadline:
            raise TimeoutError(f"missing part {path}")
        time.sleep(0.05)


def discover_variants_distributed(
    ss,
    reference,
    run_dir: str,
    region: tuple | None = None,
    opt=None,
    readmap=None,
    stats: dict | None = None,
    overlap: int | None = None,
    barrier_timeout_s: float = 600.0,
):
    """Discovery region-sharded over the processes of the run.

    Every process calls this with the same arguments (the seqset and readmap
    are the same artifacts on each) and gets the same merged records.
    ``run_dir`` must be storage every process reads.  Each process publishes
    its owned records as ``discovery_part_<pid>.json``, waits at a
    ``torch.distributed.barrier`` and then for every part."""
    from biograph_tpu_torch.variants.discover import DiscoverOptions, _dedup_records, discover_variants

    opt = opt or DiscoverOptions()
    nproc = process_count()
    pid = process_index()
    G = len(np.asarray(reference.flat))
    lo, hi = region if region else (0, G)
    if nproc <= 1:
        return discover_variants(ss, reference, region=(lo, hi), opt=opt, readmap=readmap, stats=stats)
    if overlap is None:
        overlap = opt.max_path + opt.rejoin_k + opt.probe_ctx + 2
    own_lo, own_hi = _slices(lo, hi, nproc)[pid]
    ext = (max(lo, own_lo - overlap), min(hi, own_hi + overlap))
    local = discover_variants(ss, reference, region=ext, opt=opt, readmap=readmap, stats=stats)
    # ownership filter: the anchor position (a record's pos is 1-based,
    # contig-relative)
    owned = [r for r in local if own_lo <= reference.contig_by_name(r["chrom"]).start + r["pos"] - 1 < own_hi]
    st = storage.for_path(run_dir)
    st.makedirs(run_dir)
    part = storage.join(run_dir, f"discovery_part_{pid:05d}.json")
    tmp = part + ".tmp"
    with st.open(tmp, "w") as f:
        json.dump(owned, f)
    st.publish(tmp, part)  # atomic: a reader never sees a partial part
    dist.barrier()
    deadline = time.time() + barrier_timeout_s
    merged = []
    for p in range(nproc):
        path = storage.join(run_dir, f"discovery_part_{p:05d}.json")
        _await_file(st, path, deadline)
        with st.open(path) as f:
            merged.extend(json.load(f))
    return _dedup_records(merged)


def discover_structural_distributed(
    readmap,
    reference,
    run_dir: str,
    opt=None,
    barrier_timeout_s: float = 600.0,
):
    """Pair/split SV discovery with the O(reads) scan split by read slice.

    Every process densifies, places and split-places only its contiguous
    slice of the readmap's forward reads, publishes the scan
    (``sv_part_<pid>.npz``: placements, raw events, clip candidates, k-mer
    edge table), and runs the finalize over every part, so every process
    returns the single-process records.  Runs on the readmap's device."""
    from biograph_tpu_torch.variants.align import RefKmerIndex
    from biograph_tpu_torch.variants.pop_tracer import (
        SvOptions,
        _sv_finalize,
        _sv_scan_reads,
        discover_structural,
        merge_edge_tables,
    )

    opt = opt or SvOptions()
    nproc = process_count()
    pid = process_index()
    if nproc <= 1:
        codes, lens, mate = readmap.forward_reads()
        return discover_structural(reference, codes, lens, mate_of=mate, opt=opt, device=readmap.device)

    # the lengths and mate links of every read are cheap; codes only for
    # this process's slice
    _, lens, mate = readmap.forward_reads(read_slice=(0, 0))
    lo, hi = _slices(0, len(lens), nproc)[pid]
    codes, _, _ = readmap.forward_reads(read_slice=(lo, hi))
    index = RefKmerIndex.build(
        np.asarray(reference.flat), opt.k, is_n=getattr(reference, "is_n", None), device=readmap.device
    )
    placements, raw_events, clip_cands, ek, ec = _sv_scan_reads(index, codes, lens[lo:hi], opt, owner_base=lo)

    st = storage.for_path(run_dir)
    st.makedirs(run_dir)
    part = storage.join(run_dir, f"sv_part_{pid:05d}.npz")
    tmp = part + ".tmp.npz"
    with st.open(tmp, "wb") as f:
        np.savez(
            f,
            pos=placements.pos,
            is_rc=placements.is_rc,
            ev_left=np.array([e[0] for e in raw_events], np.int64),
            ev_right=np.array([e[1] for e in raw_events], np.int64),
            ev_owner=np.array([e[3] for e in raw_events], np.int64),
            ev_ins=np.frombuffer(b"".join(e[2] for e in raw_events), np.uint8),
            ev_ins_len=np.array([len(e[2]) for e in raw_events], np.int64),
            cl_left=np.array([c[0] for c in clip_cands], np.int64),
            cl_owner=np.array([c[2] for c in clip_cands], np.int64),
            cl_tail=np.concatenate([c[1] for c in clip_cands]) if clip_cands else np.zeros(0, np.uint8),
            cl_tail_len=np.array([len(c[1]) for c in clip_cands], np.int64),
            edge_keys=ek,
            edge_counts=ec,
        )
    st.publish(tmp, part)
    dist.barrier()

    deadline = time.time() + barrier_timeout_s
    pos_parts, rc_parts, tables = [], [], []
    all_events, all_clips = [], []
    for p in range(nproc):
        path = storage.join(run_dir, f"sv_part_{p:05d}.npz")
        _await_file(st, path, deadline)
        with st.open(path, "rb") as f:
            z = dict(np.load(f))
        pos_parts.append(z["pos"])
        rc_parts.append(z["is_rc"])
        tables.append((z["edge_keys"], z["edge_counts"]))
        off = 0
        for left, right, n, o in zip(z["ev_left"], z["ev_right"], z["ev_ins_len"], z["ev_owner"]):
            all_events.append((int(left), int(right), z["ev_ins"][off : off + int(n)].tobytes(), int(o)))
            off += int(n)
        off = 0
        for left, n, o in zip(z["cl_left"], z["cl_tail_len"], z["cl_owner"]):
            all_clips.append((int(left), z["cl_tail"][off : off + int(n)].copy(), int(o)))
            off += int(n)
    ek_m, ec_m = merge_edge_tables(tables)
    if not all_events and not all_clips:
        return []
    return _sv_finalize(
        reference, index, all_events, all_clips, ek_m, ec_m,
        np.concatenate(pos_parts), np.concatenate(rc_parts), lens, mate, opt,
    )
