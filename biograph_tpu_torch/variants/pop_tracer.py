"""Pair/split-evidence structural-variant discovery (torch).

Counterpart of ``biograph_tpu/variants/pop_tracer.py`` (the reference's pop
tracer, modules/variants/pop_tracer.h:8, scored with mate-pair support as in
modules/variants/pair_cov.cpp): reads that fail whole-read placement are
split-placed, their prefix and suffix diagonals voted out of one batched
k-mer lookup; a read whose prefix and suffix land on different diagonals
spans a breakpoint (a deletion when the suffix diagonal is larger, an
insertion with the read's bases between the two runs otherwise).
Candidates cluster on (left, right, inserted), need ``min_sv_reads`` split
reads, and proper pairs straddling the junction add pair support.
One-sided left clips seed a greedy walk of the unplaced reads' k-mer graph
that assembles insertions longer than a read.

Event size is bounded only by the reference: this is the engine past the
wavefront's ``max_path`` cap (the reference's flagship 49 kb deletion,
modules/variants/hg002_test.cpp:23).

The per-read arrays (split placement, match runs, the edge table) are
tensor code on the index's device.  The JAX package's breakend walk is one
``lax.while_loop`` over every cluster lane; here it is a host loop of
tensor steps over all lanes at once that reads ``any(~stopped)`` every
``WALK_SYNC_EVERY`` steps.  A stopped lane's state never changes again, so
the extra steps past the last lane's stop change no answer, and the loop
still ends at exactly ``max_assembly`` steps.  k-mers, edge keys and seeds
are int64 where the JAX package has uint64: k = 16 gives 34-bit edge keys,
so every sort and search orders them the same.  Everything after the scan
(clustering, pair evidence, records) is the JAX package's host code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from biograph_tpu_torch import resolve_device
from biograph_tpu_torch.core import dna
from biograph_tpu_torch.variants.align import Placements, RefKmerIndex, place_reads

WALK_SYNC_EVERY = 16  # walk steps between reads of any(~stopped)
_NONE = 1 << 62  # mode_diag's sentinel: no diagonal


@dataclass
class SvOptions:
    """Knobs of the pair/split SV engine (assemble_options' pop subset,
    modules/variants/assemble.h:475)."""

    k: int = 16  # seed k-mer size for split placement
    min_run: int = 20  # min exact prefix/suffix anchor run (bases)
    min_sv_reads: int = 3  # split reads required per event
    min_event: int = 50  # smaller events belong to the wavefront engine
    max_frag: int = 1000  # max mate-pair fragment for pair support
    max_hits: int = 4  # reference hits considered per seed k-mer
    cluster_pad: int = 8  # breakpoint jitter merged into one event
    max_reads_batch: int = 1 << 14


@dataclass
class SvEvent:
    """A clustered breakpoint event."""

    left: int  # flat ref position after the last prefix-matched base
    right: int  # flat ref position of the first suffix-matched base
    ins: np.ndarray  # inserted bases between the anchors (uint8 codes)
    support: int  # split reads
    pair_support: int = 0  # straddling proper pairs

    @property
    def del_len(self) -> int:
        return self.right - self.left

    @property
    def ins_len(self) -> int:
        return len(self.ins)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (its length if there is
    none): the first-occurrence rule of numpy's argmax, stated outright."""
    n = mask.shape[-1]
    return torch.where(mask, torch.arange(n, device=mask.device), n).amin(dim=-1)


def _ref_window(ref: torch.Tensor, starts: torch.Tensor, L: int):
    """(ref[starts + j] clipped, in-bounds mask) for j in [0, L)."""
    G = ref.shape[0]
    idx = starts[:, None] + torch.arange(L, device=ref.device)[None, :]
    ok = (idx >= 0) & (idx < G)
    return ref[idx.clamp(0, G - 1)], ok


def _match_run_fwd(reads: torch.Tensor, lens: torch.Tensor, ref: torch.Tensor, starts: torch.Tensor):
    """Per read: length of the exact run read[0:p] == ref[start:start+p]."""
    R, L = reads.shape
    refw, ok = _ref_window(ref, starts, L)
    j = torch.arange(L, device=reads.device)[None, :]
    eq = ok & (refw == reads) & (j < lens[:, None])
    lens64 = lens.to(torch.int64)
    return torch.where(eq.all(dim=1), lens64, _first_true(~eq))


def _match_run_bwd(reads: torch.Tensor, lens: torch.Tensor, ref: torch.Tensor, diag: torch.Tensor):
    """Per read: smallest s with read[s:len] == ref[diag+s : diag+len]."""
    R, L = reads.shape
    refw, ok = _ref_window(ref, diag, L)
    j = torch.arange(L, device=reads.device)[None, :]
    # positions past the read's length count as matched
    mism = ~((ok & (refw == reads)) | (j >= lens[:, None]))
    return torch.where(mism, j, -1).amax(dim=1) + 1


def _mode_diag(diag: torch.Tensor, mask: torch.Tensor):
    """Per read, the diagonal of the longest run of equal masked diagonals
    and its length: (best, runs), best = _NONE where the mask is empty.

    The JAX package scans the sorted row from its second column on and
    takes a run only when it is strictly longer than the longest so far, so
    the answer is the first column j >= 1 at which the run ending there is
    longest; a row whose only diagonal is in column 0 falls back to it."""
    R = diag.shape[0]
    ds = torch.sort(torch.where(mask, diag, _NONE).reshape(R, -1), dim=1).values
    M = ds.shape[1]
    j = torch.arange(M, device=ds.device)
    starts = torch.ones_like(ds, dtype=torch.bool)
    starts[:, 1:] = ds[:, 1:] != ds[:, :-1]
    cur = j - torch.cummax(torch.where(starts, j, 0), dim=1).values + 1
    ok = ds != _NONE
    ok[:, 0] = False
    score = torch.where(ok, cur, 0)
    runs = score.amax(dim=1)
    at = _first_true(score == runs[:, None]).clamp(max=M - 1)
    best = torch.where(runs > 0, ds.gather(1, at[:, None])[:, 0], _NONE)
    head = ds[:, 0] != _NONE
    best = torch.where(head & (runs == 0), ds[:, 0], best)
    return best, torch.maximum(runs, head.to(torch.int64))


def split_place(index: RefKmerIndex, reads, lens, opt: SvOptions):
    """Split placement of reads: per read the best (prefix diag, suffix
    diag), on the index's device.  reads (uint8 [R, L]) and lens are numpy
    arrays or tensors already on that device.

    Returns a dict of numpy arrays over reads: d_pre, d_suf, p (prefix run),
    s (suffix run start), valid, have_pre, have_suf."""
    R, L = reads.shape
    k = index.k
    if R == 0 or L < k:
        z = np.zeros(0, np.int64)
        return dict(d_pre=z, d_suf=z, p=z, s=z, valid=np.zeros(0, bool))
    dev = index.ref_codes.device
    rd = torch.as_tensor(reads, dtype=torch.uint8, device=dev)
    ln = torch.as_tensor(lens, dtype=torch.int64, device=dev)
    km, kvalid = dna.kmers_from_codes(rd, ln, k)
    pos, hit = index.lookup(km, opt.max_hits)  # [R, nwin, H]
    hit = hit & kvalid[:, :, None]
    nwin = pos.shape[1]
    offs = torch.arange(nwin, device=dev)[None, :, None]
    diag = torch.where(hit, pos - offs, -(1 << 62))
    # vote the dominant diagonal among early-offset hits (prefix) and
    # late-offset hits (suffix)
    third = torch.clamp(ln // 3, min=k)[:, None, None]
    pre_hit = hit & (offs < third)
    suf_hit = hit & (offs >= torch.clamp(ln[:, None, None] - k + 1 - third, min=0))
    d_pre, _ = _mode_diag(diag, pre_hit)
    d_suf, _ = _mode_diag(diag, suf_hit)
    have_pre = d_pre != _NONE
    have_suf = d_suf != _NONE
    d_pre = torch.where(have_pre, d_pre, 0)
    d_suf = torch.where(have_suf, d_suf, 0)
    p = _match_run_fwd(rd, ln, index.ref_codes, d_pre)
    s = _match_run_bwd(rd, ln, index.ref_codes, d_suf)
    valid = (
        have_pre
        & have_suf
        & (p >= opt.min_run)
        & (ln - s >= opt.min_run)
        & (d_pre != d_suf)
        & (d_pre >= 0)
        & (d_suf >= 0)
    )
    out = dict(
        d_pre=d_pre, d_suf=d_suf, p=p, s=s, valid=valid,
        have_pre=have_pre & (d_pre >= 0), have_suf=have_suf & (d_suf >= 0),
    )
    return {name: t.cpu().numpy() for name, t in out.items()}


def _events_from_split(sp, reads, lens, opt: SvOptions) -> List[Tuple[int, int, bytes, int]]:
    """(left, right, ins_codes, read) per supporting read, micro-homology
    resolved to the leftmost breakpoint."""
    out = []
    for i in np.nonzero(sp["valid"])[0]:
        d_pre, d_suf = int(sp["d_pre"][i]), int(sp["d_suf"][i])
        p, s = int(sp["p"][i]), int(sp["s"][i])
        # homology at the junction can pull the suffix run left past the
        # prefix run (s < p) or pull right below left: pin the junction at
        # the end of the prefix run and shift the suffix run right by the
        # overlap (the shifted bases match the reference by construction)
        s = max(s, p)
        left = d_pre + p
        right = d_suf + s
        if right < left:
            delta = left - right
            s += delta
            right += delta
            if s > int(lens[i]):
                continue
        ins = reads[i, p:s].tobytes()
        if right - left == len(ins) == 0:
            continue
        if (right - left) < opt.min_event and len(ins) < opt.min_event:
            continue
        out.append((left, right, ins, int(i)))
    return out


def _kmer_edge_table(reads: torch.Tensor, lens: torch.Tensor, k: int):
    """Sorted (kmer << 2 | next_base) edge keys and their counts over all
    reads (numpy int64): the chaining structure the reference builds by
    popping seqset entry fronts (pop_tracer.h:34-60), as one unique over
    every k-mer edge of the reads, on the reads' device."""
    dev = reads.device
    km, valid = dna.kmers_from_codes(reads, lens, k)
    R, W = km.shape
    if W <= 1:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    nb = reads[:, k:].to(torch.int64)  # next base after each window
    has_next = valid[:, :-1] & (torch.arange(W - 1, device=dev)[None, :] + k < lens[:, None])
    keys = (km[:, :-1] << 2) | nb
    uk, counts = torch.unique(keys[has_next], sorted=True, return_counts=True)
    return uk.cpu().numpy(), counts.to(torch.int64).cpu().numpy()


def _ref_hit(index: RefKmerIndex, kmer: int) -> int:
    """Smallest reference position of one k-mer, or -1."""
    q = torch.tensor([int(kmer)], dtype=torch.int64, device=index.ref_codes.device)
    pos, hit = index.lookup(q, 2)
    pos, hit = pos[0].cpu().numpy(), hit[0].cpu().numpy()
    for h in range(len(pos)):
        if hit[h]:
            return int(pos[h])
    return -1


def _assemble_breakend(
    seed_tails: List[np.ndarray],
    edge_keys: np.ndarray,
    edge_counts: np.ndarray,
    index: RefKmerIndex,
    left: int,
    opt: SvOptions,
    max_assembly: int = 20000,
    confirm: int = 16,
):
    """Extend the novel sequence hanging off a left breakend through the
    read k-mer graph until it re-anchors on the reference: the host oracle
    of the batched walk.

    Returns (ins_codes, right) or None.  The walk takes the heaviest
    outgoing edge each step; an anchor candidate (the current k-mer present
    in the reference) is accepted once ``confirm`` walked bases after it
    match the reference's right flank."""
    k = index.k
    mask = (1 << (2 * k)) - 1
    seed = _seed_bases(seed_tails, k)
    if seed is None:
        return None
    cur = 0
    for b in seed:
        cur = ((cur << 2) | int(b)) & mask
    assembled = [int(b) for b in seed]
    ref = index.ref_codes.cpu().numpy()
    pending = None  # (t_idx, q): an anchor awaiting confirmation
    q0 = _ref_hit(index, cur)
    if q0 >= 0:
        pending = (k - 1, q0)
    for _ in range(max_assembly):
        if pending is not None:
            t0, q = pending
            if len(assembled) - 1 - t0 >= confirm:
                seg = np.array(assembled[t0 + 1 : t0 + 1 + confirm], np.uint8)
                rseg = ref[q + k : q + k + confirm]
                if len(rseg) == confirm and (seg == rseg).all():
                    return np.array(assembled[: t0 - k + 1], np.uint8), q
                pending = None
        keys = np.int64((cur << 2) & (mask << 2)) | np.arange(4, dtype=np.int64)
        li = np.searchsorted(edge_keys, keys)
        lic = np.clip(li, 0, max(len(edge_keys) - 1, 0))
        ok = (li < len(edge_keys)) & (len(edge_keys) > 0)
        ok = ok & (edge_keys[lic] == keys)
        counts = np.where(ok, edge_counts[lic], 0)
        if counts.max(initial=0) < 2:
            break
        nb = int(counts.argmax())
        cur = ((cur << 2) | nb) & mask
        assembled.append(nb)
        if pending is None:
            q = _ref_hit(index, cur)
            # plausible right side only: at or after the breakend
            if q >= 0 and q >= left - opt.cluster_pad and len(assembled) - k >= 0:
                pending = (len(assembled) - 1, q)
    # end of the walk: a pending anchor whose remaining bases all match
    if pending is not None:
        t0, q = pending
        seg = np.array(assembled[t0 + 1 :], np.uint8)
        rseg = ref[q + k : q + k + len(seg)]
        if len(seg) >= 4 and len(rseg) == len(seg) and (seg == rseg).all():
            return np.array(assembled[: t0 - k + 1], np.uint8), q
    return None


def _seed_bases(seed_tails: List[np.ndarray], k: int):
    """Per-column majority over the cluster's tails: the first k bases (a
    tie goes to the smallest base), or None when no tail reaches k or a
    column is empty."""
    L0 = max(len(t) for t in seed_tails)
    if L0 < k:
        return None
    mat = np.full((len(seed_tails), L0), -1, np.int8)
    for i, t in enumerate(seed_tails):
        mat[i, : len(t)] = t
    seed = []
    for j in range(k):
        col = mat[:, j]
        col = col[col >= 0]
        if len(col) == 0:
            return None
        seed.append(int(np.bincount(col, minlength=4).argmax()))
    return seed


def _seed_consensus(seed_tails: List[np.ndarray], k: int):
    """The cluster's seed k-mer (int) from ``_seed_bases``, or None."""
    bases = _seed_bases(seed_tails, k)
    if bases is None:
        return None
    seed = 0
    for b in bases:
        seed = (seed << 2) | b
    return seed


def _breakend_walk(seeds, lefts, edge_keys, edge_counts, index: RefKmerIndex, confirm: int,
                   max_assembly: int, pad: int, stats: dict | None = None):
    """The greedy unitig walk of every breakend cluster at once, one lane a
    cluster: the same update rules as ``_assemble_breakend`` (heaviest
    outgoing edge with count >= 2, the first maximum on a tie; anchor on
    the smallest reference position of the current k-mer; accept after
    ``confirm`` walked bases match the right flank).

    Returns (path [L, CAP] uint8, nstep, pend_t0, pend_q, success, res_t0,
    res_q) as tensors on the index's device; the end-of-walk partial match
    is the caller's.  ``stats["walk_steps"]`` gets the steps run."""
    k = index.k
    dev = seeds.device
    L = seeds.shape[0]
    CAP = max_assembly + k
    ref = index.ref_codes
    G = ref.shape[0]
    E = edge_keys.shape[0]
    kmask = (1 << (2 * k)) - 1
    ref_kmers, ref_pos = index.kmers, index.positions
    nk = ref_kmers.shape[0]
    lanes = torch.arange(L, device=dev)

    def ref_first_pos(cur):
        """Smallest reference position of each k-mer, -1 when absent: the
        index sorts stably, so a k-mer's run head is its least position."""
        if nk == 0:
            return torch.full_like(cur, -1)
        i = torch.searchsorted(ref_kmers, cur)
        ic = i.clamp(0, nk - 1)
        return torch.where((i < nk) & (ref_kmers[ic] == cur), ref_pos[ic], -1)

    path = torch.zeros((L, CAP), dtype=torch.uint8, device=dev)
    shifts = 2 * (k - 1 - torch.arange(k, device=dev))
    path[:, :k] = ((seeds[:, None] >> shifts[None, :]) & 3).to(torch.uint8)
    q0 = ref_first_pos(seeds)
    cur = seeds.clone()
    nstep = torch.full((L,), k, dtype=torch.int64, device=dev)
    pend_t0 = torch.where(q0 >= 0, k - 1, -1)
    pend_q = q0
    stopped = torch.zeros(L, dtype=torch.bool, device=dev)
    success = torch.zeros(L, dtype=torch.bool, device=dev)
    res_t0 = torch.full((L,), -1, dtype=torch.int64, device=dev)
    res_q = torch.full((L,), -1, dtype=torch.int64, device=dev)
    conf_ar = torch.arange(confirm, device=dev)
    four = torch.arange(4, device=dev)
    steps = 0
    for it in range(max_assembly):
        if it % WALK_SYNC_EVERY == 0 and not bool((~stopped).any()):
            break
        steps += 1
        act = ~stopped
        # 1) pending-anchor confirmation
        check = act & (pend_t0 >= 0) & (nstep - 1 - pend_t0 >= confirm)
        segi = (pend_t0[:, None] + 1 + conf_ar[None, :]).clamp(0, CAP - 1)
        seg = path.gather(1, segi)
        refi = pend_q[:, None] + k + conf_ar[None, :]
        refseg = ref[refi.clamp(0, G - 1)]
        okconf = ((refi >= 0) & (refi < G) & (refseg == seg)).all(dim=1)
        newly_ok = check & okconf
        success = success | newly_ok
        res_t0 = torch.where(newly_ok, pend_t0, res_t0)
        res_q = torch.where(newly_ok, pend_q, res_q)
        stopped = stopped | newly_ok
        pend_t0 = torch.where(check & ~okconf, -1, pend_t0)  # a failed check clears it
        act2 = ~stopped
        # 2) the heaviest outgoing edge with support >= 2
        keys = ((cur << 2) & (kmask << 2))[:, None] | four[None, :]
        if E:
            li = torch.searchsorted(edge_keys, keys)
            lic = li.clamp(0, E - 1)
            counts = torch.where((li < E) & (edge_keys[lic] == keys), edge_counts[lic], 0)
        else:
            counts = torch.zeros_like(keys)
        bw = counts.amax(dim=1)
        best = _first_true(counts == bw[:, None])
        dead_end = act2 & (bw < 2)
        stopped = stopped | dead_end
        ext = act2 & ~dead_end
        # 3) extend
        cur = torch.where(ext, ((cur << 2) | best) & kmask, cur)
        wr = nstep.clamp(0, CAP - 1)
        path[lanes, wr] = torch.where(ext, best.to(torch.uint8), path[lanes, wr])
        nstep = torch.where(ext, nstep + 1, nstep)
        # 4) a new pending anchor, plausible right side only
        qn = ref_first_pos(cur)
        take = ext & (pend_t0 < 0) & (qn >= 0) & (qn >= lefts - pad)
        pend_t0 = torch.where(take, nstep - 1, pend_t0)
        pend_q = torch.where(take, qn, pend_q)
    if stats is not None:
        stats["walk_steps"] = stats.get("walk_steps", 0) + steps
    return path, nstep, pend_t0, pend_q, success, res_t0, res_q


def _assemble_breakends_batch(
    seeds: np.ndarray,
    lefts: np.ndarray,
    edge_keys: np.ndarray,
    edge_counts: np.ndarray,
    index: RefKmerIndex,
    opt: SvOptions,
    max_assembly: int = 20000,
    confirm: int = 16,
    stats: dict | None = None,
):
    """Every cluster's breakend walk as device lanes; per cluster
    (ins_codes, right) or None, by the acceptance rules of the host oracle
    ``_assemble_breakend``."""
    L = len(seeds)
    if L == 0:
        return []
    k = index.k
    dev = index.ref_codes.device

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64).copy()).to(dev)

    out_t = _breakend_walk(
        t(seeds), t(lefts), t(edge_keys), t(edge_counts), index,
        confirm, max_assembly, int(opt.cluster_pad), stats,
    )
    path, nstep, pend_t0, pend_q, success, res_t0, res_q = (x.cpu().numpy() for x in out_t)
    ref = index.ref_codes.cpu().numpy()
    out = []
    for i in range(L):
        t0, q = -1, -1
        if success[i]:
            t0, q = int(res_t0[i]), int(res_q[i])
        elif pend_t0[i] >= 0:
            # end of the walk: a pending anchor whose remaining bases match
            t0p, qp = int(pend_t0[i]), int(pend_q[i])
            seg = path[i, t0p + 1 : nstep[i]]
            rseg = ref[qp + k : qp + k + len(seg)]
            if len(seg) >= 4 and len(rseg) == len(seg) and (seg == rseg).all():
                t0, q = t0p, qp
        if t0 >= 0 and t0 - k + 1 >= 0:
            out.append((path[i, : t0 - k + 1].copy(), q))
        else:
            out.append(None)
    return out


def _left_normalize_event(ref: np.ndarray, left: int, right: int, ins: np.ndarray):
    """Shift a (deleted span [left, right) + inserted sequence) left while
    the base entering on the right equals the base leaving on the left (VCF
    left alignment of the event as a whole)."""
    ins = list(ins)
    while left > 0:
        prev = ref[left - 1]
        tail = ins[-1] if ins else (ref[right - 1] if right > left else None)
        if tail is None or tail != prev:
            break
        if ins:
            ins = [prev] + ins[:-1]
        left -= 1
        right -= 1
    return left, right, np.array(ins, np.uint8)


def _sv_scan_reads(
    index: RefKmerIndex,
    codes: np.ndarray,
    lengths: np.ndarray,
    opt: SvOptions,
    placements: Placements | None = None,
    owner_base: int = 0,
    stats: dict | None = None,
):
    """The per-read scan, the phase that shards by read.

    Places the reads (unless given), split-places the unplaced ones in both
    orientations and returns (placements, raw_events, clip_cands,
    edge_keys, edge_counts): events and clips carry global read ids (local
    index + owner_base), the edge table covers this slice's unplaced reads
    (``merge_edge_tables`` joins slices).  Disjoint slices scanned apart and
    merged finalize to the single pass's records."""
    if placements is None:
        placements = place_reads(index, codes, lengths, max_mismatches=3)
    unplaced = np.nonzero(placements.pos < 0)[0]
    raw_events: List[Tuple[int, int, bytes, int]] = []
    clip_cands: List[Tuple[int, np.ndarray, int]] = []  # (left, tail, owner)
    if stats is not None:
        stats["unplaced_reads"] = stats.get("unplaced_reads", 0) + len(unplaced)
    if len(unplaced) == 0:
        return placements, raw_events, clip_cands, np.zeros(0, np.int64), np.zeros(0, np.int64)

    # both orientations of each unplaced read
    dev = index.ref_codes.device
    sub = codes[unplaced]
    sublen = lengths[unplaced]
    sub_t = torch.from_numpy(np.ascontiguousarray(sub, np.uint8)).to(dev)
    sublen_t = torch.from_numpy(np.asarray(sublen).copy()).to(dev)
    rc = dna.revcomp_codes(sub_t, sublen_t)
    reads2_t = torch.cat([sub_t, rc])
    lens2_t = torch.cat([sublen_t, sublen_t]).to(torch.int64)
    reads2 = reads2_t.cpu().numpy()  # the host copy: events' inserted bases, clip tails
    lens2 = np.concatenate([sublen, sublen])
    owner = np.concatenate([unplaced, unplaced]) + owner_base

    for lo in range(0, len(reads2), opt.max_reads_batch):
        hi = min(len(reads2), lo + opt.max_reads_batch)
        sp = split_place(index, reads2_t[lo:hi], lens2_t[lo:hi], opt)
        for left, right, ins, i in _events_from_split(sp, reads2[lo:hi], lens2[lo:hi], opt):
            raw_events.append((left, right, ins, int(owner[lo + i])))
        # one-sided left clips: the prefix anchors, the tail is novel (the
        # material of insertions longer than a read)
        oneside = sp["have_pre"] & ~sp["valid"] & (sp["p"] >= opt.min_run) & (lens2[lo:hi] - sp["p"] >= index.k + 4)
        for i in np.nonzero(oneside)[0]:
            p = int(sp["p"][i])
            clip_cands.append((int(sp["d_pre"][i]) + p, reads2[lo + i, p : lens2[lo + i]].copy(), int(owner[lo + i])))
    edge_keys, edge_counts = _kmer_edge_table(reads2_t, lens2_t, index.k)
    if stats is not None:
        stats["split_events"] = stats.get("split_events", 0) + len(raw_events)
        stats["clip_candidates"] = stats.get("clip_candidates", 0) + len(clip_cands)
    return placements, raw_events, clip_cands, edge_keys, edge_counts


def merge_edge_tables(parts):
    """Merge per-slice sorted (edge_keys, edge_counts) tables, summing the
    counts of equal keys."""
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    keys = np.concatenate([k for k, _ in parts])
    counts = np.concatenate([c for _, c in parts])
    uk, inv = np.unique(keys, return_inverse=True)
    out = np.zeros(len(uk), np.int64)
    np.add.at(out, inv, counts)
    return uk, out


def _clip_clusters(clip_cands, k: int, opt: SvOptions):
    """Left clips grouped within cluster_pad: (left_c, owners, seed k-mer,
    the tails the seed was voted from) for each group with min_sv_reads
    distinct reads and a seed."""
    # (left, owner) key: the same grouping whatever order slices added them
    clip_cands = sorted(clip_cands, key=lambda t: (t[0], t[2]))
    groups = []
    gi = 0
    while gi < len(clip_cands):
        gj = gi + 1
        while gj < len(clip_cands) and clip_cands[gj][0] - clip_cands[gi][0] <= opt.cluster_pad:
            gj += 1
        group = clip_cands[gi:gj]
        owners = {o for _, _, o in group}
        if len(owners) >= opt.min_sv_reads:
            lefts = np.array([l for l, _, _ in group])
            left_c = int(np.bincount(lefts - lefts.min()).argmax() + lefts.min())
            tails = [t for l, t, _ in group if l == left_c] or [t for _, t, _ in group]
            seed = _seed_consensus(tails, k)
            if seed is not None:
                groups.append((left_c, owners, seed, tails))
        gi = gj
    return groups


def _sv_finalize(
    reference,
    index: RefKmerIndex,
    raw_events,
    clip_cands,
    edge_keys,
    edge_counts,
    pos_all: np.ndarray,
    rc_all: np.ndarray,
    lengths: np.ndarray,
    mate_of: np.ndarray | None,
    opt: SvOptions,
    stats: dict | None = None,
) -> List[Dict]:
    """Clustering, breakend assembly, pair evidence and records over the
    (merged) scan; pos_all, rc_all, lengths and mate_of are over all reads,
    and a mate_of of None or of every read its own mate is unpaired."""
    ref = index.ref_codes.cpu().numpy()
    # cluster: the exact key after left normalization, then merge within pad
    norm: Dict[Tuple[int, int, bytes], set] = {}
    for left, right, ins, rid in raw_events:
        ln, rn, insn = _left_normalize_event(ref, left, right, np.frombuffer(ins, np.uint8))
        norm.setdefault((int(ln), int(rn), insn.tobytes()), set()).add(rid)

    # breakend assembly: every clip cluster's walk as a lane of one loop
    groups = _clip_clusters(clip_cands, index.k, opt) if clip_cands else []
    if stats is not None:
        stats["clip_clusters"] = len(groups)
        stats["breakend_lanes"] = len(groups)
        stats.setdefault("walk_steps", 0)
    if groups:
        results = _assemble_breakends_batch(
            np.array([g[2] for g in groups], np.int64),
            np.array([g[0] for g in groups], np.int64),
            edge_keys, edge_counts, index, opt, stats=stats,
        )
        assembled = 0
        for (left_c, owners, _, _), res in zip(groups, results):
            if res is None:
                continue
            assembled += 1
            ins_codes, right_c = res
            if 0 < left_c - right_c <= index.k + opt.cluster_pad:
                # junction micro-homology: the walk re-anchored a few bases
                # left of the clip; pin the junction at left_c and give the
                # homologous reference bases to the insertion
                ins_codes = np.concatenate([ins_codes, ref[right_c:left_c]]).astype(np.uint8)
                right_c = left_c
            if (len(ins_codes) >= opt.min_event or right_c - left_c >= opt.min_event) and right_c >= left_c:
                ln, rn, insn = _left_normalize_event(ref, left_c, right_c, ins_codes)
                norm.setdefault((int(ln), int(rn), insn.tobytes()), set()).update(owners)
        if stats is not None:
            stats["breakends_assembled"] = assembled
    # merge keys whose breakpoints differ by <= cluster_pad with the same
    # inserted length and deleted span
    keys = sorted(norm.keys())
    merged: List[SvEvent] = []
    used = [False] * len(keys)
    for a in range(len(keys)):
        if used[a]:
            continue
        la, ra, ia = keys[a]
        readset = set(norm[keys[a]])
        for b in range(a + 1, len(keys)):
            if used[b]:
                continue
            lb, rb, ib = keys[b]
            if lb - la > opt.cluster_pad:
                break
            if (rb - lb) == (ra - la) and len(ib) == len(ia) and abs(lb - la) <= opt.cluster_pad:
                readset |= norm[keys[b]]
                used[b] = True
        used[a] = True
        merged.append(SvEvent(left=la, right=ra, ins=np.frombuffer(ia, np.uint8), support=len(readset)))
    merged = [e for e in merged if e.support >= opt.min_sv_reads]

    if mate_of is not None and (mate_of != np.arange(len(pos_all))).any() and len(merged):
        # proper pairs straddling the junction with a plausible implied
        # fragment once the event is removed
        pos, rcb, mate = pos_all, rc_all, np.asarray(mate_of)
        both = (pos >= 0) & (pos[mate] >= 0) & (mate != np.arange(len(pos)))
        proper = both & (rcb != rcb[mate])
        lo_p = np.minimum(pos, pos[mate])
        hi_p = np.maximum(pos + lengths, pos[mate] + lengths[mate])
        sel = np.nonzero(proper)[0]
        lo_p, hi_p = lo_p[sel], hi_p[sel]
        # pairs with one mate in the novel sequence (pair_cov's pairs placed
        # into the assembled insertion, pair_cov.cpp): an anchored read
        # within a fragment of the junction whose mate failed placement
        # supports an insertion longer than a fragment
        half = (pos >= 0) & (pos[mate] < 0) & (mate != np.arange(len(pos)))
        hp, hl = pos[half], lengths[half]
        for e in merged:
            straddle = (lo_p + 1 <= e.left) & (hi_p - 1 >= e.right)
            implied = (hi_p - lo_p) - e.del_len + e.ins_len
            e.pair_support = int((straddle & (implied <= opt.max_frag) & (implied > 0)).sum()) // 2
            if e.ins_len > opt.max_frag - 2 * int(lengths.max(initial=0)):
                near = ((hp + hl >= e.left - opt.max_frag) & (hp + hl <= e.left)) | ((hp >= e.right) & (hp <= e.right + opt.max_frag))
                e.pair_support += int(near.sum())
    elif len(merged):
        # unpaired library: spanning placed reads stand in for pairs
        pos = pos_all
        sel = np.nonzero(pos >= 0)[0]
        for e in merged:
            span = (pos[sel] + 1 <= e.left) & (pos[sel] + lengths[sel] - 1 >= e.right)
            e.pair_support = 0 if e.del_len > int(lengths.max(initial=0)) else int(span.sum())

    out = []
    for e in merged:
        left, right, ins = e.left, e.right, e.ins
        contig = None
        for c in reference.contigs:
            if c.start <= left < c.start + c.length:
                contig = c
                break
        if contig is None or right > contig.start + contig.length:
            continue
        anchor = ref[left - 1] if left > 0 else ref[left]
        pos0 = left - 1 if left > 0 else left
        out.append(
            {
                "chrom": contig.name,
                "pos": int(pos0 - contig.start + 1),
                "ref": dna.codes_to_seq(np.concatenate([[anchor], ref[left:right]]).astype(np.uint8)),
                "alt": dna.codes_to_seq(np.concatenate([[anchor], ins]).astype(np.uint8)),
                "support": int(e.support),
                "ref_support": 0,
                "pair_support": int(e.pair_support),
                "svlen": int(e.ins_len - e.del_len),
            }
        )
    out.sort(key=lambda r: (r["chrom"], r["pos"]))
    return out


def discover_structural(
    reference,
    codes: np.ndarray,
    lengths: np.ndarray,
    mate_of: np.ndarray | None = None,
    opt: SvOptions | None = None,
    placements: Placements | None = None,
    index: RefKmerIndex | None = None,
    device="cuda",
    stats: dict | None = None,
) -> List[Dict]:
    """Structural variants of at least min_event bases from split reads and
    pair support: discovery-record dicts (chrom, pos, ref, alt, support,
    ref_support, pair_support, svlen) that merge with the wavefront's.
    The reads and their mates are ``Readmap.forward_reads``'; a mate_of of
    None or of every read its own mate is an unpaired library.

    Runs on ``device``, or on the given index's device.  ``stats`` (a dict,
    filled in place) gets the engine's counters: unplaced_reads,
    split_events, clip_candidates, clip_clusters, breakend_lanes,
    breakends_assembled and walk_steps."""
    opt = opt or SvOptions()
    if index is None:
        index = RefKmerIndex.build(
            np.asarray(reference.flat), opt.k, is_n=getattr(reference, "is_n", None), device=resolve_device(device)
        )
    placements, raw_events, clip_cands, edge_keys, edge_counts = _sv_scan_reads(
        index, codes, lengths, opt, placements=placements, stats=stats
    )
    if not raw_events and not clip_cands:
        return []
    return _sv_finalize(
        reference, index, raw_events, clip_cands, edge_keys, edge_counts,
        placements.pos, placements.is_rc, lengths, mate_of, opt, stats=stats,
    )
