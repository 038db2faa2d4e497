"""Wavefront assembly along the reference: the discovery engine (torch).

Counterpart of ``biograph_tpu/variants/discover.py`` for the path from the
read store (and, where given, the readmap) to variant records: instead of one
pointer-chasing path walk at a time, a *beam of frontier lanes* advances
through the seqset in lockstep, every step a batch of rank queries.

Coordinate convention: the walk runs left-to-right over the reference but
the seqset prepends bases, so lanes hold ranges in reverse-complement space:
pushing complement(b) appends b on the forward strand.

Stages:
  1. prescreen     - positions whose ending 12-mer occurs in the read set
                     (a bitmap over all 4^12 12-mers, a seqset property)
  2. front end     - a min_anchor_ctx find-window filter and the exact
                     longest-window bisection, every lane one chain of the
                     chain_window kernel
  3. anchors       - the 4-base branch probe (push4) at every lane
  4. wavefront     - beam search: each step pushes 4 candidate bases a lane
                     (push4), keeps the child its policy ranks, truncates to
                     probe_ctx, and tests rejoin against a span k-mer table
  5. scoring       - with a readmap: each assembly's read coverage along its
                     alt path and its reference span (``score_assemblies``
                     over ``Readmap.coverage``), the min_alt_support
                     filter, and the pair gate (``pair_gate_assemblies``:
                     long alt paths need mate pairs placed around them by
                     ``variants/align.py``)
  6. variants      - prefix/suffix trimming and the affine DP of
                     ``ops/align_dp.py`` -> SNP/ins/del records,
                     left-normalized
  7. output        - ``write_discovery_vcf`` (``io/vcf.py``) and
                     ``write_assembly_csv``

On the card the seqset work goes through the kernels of ``ops/rank4.py``
(``rank`` in the seed's push_front, ``push4`` in the anchor scan and every
beam step, ``chain_window`` in the filter and the bisection, and in
coverage where its routes need it); on CPU tensors the same code runs on
their plain versions.  The front end is the JAX package's accelerator route
(``find_window_auto`` + ``probe_exact`` on the chain kernel over every
prescreened lane); its CPU route (the rolling-hash filter and the push4
pre-gate) gives the same anchors.  Scoring takes the JAX package's
accelerator form, one padded coverage batch, on every device.

Not ported yet, each raising ``NotImplementedError`` where a call would need
it: the dense front end for ``min_anchor_ctx < 12`` (the restart masks of
``discover.py``'s non-prescreen route), in-loop truncation without the trunc
tables (``ops/ltsearch.py``), and the sharded engine.  The JAX package's
block, chunk, interleaved and whole-device wavefront dispatch loops are
replaced by one host loop with done-lane compaction.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from biograph_tpu_torch.core import dna
from biograph_tpu_torch.index import probes
from biograph_tpu_torch.index.readmap import Readmap
from biograph_tpu_torch.index.seqset import Seqset, SeqsetRanges
from biograph_tpu_torch.ops.align_dp import align_blocks_batch


@dataclass
class DiscoverOptions:
    """Engine knobs, field for field those of the JAX package's
    ``DiscoverOptions`` (the scoring, pair-gate and VCF knobs are carried for
    the slices that use them)."""

    min_anchor_ctx: int = 20  # min ref context at a branch point
    probe_ctx: int = 25  # context length for branch probing / extension
    # Range widths count DISTINCT suffix continuations (entries are deduped),
    # so validity (>=1) is the branch criterion
    min_branch_width: int = 1
    min_extend_width: int = 1
    beam_width: int = 256  # frontier lanes per group, at least
    bidir: bool = True  # trace fwd AND reverse-complement
    skip_trace_fwd: bool = False
    skip_trace_rev: bool = False
    max_path: int = 420  # max assembled alt bases (300bp-class insertions fit)
    rejoin_k: int = 23  # suffix k-mer size for rejoin detection
    max_assemblies: int = 4096  # per orientation; truncation is counted
    min_alt_support: int = 3
    hom_frac: float = 0.8
    # beam clones per anchor (best/second-best at the first junctions);
    # power of two (each junction consumes one policy bit)
    branch_clones: int = 4
    # adaptive depth: anchors whose whole clone beam dies un-rejoined are
    # re-explored with branch_clones x 4^round clones
    branch_retry_rounds: int = 1
    # rejoin search window in bases, rounded up to a power of two
    read_ahead_distance: int = 1 << 18
    scaffold_split_size: int = 1 << 20
    # coverage scoring
    read_cov_max_reads_per_entry: int = 0
    penalize_directional_coverage: bool = True
    # VCF-emit genotype gate
    simple_genotype_filter: bool = True
    min_depth_portion: float = 0.23
    min_read_depth: int = 1
    min_pair_depth: int = 0
    # in-search pair evidence
    pair_gate: bool = True
    max_bases_between_pairs: int = 300
    max_pair_distance: int = 1000
    min_pair_evidence: int = 1
    # VCF output shaping
    vcf_sv_size_threshold: int = 50
    output_assembly_ids: bool = False
    # debug: dump any assembly whose bubble overlaps one of these flat offsets
    trace_offsets: tuple = ()


@dataclass
class Assembly:
    """One assembled alternate path."""

    chunk_start: int  # flat ref coord of the span table's base
    anchor: int  # last ref-matching position (flat coords)
    rejoin: int  # first ref-matching position after the bubble (flat)
    seq: np.ndarray  # alt bases between anchor and rejoin (uint8 codes)
    support: int  # min range width along the path
    ref_support: int = 0


MAXA = 8192  # max anchors returned per anchor scan (truncation is counted)
CHECK_EVERY = 48  # beam steps between polls of the undone count
WAVE_LANES = 4096  # anchors pooled into one beam group, at least
WAVE_COMPACT_MIN = 512  # never shrink a beam state below this width
SPAN_TABLE_CAP = 1 << 23  # shared span table rows: 134 MB as two int64 arrays
# what the memory plan budgets against when the seqset lies on the host
HOST_BUDGET_BYTES = 4 << 30
_SENTINEL = torch.iinfo(torch.int64).max  # pad rows of the span tables


def _next_pow2(n):
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


class _StageClock:
    """Seconds a stage, added into ``stage_s`` under the stage's name; the
    host clock is read after the device has drained."""

    def __init__(self, dev, stage_s: dict):
        self.dev, self.stage_s = dev, stage_s
        self.t = self._now()

    def _now(self) -> float:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.time()

    def mark(self, stage: str) -> None:
        now = self._now()
        self.stage_s[stage] = self.stage_s.get(stage, 0.0) + (now - self.t)
        self.t = now


# ---------------------------------------------------------------------------
# memory plan
# ---------------------------------------------------------------------------


def _discovery_memory_plan(ss: Seqset, G: int, stats: dict | None = None):
    """Budget discovery's device-resident working set: the seqset core, the
    prescreen bitmap, the doubled reference, the two n-entry trunc tables
    and the shared rejoin span table, against half the card's memory
    (``torch.cuda.mem_get_info``) or, for a seqset on the host,
    ``HOST_BUDGET_BYTES``.  The core is what the seqset holds on the query
    device: the engine's tensors (rank-block table, entry sizes, shared,
    pop_sel, fixed) and the stored rank pair where it lies there too.  Over
    budget the shared span table shrinks or goes first (groups then build
    their own bounded tables); a plan without trunc tables cannot run yet
    (``discover_variants`` raises).  The plan is recorded in
    stats["memory_plan"]."""
    if ss.device.type == "cuda":
        budget = torch.cuda.mem_get_info(ss.device)[1] // 2
    else:
        budget = HOST_BUDGET_BYTES
    n = int(ss.n_entries)
    d = ss.d
    held = [d.fixed, d.rank_blocks, d.entry_sizes, d.shared, d.pop_sel]
    held += [t for t in (ss.prev_words, ss.prev_cum) if t.device == ss.device]
    core = sum(t.numel() * t.element_size() for t in held)
    core += 1 << (2 * _PRESCREEN_K)  # the prescreen bitmap, one byte a k-mer
    ref2 = 2 * G  # doubled fwd++rc reference, uint8
    trunc = 16 * n  # prev_lt + next_lt, int64 each
    head = budget - core - ref2
    use_trunc = head >= trunc
    span_budget = head - (trunc if use_trunc else 0)
    span_cap = min(SPAN_TABLE_CAP, max(span_budget // 16, 0))
    if span_cap < 16384:  # smallest ladder rung: shared table off
        span_cap = 0
    plan = {
        "budget_bytes": int(budget),
        "core_bytes": core,
        "ref2_bytes": ref2,
        "trunc_bytes": trunc,
        "use_trunc_tables": bool(use_trunc),
        "span_table_cap": int(span_cap),
    }
    if stats is not None:
        stats["memory_plan"] = plan
    return plan


# ---------------------------------------------------------------------------
# prescreen
# ---------------------------------------------------------------------------

_PRESCREEN_K = 12  # bitmap k-mer (4^12 = 16.7M one-byte slots)
_PRESCREEN_BLK = 256  # the hit mask is padded to a multiple of this


def _prescreen_bitmap(ss: Seqset) -> torch.Tensor:
    """uint8 [4^K] membership bitmap of every K-mer present in the read set,
    cached on the seqset instance (it is a property of the seqset alone).

    The seqset's entries are the prefix-maximal distinct suffixes of reads
    ++ revcomps, so the K-prefixes of entries with size >= K enumerate
    EXACTLY the length-K substrings of the read set; the set is rc-closed
    because the build includes revcomps."""
    bm = ss.__dict__.get("_prescreen_bitmap")
    if bm is None:
        K = _PRESCREEN_K
        d = ss.d
        n = d.n_entries
        seqs = d.sequences(torch.arange(n, dtype=torch.int64, device=d.device), K)
        val = torch.zeros(n, dtype=torch.int64, device=d.device)
        for i in range(K):
            val = (val << 2) | seqs[:, i].to(torch.int64)
        bm = torch.zeros(1 << (2 * K), dtype=torch.uint8, device=d.device)
        bm[val[d.entry_sizes >= K]] = 1
        ss.__dict__["_prescreen_bitmap"] = bm
    return bm


def _hit_mask(bitmap, ref2_dev) -> torch.Tensor:
    """Per-position 'the K-mer ENDING here is a read K-mer' (positions
    p < K-1 read a zero pad: anchors need >= min_anchor_ctx of context so
    none live there).  bool, padded to a BLK multiple."""
    K = _PRESCREEN_K
    n2 = ref2_dev.shape[0]
    width = -(-n2 // _PRESCREEN_BLK) * _PRESCREEN_BLK
    refp = torch.cat([ref2_dev.new_zeros(K - 1), ref2_dev, ref2_dev.new_zeros(width - n2)])
    val = torch.zeros(width, dtype=torch.int64, device=ref2_dev.device)
    for j in range(K):
        val = (val << 2) | refp[j : j + width].to(torch.int64)
    hit = bitmap[val] > 0
    hit[n2:] = False
    return hit


def _hit_positions(hit, Pc: int) -> torch.Tensor:
    """The first Pc hit positions, ascending, padded with -1: int64 [Pc]."""
    found = torch.nonzero(hit)[:Pc, 0]
    pos = torch.full((Pc,), -1, dtype=torch.int64, device=hit.device)
    pos[: found.shape[0]] = found
    return pos


def use_prescreen(opt) -> bool:
    """K-mer coverage prescreen gate: sound whenever anchors require at
    least K bases of context (a window of length >= min_anchor_ctx >= K
    ending at p contains the K-mer ending at p, so un-hit positions can
    never anchor)."""
    return opt.min_anchor_ctx >= _PRESCREEN_K


# ---------------------------------------------------------------------------
# front end: filter -> exact -> anchor scan
# ---------------------------------------------------------------------------


def _anchor_scan_at(d, ref2, pos, begin, end, size, min_anchor_ctx: int,
                    min_branch_width: int, cap):
    """Branch probe + anchor detection over a compact lane set.

    One push4 gives all four children of every lane's probe range; lanes
    where a non-reference base has a continuation (and enough context)
    become anchors.  cap: per-lane anchor-position bound encoding every
    validity gate (segment membership, p_last, seg_hi, min context,
    padding) as (pos + 1) <= cap; -1 disables a lane.

    Returns (n_raw, stacked): the count of anchors found and int64
    [5, min(n_raw, MAXA)] rows (pos, alt base, begin, end, size) of the
    first MAXA of them in lane order."""
    n2 = ref2.shape[0]
    nb4, ne4 = d.push4(SeqsetRanges(begin, end, size))
    # candidate alt base bb pushes complement 3-bb -> flip columns
    W4 = (ne4 - nb4).flip(1)
    nxt = ref2[(pos + 1).clamp(0, n2 - 1)].to(torch.int64)
    base_ids = torch.arange(4, device=pos.device)[None, :]
    good = (
        (W4 >= min_branch_width)
        & (base_ids != nxt[:, None])
        & (size[:, None] >= min_anchor_ctx)
        & ((pos + 1)[:, None] <= cap[:, None])
        & (begin < end)[:, None]
    )
    src = torch.nonzero(good.reshape(-1))[:, 0]
    n_raw = src.shape[0]
    src = src[:MAXA]
    li = src // 4
    stacked = torch.stack(
        [pos[li], src % 4, begin[li], end[li], size[li].to(torch.int64)]
    )
    return n_raw, stacked


def _candidate_lanes(ss, ref2_dev, segments, opt, stats):
    """The lanes the front end probes: (hit_pos, pos, cap, ctx).  hit_pos is
    the prescreen's hit positions, padded with -1 to a power of two; pos the
    hits that lie in a segment with enough context, cap each lane's anchor
    position bound (``_anchor_scan_at``) and ctx the start of its segment's
    context."""
    hit = _hit_mask(_prescreen_bitmap(ss), ref2_dev)
    n_hits = int(hit.sum())
    stats["prescreen_probed"] = n_hits
    hit_pos = _hit_positions(hit, max(_next_pow2(n_hits), 1024))
    del hit
    # per-lane validity cap and context clip (<= 2 segments: a where-chain)
    cap = torch.full_like(hit_pos, -1)
    ctx = torch.zeros_like(hit_pos)
    for _, ctx_lo, p_first, p_last, seg_hi in segments:
        in_seg = (hit_pos >= p_first) & (hit_pos <= p_last)
        cap = torch.where(in_seg, min(seg_hi, p_last + 1), cap)
        ctx = torch.where(in_seg, ctx_lo, ctx)
    cap = torch.where(hit_pos - ctx + 1 >= opt.min_anchor_ctx, cap, -1)
    # the lanes: a hit outside every segment (a region was asked for), one
    # short of context, and the padding can never anchor
    lanes = torch.nonzero(cap >= 0)[:, 0]
    return hit_pos, hit_pos[lanes], cap[lanes], ctx[lanes]


def _find_anchors(ss, ref2_dev, segments, opt, stats, clock, G):
    """Prescreened compact front end: filter -> exact -> anchor scan over
    the prescreen's hit positions only.  Returns (anchor_parts, hit_pos):
    the anchors' numpy columns (pos, alt base, begin, end, size) by
    orientation (False the forward half, True the reverse-complement half),
    and the prescreen's hit positions, padded with -1 to a power of two.

    The min_anchor_ctx find-window filter marks the candidate lanes that
    cannot anchor, and the binary-search exact probe recovers the
    longest-window range of each lane.  Every candidate runs through the
    exact rounds: on the chain kernel they cost less than compacting to the
    filter's live subset would, dead lanes stay invalid through the rounds
    and the anchor gate drops them."""
    d = ss.d
    hit_pos, pos, cap, ctx = _candidate_lanes(ss, ref2_dev, segments, opt, stats)
    # filter: does a min_anchor_ctx window end here?
    seed = probes.find_window_auto(d, ref2_dev, pos, opt.min_anchor_ctx, opt.probe_ctx)
    clock.mark("probe_filter")
    b2, e2, s2 = probes.probe_exact_kernel(
        d, ref2_dev, pos, ctx, opt.probe_ctx, opt.min_anchor_ctx, seed
    )
    del seed
    clock.mark("probe_exact")
    n_raw, stacked = _anchor_scan_at(
        d, ref2_dev, pos, b2, e2, s2, opt.min_anchor_ctx,
        opt.min_branch_width, cap,
    )
    del b2, e2, s2, cap, ctx, pos
    live = stacked.cpu().numpy()
    n = live.shape[1]
    stats["anchors_found"] += n_raw
    if n_raw > n:
        stats["anchors_truncated"] += n_raw - n
        warnings.warn(
            f"discovery: {n_raw - n} anchors over the {MAXA} cap were "
            "dropped; raise MAXA"
        )
    anchor_parts: dict = {}
    # split by orientation (the compact scan pools both halves)
    for rev_half in (False, True):
        m = (live[0] >= G) == rev_half
        if m.any():
            anchor_parts[rev_half] = tuple(c[m] for c in live)
    clock.mark("anchors")
    return anchor_parts, hit_pos


# ---------------------------------------------------------------------------
# the wavefront
# ---------------------------------------------------------------------------


def _trunc_tables(ss: Seqset, c: int):
    """Constant-threshold widen tables: prev_lt[i] = largest j <= i with
    shared[j] < c (-1 if none); next_lt[i] = smallest j >= i with
    shared[j] < c (n if none).  Truncating ranges to a KNOWN constant c is
    then two gathers per lane (``_SeqsetDevice.trunc_gather``) instead of
    two less-than searches; the wavefront truncates to probe_ctx every step.

    Cached on the Seqset instance only, never keyed on ``id()``: such a key
    can outlive its seqset and serve a new one the old one's tables."""
    cache = ss.__dict__.setdefault("_trunc_cache", {})
    hit = cache.get(c)
    if hit is None:
        n = ss.shared.shape[0]
        idx = torch.arange(n, dtype=torch.int64, device=ss.device)
        lt = ss.shared < c
        prev_lt = torch.cummax(torch.where(lt, idx, -1), 0).values
        nxt = torch.where(lt, idx, n)
        next_lt = torch.cummin(nxt.flip(0), 0).values.flip(0)
        hit = (prev_lt, next_lt)
        cache[c] = hit
    return hit


def _sorted_span_table(kmers, pos, k: int):
    """(K, key2) of a span's (k-mer, position) rows, pad rows carrying
    ``_SENTINEL`` in both: K the k-mers ascending (position the second key),
    key2 = (run_start(K[i]) << 32) | pos[i], ascending."""
    if 2 * k > 62 or kmers.shape[0] >= 1 << 31:
        raise ValueError(
            "span table: int64 rows hold k-mers of at most 31 bases, fewer "
            "than 2^31 rows and 32-bit positions"
        )
    by_pos = torch.sort(pos, stable=True)
    K, by_kmer = torch.sort(kmers[by_pos.indices], stable=True)
    P = by_pos.values[by_kmer]
    # each row's run start: the rows that open a run, indexed by the count of
    # runs opened so far (a prefix sum; a prefix max over one long row is
    # served by a single block)
    first = torch.cat([K.new_ones(1, dtype=torch.bool), K[1:] != K[:-1]])
    i0 = torch.nonzero(first)[:, 0][torch.cumsum(first, 0) - 1]
    key2 = torch.where(K == _SENTINEL, _SENTINEL, (i0 << 32) | P)
    return K, key2


def _span_kmers_dev(ref2_dev, lo: int, span_len: int, npk: int, k: int):
    """Span k-mer table over the reference positions [lo, lo + span_len).

    Returns (K, key2), both int64 [npk] (the JAX package carries them as
    uint64 with an all-ones pad; k-mers of 2k <= 62 bits and run starts
    below 2^31 keep every real row under 2^63, so the largest int64 sorts
    last as the pad and can equal no real row):
      * K    - k-mers of the span sorted ascending,
      * key2 - (run_start(K[i]) << 32) | pos[i], ascending.
    One searchsorted on K finds a query k-mer's run start r; a second on
    key2 for (r << 32 | min_pos) finds that k-mer's nearest occurrence
    at/after min_pos.  Positions are 32-bit, so a table may span a whole
    scaffold."""
    n2 = ref2_dev.shape[0]
    i = torch.arange(npk, dtype=torch.int64, device=ref2_dev.device)
    # zero-pad so every slice below fits (rows past span_len are pads)
    refp = torch.cat([ref2_dev, ref2_dev.new_zeros(npk)])
    acc = torch.zeros(npk, dtype=torch.int64, device=ref2_dev.device)
    for j in range(k):
        start = min(max(lo + j, 0), n2)
        acc = (acc << 2) | refp[start : start + npk].to(torch.int64)
    valid = (i + k) <= span_len
    return _sorted_span_table(
        torch.where(valid, acc, _SENTINEL), torch.where(valid, i, _SENTINEL), k
    )


def _span_kmers_compact_dev(ref2_dev, lo: int, span_len: int, k: int, pos_abs):
    """``_span_kmers_dev`` over a COMPACT covered-position subset.

    pos_abs: int64 [npk] absolute ref2 start positions (pad with -1).  Every
    rolling k-mer the beam can query is read content, and every span
    occurrence of a read k-mer ends on a prescreen hit, so a table of the
    hit positions' rows answers every reachable query as the dense table
    does.  Returns (K, key2, number of real rows as a 0-d tensor)."""
    n2 = ref2_dev.shape[0]
    rel = pos_abs - lo
    acc = torch.zeros_like(pos_abs)
    for j in range(k):
        acc = (acc << 2) | ref2_dev[(pos_abs + j).clamp(0, n2 - 1)].to(torch.int64)
    valid = (pos_abs >= 0) & (rel >= 0) & (rel + k <= span_len)
    K, key2 = _sorted_span_table(
        torch.where(valid, acc, _SENTINEL), torch.where(valid, rel, _SENTINEL), k
    )
    return K, key2, valid.sum()


def _wavefront_seed(d, seed, MAXP: int):
    """Initial wavefront state from the per-anchor seed tensors: the first
    alt-base push and all derived state."""
    A = seed["begin"].shape[0]
    dev = seed["begin"].device
    r0 = d.push_front(
        SeqsetRanges(seed["begin"], seed["end"], seed["size"]), 3 - seed["ab"]
    )
    alive0 = r0.begin < r0.end
    path = torch.zeros((A, MAXP), dtype=torch.uint8, device=dev)
    path[:, 0] = seed["ab"].to(torch.uint8)
    return dict(
        begin=r0.begin,
        end=r0.end,
        size=r0.size,
        path=path,
        path_len=torch.ones(A, dtype=torch.int32, device=dev),
        support=torch.where(alive0, r0.end - r0.begin, 0),
        n_junction=torch.zeros(A, dtype=torch.int32, device=dev),
        roll=seed["ab"].to(torch.int64),
        done=~alive0,
        policy=seed["policy"],
        min_local=seed["min_local"],
        rejoin=torch.full((A,), -1, dtype=torch.int64, device=dev),
        out_len=torch.zeros(A, dtype=torch.int32, device=dev),
        out_support=torch.zeros(A, dtype=torch.int64, device=dev),
    )


def _rejoin_lookup(span_tab, n_packed, roll, min_local, can, pos_bits: int):
    """Nearest span occurrence of each rolling k-mer at/after min_local,
    within the per-lane rejoin window (2^pos_bits bases, the
    read_ahead_distance knob).  span_tab is the (K, key2) pair of
    ``_span_kmers_dev``; n_packed (int or 0-d tensor) its real rows.
    Returns (found, jpos)."""
    K, key2 = span_tab
    npk = K.shape[0]
    lo = torch.searchsorted(K, roll)  # run start of the query k-mer
    q2 = (lo << 32) | min_local.clamp(0, (1 << 32) - 1)
    idx = torch.searchsorted(key2, q2)
    idxc = idx.clamp(0, npk - 1)
    jpos = key2[idxc] & 0xFFFFFFFF
    found = (
        can
        & (idx < n_packed)
        & (K[idxc] == roll)
        & (jpos - min_local < (1 << pos_bits))
    )
    return found, jpos


def _pick(x, col):
    """x[i, col[i]] for a [A, 4] tensor."""
    return x.gather(1, col[:, None])[:, 0]


def _wavefront_body(d, packed, prev_lt, next_lt, n_packed, st, step_i: int,
                    MAXP: int, k: int, min_w: int, probe_ctx: int,
                    pos_bits: int):
    """One beam-extension step.  ``packed`` is the (K, key2) span table pair.
    The state's path matrix is updated in place; every other tensor of the
    returned state is new."""
    if prev_lt is None:
        raise NotImplementedError(
            "the wavefront without trunc tables truncates through LtSearch "
            "(ops/ltsearch.py), which is not ported yet"
        )
    kmask = (1 << (2 * k)) - 1
    done = st["done"]
    cur = SeqsetRanges(st["begin"], st["end"], st["size"])
    # all 4 children per lane from one push4; candidate alt base bb pushes
    # complement 3-bb -> flip columns into bb order
    nb4, ne4 = d.push4(cur)
    Bc = nb4.flip(1)
    Ec = ne4.flip(1)
    W = Ec - Bc  # [A, 4]
    n_viable = (W >= min_w).sum(dim=1)
    order = torch.argsort(-W, dim=1, stable=True)
    rank_bit = ((st["policy"] >> st["n_junction"].clamp(max=30)) & 1).to(torch.int64)
    take_rank = torch.where(n_viable > 1, rank_bit, 0)
    best = _pick(order, take_rank)
    bw = _pick(W, best)
    ext = (~done) & (bw >= min_w)
    n_junction = st["n_junction"] + ((~done) & (n_viable > 1)).to(torch.int32)
    nb = torch.where(ext, best, 0)
    begin = torch.where(ext, _pick(Bc, nb), cur.begin)
    end = torch.where(ext, _pick(Ec, nb), cur.end)
    size = torch.where(ext, cur.size + 1, cur.size)
    # truncate to probe_ctx via the constant-threshold widen tables: the
    # semantics of truncate_ranges(., probe_ctx) at two gathers per lane
    need = size > probe_ctx
    wb, we = d.trunc_gather(prev_lt, next_lt, begin, end)
    begin = torch.where(need, wb, begin)
    end = torch.where(need, we, end)
    size = torch.where(need, probe_ctx, size)
    path = st["path"]
    path[:, step_i] = torch.where(ext, nb.to(torch.uint8), path[:, step_i])
    path_len = torch.where(ext, step_i + 1, st["path_len"])
    support = torch.where(ext, torch.minimum(st["support"], bw), st["support"])
    roll = torch.where(ext, ((st["roll"] << 2) | nb) & kmask, st["roll"])
    done = done | ~ext

    # rejoin: nearest span occurrence of the rolling kmer after the anchor
    can = ext & (path_len > k)
    found, jpos = _rejoin_lookup(packed, n_packed, roll, st["min_local"], can, pos_bits)
    newly = found & (st["rejoin"] < 0)
    return dict(
        begin=begin,
        end=end,
        size=size,
        path=path,
        path_len=path_len,
        support=support,
        n_junction=n_junction,
        roll=roll,
        done=done | newly,
        policy=st["policy"],
        min_local=st["min_local"],
        rejoin=torch.where(newly, jpos, st["rejoin"]),
        out_len=torch.where(newly, path_len, st["out_len"]),
        out_support=torch.where(newly, support, st["out_support"]),
    )


def _maybe_compact(c, undone: int, stats=None) -> None:
    """Shrink ctx c's beam state to the live-lane subset when sparse (a
    reduction of 4x or more, never below WAVE_COMPACT_MIN lanes).

    The compacted state's rows map to full-state rows via c["sel"]; on every
    further shrink the selection is composed, and ``_asm_finish`` scatters
    the survivor rows back before harvesting."""
    width = c["st"]["begin"].shape[0]
    new_width = max(_next_pow2(max(undone, 1)), WAVE_COMPACT_MIN)
    if new_width * 4 > width:
        return
    if stats is not None:
        stats["wave_compactions"] = stats.get("wave_compactions", 0) + 1
    # lane indices live-first (stable): the first `undone` are the live
    # lanes, the rest done lanes usable as padding
    front = torch.argsort(c["st"]["done"].to(torch.int32), stable=True)[:new_width]
    if c.get("sel") is None:
        c["full_st"] = c["st"]
        sel = front
    else:
        _scatter_state(c["full_st"], c["st"], c["sel"])
        sel = c["sel"][front]
    c["sel"] = sel
    c["st"] = {name: v[sel] for name, v in c["full_st"].items()}


def _scatter_state(full, small, sel) -> None:
    """Write the compacted rows back into the full-width state, in place."""
    for name in full:
        full[name][sel] = small[name]


def _drive(d, c, trunc_tables, stats=None) -> None:
    """Advance one group's beam to its end: step by step, with a poll of the
    undone count every CHECK_EVERY steps that ends the loop at 0 and shrinks
    the state when few lanes are live."""
    while c["step"] < c["MAXP"]:
        target = min(c["step"] + CHECK_EVERY, c["MAXP"])
        if stats is not None:
            stats["wave_steps"] = stats.get("wave_steps", 0) + target - c["step"]
        while c["step"] < target:
            c["st"] = _wavefront_body(
                d, c["packed"], trunc_tables[0], trunc_tables[1],
                c["n_packed"], c["st"], c["step"], c["MAXP"], c["k"],
                c["min_w"], c["probe_ctx"], c["pos_bits"],
            )
            c["step"] += 1
        if c["step"] >= c["MAXP"]:
            break
        undone = int((~c["st"]["done"]).sum())
        if undone == 0:
            break
        _maybe_compact(c, undone, stats)


def _asm_start(d, anchors, opt: DiscoverOptions, ref_limit: int, ref_dev,
               span_shared=None, ncl=None):
    """Host prep + device seed for one beam group; returns the ctx dict the
    ``_drive`` advances (None for an empty group).

    Each anchor is explored by ``ncl`` clone lanes: where several child
    bases are viable (repeat junctions), clone j of an anchor takes the
    child ranked by bit (j >> n_junction) & 1, exploring best/second-best
    combinations at the first junctions; per anchor the best-supported,
    smallest assembly wins (applied in ``_asm_finish``)."""
    a_pos, ab, a_begin, a_end, a_size = anchors
    A0 = len(a_pos)
    if A0 == 0:
        return None
    dev = d.device
    MAXP = opt.max_path
    k = opt.rejoin_k
    pos_bits = max(int(opt.read_ahead_distance - 1).bit_length(), 1)

    # local ref kmer index for rejoin (bounded span; never crossing
    # ref_limit: with a doubled fwd+rc ref array the halves must not mix)
    anchor_flat0 = np.asarray(a_pos)
    if span_shared is not None:
        packed, lo_flat, n_packed = span_shared
    else:
        lo_flat = int(anchor_flat0.min())
        hi_flat = int(min(anchor_flat0.max() + MAXP + k + 2, ref_limit))
        span_len = min(hi_flat + 1, ref_limit) - lo_flat
        if span_len < k:
            return None
        n_packed = span_len - k + 1
        # the table's rows on a 4x ladder (2x above 1M), as the JAX package
        # pads them
        npk = 16384
        while npk < n_packed:
            npk *= 4 if npk < (1 << 20) else 2
        packed = _span_kmers_dev(ref_dev, lo_flat, span_len, npk, k)

    # replicate each anchor into ncl clone lanes; retry rounds pass a
    # widened ncl for adaptive depth
    ncl = max(int(ncl if ncl is not None else opt.branch_clones), 1)
    rep = np.repeat(np.arange(A0), ncl)
    policy = np.tile(np.arange(ncl), A0)
    A = A0 * ncl
    anchor_flat = anchor_flat0[rep]
    Ap = max(_next_pow2(A), 128)  # lanes padded to a power of two

    def pad(x, dtype):
        out = np.zeros(Ap, dtype)
        out[:A] = x
        return torch.from_numpy(out).to(dev)

    seed = dict(
        begin=pad(a_begin[rep], np.int64),
        end=pad(a_end[rep], np.int64),
        size=pad(a_size[rep], np.int32),
        ab=pad(ab[rep], np.int64),
        policy=pad(policy, np.int32),
        min_local=pad(anchor_flat - lo_flat + 1, np.int64),
    )
    return dict(
        st=_wavefront_seed(d, seed, MAXP), step=1, packed=packed,
        n_packed=n_packed, MAXP=MAXP, k=k, min_w=opt.min_extend_width,
        probe_ctx=opt.probe_ctx, pos_bits=pos_bits, rep=rep,
        anchor_flat=anchor_flat, lo_flat=lo_flat, A=A, n_sel=A0,
    )


def _compact_hits(st):
    """The rejoined lanes of a finished state, in lane order, on the host:
    (lanes, rejoin, out_len, out_support, path rows)."""
    lanes = torch.nonzero(st["rejoin"] >= 0)[:, 0]
    return tuple(
        x.cpu().numpy()
        for x in (lanes, st["rejoin"][lanes], st["out_len"][lanes],
                  st["out_support"][lanes], st["path"][lanes])
    )


def _asm_finish(c):
    """Fetch one finished beam group's rejoined lanes and build Assembly
    records (per anchor the best-supported, smallest bubble wins).
    Returns (assemblies, succeeded_local_anchor_ids, branchy_local_ids);
    the id sets feed the adaptive-depth retry in ``wavefront_assemble``
    (retrying an anchor that never saw a junction is pure waste: every
    clone walked the identical path)."""
    out = c["st"]
    if c.get("sel") is not None:
        # fold the compacted live subset back into the full-width state
        _scatter_state(c["full_st"], c["st"], c["sel"])
        out = c["full_st"]
    A, k = c["A"], c["k"]
    rep, anchor_flat, lo_flat = c["rep"], c["anchor_flat"], c["lo_flat"]
    # only rejoined lanes leave the device: the path matrix is the bulk of
    # the state and most lanes never rejoin
    lanes, rejoin, out_len, out_support, out_path = _compact_hits(out)
    results = {}
    for hit in range(len(lanes)):
        lane = int(lanes[hit])
        if lane >= A:
            continue
        j_flat = lo_flat + int(rejoin[hit])
        a_flat = int(anchor_flat[lane])
        alt_len = int(out_len[hit]) - k
        if alt_len < 0 or j_flat <= a_flat:
            continue
        asm = Assembly(
            chunk_start=lo_flat,
            anchor=a_flat,
            rejoin=j_flat,
            seq=out_path[hit, :alt_len].copy(),
            support=int(out_support[hit]),
        )
        key = rep[lane]
        old = results.get(key)
        if old is None or _asm_better(asm, old):
            results[key] = asm
    nj = out["n_junction"][:A].cpu().numpy()
    branchy = {int(rep[lane]) for lane in np.nonzero(nj > 0)[0]}
    return list(results.values()), set(results.keys()), branchy


def _asm_better(a: Assembly, b: Assembly) -> bool:
    """Prefer higher support, then the more parsimonious bubble."""
    if a.support != b.support:
        return a.support > b.support
    da = abs((a.rejoin - a.anchor - 1) - len(a.seq)) + len(a.seq)
    db = abs((b.rejoin - b.anchor - 1) - len(b.seq)) + len(b.seq)
    return da < db


def wavefront_assemble(
    ss: Seqset,
    anchors: tuple,
    opt: DiscoverOptions,
    ref_dev,
    hit_pos,
    stats: dict | None = None,
    ref_limit: int | None = None,
    span_cap: int = SPAN_TABLE_CAP,
) -> List[Assembly]:
    """Extend alt branches through the seqset; rejoin to reference.

    anchors: (a_pos, ab, begin, end, size) numpy columns, the compact
    per-anchor probe ranges of the anchor scan.  ref_dev: the doubled
    reference on the seqset's device; span k-mer tables are built from it
    there.  hit_pos: the prescreen's hit positions (``_candidate_lanes``); a
    table of their rows stands in for the dense span table when it is
    smaller.  span_cap: the most rows a shared dense table may have (the
    memory plan's ``span_table_cap``)."""
    d = ss.d
    n_anchor = len(anchors[0])
    if n_anchor == 0:
        return []
    if ref_limit is None:
        ref_limit = ref_dev.shape[0]
    trunc_tables = _trunc_tables(ss, opt.probe_ctx)

    # group anchors by genome position; the (K, key2) span table puts no
    # limit on a group's genome span, so groups are sized by lane count only
    eff_width = max(opt.beam_width, WAVE_LANES)
    flat_pos = np.asarray(anchors[0])
    order = np.argsort(flat_pos, kind="stable")
    groups = [order[i : i + eff_width] for i in range(0, n_anchor, eff_width)]

    # Shared rejoin span table: when the anchors' joint span fits the table
    # budget, ONE (K, key2) table serves all groups of this orientation.
    # Past the budget groups build their own bounded spans.
    span_shared = None
    k_rej = opt.rejoin_k
    lo_all = int(flat_pos.min())
    hi_all = int(min(flat_pos.max() + opt.max_path + k_rej + 2, ref_limit))
    span_all = min(hi_all + 1, ref_limit) - lo_all
    if span_all >= k_rej:
        npk_all = 16384
        while npk_all < span_all - k_rej + 1:
            npk_all *= 4 if npk_all < (1 << 20) else 2
        # every reachable query k-mer is read content whose last
        # PRESCREEN_K bases hit, so span occurrences only start at
        # hit_pos - (k-1): a smaller table with identical answers
        if _PRESCREEN_K <= k_rej <= opt.probe_ctx and hit_pos.shape[0] < npk_all:
            K_t, key2_t, n_real = _span_kmers_compact_dev(
                ref_dev, lo_all, span_all, k_rej,
                pos_abs=hit_pos - (k_rej - 1),
            )
            # n_real stays on the device: it only feeds a bound check there
            span_shared = ((K_t, key2_t), lo_all, n_real)
        if span_shared is None and npk_all <= span_cap:
            span_shared = (
                _span_kmers_dev(ref_dev, lo_all, span_all, npk_all, k_rej),
                lo_all,
                span_all - k_rej + 1,
            )

    def run_groups(group_sels, ncl):
        """Each group's beam from seed to end; (anchor ids, ctx) pairs."""
        pairs = []
        for sel in group_sels:
            c = _asm_start(
                d, tuple(a[sel] for a in anchors), opt, ref_limit, ref_dev,
                span_shared, ncl=ncl,
            )
            if c is not None:
                _drive(d, c, trunc_tables, stats)
                pairs.append((sel, c))
        return pairs

    def harvest(sel, c):
        asms, ok_keys, branchy = _asm_finish(c)
        out.extend(asms)
        failed.extend(
            int(sel[j]) for j in range(len(sel)) if j not in ok_keys and j in branchy
        )
        return ok_keys

    out: List[Assembly] = []
    failed: List[int] = []
    done_anchors = 0
    truncated = False
    for sel, c in run_groups(groups, None):
        harvest(sel, c)
        done_anchors += c["n_sel"]
        if len(out) >= opt.max_assemblies:
            truncated = True
            if stats is not None and done_anchors < n_anchor:
                stats["assemblies_truncated"] += n_anchor - done_anchors
                warnings.warn(
                    f"discovery: assembly cap {opt.max_assemblies} hit;"
                    f" {n_anchor - done_anchors} anchors unexplored in this batch"
                )
            break
    # adaptive-depth retry: anchors whose whole beam died un-rejoined
    # re-explore with 4x the clones per round (two more junctions of
    # best/second coverage), paid only where the fixed beam failed
    ncl = max(int(opt.branch_clones), 1)
    for _ in range(int(opt.branch_retry_rounds)):
        if not failed or truncated:
            break
        ncl *= 4
        per = max(eff_width // max(ncl // max(int(opt.branch_clones), 1), 1), 16)
        fgroups = [
            np.asarray(failed[i : i + per], np.int64)
            for i in range(0, len(failed), per)
        ]
        failed = []
        for sel, c in run_groups(fgroups, ncl):
            ok_keys = harvest(sel, c)
            if stats is not None:
                stats["branch_retry_rescued"] = stats.get(
                    "branch_retry_rescued", 0
                ) + len(ok_keys)
    return out[: opt.max_assemblies]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _segments(opt, lo: int, hi: int, G: int):
    """The probe segments of a region [lo, hi) of a G-base reference over
    the doubled (fwd ++ rc) array: (rev_half, ctx_lo, first_probe,
    last_probe, max_anchor_pos) each.  The rc pass anchors events from their
    right side, recovering candidates whose left context is
    repeat-poisoned."""
    segments = []
    if not opt.skip_trace_fwd:
        segments.append((False, 0, lo, min(hi, G - 1) - 1, min(hi, G - 1)))
    if opt.bidir and not opt.skip_trace_rev:
        seg_hi_r = min(2 * G - lo, 2 * G - 1)
        segments.append((True, G, G + (G - hi), seg_hi_r - 1, seg_hi_r))
    return segments


def discover_variants(
    ss: Seqset,
    reference,
    region: tuple | None = None,
    opt: DiscoverOptions | None = None,
    readmap=None,
    stats: dict | None = None,
    out_assemblies: list | None = None,
):
    """Top-level entry point: prescreen -> anchors -> wavefront -> variants, on
    the device the seqset lies on.

    reference: an ``index.reference.Reference`` (``flat`` codes and
    ``contigs``).  region: (flat_start, flat_end) or None for the whole
    reference.  Both orientations probe over a doubled (fwd ++ rc) reference
    array.  readmap: the library's ``Readmap`` on the seqset's device, or
    None; with it the assemblies are scored by read coverage, filtered at
    min_alt_support and pair-gated.  ``stats`` (optional dict, filled in
    place) reports anchor and assembly truncation so dense regions can't
    drop candidates silently, the memory plan, ``pair_gated``, and
    ``stage_s``: seconds in ``probe_filter``, ``probe_exact``, ``anchors``,
    ``wavefront``, ``score`` (with a readmap) and ``extract``, each read
    after the device has drained.  out_assemblies: optional list; the
    deduped (with a readmap: scored and gated) Assembly records are
    appended to it.

    Returns the records (dicts of chrom, pos, ref, alt, support,
    ref_support, aid), sorted by position.  Without a readmap ``support`` is
    the narrowest range along the alt path and ``ref_support`` is 0."""
    opt = opt or DiscoverOptions()
    if not use_prescreen(opt):
        raise NotImplementedError(
            f"min_anchor_ctx < {_PRESCREEN_K} needs the dense front end "
            "(the restart masks of the non-prescreen route), which is not "
            "ported yet"
        )
    dev = ss.device
    if readmap is not None and readmap.device != dev:
        raise ValueError(
            f"discover_variants: the readmap lies on {readmap.device}, the "
            f"seqset on {dev}"
        )
    ref = np.asarray(reference.flat)
    G = len(ref)
    lo, hi = region if region else (0, G)
    if stats is None:
        stats = {}
    stats.setdefault("anchors_found", 0)
    stats.setdefault("anchors_truncated", 0)
    stats.setdefault("assemblies_truncated", 0)
    plan = _discovery_memory_plan(ss, G, stats)
    if not plan["use_trunc_tables"]:
        raise NotImplementedError(
            "the memory plan leaves no room for the trunc tables, and "
            "in-loop truncation through LtSearch (ops/ltsearch.py) is not "
            "ported yet"
        )
    ref2 = np.concatenate([ref, (3 - ref[::-1]).astype(np.uint8)])
    ref2_dev = torch.from_numpy(ref2).to(dev)
    segments = _segments(opt, lo, hi, G)
    if not segments:
        return []
    clock = _StageClock(dev, stats.setdefault("stage_s", {}))
    anchor_parts, hit_pos = _find_anchors(ss, ref2_dev, segments, opt, stats, clock, G)
    # wavefront, once per orientation over its pooled anchors
    all_asms: List[Assembly] = []
    for rev_half, anchors in anchor_parts.items():
        asms = wavefront_assemble(
            ss, anchors, opt, ref2_dev, hit_pos, stats=stats,
            ref_limit=(2 * G if rev_half else G),
            span_cap=plan["span_table_cap"],
        )
        if rev_half:
            asms = [
                _rc_assembly(
                    Assembly(
                        chunk_start=a.chunk_start - G,
                        anchor=a.anchor - G,
                        rejoin=a.rejoin - G,
                        seq=a.seq,
                        support=a.support,
                        ref_support=a.ref_support,
                    ),
                    G,
                )
                for a in asms
            ]
        all_asms.extend(asms)
    clock.mark("wavefront")
    # dedup identical bubbles across orientations: fwd and rev mostly
    # rediscover the same assemblies
    uniq = {}
    for a in all_asms:
        key = (a.anchor, a.rejoin, a.seq.tobytes())
        if key not in uniq or a.support > uniq[key].support:
            uniq[key] = a
    all_asms = list(uniq.values())
    if readmap is not None:
        all_asms = score_assemblies(readmap, ref, all_asms, opt)
        # sub-threshold assemblies can never yield an emittable record
        all_asms = [a for a in all_asms if a.support >= opt.min_alt_support]
        # long alt paths without any mate-pair anchoring are discarded
        all_asms = pair_gate_assemblies(readmap, ref, all_asms, opt, stats)
    if opt.trace_offsets:
        for a in all_asms:
            if any(a.anchor <= t <= a.rejoin for t in opt.trace_offsets):
                print(
                    f"TRACE assembly anchor={a.anchor} rejoin={a.rejoin} "
                    f"support={a.support} ref_support={a.ref_support} "
                    f"alt={dna.codes_to_seq(np.asarray(a.seq, np.uint8))}"
                )
    if out_assemblies is not None:
        out_assemblies.extend(all_asms)
    if readmap is not None:
        clock.mark("score")
    records = extract_variants(all_asms, ref, reference, opt, device=dev)
    clock.mark("extract")
    return _dedup_records(records)


def _rc_assembly(a: Assembly, G: int) -> Assembly:
    """Map an assembly traced in reverse-complement coordinates back to the
    forward strand: the bubble (anchor, rejoin) flips end-for-end and the alt
    path reverse-complements."""
    return Assembly(
        chunk_start=G - 1 - a.chunk_start,
        anchor=G - 1 - a.rejoin,
        rejoin=G - 1 - a.anchor,
        seq=(3 - np.asarray(a.seq, np.uint8))[::-1].copy(),
        support=a.support,
        ref_support=a.ref_support,
    )


# ---------------------------------------------------------------------------
# scoring and the pair gate
# ---------------------------------------------------------------------------


def _ref_pair_spans(rm: Readmap, ref: np.ndarray, max_frag: int):
    """Proper-pair spans [a, b) and half-placed mate positions on the
    reference, computed once per readmap and cached on the instance.

    A proper pair has both mates placed, on opposite strands, at most
    max_frag apart.  A half-placed pair (one mate on the novel path of an
    insertion never places) is kept as one position: generous evidence for
    the gate, which only culls paths with nothing."""
    key = ("_ref_pair_spans", max_frag)
    hit = rm.__dict__.get(key)
    if hit is not None:
        return hit
    from biograph_tpu_torch.variants.align import RefKmerIndex, place_reads

    loop = rm.mate_pair_ptr.cpu().numpy()
    fwd_ids = np.nonzero(rm.is_forward.cpu().numpy())[0]
    mate2 = loop[loop]
    entries = rm.entry_of_rm[torch.from_numpy(fwd_ids).to(rm.device)]
    lens = rm.read_lengths.cpu().numpy()[fwd_ids]
    L = int(lens.max(initial=1))
    codes = np.zeros((len(fwd_ids), L), np.uint8)
    for lo in range(0, len(fwd_ids), 1 << 17):
        hi = min(len(fwd_ids), lo + (1 << 17))
        codes[lo:hi] = rm.seqset.d.sequences(entries[lo:hi], L).cpu().numpy()
    codes = np.where(np.arange(L)[None, :] < lens[:, None], codes, 0).astype(np.uint8)
    idx = RefKmerIndex.build(ref, 13, device=rm.device)
    pl = place_reads(idx, codes, lens, max_mismatches=3)
    pos_of_fwd = np.full(rm.num_entries, -1, np.int64)
    pos_of_fwd[fwd_ids] = np.arange(len(fwd_ids))
    mate_idx = pos_of_fwd[mate2[fwd_ids]]
    mclip = np.clip(mate_idx, 0, len(fwd_ids) - 1)
    placed = pl.pos >= 0
    paired = (mate_idx != np.arange(len(fwd_ids))) & (mate_idx >= 0)
    both = placed & paired & placed[mclip]
    proper = (
        both
        & (np.abs(pl.pos - pl.pos[mclip]) <= max_frag)
        & (pl.is_rc != pl.is_rc[mclip])
    )
    a = np.minimum(pl.pos, pl.pos[mclip])[proper]
    b = np.maximum(pl.pos + lens, pl.pos[mclip] + lens)[proper]
    half = paired & (placed ^ placed[mclip])
    half_pos = np.where(placed, pl.pos, pl.pos[mclip])[half]
    half_len = np.where(placed, lens, lens[mclip])[half]
    order = np.argsort(a)
    spans = (a[order], b[order], np.sort(half_pos + half_len // 2))
    rm.__dict__[key] = spans
    return spans


def pair_gate_assemblies(rm: Readmap, ref: np.ndarray, asms: List[Assembly],
                         opt: DiscoverOptions, stats: dict | None = None):
    """The tracer's pair-evidence discard, at assembly acceptance: alt paths
    longer than max_bases_between_pairs must show min_pair_evidence proper
    pairs straddling the bubble (or half-placed mates within
    max_pair_distance of it).  Vacuous when the library is unpaired."""
    if not opt.pair_gate or not asms:
        return asms
    if rm.num_entries == 0 or rm.get_pair_stats()["paired_reads"] == 0:
        return asms
    if not any(len(a.seq) > opt.max_bases_between_pairs for a in asms):
        return asms
    a_s, b_s, half_mid = _ref_pair_spans(rm, ref, opt.max_pair_distance)
    kept = []
    gated = 0
    for a in asms:
        if len(a.seq) <= opt.max_bases_between_pairs:
            kept.append(a)
            continue
        # proper pairs straddling the bubble: a <= anchor and b >= rejoin
        i = np.searchsorted(a_s, a.anchor + 1, side="right")
        straddle = int((b_s[:i] >= a.rejoin).sum())
        # half-placed mates near the bubble (novel-insertion evidence)
        lo = np.searchsorted(half_mid, a.anchor - opt.max_pair_distance)
        hi = np.searchsorted(half_mid, a.rejoin + opt.max_pair_distance)
        if straddle + int(hi - lo) >= opt.min_pair_evidence:
            kept.append(a)
        else:
            gated += 1
    if stats is not None:
        stats["pair_gated"] = stats.get("pair_gated", 0) + gated
    return kept


MID_CAP = 192  # ref-span scoring cap for giant deletions (bases per side)


def score_assemblies(rm: Readmap, ref: np.ndarray, asms: List[Assembly], opt: DiscoverOptions):
    """Replace range-width support with read coverage of the alt path: each
    assembly's alt sequence plus flanking context goes through
    ``Readmap.coverage``, and support is the least depth across the bubble;
    the matching reference span is scored the same way (ref_support).

    One padded batch on every device: the JAX package's accelerator form.
    Its CPU form (one batch per bubble-size bucket) gives the same values,
    since a row's coverage does not depend on its padding or its
    neighbours."""
    if not asms:
        return asms
    rows, q, ql = _score_rows(ref, asms, int(rm.max_read_len) + 2)
    kmax = opt.read_cov_max_reads_per_entry or 16
    fwd, rev = rm.coverage(q, ql, kmax=kmax)
    fwd = fwd.cpu().numpy()
    rev = rev.cpu().numpy()
    tot = fwd + rev
    if opt.penalize_directional_coverage:
        # discount heavily one-sided depth: one direction dominating is the
        # signature of systematic read errors
        skew = np.abs(fwd - rev) * 4 > tot * 3
        tot = np.where(skew, 2 * np.minimum(fwd, rev), tot)
    ref_mins: dict = {}
    for r, (i, kind, seq, lo, hi) in enumerate(rows):
        win = tot[r, lo:hi]
        v = int(win.min()) if len(win) else 0
        if kind == 0:
            asms[i].support = v
        else:
            ref_mins[i] = min(ref_mins.get(i, 1 << 30), v)
    for i, a in enumerate(asms):
        a.ref_support = ref_mins.get(i, 0)
    return asms


def _score_rows(ref: np.ndarray, asms: List[Assembly], C: int):
    """The coverage rows of a scoring batch: (rows, q uint8 [B, qlen], ql
    int32 [B]), rows as (asm_idx, kind, seq, lo, hi) with kind 0 the alt
    path, 1 the reference span, 2 a breakpoint window of a giant one; the
    least depth over [lo, hi) of a row is its score.  C is the flank: a full
    read length and two, since the walk counts a read only once its END is
    reached with enough context."""
    rows = []
    for i, a in enumerate(asms):
        left = ref[max(a.anchor + 1 - C, 0) : a.anchor + 1]
        right = ref[a.rejoin : a.rejoin + C]
        alt = np.asarray(a.seq, np.uint8)
        seq = np.concatenate([left, alt, right])
        rows.append(
            (i, 0, seq, max(len(left) - 1, 0), min(len(left) + len(alt) + 1, len(seq)))
        )
        mid = ref[a.anchor + 1 : a.rejoin]
        if len(mid) <= 2 * MID_CAP:
            seq = np.concatenate([left, mid, right])
            rows.append(
                (i, 1, seq, max(len(left) - 1, 0), min(len(left) + len(mid) + 1, len(seq)))
            )
        else:
            # a long deletion: its two breakpoint windows, each stopping C
            # short of the cut, where context is truncated
            lseq = np.concatenate([left, mid[: MID_CAP + C]])
            rows.append((i, 2, lseq, max(len(left) - 1, 0), len(left) + MID_CAP))
            rseq = np.concatenate([mid[-(MID_CAP + C) :], right])
            rows.append((i, 2, rseq, MID_CAP + C, len(rseq)))
    qlen = max(max(len(r[2]) for r in rows), 2 * C + 1)
    q = np.zeros((len(rows), qlen), np.uint8)
    ql = np.zeros(len(rows), np.int32)
    for r, (_, _, seq, _, _) in enumerate(rows):
        q[r, : len(seq)] = seq
        ql[r] = len(seq)
    return rows, q, ql


# ---------------------------------------------------------------------------
# assemblies -> records (host numpy)
# ---------------------------------------------------------------------------


def _dedup_records(records):
    seen = {}
    for r in records:
        key = (r["chrom"], r["pos"], r["ref"], r["alt"])
        if key not in seen or seen[key]["support"] < r["support"]:
            seen[key] = r
    return sorted(seen.values(), key=lambda r: (r["chrom"], r["pos"]))


def extract_variants(assemblies: List[Assembly], ref: np.ndarray, reference,
                     opt: DiscoverOptions, device="cuda"):
    """Assemblies -> normalized variant records (chrom, pos, ref, alt,
    support).

    Prefix/suffix trimming handles SNPs and clean indels; complex blocks are
    aligned in one batch on ``device`` (``ops/align_dp.py``) and split into
    primitive pieces; giant blocks are emitted as one left-normalized
    record."""
    out = []
    trimmed = []  # (asm, pos_flat, rs, as_)
    complex_ids = []
    aid_of = {id(a): i for i, a in enumerate(assemblies)}
    for asm in assemblies:
        a, j = asm.anchor, asm.rejoin
        ref_seg = ref[a + 1 : j]
        alt_seg = np.asarray(asm.seq, np.uint8)
        # trim common prefix/suffix (vectorized: one compare + argmax each)
        m = min(len(ref_seg), len(alt_seg))
        neq = ref_seg[:m] != alt_seg[:m]
        p = int(np.argmax(neq)) if neq.any() else m
        rs, as_ = ref_seg[p:], alt_seg[p:]
        m2 = min(len(rs), len(as_))
        neq2 = rs[len(rs) - m2 :][::-1] != as_[len(as_) - m2 :][::-1]
        q = int(np.argmax(neq2)) if neq2.any() else m2
        rs = rs[: len(rs) - q]
        as_ = as_[: len(as_) - q]
        pos_flat = a + 1 + p  # first differing base (flat, 0-based)
        if len(rs) == 0 and len(as_) == 0:
            continue  # identical to reference
        idx = len(trimmed)
        trimmed.append((asm, pos_flat, rs, as_))
        if (
            len(rs) != len(as_)
            and min(len(rs), len(as_)) > 0
            and (len(rs) > 2 or len(as_) > 2)
            # giant blocks (repeat-mediated distant rejoins) skip base-level
            # decomposition: emitted as one left-normalized block record
            and max(len(rs), len(as_)) <= 2048
        ):
            complex_ids.append(idx)
    ops_by_id = {}
    if complex_ids:
        all_ops = align_blocks_batch(
            [trimmed[i][2] for i in complex_ids],
            [trimmed[i][3] for i in complex_ids],
            device,
        )
        ops_by_id = dict(zip(complex_ids, all_ops))
    for idx, (asm, pos_flat, rs, as_) in enumerate(trimmed):
        pieces = []
        if len(rs) == len(as_):
            # same-length block: split into primitive SNPs at mismatches
            for i in np.nonzero(np.asarray(rs) != np.asarray(as_))[0]:
                pieces.append(
                    (
                        pos_flat + int(i),
                        dna.codes_to_seq(rs[i : i + 1]),
                        dna.codes_to_seq(as_[i : i + 1]),
                    )
                )
        elif idx in ops_by_id:
            pieces.extend(
                _align_decompose(ref, pos_flat, rs, as_, ops=ops_by_id[idx])
            )
        else:
            # clean indel / tiny block: left-anchor + left-shift
            pieces.append(_left_normalize(ref, pos_flat, rs, as_))
        for vpos, ref_str, alt_str in pieces:
            contig = _contig_of(reference, vpos)
            if contig is None:
                continue
            out.append(
                {
                    "chrom": contig.name,
                    "pos": vpos - contig.start + 1,
                    "ref": ref_str,
                    "alt": alt_str,
                    "support": asm.support,
                    "ref_support": asm.ref_support,
                    "aid": aid_of[id(asm)],
                }
            )
    return _dedup_records(out)


def write_discovery_vcf(path: str, reference, records, sample="SAMPLE", opt=None):
    """Emit discovery records as VCF.  Genotypes come from the binomial
    genotyper over alt vs ref bubble coverage, not a hardcoded ploidy; with
    ``simple_genotype_filter`` records under the depth floors or the alt
    depth share are left out."""
    from biograph_tpu_torch.io.vcf import VcfRecord, VcfWriter

    opt = opt or DiscoverOptions()
    headers = [
        '##INFO=<ID=SUP,Number=1,Type=Integer,Description="Min read support along assembly">',
        '##INFO=<ID=RSUP,Number=1,Type=Integer,Description="Min read support along the reference span">',
        '##INFO=<ID=PAIRS,Number=1,Type=Integer,Description="Mate pairs straddling the event">',
        '##INFO=<ID=AID,Number=1,Type=Integer,Description="Assembly id">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length difference alt-ref">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Structural variant type">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">',
    ]
    with VcfWriter(
        path,
        sample=sample,
        contigs=[(c.name, c.length) for c in reference.contigs],
        extra_headers=headers,
    ) as w:
        for r in records:
            if r["support"] < opt.min_alt_support:
                continue
            alt_d = int(r["support"])
            ref_d = int(r.get("ref_support", 0))
            if opt.simple_genotype_filter:
                # depth floors, then the alt-depth share of the local depth
                if alt_d < opt.min_read_depth:
                    continue
                if int(r.get("pair_support", opt.min_pair_depth)) < opt.min_pair_depth:
                    continue
                total_d = alt_d + ref_d
                if total_d and alt_d / total_d < opt.min_depth_portion:
                    continue
            frac = alt_d / max(alt_d + ref_d, 1)
            gt = "1/1" if frac >= opt.hom_frac else "0/1"
            info = {"SUP": alt_d, "RSUP": ref_d}
            if "pair_support" in r:
                info["PAIRS"] = int(r["pair_support"])
            if opt.output_assembly_ids and "aid" in r:
                info["AID"] = int(r["aid"])
            svlen = len(r["alt"]) - len(r["ref"])
            if abs(svlen) >= opt.vcf_sv_size_threshold:
                info["SVLEN"] = svlen
                info["SVTYPE"] = "INS" if svlen > 0 else "DEL"
            w.write(
                VcfRecord(
                    chrom=r["chrom"],
                    pos=r["pos"],
                    ref=r["ref"],
                    alt=r["alt"],
                    qual=3 * alt_d + 27,
                    info=info,
                    fmt={"GT": gt, "DP": alt_d + ref_d},
                )
            )


def write_assembly_csv(path: str, reference, assemblies: List[Assembly]):
    """Assembly dump CSV: one row per scored assembly with its bubble
    coordinates, support and both sequences.  Returns the row count."""
    ref = np.asarray(reference.flat)
    with open(path, "w") as f:
        f.write(
            "scaffold_name,left_offset,right_offset,aid,score,ref_support,"
            "ref_seq,seq,generated_by\n"
        )
        for aid, a in enumerate(assemblies):
            c = _contig_of(reference, a.anchor)
            if c is None:
                continue
            f.write(
                f"{c.name},{a.anchor - c.start},{a.rejoin - c.start},{aid},"
                f"{a.support},{a.ref_support},"
                f"{dna.codes_to_seq(ref[a.anchor + 1 : a.rejoin])},"
                f"{dna.codes_to_seq(np.asarray(a.seq, np.uint8))},WAVEFRONT\n"
            )
    return len(assemblies)


def _align_decompose(ref, pos_flat, rs, as_, ops=None):
    """Global affine alignment of ref block vs alt block; emit primitive SNP
    / indel pieces.  With ops precomputed (the batched aligner,
    ops/align_dp.py), only grouping runs here; the scalar NW below serves
    direct calls."""
    if ops is not None:
        return _ops_to_pieces(ref, pos_flat, rs, as_, ops)
    n, m = len(rs), len(as_)
    GAP_OPEN, GAP_EXT, MIS = 2.5, 0.5, 1.0
    INF = 1e18
    # three-state affine DP (M, Ix = gap in alt/deletion, Iy = insertion)
    M = np.full((n + 1, m + 1), INF)
    Ix = np.full((n + 1, m + 1), INF)
    Iy = np.full((n + 1, m + 1), INF)
    M[0, 0] = 0.0
    for i in range(1, n + 1):
        Ix[i, 0] = GAP_OPEN + GAP_EXT * (i - 1)
    for j in range(1, m + 1):
        Iy[0, j] = GAP_OPEN + GAP_EXT * (j - 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = 0.0 if rs[i - 1] == as_[j - 1] else MIS
            M[i, j] = sub + min(M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1])
            Ix[i, j] = min(M[i - 1, j] + GAP_OPEN, Ix[i - 1, j] + GAP_EXT)
            Iy[i, j] = min(M[i, j - 1] + GAP_OPEN, Iy[i, j - 1] + GAP_EXT)
    # traceback
    i, j = n, m
    state = int(np.argmin([M[i, j], Ix[i, j], Iy[i, j]]))
    ops = []  # (op, ref_idx, alt_idx): 'M' match/mismatch, 'D' del, 'I' ins
    while i > 0 or j > 0:
        if state == 0:
            i, j = i - 1, j - 1
            ops.append(("M", i, j))
            state = int(np.argmin([M[i, j], Ix[i, j], Iy[i, j]])) if (i or j) else 0
        elif state == 1:
            prevM = M[i - 1, j] + GAP_OPEN
            prevX = Ix[i - 1, j] + GAP_EXT
            i -= 1
            ops.append(("D", i, j))
            state = 0 if prevM <= prevX else 1
        else:
            prevM = M[i, j - 1] + GAP_OPEN
            prevY = Iy[i, j - 1] + GAP_EXT
            j -= 1
            ops.append(("I", i, j))
            state = 0 if prevM <= prevY else 2
    ops.reverse()
    return _ops_to_pieces(ref, pos_flat, rs, as_, ops)


def _ops_to_pieces(ref, pos_flat, rs, as_, ops):
    """Group alignment ops into primitive SNP / indel pieces."""
    pieces = []
    run = None  # (kind, ref_lo, ref_hi, alt_lo, alt_hi)
    for op, ri, aj in ops:
        if op == "M":
            if run is not None:
                pieces.append(run)
                run = None
            if rs[ri] != as_[aj]:
                pieces.append(("S", ri, ri + 1, aj, aj + 1))
        else:
            kind = op
            if run is not None and run[0] == kind:
                run = (kind, run[1], max(run[2], ri + (op == "D")), run[3], max(run[4], aj + (op == "I")))
            else:
                if run is not None:
                    pieces.append(run)
                lo_r, hi_r = (ri, ri + 1) if op == "D" else (ri, ri)
                lo_a, hi_a = (aj, aj + 1) if op == "I" else (aj, aj)
                run = (kind, lo_r, hi_r, lo_a, hi_a)
    if run is not None:
        pieces.append(run)
    out = []
    for kind, rlo, rhi, alo, ahi in pieces:
        if kind == "S":
            out.append(
                (
                    pos_flat + rlo,
                    dna.codes_to_seq(rs[rlo:rhi]),
                    dna.codes_to_seq(as_[alo:ahi]),
                )
            )
        else:
            out.append(
                _left_normalize(ref, pos_flat + rlo, rs[rlo:rhi], as_[alo:ahi])
            )
    return out


def _left_normalize(ref, pos, rs, as_):
    """VCF-style left alignment of an indel/block at flat position pos.

    For a pure indel the step-by-step rule (shift while the base before
    equals the arm's last base, rotating the arm) is equivalent to: shift by
    the longest s with ref[pos-1-i] == arm[(L-1-i) mod L] for all i < s,
    computed blockwise as vectorized comparisons."""
    rs = np.asarray(rs, np.uint8)
    as_ = np.asarray(as_, np.uint8)
    arm = as_ if len(rs) == 0 else (rs if len(as_) == 0 else None)
    if arm is not None and len(arm) and pos > 0:
        L = len(arm)
        # block-wise scan: compare 4096 positions at a time so the common
        # case (shift of a few bases) costs O(block), not O(pos)
        s = 0
        B = 4096
        while s < pos:
            n = min(B, pos - s)
            i = np.arange(s, s + n)
            neq = ref[pos - 1 - i] != arm[(L - 1 - i) % L]
            if neq.any():
                s += int(np.argmax(neq))
                break
            s += n
        if s:
            arm = np.roll(arm, s % L)
            pos -= s
            if len(rs):
                rs = arm
            else:
                as_ = arm
    anchor_base = ref[pos - 1] if pos > 0 else ref[pos]
    ref_str = dna.codes_to_seq(np.concatenate([[anchor_base], rs]).astype(np.uint8))
    alt_str = dna.codes_to_seq(np.concatenate([[anchor_base], as_]).astype(np.uint8))
    return pos - 1, ref_str, alt_str


def _contig_of(reference, flat_pos):
    for c in reference.contigs:
        if c.start <= flat_pos < c.start + c.length:
            return c
    return None
