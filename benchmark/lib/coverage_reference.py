"""The plain reference of the coverage stage: every record's AD, DP, GT, GQ,
PL, PC and PS, as ``run_coverage(..., pair_cov=True, phase=True)`` has to
give them, worked out from their definitions, from the sample's reads and
haplotypes.  numpy and scipy's log-gamma alone: nothing of the port or of
the JAX package.  The benchmark keeps a copy of this file
(``benchmark/lib/coverage_reference.py``); the two hold the same code.

The definitions:

- **The donor.**  The reference with each record's first alt applied, in
  order of position; a record that overlaps one applied before it, or runs
  past the genome, is left out.

- **Allele windows.**  For each allele of a record (the alt, then the ref)
  a query: ``C`` = the longest read + 2 donor bases before the record, the
  allele, ``C`` donor bases after it.  Its window runs from the last base
  before the allele through the allele's last base.  An allele longer than
  ``2 WIN_CAP + C`` is two queries instead, one a breakpoint, each with a
  window of ``WIN_CAP`` allele bases (the left one from the base before the
  allele, the right one through the base after it).

- **Depth.**  The store holds every suffix of every read, in both
  orientations, less those that begin another suffix (its entries, in
  lexicographic order, A < C < G < T); a read is attached to the least
  entry that begins with it.  The coverage walk reads a query's complement
  from its right end: at each position j it takes the longest window ``w``
  = the query's bases ``[j - s + 1, j]``, inside the query, that a read
  holds; where exactly one entry begins with ``w``'s reverse complement,
  each read attached to that entry, no longer than ``s``, ends at j and
  covers its bases.  So a read counts in a query where its bases equal the
  query's over its whole length ``[a, j]``, unless reads holding it go on
  to its left in two ways (both haplotypes hold the read, and differ less
  than a read length to its left): then it counts only where the query's
  own bases to the left of ``a`` follow one of those ways beyond the
  other, and that way, read as a complement, is the least
  (``Sample.branches``).  An allele's depth is the least, over its window(s),
  of the reads covering a position, both strands.

- **Genotype.**  Binomial log10-likelihoods of 0, 1 and 2 alt copies with
  alt shares ``PRIORS`` over ``max(DP, 1)`` reads; GT the best, ``./.``
  where DP is 0; PL each genotype's distance from the best, times -10,
  rounded; GQ ten times the best's lead over the second, rounded.

- **PC.**  Every read is placed on the donor: of the starts where one of
  its three seeds (the ``PLACE_K`` bases at offsets 0, (length - K) / 2
  and length - K of the read as it lies on the donor) matches exactly, the
  one with the fewest mismatches, the leftmost of equals, if it has at
  most ``PLACE_MAX_MISMATCHES``.  A read whose mate is placed on the other
  strand within ``MAX_FRAG`` bases spans [the leftmost start of the two,
  the rightmost start + its own length); a record's PC is half the reads
  whose span holds the donor's copy of the record's alt, rounded down.

- **PS.**  Consecutive het records (GT 0/1) whose alleles one read can
  span (the second's end at most the longest read past the first's start)
  are linked by the four queries, on the reference, of their alleles
  (alt-alt, alt-ref, ref-alt, ref-ref): reads counted as above with their
  start at most the first allele's first base, less those ending before
  the second allele's last base.  Cis where alt-alt and ref-ref both reach
  ``MIN_LINK`` and the crossed ones are 0, trans the other way round; a
  run of links is a phase block, its PS the first record's position, each
  GT ``0|1`` or ``1|0`` by the parity of trans links from the first.

A record the definitions leave undecided is *open* and judged by nothing:
one whose window holds a position where ``KMAX`` reads or more end (the
walk gathers at most ``KMAX`` reads an entry), one where a read that holds
another holds it twice (a repeat), and the records of a phase block whose
link hangs on such a query.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import gammaln

CODE = "ACGT"
WIN_CAP = 192
PRIORS = (0.05, 0.5, 0.95)
MAX_FRAG = 1000
PLACE_K = 13
PLACE_SEEDS = 3
PLACE_MAX_MISMATCHES = 3
MIN_LINK = 2
KMAX = 16
SEED = 20  # bases a read is looked up by in the queries
RISK_BASES = 40  # a haplotype difference this close left of a read may branch its entries
HOLDER_ENDS = (-40, 80)  # reads that hold a read end this close to its end (reference bases)
PAIR_MARGIN = 3000  # reads this close to a region's records are placed
_COMP = bytes([3, 2, 1, 0]) + bytes(range(4, 256))
_INDEX = np.full(256, 255, np.uint8)
for _i, _c in enumerate(CODE):
    _INDEX[ord(_c)] = _i


def codes_of(seq: str) -> np.ndarray:
    return _INDEX[np.frombuffer(seq.encode(), np.uint8)]


def hap_position(G: int, edits) -> np.ndarray:
    """Each reference base's position on a haplotype with these edits
    ((first changed base, bases removed, bases added), sorted); -1 where
    deleted."""
    x = np.arange(G, dtype=np.int64)
    if not edits:
        return x
    at = np.array([e[0] for e in edits], np.int64)
    removed = np.array([e[1] for e in edits], np.int64)
    shift = np.concatenate([[0], np.cumsum(np.array([len(e[2]) for e in edits], np.int64) - removed)])
    k = np.searchsorted(at, x, side="right")
    prev = np.maximum(k - 1, 0)
    inside = (k > 0) & (x < at[prev] + removed[prev])
    return np.where(inside, -1, x + shift[k])


def _keys(text: np.ndarray, k: int) -> np.ndarray:
    """The 2k-bit key of every k-base window of ``text`` (codes 0-3), [n - k + 1]."""
    n = len(text) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    t = text.astype(np.int64)
    out = np.zeros(n, np.int64)
    for i in range(k):
        out = (out << 2) | t[i : i + n]
    return out


def build_donor(genome: np.ndarray, flat_records):
    """(donor, donor position of each reference position [G + 1]) of
    ``flat_records`` [(0-based pos, ref codes, alt codes)] sorted by
    position; a record overlapping one applied, or past the genome, is
    left out; a position inside a replaced span maps to its start."""
    G = len(genome)
    pieces, donor_of_ref = [], np.zeros(G + 1, np.int64)
    prev = offset = 0
    for p0, ra, aa in flat_records:
        if p0 < prev or p0 + len(ra) > G:
            continue
        pieces += [genome[prev:p0], aa]
        donor_of_ref[prev:p0] = np.arange(prev, p0) + offset
        donor_of_ref[p0 : p0 + len(ra)] = p0 + offset
        offset += len(aa) - len(ra)
        prev = p0 + len(ra)
    pieces.append(genome[prev:])
    donor_of_ref[prev : G + 1] = np.arange(prev, G + 1) + offset
    return np.concatenate(pieces), donor_of_ref


def genotype(ref_depth, alt_depth, priors=PRIORS):
    """(GT strings, GQ int32 [N], PL int32 [N, 3]) of the binomial genotyper."""
    ref_depth = np.asarray(ref_depth, np.int64)
    alt_depth = np.asarray(alt_depth, np.int64)
    N = len(ref_depth)
    tot = np.maximum(alt_depth + ref_depth, 1)
    alt = np.minimum(alt_depth, tot)
    non = tot - alt
    comb = (gammaln(tot + 1) - gammaln(alt + 1) - gammaln(non + 1)) / np.log(10)
    gl = np.zeros((N, 3))
    for g, p in enumerate(priors):
        gl[:, g] = comb + alt * np.log10(p) + non * np.log10(1 - p)
    order = np.argsort(-gl, axis=1)
    best, second = order[:, 0], order[:, 1]
    pl = np.round(-10 * (gl - gl[np.arange(N), best][:, None])).astype(np.int32)
    gq = np.round(10 * (gl[np.arange(N), best] - gl[np.arange(N), second])).astype(np.int32)
    names = ("0/0", "0/1", "1/1")
    gt = [names[int(b)] if a + r > 0 else "./." for b, a, r in zip(best, alt_depth, ref_depth)]
    return gt, gq, pl


@dataclass
class Expected:
    """The reference's numbers of a list of records, each [N]."""

    ad: list  # "ref,alt"
    dp: np.ndarray
    gt: list
    gq: np.ndarray
    pl: list  # "a,b,c"
    pc: np.ndarray
    ps: list  # int or None
    open: np.ndarray  # bool


class Sample:
    """A sequencing run of a diploid sample: its reads as sequenced (mates
    2i and 2i + 1, read 2 the reverse complement of its fragment's end) and
    the generator's truth: the haplotypes, each pair's haplotype, start and
    fragment length, the small variants (0-based pos, ref, alt, haplotype 0,
    1 or 2 for both) and each haplotype's edits."""

    def __init__(self, genome, codes, lengths, truth):
        self.genome = np.asarray(genome, np.uint8)
        G = len(self.genome)
        R, L = codes.shape
        self.L = L
        self.lens = np.asarray(lengths, np.int64)
        pair = np.arange(R) // 2
        is2 = np.arange(R) % 2 == 1
        self.hap = np.asarray(truth["hap_of"])[pair]
        start, frag = np.asarray(truth["start"])[pair], np.asarray(truth["frag"])[pair]
        fstart = np.where(is2, start + frag - self.lens, start)
        # every read as it lies on its haplotype
        fwd = np.array(codes, np.uint8, copy=True)
        idx = np.arange(L)[None, :]
        r2 = np.nonzero(is2)[0]
        src = (self.lens[r2][:, None] - 1 - idx).clip(0)
        rc = (3 - np.take_along_axis(codes[r2], src, axis=1)).astype(np.uint8)
        fwd[r2] = np.where(idx < self.lens[r2][:, None], rc, 0)
        self.fwd = fwd
        self.key = _keys(np.concatenate([fwd[:, :SEED], np.zeros((R, 1), np.uint8)], axis=1).reshape(-1), SEED)[
            :: SEED + 1] if R else np.zeros(0, np.int64)
        # each read's first and last base on the reference (a base inside
        # an insertion goes to the base before it)
        self.ref_start = np.zeros(R, np.int64)
        ref_end = np.zeros(R, np.int64)
        edits = truth["edits"]
        for h in range(2):
            hp = hap_position(G, edits[h])
            ys = np.nonzero(hp >= 0)[0]
            xs = hp[ys]
            sel = np.nonzero(self.hap == h)[0]
            for out, at in ((self.ref_start, fstart[sel]), (ref_end, fstart[sel] + self.lens[sel] - 1)):
                out[sel] = ys[np.clip(np.searchsorted(xs, at, side="right") - 1, 0, None)]
        self.by_start = np.argsort(self.ref_start, kind="stable")
        self.start_sorted = self.ref_start[self.by_start]
        self.ref_end = ref_end
        self.by_end = np.argsort(ref_end, kind="stable")
        self.end_sorted = ref_end[self.by_end]
        # the bases where the haplotypes differ: het small variants and the
        # edits of one haplotype alone, each a base wider on either side
        het = np.zeros(G + 1, np.int64)
        for p, r, _, h in truth["small"]:
            if h in (0, 1):
                het[max(p - 1, 0) : min(p + len(r) + 1, G)] = 1
        keyed = [{(a, n, bytes(np.asarray(s, np.uint8))) for a, n, s in edits[h]} for h in range(2)]
        for a, n, _ in keyed[0] ^ keyed[1]:
            het[max(a - 2, 0) : min(a + n + 1, G)] = 1
        cum = np.concatenate([[0], np.cumsum(het)])
        lo = np.clip(self.ref_start - RISK_BASES, 0, G)
        hi = np.clip(self.ref_start + 2, 0, G + 1)
        self.risky = cum[hi] - cum[lo] > 0
        self._bytes = {}
        self._branch = {}

    def read_bytes(self, r: int) -> bytes:
        got = self._bytes.get(r)
        if got is None:
            got = self._bytes[r] = self.fwd[r, : self.lens[r]].tobytes()
        return got

    def near(self, lo: int, hi: int) -> np.ndarray:
        """Reads whose first base lies in [lo, hi) of the reference."""
        a, b = np.searchsorted(self.start_sorted, [lo, hi])
        return self.by_start[a:b]

    def branches(self, r: int):
        """Where reads holding read r go on to its left in more than one
        way: (the ways that no other way extends, the least of them read as
        a complement); None where they are one way; "open" where a read
        holds read r twice."""
        if r in self._branch:
            return self._branch[r]
        x = self.read_bytes(r)
        ways = set()
        end = int(self.ref_end[r])
        a, b = np.searchsorted(self.end_sorted, [end + HOLDER_ENDS[0], end + HOLDER_ENDS[1]])
        for y in self.by_end[a:b]:
            yb = self.read_bytes(int(y))
            off = yb.find(x)
            if off < 0:
                continue
            if yb.find(x, off + 1) >= 0:
                self._branch[r] = "open"
                return "open"
            ways.add(yb[:off][::-1])
        ends = [w for w in ways if not any(v != w and v.startswith(w) for v in ways)]
        got = None
        if len(ends) > 1:
            got = (ends, min(ends, key=lambda w: w.translate(_COMP)))
        self._branch[r] = got
        return got


def _lcp(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def walk_reads(sample: Sample, queries: list, lo: int, hi: int, exact: bool = True):
    """The reads the coverage walk counts in each query: (query, first
    base, last base) int64 arrays, and the queries holding an undecided
    position.  Only reads whose first base lies in [lo, hi) of the
    reference are looked at.  ``exact`` False counts every read whose first
    ``SEED`` bases lie in a query and that fits it, whatever its other
    bases (a control's depth)."""
    nq = len(queries)
    qlen = np.array([len(q) for q in queries], np.int64)
    qstart = np.concatenate([[0], np.cumsum(qlen + 1)])
    text = np.full(int(qstart[-1]), 4, np.uint8)
    for q, codes in enumerate(queries):
        text[qstart[q] : qstart[q] + qlen[q]] = codes
    keys = _keys(np.minimum(text, 3), SEED)
    bad = np.concatenate([[0], np.cumsum(text == 4)])
    ok = bad[SEED : SEED + len(keys)] - bad[: len(keys)] == 0
    kpos = np.nonzero(ok)[0]
    order = np.argsort(keys[kpos], kind="stable")
    kpos, ksorted = kpos[order], keys[kpos][order]
    reads = sample.near(lo, hi)
    a0 = np.searchsorted(ksorted, sample.key[reads], side="left")
    a1 = np.searchsorted(ksorted, sample.key[reads], side="right")
    n = a1 - a0
    cand_r = np.repeat(reads, n)
    cand_p = kpos[np.repeat(a0 - np.concatenate([[0], np.cumsum(n)[:-1]]), n) + np.arange(int(n.sum()))]
    q = np.searchsorted(qstart, cand_p, side="right") - 1
    a = cand_p - qstart[q]
    m = sample.lens[cand_r]
    fit = a + m <= qlen[q]
    cand_r, cand_p, q, a, m = cand_r[fit], cand_p[fit], q[fit], a[fit], m[fit]
    if exact:
        same = np.ones(len(cand_r), bool)
        cols = np.arange(sample.L)
        for c0 in range(0, len(cand_r), 1 << 16):
            sl = slice(c0, c0 + (1 << 16))
            got = text[(cand_p[sl][:, None] + cols).clip(0, len(text) - 1)]
            diff = (got != sample.fwd[cand_r[sl]]) & (cols < m[sl][:, None])
            same[sl] = ~diff.any(axis=1)
        cand_r, q, a, m = cand_r[same], q[same], a[same], m[same]
    j = a + m - 1
    counted = np.ones(len(cand_r), bool)
    undecided = set()
    if exact:
        for i in np.nonzero(sample.risky[cand_r])[0]:
            got = sample.branches(int(cand_r[i]))
            if got is None:
                continue
            if got == "open":
                undecided.add(int(q[i]))
                continue
            ends, least = got
            left = queries[q[i]][: a[i]][::-1].tobytes()
            lcps = [_lcp(w, left) for w in ends]
            g = max(lcps)
            holders = [w for w, n_ in zip(ends, lcps) if n_ == g]
            counted[i] = len(holders) == 1 and holders[0] == least
    q, a, j = q[counted], a[counted], j[counted]
    if len(q):
        ends_at, many = np.unique(q * (1 << 20) + j, return_counts=True)
        undecided |= {int(x >> 20) for x in ends_at[many >= KMAX]}
    return q, a, j, undecided


def _depths(queries, q, a, j) -> list:
    """Reads covering each position of each query."""
    out = []
    for k, codes in enumerate(queries):
        sel = q == k
        d = np.zeros(len(codes) + 1, np.int64)
        np.add.at(d, a[sel], 1)
        np.add.at(d, j[sel] + 1, -1)
        out.append(np.cumsum(d[:-1]))
    return out


def _coverage_queries(donor, donor_of_ref, G, records, C):
    """annotate_coverage's queries: (codes, window [lo, hi), record, allele
    0 alt / -1 ref) of each."""
    out = []
    for i, (p0, ref, alt) in enumerate(records):
        ra = codes_of(ref)
        dp0 = int(donor_of_ref[p0])
        left = donor[max(dp0 - C, 0) : dp0]
        r0 = int(donor_of_ref[min(p0 + len(ra), G)])
        right = donor[r0 : r0 + C]
        for ai, mid in ((0, codes_of(alt)), (-1, ra)):
            lo_b = max(len(left) - 1, 0)
            if len(mid) <= 2 * WIN_CAP + C:
                out.append((np.concatenate([left, mid, right]), lo_b, lo_b + len(mid) + 1, i, ai))
            else:
                out.append((np.concatenate([left, mid[: WIN_CAP + C]]), lo_b, len(left) + WIN_CAP, i, ai))
                out.append((np.concatenate([mid[-(WIN_CAP + C) :], right]), C, WIN_CAP + C + 1, i, ai))
    return out


def placements(sample: Sample, donor: np.ndarray, reads: np.ndarray, wlo: int, whi: int):
    """(start on the donor, -1 where unplaced) of each of ``reads``, by
    seed and mismatch count; only seed matches in donor[wlo:whi] count."""
    K = PLACE_K
    win = donor[wlo:whi]
    keys = _keys(win, K)
    order = np.argsort(keys, kind="stable")
    ksorted = keys[order]
    lens = sample.lens[reads]
    cand_i, cand_s = [], []
    for s in range(PLACE_SEEDS):
        off = np.clip((lens - K) * s // (PLACE_SEEDS - 1), 0, sample.L - K)
        seed = _keys(np.concatenate([sample.fwd[reads[:, None], off[:, None] + np.arange(K)],
                                     np.zeros((len(reads), 1), np.uint8)], axis=1).reshape(-1), K)[:: K + 1]
        a0 = np.searchsorted(ksorted, seed, side="left")
        a1 = np.searchsorted(ksorted, seed, side="right")
        n = a1 - a0
        hit = order[np.repeat(a0 - np.concatenate([[0], np.cumsum(n)[:-1]]), n) + np.arange(int(n.sum()))]
        cand_i.append(np.repeat(np.arange(len(reads)), n))
        cand_s.append(wlo + hit - np.repeat(off, n))
    ci, cs = np.concatenate(cand_i), np.concatenate(cand_s)
    pair = np.unique(np.stack([ci, cs], axis=1), axis=0)
    ci, cs = pair[:, 0], pair[:, 1]
    ok = (cs >= 0) & (cs + lens[ci] <= len(donor))
    ci, cs = ci[ok], cs[ok]
    mm = np.zeros(len(ci), np.int64)
    cols = np.arange(sample.L)
    for c0 in range(0, len(ci), 1 << 16):
        sl = slice(c0, c0 + (1 << 16))
        got = donor[(cs[sl][:, None] + cols).clip(0, len(donor) - 1)]
        mm[sl] = ((got != sample.fwd[reads[ci[sl]]]) & (cols < lens[ci[sl]][:, None])).sum(axis=1)
    best = np.lexsort((cs, mm, ci))
    first = np.ones(len(best), bool)
    first[1:] = ci[best][1:] != ci[best][:-1]
    pos = np.full(len(reads), -1, np.int64)
    b = best[first]
    placed = mm[b] <= PLACE_MAX_MISMATCHES
    pos[ci[b][placed]] = cs[b][placed]
    return pos


def pair_counts(sample: Sample, donor, donor_of_ref, records, G: int) -> np.ndarray:
    """PC of each record (see the module's docstring)."""
    if not records:
        return np.zeros(0, np.int32)
    lo = min(p for p, _, _ in records) - PAIR_MARGIN
    hi = max(p + len(r) for p, r, _ in records) + PAIR_MARGIN
    reads = sample.near(lo, hi)
    reads = np.unique(np.concatenate([reads, reads ^ 1]))
    wlo = int(donor_of_ref[max(lo - PAIR_MARGIN, 0)])
    whi = int(donor_of_ref[min(hi + PAIR_MARGIN, G)])
    pos = placements(sample, donor, reads, wlo, whi)
    mate = np.searchsorted(reads, reads ^ 1)  # both mates of every pair are among the reads
    lens = sample.lens[reads]
    mpos = pos[mate]
    # read 1 lies forward on the donor and read 2 reversed: mates are
    # placed on the two strands
    ok = (pos >= 0) & (mpos >= 0) & (np.abs(pos - mpos) <= MAX_FRAG)
    a = np.minimum(pos, mpos)[ok]
    b = np.maximum(pos + lens, mpos + lens)[ok]
    out = np.zeros(len(records), np.int32)
    for i, (p0, _, alt) in enumerate(records):
        dlo = int(donor_of_ref[p0])
        out[i] = int(((a <= dlo) & (b >= dlo + len(alt))).sum()) // 2
    return out


def phase_sets(sample: Sample, records, gt, C: int, max_span: int, exact: bool = True):
    """(GT, PS, records left open) after read-backed phasing."""
    G = len(sample.genome)
    genome = sample.genome
    out_gt, out_ps = list(gt), [None] * len(records)
    hets = [i for i in range(len(records)) if gt[i] in ("0/1", "1/0")]
    pairs = []
    for x, y in zip(hets, hets[1:]):
        (p1, r1, _), (p2, r2, _) = records[x], records[y]
        if 0 < p2 + len(r2) - p1 <= max_span and p2 > p1 + len(r1) - 1:
            pairs.append((x, y))
    queries, spans = [], []
    for x, y in pairs:
        (p1, r1, a1), (p2, r2, a2) = records[x], records[y]
        left = genome[max(p1 - C, 0) : p1]
        mid = genome[p1 + len(r1) : p2]
        right = genome[p2 + len(r2) : p2 + len(r2) + C]
        for s1 in (a1, r1):
            for s2 in (a2, r2):
                queries.append(np.concatenate([left, codes_of(s1), mid, codes_of(s2), right]))
                spans.append((len(left), len(left) + len(s1) + len(mid) + len(s2) - 1))
    links, unsure = {}, set()
    if queries:
        lo = min(records[x][0] for x, _ in pairs) - C - 200
        hi = max(records[y][0] + len(records[y][1]) for _, y in pairs) + C + 200
        q, a, j, undecided = walk_reads(sample, queries, lo, hi, exact)
        for k, (x, y) in enumerate(pairs):
            s = []
            for t in range(4):
                row = 4 * k + t
                sa, sb = spans[row]
                sel = q == row
                s.append(max(int((a[sel] <= sa).sum()) - int((j[sel] <= sb - 1).sum()), 0))
            cis, trans = min(s[0], s[3]), min(s[1], s[2])
            if cis >= MIN_LINK and trans == 0:
                links[(x, y)] = True
            elif trans >= MIN_LINK and cis == 0:
                links[(x, y)] = False
            if any(4 * k + t in undecided for t in range(4)):
                unsure.add((x, y))
    opened = set()
    i = 0
    while i < len(hets):
        block, flips = [hets[i]], [False]
        while i + 1 < len(hets) and ((hets[i], hets[i + 1]) in links or (hets[i], hets[i + 1]) in unsure):
            if (hets[i], hets[i + 1]) in unsure:
                opened.add(hets[i])
                opened.add(hets[i + 1])
            if (hets[i], hets[i + 1]) not in links:
                break
            flips.append(flips[-1] ^ (not links[(hets[i], hets[i + 1])]))
            block.append(hets[i + 1])
            i += 1
        if len(block) > 1:
            for r, flip in zip(block, flips):
                out_gt[r] = "1|0" if flip else "0|1"
                out_ps[r] = records[block[0]][0] + 1
            if opened & set(block):
                opened |= set(block)
        i += 1
    return out_gt, out_ps, opened


def expected(sample: Sample, records, max_read_len: int, pair_cov: bool = True, phase: bool = True,
             priors=PRIORS, exact: bool = True) -> Expected:
    """The reference's numbers of ``records`` [(0-based pos, ref, alt)],
    sorted by position, plain ACGT alleles, one alt each, as one
    ``run_coverage`` call on a VCF of them gives them.  ``priors`` and
    ``exact`` are the controls' levers (the genotyper's alt shares; the
    depth's exact match)."""
    genome = sample.genome
    G = len(genome)
    N = len(records)
    C = max_read_len + 2
    flat = sorted(((p, codes_of(r), codes_of(a)) for p, r, a in records), key=lambda t: t[0])
    donor, donor_of_ref = build_donor(genome, flat)
    opened = np.zeros(N, bool)
    depth = {}
    if N:
        cq = _coverage_queries(donor, donor_of_ref, G, records, C)
        codes = [c for c, *_ in cq]
        lo = min(p for p, _, _ in records) - C - 200
        hi = max(p + len(r) for p, r, _ in records) + C + 200
        q, a, j, undecided = walk_reads(sample, codes, lo, hi, exact)
        cov = _depths(codes, q, a, j)
        for k, (c, wlo, whi, i, ai) in enumerate(cq):
            win = cov[k][wlo : min(whi, len(c))]
            d = int(win.min()) if len(win) else 0
            depth[i, ai] = min(depth.get((i, ai), 1 << 30), d)
            if k in undecided:
                opened[i] = True
    ref_depth = np.array([depth.get((i, -1), 0) for i in range(N)], np.int64)
    alt_depth = np.array([depth.get((i, 0), 0) for i in range(N)], np.int64)
    gt, gq, pl = genotype(ref_depth, alt_depth, priors)
    pc = pair_counts(sample, donor, donor_of_ref, records, G) if pair_cov else np.zeros(N, np.int32)
    ps = [None] * N
    if phase:
        gt, ps, more = phase_sets(sample, records, gt, C, max_read_len, exact)
        opened[list(more)] = True
    return Expected(
        ad=[f"{r},{a}" for r, a in zip(ref_depth, alt_depth)], dp=ref_depth + alt_depth, gt=gt, gq=gq,
        pl=[",".join(str(int(x)) for x in row) for row in pl], pc=pc, ps=ps, open=opened,
    )


def compare(expected: Expected, records, got: list, feature_rows: dict | None = None,
            examples: dict | None = None) -> dict:
    """The numbers the check compares, one call's output against the
    reference: ``got`` the output VCF's records as dicts (chrom, pos, ref,
    alt, info, fmt), ``feature_rows`` the rows of each of its feature
    columns.

    - ``lost``: records missing, out of order or with no feature row;
    - ``ad_off``: records whose AD or DP (INFO or FORMAT) differs;
    - ``pc_off``: records whose PC differs;
    - ``gt_off``: records whose GT, GQ or PL differs;
    - ``ps_off``: records whose PS differs;
    - ``open``: records left open, judged by nothing."""
    if examples is None:
        examples = {}
    N = len(records)
    out = {"lost": 0, "ad_off": 0, "pc_off": 0, "gt_off": 0, "ps_off": 0, "open": int(expected.open.sum())}
    keys = [(p + 1, r, a) for p, r, a in records]
    have = [(int(g["pos"]), g["ref"], g["alt"]) for g in got]
    rows = min(feature_rows.values(), default=0) if feature_rows is not None else N
    out["lost"] = sum(i >= len(have) or have[i] != keys[i] for i in range(N)) + max(len(have) - N, 0) + max(N - rows, 0)

    def note(kind, i, found, want):
        if len(examples.setdefault(kind, [])) < 5:
            examples[kind].append((keys[i], found, want))
        out[kind] += 1

    for i in range(min(N, len(have))):
        if have[i] != keys[i] or expected.open[i]:
            continue
        g, info = got[i]["fmt"], got[i]["info"]
        dp = int(expected.dp[i])
        if g.get("AD") != expected.ad[i] or int(g.get("DP", -1)) != dp or int(info.get("DP", -1)) != dp:
            note("ad_off", i, (g.get("AD"), g.get("DP"), info.get("DP")), (expected.ad[i], dp))
        if int(info.get("PC", -1)) != int(expected.pc[i]):
            note("pc_off", i, info.get("PC"), int(expected.pc[i]))
        if (g.get("GT"), int(g.get("GQ", -1)), g.get("PL")) != (expected.gt[i], int(expected.gq[i]), expected.pl[i]):
            note("gt_off", i, (g.get("GT"), g.get("GQ"), g.get("PL")),
                 (expected.gt[i], int(expected.gq[i]), expected.pl[i]))
        ps = g.get("PS")
        if (None if ps is None else int(ps)) != expected.ps[i]:
            note("ps_off", i, ps, expected.ps[i])
    return out


def parse_vcf(text: str) -> list:
    """The records of a one-sample VCF's text as dicts: chrom, pos, ref,
    alt, info (key -> str), fmt (key -> str)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        cols = line.split("\t")
        info = dict(kv.split("=", 1) if "=" in kv else (kv, "") for kv in cols[7].split(";") if kv != ".")
        fmt = dict(zip(cols[8].split(":"), cols[9].split(":"))) if len(cols) > 9 else {}
        out.append({"chrom": cols[0], "pos": int(cols[1]), "ref": cols[3], "alt": cols[4], "info": info, "fmt": fmt})
    return out
