"""The plain reference of the discovery cells: which planted variants a
call has to report, worked out from the generator's haplotypes and the
reads themselves, with no code of the port.

The port's discovery (``variants/discover.py`` with a readmap) reports a
variant when an alt path through the reads holds it and the path's read
support, after scoring, is at least ``min_alt_support``.  A path's support
is the least depth over its bubble (the anchor base, the alt bases, the
rejoin base) of the reads that match, base for base, the alt path between
a read length and two of reference on each side; at a position where one
strand holds more than 7/8 of the depth, the depth is twice the smaller
strand's.  Variants closer than ``rejoin_k`` matching bases lie on one
path.  This module computes the same from its definition:

- each haplotype's small variants, grouped into bubbles by that gap (a
  lone indel at its left-most placement along its repeat);
- each bubble's alt row, and every read placed on it by the generator's
  coordinates, kept where its bases equal the row's, and where the
  readmap attaches it to the row's entry (``_unattached``);
- the least strand-corrected depth over the bubble (for a lone indel, at
  its best placement along the repeat);
- a variant's support, the largest over the bubbles that hold it.

A variant is *due* where that support is at least ``min_alt_support`` +
``SUPPORT_MARGIN``, *not due* where it is at most ``min_alt_support`` -
``SUPPORT_MARGIN``, and *open* otherwise: the definition fixes the reads
that count but not each read's last bases at a bubble's end, so a support
near the threshold may go either way.  Open too are: bubbles that hold an
indel beside another variant (the aligner may split them another way);
indels with fewer than ``min_alt_support`` + ``CROWDED_MARGIN`` reads and
another variant within a read length (the beam may carry both on one
path, whose reads then count for the indel); one haplotype's bubble that
overlaps the other's (the beam may keep either path, or one crossing
between them); variants within ``END_MARGIN`` of the genome's ends; and
the spans of the structural variants, which ``discovery --no-sv`` does not
call.
Records are compared in left-normalized VCF form (``left_normalize``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SUPPORT_MARGIN = 1
CROWDED_MARGIN = 5
END_MARGIN = 400
MAX_BUBBLE_ALT = 64  # longer alt paths are open
CODE = "ACGT"


def left_normalize(genome: np.ndarray, pos: int, ref: str, alt: str):
    """(pos, ref, alt) of a VCF-form variant (0-based pos of its first
    base), shifted as far left as the genome allows and anchored on one
    base: the form discovery reports."""
    while ref and alt and ref[-1] == alt[-1] and pos > 0 and (len(ref) > 1 or len(alt) > 1):
        ref, alt = ref[:-1], alt[:-1]
        if not ref or not alt:
            pos -= 1
            base = CODE[int(genome[pos])]
            ref, alt = base + ref, base + alt
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt, pos = ref[1:], alt[1:], pos + 1
    return pos, ref, alt


def _changed_span(pos: int, ref: str, alt: str):
    """[first, end) of the reference bases a VCF-form variant changes;
    an insertion's span is empty, at the base after its anchor."""
    if len(ref) == len(alt) == 1:
        return pos, pos + 1
    return pos + 1, pos + len(ref)


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
    k = np.searchsorted(at, x, side="right")  # edits at or before x
    prev = np.maximum(k - 1, 0)
    inside = (k > 0) & (x < at[prev] + removed[prev])
    return np.where(inside, -1, x + shift[k])


@dataclass
class Expected:
    """What a call over a span has to report: ``due`` and ``not_due`` hold
    normalized (pos, ref, alt); ``open_spans`` are [lo, hi) of reference
    where neither a record nor its absence is judged; ``support`` maps each
    planted variant to its reference support."""

    due: set
    not_due: set
    open_variants: set
    open_spans: list
    support: dict


def _bubbles(small, G, rejoin_k):
    """Per haplotype, lists of bubbles; a bubble is (variant indices,
    first changed base, end, open)."""
    out = []
    for h in range(2):
        idx = [i for i, v in enumerate(small) if v[3] in (h, 2)]
        idx.sort(key=lambda i: small[i][0])
        bubbles = []
        cur, cur_open = [], False
        last_end = None
        for i in idx:
            p, r, a, _ = small[i]
            first, end = _changed_span(p, r, a)
            if cur and first - last_end <= rejoin_k + 2:
                near = first - last_end >= rejoin_k - 2
                if first - last_end < rejoin_k:
                    cur.append(i)
                    cur_open |= near
                    last_end = max(last_end, end)
                    continue
                cur_open |= near
                bubbles.append([cur, cur_open])
                cur, cur_open = [i], near
                last_end = end
                continue
            if cur:
                bubbles.append([cur, cur_open])
            cur, cur_open, last_end = [i], False, end
        if cur:
            bubbles.append([cur, cur_open])
        out.append(bubbles)
    return out


def _forward_reads(codes, lengths, truth, read_len):
    """(hap, fwd start, length, strand, fwd bases [R, read_len]) of every
    read, in the generator's haplotype coordinates."""
    R = len(lengths)
    pair = np.arange(R) // 2
    hap = truth["hap_of"][pair]
    start = truth["start"][pair]
    frag = truth["frag"][pair]
    lens = lengths.astype(np.int64)
    is2 = (np.arange(R) % 2) == 1
    fstart = np.where(is2, start + frag - lens, start)
    fwd = codes.copy()
    idx = np.arange(read_len)[None, :]
    # read 2 holds the reverse complement of its fragment's last bases
    r2 = np.nonzero(is2)[0]
    src = (lens[r2][:, None] - 1 - idx).clip(0)
    rc = (3 - np.take_along_axis(codes[r2], src, axis=1)).astype(np.uint8)
    fwd[r2] = np.where(idx < lens[r2][:, None], rc, 0)
    return hap, fstart, lens, is2.astype(np.int64), fwd


def _unattached(row, cands, fwd) -> list:
    """Reads that match a row but that the readmap attaches elsewhere.

    The readmap attaches an oriented read to the least seqset entry that
    begins with it, and the coverage walk counts, where a read ends, the
    reads attached to the one entry that the row's longest window there
    reaches.  A read X that lies inside longer reads Y (read in the walk's
    direction, toward the row's start) is a prefix of every entry that
    they continue into; where those continuations branch, X goes to the
    least branch (the larger forward base at the branch, since the walk
    reads complements), and the walk follows the row's.  Where the row's
    continuation ends and two others go on, the walk's range is not one
    entry and counts no read.  ``cands``: (offset, length, read, offsets
    where the read differs from the row) of every read placed on the row.
    Returns the matching reads not counted."""
    out = []
    for ox, lx, x, dx in cands:
        if len(dx):
            continue
        cur = [(oy, ly, y, dy) for oy, ly, y, dy in cands
               if oy < ox and oy + ly >= ox + lx and not ((dy >= ox) & (dy < ox + lx)).any()]
        pos = ox - 1
        while cur:
            last = [int(dy[dy <= pos].max()) if (dy <= pos).any() else -1 for _, _, _, dy in cur]
            q = max(last)
            if q < 0:
                break  # every continuation follows the row: one entry
            div = [c for c, d in zip(cur, last) if d == q]
            same = [c for c, d in zip(cur, last) if d < q and c[0] <= q]
            if not same:
                # the walk stops at q + 1; one entry only if the others agree
                seqs = {}
                for oy, _, y, _ in div:
                    for t in range(oy, q + 1):
                        seqs.setdefault(t, set()).add(int(fwd[y][t - oy]))
                if any(len(v) > 1 for v in seqs.values()):
                    out.append(x)
                break
            if any(int(fwd[y][q - oy]) > int(row[q]) for oy, _, y, _ in div):
                out.append(x)
                break
            cur, pos = same, q - 1
    return out


def expected_calls(genome, truth, codes, lengths, read_len, min_alt_support=3, rejoin_k=23,
                   chunk=1 << 18, exact=True) -> Expected:
    """The reference's verdict on every planted small variant of a whole
    genome (see the module's docstring).  ``exact`` False counts, in place
    of the reads that match a bubble's row, every read of a haplotype
    that carries the bubble over it (the control's depth)."""
    G = len(genome)
    C = read_len + 2
    small = truth["small"]
    hmaps = [hap_position(G, truth["edits"][h]) for h in range(2)]
    hap, fstart, lens, strand, fwd = _forward_reads(codes, lengths, truth, read_len)
    order = np.lexsort((fstart, hap))
    hap_s, fstart_s = hap[order], fstart[order]
    bounds = [np.searchsorted(hap_s, h) for h in range(3)]
    bubbles = _bubbles(small, G, rejoin_k)
    # one row per distinct bubble (a hom bubble appears on both haplotypes)
    rows, keyed = [], {}
    for h in range(2):
        for members, is_open in bubbles[h]:
            p0, r0, a0, _ = small[members[0]]
            first, _ = _changed_span(p0, r0, a0)
            end = max(_changed_span(*small[i][:3])[1] for i in members)
            a, r = first - 1, end
            ha, hr = int(hmaps[h][a]), int(hmaps[h][r])
            alt = truth["haps"][h][ha + 1 : hr]
            if len(members) == 1 and len(r0) != len(a0):
                # a lone indel: its left-most placement (the row's bases
                # are the same at every placement along a repeat)
                pn, rn, an = left_normalize(genome, p0, r0, a0)
                a, r = pn, pn + len(rn)
                alt = np.array(["ACGT".index(b) for b in an[1:]], np.uint8)
            key = (a, r, alt.tobytes())
            has_indel = any(len(small[i][1]) != len(small[i][2]) for i in members)
            is_open = is_open or (has_indel and len(members) > 1) or len(alt) > MAX_BUBBLE_ALT
            if key in keyed:
                rows[keyed[key]][1].update(members)
                rows[keyed[key]][2] |= is_open
                rows[keyed[key]][7].add(h)
                continue
            keyed[key] = len(rows)
            # where the haplotypes differ around the bubble, reads of the two
            # may branch apart inside longer reads
            local = [truth["haps"][k][max(int(hmaps[k][max(a - C, 0)]), 0) : max(int(hmaps[k][min(r + C, G - 1)]), 0)] for k in range(2)]
            rows.append([key, set(members), is_open, a, r, alt, not np.array_equal(*local), {h}])
    nrow = len(rows)
    Lrow = 2 * C + max((len(x[5]) for x in rows), default=0)
    row_codes = np.full((nrow, Lrow), 255, np.uint8)
    row_len = np.zeros(nrow, np.int64)
    left_len = np.zeros(nrow, np.int64)
    anchor = np.zeros(nrow, np.int64)
    for k, (_, _, _, a, r, alt, _, _) in enumerate(rows):
        left = genome[max(a - C + 1, 0) : a + 1]
        seq = np.concatenate([left, alt, genome[r : r + C]])
        row_codes[k, : len(seq)] = seq
        row_len[k] = len(seq)
        left_len[k] = len(left)
        anchor[k] = a
    # a lone indel in a repeat has a bubble at every placement along it;
    # the traces of the two orientations find its two ends, and the record
    # keeps the better support: its window runs over every placement
    slide = np.zeros(nrow, np.int64)
    for k, (_, members, _, a, r, alt, _, _) in enumerate(rows):
        (p, ref_a, alt_a, _), = [small[i] for i in members] if len(members) == 1 else [(0, "A", "C", 0)]
        if len(ref_a) == len(alt_a):
            continue
        n = len(alt)
        if n:  # an insertion: the inserted bases repeat into the right flank
            while C + n + slide[k] < row_len[k] - 1 and row_codes[k, C + slide[k]] == row_codes[k, C + n + slide[k]]:
                slide[k] += 1
        else:
            while r + slide[k] < G - 1 and genome[a + 1 + slide[k]] == genome[r + slide[k]]:
                slide[k] += 1
    width = np.array([len(x[5]) for x in rows], np.int64) + 2
    win_lo = left_len - 1
    win_hi = win_lo + width + slide
    W = int((win_hi - win_lo).max()) if nrow else 1
    branching = {k for k, row in enumerate(rows) if row[6] and exact}
    carried = np.array([[h in row[7] for h in range(2)] for row in rows], bool).reshape(-1, 2)
    matched, kept = [], {k: [] for k in branching}
    # (row, read) candidates: reads of either haplotype starting within a
    # read length left of the anchor and before the rejoin
    cols = np.arange(read_len)[None, :]
    for h in range(2):
        ha = hmaps[h][anchor]
        ok = ha >= 0
        rows_h = np.nonzero(ok)[0]
        ha = ha[ok]
        lo = np.searchsorted(fstart_s[bounds[h] : bounds[h + 1]], ha - read_len) + bounds[h]
        hi = np.searchsorted(fstart_s[bounds[h] : bounds[h + 1]], ha + (win_hi[rows_h] - win_lo[rows_h]), side="right") + bounds[h]
        n = hi - lo
        row_of = np.repeat(rows_h, n)
        base = np.repeat(ha, n)
        read_at = np.repeat(lo - np.concatenate([[0], np.cumsum(n)[:-1]]), n) + np.arange(int(n.sum()))
        reads = order[read_at]
        for c0 in range(0, len(reads), chunk):
            rr, rw, b = row_of[c0 : c0 + chunk], reads[c0 : c0 + chunk], base[c0 : c0 + chunk]
            o = fstart[rw] - b + left_len[rr] - 1
            ln = lens[rw]
            fits = (o >= 0) & (o + ln <= row_len[rr])
            rr, rw, o, ln = rr[fits], rw[fits], o[fits], ln[fits]
            got = row_codes[rr[:, None], (o[:, None] + cols).clip(0, Lrow - 1)]
            differs = (got != fwd[rw]) & (cols < ln[:, None])
            same = ~differs.any(axis=1) if exact else carried[rr, hap[rw]]
            for i in np.nonzero(np.isin(rr, list(branching)))[0] if branching else ():
                kept[int(rr[i])].append((int(o[i]), int(ln[i]), int(rw[i]), np.nonzero(differs[i])[0] + o[i]))
            matched.append((rr[same], rw[same], o[same], ln[same]))
    rr, rw, o, ln = (np.concatenate([m[i] for m in matched]) if matched else np.zeros(0, np.int64) for i in range(4))
    if branching:
        drop = set()
        for k, cands in kept.items():
            drop |= {(k, x) for x in _unattached(row_codes[k], cands, fwd)}
        keep = np.array([(int(a), int(b)) not in drop for a, b in zip(rr, rw)], bool)
        rr, rw, o, ln = rr[keep], rw[keep], o[keep], ln[keep]
    fwd_depth = np.zeros((nrow, W), np.int64)
    rev_depth = np.zeros((nrow, W), np.int64)
    pos = win_lo[rr][:, None] + np.arange(W)[None, :]
    cov = (pos >= o[:, None]) & (pos < (o + ln)[:, None]) & (pos < win_hi[rr][:, None])
    is_rev = strand[rw].astype(bool)
    np.add.at(fwd_depth, rr[~is_rev], cov[~is_rev].astype(np.int64))
    np.add.at(rev_depth, rr[is_rev], cov[is_rev].astype(np.int64))
    tot = fwd_depth + rev_depth
    skew = np.abs(fwd_depth - rev_depth) * 4 > tot * 3
    tot = np.where(skew, 2 * np.minimum(fwd_depth, rev_depth), tot)
    row_support = np.zeros(nrow, np.int64)
    for k in range(nrow):  # the best placement's least depth
        row_support[k] = max(int(tot[k, j : j + width[k]].min()) for j in range(int(slide[k]) + 1))
    # a bubble of one haplotype that overlaps another bubble of the other:
    # the beam may keep either path, or one that crosses between them
    lone = [k for k, row in enumerate(rows) if len(row[7]) == 1]
    for i, k in enumerate(lone):
        for j in lone[i + 1 :]:
            if rows[k][7] != rows[j][7] and rows[k][3] <= rows[j][4] and rows[j][3] <= rows[k][4]:
                rows[k][2] = rows[j][2] = True
    support = {}
    opened = set()
    for k, (_, members, is_open, *_) in enumerate(rows):
        for i in members:
            support[i] = max(support.get(i, 0), int(row_support[k]))
            if is_open:
                opened.add(i)
    # an indel that neighbours cut down to a few reads: the beam may carry
    # it on one path with a neighbour, whose reads then count for it
    crowded = set()
    for h in range(2):
        idx = sorted((i for i, v in enumerate(small) if v[3] in (h, 2)), key=lambda i: small[i][0])
        pos = np.array([small[i][0] for i in idx], np.int64)
        for j, i in enumerate(idx):
            near = (j > 0 and pos[j] - pos[j - 1] <= C) or (j + 1 < len(idx) and pos[j + 1] - pos[j] <= C)
            if near and len(small[i][1]) != len(small[i][2]) and support.get(i, 0) < min_alt_support + CROWDED_MARGIN:
                crowded.add(i)
    due, not_due, open_variants = set(), set(), set()
    sup_by_norm = {}
    for i, (p, r, a, _) in enumerate(small):
        v = left_normalize(genome, p, r, a)
        s = support.get(i, 0)
        sup_by_norm[v] = s
        if i in opened or i in crowded or p < END_MARGIN or p >= G - END_MARGIN:
            open_variants.add(v)
        elif s >= min_alt_support + SUPPORT_MARGIN:
            due.add(v)
        elif s <= min_alt_support - SUPPORT_MARGIN:
            not_due.add(v)
        else:
            open_variants.add(v)
    open_spans = [(0, END_MARGIN), (G - END_MARGIN, G)]
    for _, left, svlen in truth["sv"]:
        open_spans.append((left - C, left + max(-svlen, 0) + C))
    # an open bubble's records may split it in another way
    open_spans += [(row[3] - rejoin_k, row[4] + rejoin_k) for row in rows if row[2]]
    return Expected(due, not_due, open_variants, open_spans, sup_by_norm)


def judge(records, expected: Expected, span=None, edge=0, examples=None) -> dict:
    """The numbers compared for one call's records:

    - ``missed``: due variants it did not report;
    - ``extra``: reported variants that are not due, or match no planted
      variant outside the open spans;
    - ``support_off``: reported SNVs, due or not, whose support differs
      from the reference's (an indel's bubble may sit anywhere along its
      repeat, which moves its support by a read or two, so indels are
      judged by presence alone).

    Open variants are judged by nothing.  ``span`` [lo, hi) limits all to
    a region call's span, ``edge`` bases inside each end.  ``examples``, a
    dict, collects the variants behind each count."""
    if examples is None:
        examples = {}
    lo, hi = span if span else (0, 1 << 62)
    lo, hi = lo + edge, hi - edge
    got = {}
    for r in records:
        v = (int(r["pos"]) - 1, r["ref"], r["alt"])
        if lo <= v[0] < hi:
            got[v] = int(r["support"])
    due = {v for v in expected.due if lo <= v[0] < hi}
    planted = expected.due | expected.not_due | expected.open_variants
    missed = sorted(due - set(got))
    extra, support_off = [], []
    for v, s in got.items():
        if v in expected.open_variants:
            continue
        if v in expected.not_due or (v not in planted and not any(a <= v[0] < b for a, b in expected.open_spans)):
            extra.append(v)
        if v in planted and len(v[1]) == len(v[2]) == 1 and s != expected.support[v]:
            support_off.append((v, s, expected.support[v]))
    out = {"missed": missed, "extra": sorted(extra), "support_off": sorted(support_off)}
    for k, found in out.items():
        if found:
            examples.setdefault(k, []).extend(found[: 5 - len(examples.get(k, []))])
    return {k: len(found) for k, found in out.items()}
