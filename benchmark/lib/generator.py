"""The benchmark's input generator: a seeded genome and a paired library.

Frozen copy of ``chip_smoke.py`` ``leg_genome`` (:2959) and
``sv_paired_library`` (:2965-3060) at commit 3444720, with five changes
that keep its output otherwise as it was:

- the sample, the genome and its variants, is one draw (``SAMPLE_SEED``)
  for every run, with the sizes of the structural variants and the
  indels' lengths evenly spaced quantiles of the original distributions
  (indels of 1-8 bases in turn) and the structural variants evenly
  spaced, each moved by up to a quarter of the spacing; a run's seed
  draws its reads (which haplotype, where, how long the fragment and the
  trim): a seed is a sequencing run, and changes the reads, not how much
  work the sample makes;

- ``ploidy`` 1 puts every variant on both haplotypes (a haploid genome);
- ``trimmed_share`` is the share of reads trimmed at the 3' end (the
  original trims half);
- the substitution draw is skipped when ``error_rate`` is 0;
- the truth carries each read's haplotype and fragment, and each
  haplotype's edits, for the plain reference (``lib/reference.py``).

Nothing here imports the port or the JAX package.
"""

from __future__ import annotations

import numpy as np

CODE = "ACGT"


def rng_for(seed: int, salt: int) -> np.random.Generator:
    """A generator for one use of a run's seed: any whole number, negative
    or past 64 bits included, with ``salt`` naming the use."""
    return np.random.default_rng([seed % (1 << 64), salt])


# the sample (its genome, the variants' places, kinds, sizes, haplotypes,
# alleles and inserted bases) is one draw for every run, and a run's seed
# draws its reads: a sequencing run of one sample.  With the genome drawn
# from the seed, whole-genome discovery read 1016-1565 kbp/s over six seeds
# and 1 % apart on one seed: the wavefront's beam runs as long as its
# longest lane, and chance repeats of a random genome set that.
SAMPLE_SEED = 0


def quantiles(n: int) -> np.ndarray:
    """n evenly spaced points of (0, 1): the sizes of a set drawn the same
    for every seed."""
    return (np.arange(n) + 0.5) / max(n, 1)


def genome(length: int) -> np.ndarray:
    """``leg_genome``: the sample's genome, uniform random bases, uint8
    codes 0-3."""
    return rng_for(SAMPLE_SEED, 0).integers(0, 4, length, dtype=np.uint8)


def paired_library(genome, seed, n_pairs, n_het, n_hom, n_indel, hom_dels, het_dels, big_del, ins,
                   long_ins, read_len=150, error_rate=0.0, gap=2000, ploidy=2, trimmed_share=0.5,
                   frag_mean=400, frag_sd=40):
    """``sv_paired_library``: a paired library of a sample with structural
    and small variants.

    Structural variants, at least ``gap`` bases apart, evenly spaced (each
    moved by up to a quarter of the spacing) in random order along the
    genome: hom_dels hom deletions of 50-5000 bases (log-uniform
    quantiles), het_dels het deletions of 50-1000, one hom deletion of
    big_del bases (none when 0), ins hom novel insertions of 60-300 bases
    and long_ins of 1000-2000 (uniform quantiles).  Small variants on a
    grid of 20 bases, at least 300 bases from any structural variant: n_het
    het and n_hom hom SNPs and n_indel het indels of 1-8 bases (each length
    in turn), half of them insertions.  With ploidy 1 every
    variant is on both haplotypes.  Each pair comes from one haplotype: a
    fragment of normal length (frag_mean, frag_sd), read 1 its first
    read_len bases, read 2 the reverse complement of its last;
    trimmed_share of the reads trimmed at the 3' end by 1-30 bases; then
    error_rate uniform substitutions.  Returns (codes [2 n_pairs,
    read_len], lengths, truth), mates interleaved; truth["sv"] lists
    (class, 0-based left, svlen), truth["small"] the small variants as
    (0-based pos, ref, alt, haplotype: 0, 1 or 2 for both) in VCF form,
    truth["haps"] the two haplotypes, truth["edits"] each haplotype's
    edits as (0-based first changed base, bases removed, bases added),
    and truth["hap_of"], truth["start"], truth["frag"] each pair's
    haplotype, start on it and fragment length."""
    if ploidy not in (1, 2):
        raise ValueError(f"ploidy {ploidy}: 1 or 2")
    rng = rng_for(seed, 1)
    sample = rng_for(SAMPLE_SEED, 1)
    G = len(genome)

    def loguniform(lo, hi, n):
        return np.round(np.exp(np.log(lo) + quantiles(n) * (np.log(hi) - np.log(lo)))).astype(np.int64)

    def uniform(lo, hi, n):  # integers lo..hi
        return np.round(lo + quantiles(n) * (hi - lo)).astype(np.int64)

    events = [("hom_del", int(n), 2) for n in loguniform(50, 5000, hom_dels)]
    events += [("het_del", int(n), int(h)) for n, h in zip(loguniform(50, 1000, het_dels), sample.integers(0, 2, het_dels))]
    events += [("big_del", big_del, 2)] if big_del else []
    events += [("ins", int(n), 2) for n in uniform(60, 300, ins)]
    events += [("long_ins", int(n), 2) for n in uniform(1000, 2000, long_ins)]
    events = [events[i] for i in sample.permutation(len(events))]
    if ploidy == 1:
        events = [(kind, n, 2) for kind, n, _ in events]
    spans = np.array([n if kind.endswith("del") else 0 for kind, n, _ in events], np.int64)
    margin = 1000
    free = G - 2 * margin - int(spans.sum()) - gap * len(events)
    if free < 0:
        raise ValueError(f"{len(events)} structural variants do not fit {G} bases")
    # evenly spaced, each moved by up to a quarter of the spacing
    n_ev = len(events)
    cuts = np.round(free * quantiles(n_ev) + sample.uniform(-0.25, 0.25, n_ev) * free / max(n_ev, 1)).astype(np.int64)
    cuts = np.clip(cuts, 0, free)
    lefts = margin + cuts + gap * np.arange(n_ev) + np.concatenate([[0], np.cumsum(spans)[:-1]]).astype(np.int64)
    sv = []  # (class, left, svlen, haplotype or 2, inserted codes)
    for (kind, n, hap), left in zip(events, lefts.tolist()):
        if kind.endswith("del"):
            sv.append((kind, left, -n, hap, np.zeros(0, np.uint8)))
        else:
            sv.append((kind, left, n, hap, sample.integers(0, 4, n, dtype=np.uint8)))
    # small variants on a grid of 20, away from every structural variant
    grid = np.arange(200, G - 200, 20)
    near = np.zeros(len(grid), bool)
    for _, left, svlen, _, _ in sv:
        near |= (grid >= left - 300) & (grid < left + max(-svlen, 0) + 300)
    slots = sample.choice(grid[~near], n_het + n_hom + n_indel, replace=False)
    het, hom, ind = np.sort(slots[:n_het]), np.sort(slots[n_het : n_het + n_hom]), np.sort(slots[n_het + n_hom :])
    het_alt = ((genome[het] + 1 + sample.integers(0, 3, n_het)) % 4).astype(np.uint8)
    hom_alt = ((genome[hom] + 1 + sample.integers(0, 3, n_hom)) % 4).astype(np.uint8)
    het_hap = sample.integers(0, 2, n_het)
    ind_hap = sample.integers(0, 2, n_indel)
    if ploidy == 1:
        het_hap = np.full(n_het, 2)
        ind_hap = np.full(n_indel, 2)
    ind_len = sample.permutation(1 + np.arange(n_indel) % 8)
    is_ins = np.arange(n_indel) % 2 == 0
    ins_seq = [sample.integers(0, 4, n, dtype=np.uint8) for n in ind_len]
    haps, hap_edits = [], []
    for h in range(2):
        hap = genome.copy()
        on = (het_hap == h) | (het_hap == 2)
        hap[np.concatenate([het[on], hom])] = np.concatenate([het_alt[on], hom_alt])
        # (0-based position of the first changed base, bases removed, bases added)
        edits = [(int(ind[i]) + 1, 0 if is_ins[i] else int(ind_len[i]), ins_seq[i] if is_ins[i] else np.zeros(0, np.uint8))
                 for i in np.nonzero((ind_hap == h) | (ind_hap == 2))[0]]
        edits += [(left, max(-svlen, 0), seq) for _, left, svlen, on_h, seq in sv if on_h in (h, 2)]
        edits.sort(key=lambda e: e[0])
        pieces, prev = [], 0
        for at, removed, added in edits:
            pieces += [hap[prev:at], added]
            prev = at + removed
        pieces.append(hap[prev:])
        haps.append(np.concatenate(pieces))
        hap_edits.append(edits)
    hap_of = rng.integers(0, 2, n_pairs)
    frag = np.clip(np.round(rng.normal(frag_mean, frag_sd, n_pairs)), read_len, 700).astype(np.int64)
    codes = np.zeros((2 * n_pairs, read_len), np.uint8)
    start = np.zeros(n_pairs, np.int64)
    for h in range(2):
        sel = np.nonzero(hap_of == h)[0]
        start[sel] = rng.integers(0, len(haps[h]) - frag[sel])
        codes[2 * sel] = haps[h][start[sel][:, None] + np.arange(read_len)]
        codes[2 * sel + 1] = (3 - haps[h][(start[sel] + frag[sel] - read_len)[:, None] + np.arange(read_len)])[:, ::-1]
    lengths = np.full(2 * n_pairs, read_len, np.int32)
    trimmed = rng.random(2 * n_pairs) < trimmed_share
    lengths[trimmed] -= rng.integers(1, 31, int(trimmed.sum())).astype(np.int32)
    inside = np.arange(read_len)[None, :] < lengths[:, None]
    if error_rate:
        hit = (rng.random(codes.shape) < error_rate) & inside
        codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    codes = np.where(inside, codes, 0).astype(np.uint8)
    small = [(int(p), CODE[genome[p]], CODE[a], int(h))
             for p, a, h in zip(np.concatenate([het, hom]), np.concatenate([het_alt, hom_alt]),
                                np.concatenate([het_hap, np.full(n_hom, 2)]))]
    for i in range(n_indel):
        p = int(ind[i])
        if is_ins[i]:
            small.append((p, CODE[genome[p]], CODE[genome[p]] + "".join(CODE[c] for c in ins_seq[i]), int(ind_hap[i])))
        else:
            small.append((p, "".join(CODE[c] for c in genome[p : p + 1 + int(ind_len[i])]), CODE[genome[p]], int(ind_hap[i])))
    truth = {
        "sv": [(kind, left, svlen) for kind, left, svlen, _, _ in sv],
        "small": sorted(small),
        "haps": haps,
        "edits": hap_edits,
        "hap_of": hap_of,
        "start": start,
        "frag": frag,
    }
    return codes, lengths, truth


def mates(n_reads: int) -> np.ndarray:
    """Interleaved pairing, read 2i with read 2i + 1 (``create --paired``)."""
    mate_of = np.arange(n_reads, dtype=np.int64)
    mate_of[0::2] += 1
    mate_of[1::2] -= 1
    return mate_of
