"""The coverage cell's inputs, state and check: the sample's VCF (every
planted variant in left-normalized form, and decoys the sample does not
carry), cut into regions with a VCF file each; the store built in set-up;
``run_coverage`` on a region's VCF as the window's call; and the comparison
of every call's output with the plain reference
(``lib/coverage_reference.py``)."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace

import numpy as np

from benchmark.lib import coverage_reference, generator, reference, store

CODE = "ACGT"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SLICE_BASES = 20_000  # the bounded call of a traced run's host-side trace


def true_records(genome: np.ndarray, truth: dict) -> list:
    """Every planted variant as a VCF record (0-based pos, ref, alt),
    left-normalized: the small ones, and the structural ones with their
    sequence written out (a deletion's deleted bases, an insertion's
    inserted ones)."""
    out = {reference.left_normalize(genome, p, r, a) for p, r, a, _ in truth["small"]}
    for h in range(2):
        for at, removed, added in truth["edits"][h]:
            if removed < 50 and len(added) < 50:
                continue  # a small indel, written above
            anchor = CODE[int(genome[at - 1])]
            ref = anchor + "".join(CODE[int(c)] for c in genome[at : at + removed])
            alt = anchor + "".join(CODE[int(c)] for c in added)
            out.add(reference.left_normalize(genome, at - 1, ref, alt))
    return sorted(out)


def decoy_records(genome: np.ndarray, records: list, vcf: dict, read_len: int) -> list:
    """One decoy a ``decoy_every`` true records, drawn once for every run:
    an SNV or an indel of 1 to ``decoy_indel_max`` bases (in turn, half
    insertions), that the sample does not carry, at least ``decoy_gap``
    bases from every true record and every other decoy, and a read length
    inside the genome's ends."""
    G = len(genome)
    gap = vcf["decoy_gap"]
    n = len(records) // vcf["decoy_every"]
    free = np.ones(G, bool)
    free[: read_len + gap] = free[G - read_len - gap :] = False
    for p, r, _ in records:
        free[max(p - gap, 0) : p + len(r) + gap] = False
    rng = generator.rng_for(generator.SAMPLE_SEED, 4)
    out = []
    for p in rng.permutation(np.nonzero(free)[0]):
        if len(out) == n:
            break
        p = int(p)
        if not free[p]:
            continue
        k = len(out)
        size = 1 + (k // 2) % vcf["decoy_indel_max"]
        base = CODE[int(genome[p])]
        if k % 2 == 0:
            rec = (p, base, CODE[(int(genome[p]) + 1 + int(rng.integers(0, 3))) % 4])
        elif (k // 2) % 2 == 0:
            rec = (p, base, base + "".join(CODE[int(c)] for c in rng.integers(0, 4, size)))
        else:
            rec = (p, base + "".join(CODE[int(c)] for c in genome[p + 1 : p + 1 + size]), base)
        rec = reference.left_normalize(genome, *rec)
        out.append(rec)
        free[max(rec[0] - gap, 0) : rec[0] + len(rec[1]) + gap] = False
    if len(out) < n:
        raise ValueError(f"room for {len(out)} of {n} decoys")
    return sorted(out)


def regions(genome_length: int, region_bases: int) -> list:
    """[k * region_bases, (k + 1) * region_bases), the last holding the
    rest of the genome."""
    n = max(genome_length // region_bases, 1)
    return [(k * region_bases, genome_length if k == n - 1 else (k + 1) * region_bases) for k in range(n)]


def in_region(records: list, region) -> list:
    lo, hi = region
    return [r for r in records if lo <= r[0] < hi]


def write_vcf(path: str, contig: str, genome_length: int, records: list) -> None:
    """A VCF of sites alone, as discovery writes one to coverage."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={contig},length={genome_length}>\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
        for p, r, a in records:
            f.write(f"{contig}\t{p + 1}\t.\t{r}\t{a}\t.\tPASS\t.\tGT\t./.\n")


class State:
    """The configuration's sample from the seed, its store on the device,
    its VCF by region on disk, and the ``run_coverage`` call the window
    repeats."""

    def __init__(self, cell, seed, device):
        self.config, self.mix = cell.config, cell.mix
        self.genome, self.codes, self.lengths, mate_of, self.truth = store.library(self.config, seed)
        contig = self.config.get("contig", "chr1")
        self.ref = store.reference(self.genome, contig)
        L = self.config["library"]["read_len"]
        truths = true_records(self.genome, self.truth)
        self.records = sorted(truths + decoy_records(self.genome, truths, self.config["vcf"], L))
        self.regions = regions(len(self.genome), self.mix["region_bases"])
        cache = os.path.join(ROOT, ".bench_cache")
        os.makedirs(cache, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="coverage_", dir=cache)
        self.vcfs = []
        for k, region in enumerate(self.regions):
            path = os.path.join(self.dir, f"region{k}.vcf")
            write_vcf(path, contig, len(self.genome), in_region(self.records, region))
            self.vcfs.append(path)
        self.slice = (0, min(SLICE_BASES, len(self.genome)))
        self.slice_vcf = os.path.join(self.dir, "slice.vcf")
        write_vcf(self.slice_vcf, contig, len(self.genome), in_region(self.records, self.slice))
        ss, rm = store.build(self.codes, self.lengths, mate_of, device)
        self.biograph = SimpleNamespace(seqset=ss, readmap=rm)
        self.opt = self.config["options"]
        self.outputs = {}

    def annotate(self, vcf_in: str, k: int):
        """``run_coverage`` on one VCF, as ``coverage`` with one worker
        runs it: the annotated VCF and the feature matrix written to disk."""
        from biograph_tpu_torch.variants.coverage_tool import run_coverage

        out = os.path.join(self.dir, f"out{k}.vcf")
        feats = os.path.join(self.dir, f"out{k}.npz")
        run_coverage(vcf_in, out, self.biograph, self.ref, sample="HG002", features_out=feats,
                     pair_cov=self.opt["pair_cov"], phase=self.opt["phase"], joint_graph=self.opt["joint_graph"])
        return out, feats

    def keep(self, vcf_out: str, feats: str) -> int:
        """A call's output, kept once for every call that gives the same:
        the VCF's text and the feature matrix's rows."""
        with open(vcf_out) as f:
            text = f.read()
        with np.load(feats) as z:
            rows = {k: len(z[k]) for k in z.files}
        key = hash((text, tuple(sorted(rows.items()))))
        self.outputs.setdefault(key, (text, rows))
        return key

    def release(self):
        """Free the program's state, so that the reference runs without it."""
        import torch

        self.biograph = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def check(state: State, calls: list, limits: dict) -> list:
    """[(name, worst value over the calls, limit)] of every number
    ``coverage_reference.compare`` gives, each call's output against the
    reference over its region, computed a region at a time after the
    program's state is freed.  Prints the records left open."""
    state.release()
    read_len = state.config["library"]["read_len"]
    sample = coverage_reference.Sample(state.genome, state.codes, state.lengths, state.truth)
    worst = dict.fromkeys(limits, 0)
    shown, judged, expected = {}, {}, {}
    for c in calls:
        k = c["region"]
        records = in_region(state.records, state.regions[k])
        if k not in expected:
            expected[k] = coverage_reference.expected(sample, records, read_len, state.opt["pair_cov"],
                                                      state.opt["phase"])
        if (c["out"], k) not in judged:
            text, rows = state.outputs[c["out"]]
            got = coverage_reference.parse_vcf(text)
            judged[c["out"], k] = coverage_reference.compare(expected[k], records, got, rows, examples=shown)
        for name in worst:
            worst[name] = max(worst[name], judged[c["out"], k][name])
    for name, found in shown.items():
        print(f"benchmark: {name}, for example: {found[:5]}", file=sys.stderr)
    share = max((e.open.mean() for e in expected.values()), default=0.0)
    print(f"benchmark: open records {sum(int(e.open.sum()) for e in expected.values())} of "
          f"{sum(len(e.open) for e in expected.values())} in {len(expected)} regions; the largest share of a "
          f"region's {share:.4f}", file=sys.stderr)
    shutil.rmtree(state.dir, ignore_errors=True)
    return [(name, worst[name], limits[name]) for name in limits]
