"""The discovery cells' shared state and their check: the store built in
set-up, the calls the window makes on it, and the comparison of every
call's records with the plain reference (``lib/reference.py``)."""

from __future__ import annotations

import gc
import sys

import numpy as np

from benchmark.lib import generator, reference, store


def region_list(mix: dict, genome_length: int) -> list:
    """The mix's regions in the order the window calls them: a fixed panel
    (``count`` regions, lengths log-uniform between the bounds by quantile,
    one to each of ``count`` equal bins of the genome, placed once for
    every run), called in rounds of the whole panel, each round in its own
    order, the same for every run.  The calls a window makes are so the
    same whatever the seed, which draws the reads: a few regions hold a
    structural variant and take three times a call's median, and with the
    order drawn from the seed, whether a window reached them moved the p95
    from seed to seed."""
    spec = mix["regions"]
    n, lo, hi = spec["count"], spec["min_bases"], spec["max_bases"]
    bin_len = genome_length // n
    if bin_len < hi:
        raise ValueError(f"{n} regions of up to {hi} bases do not fit {genome_length} bases one to a bin")
    sample = generator.rng_for(generator.SAMPLE_SEED, 2)
    lengths = np.round(np.exp(np.log(lo) + generator.quantiles(n) * (np.log(hi) - np.log(lo)))).astype(np.int64)
    lengths = lengths[sample.permutation(n)]
    starts = np.arange(n) * bin_len + sample.integers(0, bin_len - lengths + 1)
    panel = [(int(a), int(a + b)) for a, b in zip(starts, lengths)]
    order = generator.rng_for(generator.SAMPLE_SEED, 3)
    return [panel[j] for _ in range(ROUNDS) for j in order.permutation(n)]


# rounds of the panel in a run's order: more calls than any window makes
ROUNDS = 64


class Store:
    """A configuration's sample from the seed, its seqset and readmap on
    the device, and the discovery call the window repeats."""

    def __init__(self, cell, seed, device, regions=False):
        from biograph_tpu_torch.variants.discover import DiscoverOptions

        self.config, self.mix = cell.config, cell.mix
        self.genome, self.codes, self.lengths, mate_of, self.truth = store.library(self.config, seed)
        self.genome_kbp = len(self.genome) / 1e3
        self.ref = store.reference(self.genome, self.config.get("contig", "chr1"))
        self.ss, self.rm = store.build(self.codes, self.lengths, mate_of, device)
        # the discovery subcommand's defaults, and the mix's --opt overrides
        self.opt = DiscoverOptions(**self.mix.get("options", {}))
        self.regions = region_list(self.mix, len(self.genome)) if regions else None
        self.outputs = {}

    def discover(self, region):
        from biograph_tpu_torch.variants.discover import discover_variants

        stats = {}
        records = discover_variants(self.ss, self.ref, region=region, opt=self.opt, readmap=self.rm, stats=stats)
        return records, stats

    def keep(self, records) -> int:
        """A call's records, kept once for every call that returns the same:
        the window holds a key, not tens of thousands of records a call
        (whose objects every collection of the interpreter would walk)."""
        rows = tuple(sorted((r["pos"], r["ref"], r["alt"], r["support"]) for r in records))
        key = hash(rows)
        self.outputs.setdefault(key, rows)
        return key

    def release(self):
        """Free the program's state, so that the reference runs without it."""
        import torch

        self.ss = self.rm = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def check(state: Store, calls: list, limits: dict) -> list:
    """[(name, worst value over the calls, limit)] of every number
    ``reference.judge`` gives, each call's records against the reference's
    expectation over its span."""
    state.release()
    lib = state.config["library"]
    expected = reference.expected_calls(
        state.genome, state.truth, state.codes, state.lengths, lib["read_len"],
        min_alt_support=state.opt.min_alt_support, rejoin_k=state.opt.rejoin_k,
    )
    worst = dict.fromkeys(limits, 0)
    shown, judged = {}, {}
    for c in calls:
        span = c.get("region")
        if (c["out"], span) not in judged:
            records = [{"pos": p, "ref": r, "alt": a, "support": n} for p, r, a, n in state.outputs[c["out"]]]
            edge = state.mix.get("edge_bases", 0) if span else 0
            judged[c["out"], span] = reference.judge(records, expected, span, edge, examples=shown)
        for k in worst:
            worst[k] = max(worst[k], judged[c["out"], span][k])
    for k, found in shown.items():
        print(f"benchmark: {k}, for example: {found[:5]}", file=sys.stderr)
    return [(k, worst[k], limits[k]) for k in limits]
