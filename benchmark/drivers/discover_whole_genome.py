"""Whole-genome scored discovery, repeated: ``discover_variants(ss, ref,
region=chunk, readmap=rm)`` with the ``discovery`` subcommand's default
options over each of the mix's ``chunk_bases`` chunks of the reference in
turn (the ``discovery --region --no-sv`` path; a chunk as long as the
genome makes it one call).  Work: reference kilobases."""

from __future__ import annotations

from benchmark.lib import discovery_check


def setup(cell, seed, device):
    return discovery_check.Store(cell, seed, device)


def call(state, i):
    G, step = len(state.genome), state.mix["chunk_bases"]
    records, stats = [], []
    for lo in range(0, G, step):
        got, st = state.discover((lo, min(lo + step, G)))
        records += got
        stats.append(st)
    merged = {"stage_s": {}}
    for k in {k for st in stats for k in st.get("stage_s", {})}:
        merged["stage_s"][k] = sum(st.get("stage_s", {}).get(k, 0.0) for st in stats)
    for k in {k for st in stats for k, v in st.items() if isinstance(v, int)}:
        merged[k] = sum(st.get(k, 0) for st in stats)
    return {"work": state.genome_kbp, "out": state.keep(records), "stats": merged}


def slice_call(state):
    """A bounded call for the host-side trace: the first 20 kb."""
    state.discover((0, min(20_000, len(state.genome))))


def check(state, calls, limits):
    return discovery_check.check(state, calls, limits)
