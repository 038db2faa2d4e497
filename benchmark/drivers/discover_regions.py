"""Region calls, one at a time: ``discover_variants(ss, ref, region=r,
readmap=rm)``, the SDK's region call and the ``discovery --region --no-sv``
path, through the mix's panel in rounds (``discovery_check.region_list``).
Work: one call."""

from __future__ import annotations

from benchmark.lib import discovery_check


def setup(cell, seed, device):
    state = discovery_check.Store(cell, seed, device, regions=True)
    return state


def call(state, i):
    region = state.regions[i % len(state.regions)]
    records, stats = state.discover(region)
    return {"work": 1, "out": state.keep(records), "stats": stats, "region": region}


def slice_call(state):
    state.discover(state.regions[0])


def check(state, calls, limits):
    return discovery_check.check(state, calls, limits)
