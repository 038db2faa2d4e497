"""Coverage of a region's VCF, one region after another:
``run_coverage(vcf_in, vcf_out, biograph, reference, features_out=...,
pair_cov=True, phase=True)`` on the VCF of each of the mix's regions in
turn, as ``full_pipeline --region`` runs its coverage stage with one
worker.  Work: the region's reference kilobases."""

from __future__ import annotations

from benchmark.lib import coverage_check


def setup(cell, seed, device):
    return coverage_check.State(cell, seed, device)


def call(state, i):
    k = i % len(state.regions)
    out, feats = state.annotate(state.vcfs[k], k)
    lo, hi = state.regions[k]
    return {"work": (hi - lo) / 1e3, "out": state.keep(out, feats), "stats": {}, "region": k}


def slice_call(state):
    """A bounded call for the host-side trace: the records of the first 20 kb."""
    state.annotate(state.slice_vcf, "slice")


def check(state, calls, limits):
    return coverage_check.check(state, calls, limits)
