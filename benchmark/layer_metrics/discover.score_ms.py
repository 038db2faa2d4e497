"""Scoring's milliseconds a call, a whole-genome or a region call:
discovery's stage clock over the readmap's coverage of every assembly and
the pair gate (``stats["stage_s"]["score"]``), the mean over the window's
calls."""


def read(ctx):
    vals = [c["stats"]["stage_s"]["score"] for c in ctx.calls if "score" in c["stats"].get("stage_s", {})]
    return sum(vals) / len(vals) * 1e3 if vals else None
