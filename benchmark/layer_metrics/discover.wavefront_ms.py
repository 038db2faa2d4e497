"""The wavefront's milliseconds a call, a whole-genome or a region call:
discovery's own stage clock (``stats["stage_s"]["wavefront"]``, read
after the device drains), the mean over the window's calls."""


def read(ctx):
    vals = [c["stats"]["stage_s"]["wavefront"] for c in ctx.calls if "wavefront" in c["stats"].get("stage_s", {})]
    return sum(vals) / len(vals) * 1e3 if vals else None
