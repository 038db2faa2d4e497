"""The front end's milliseconds a region call: discovery's stage clock over
the find-window filter, the exact bisection and the anchor scan (and the
dense front end's dispatch and masks where a call takes it), the mean over
the window's calls."""

STAGES = ("probe_filter", "probe_exact", "anchors", "probe_dispatch", "probe_masks")


def read(ctx):
    vals = [sum(c["stats"]["stage_s"].get(k, 0.0) for k in STAGES) for c in ctx.calls if c["stats"].get("stage_s")]
    return sum(vals) / len(vals) * 1e3 if vals else None
