"""Stitcher (host): the `cns.stitch` spans, the stitcher's own work
without the caller's acceptance loop, in ms a kbp of layout span."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "cns.stitch") or w.work_unit != "kbp":
        return None
    return 1e3 * seconds(spans, "cns.stitch") / w.work
