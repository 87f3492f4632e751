"""Segment plan (host): the `cns.segplan` spans (the re-seed, the
segment plan and the packing before the first dispatch), in ms a kbp of
layout span."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "cns.segplan") or w.work_unit != "kbp":
        return None
    return 1e3 * seconds(spans, "cns.segplan") / w.work
