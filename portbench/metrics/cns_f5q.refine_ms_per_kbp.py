"""Refine of the whole-read engine: the `cns.refine` spans (both refine
groups: the band from each CIGAR, the track packing, the `refine5q`
or `refine` kernel with its fetch, and the decoding of its moves), over the window's tiles, in ms a kbp of layout span."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "cns.refine") or w.work_unit != "kbp":
        return None
    return 1e3 * seconds(spans, "cns.refine") / w.work
