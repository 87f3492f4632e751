"""Aligned strings of the whole-read engine: the `cns.strings` spans
(each aligned read's row and consensus row from its CIGAR), over the window's tiles, in ms a kbp of layout span."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "cns.strings") or w.work_unit != "kbp":
        return None
    return 1e3 * seconds(spans, "cns.strings") / w.work
