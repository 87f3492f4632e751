"""Banded stage of the whole-read engine: the `cns.banded` spans (the
band from the anchors, the `banded` kernel with its fetch, the
run-length encoding and the run lists), over the window's tiles, in ms a kbp of layout span."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "cns.banded") or w.work_unit != "kbp":
        return None
    return 1e3 * seconds(spans, "cns.banded") / w.work
