"""Useful over attempted for the quality tracks: the reads that went
through the quality-aware refine (`cns.refine` count `reads_5q`) over
the reads aligned (`cns.round` count `reads_aligned`), over the window's
rounds: ~1 where every read carries tracks and takes the 5q refine."""

from portbench.harness.spans import named, total, window_spans


def read(w):
    spans = window_spans(w)
    aligned = total(spans, "cns.round", "reads_aligned")
    if not named(spans, "cns.refine") or not aligned or w.work_unit != "kbp":
        return None
    return total(spans, "cns.refine", "reads_5q") / aligned
