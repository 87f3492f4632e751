"""Useful over attempted in the align pass: the reads accepted into the
DAG over the reads aligned (`cns.round` counts), over the window's
rounds."""

from portbench.harness.spans import total, window_spans


def read(w):
    spans = window_spans(w)
    aligned = total(spans, "cns.round", "reads_aligned")
    if not aligned or w.work_unit != "kbp":
        return None
    return total(spans, "cns.round", "reads_accepted") / aligned
