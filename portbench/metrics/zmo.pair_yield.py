"""Useful over attempted in the dot matrix: the records emitted
(`zmo.emission` count `records`) over the live pair rows chained
(`zmo.phase2` count `pair_rows`), over the window's passes."""

from portbench.harness.spans import total, window_spans


def read(w):
    spans = window_spans(w)
    rows = total(spans, "zmo.phase2", "pair_rows")
    if not rows or w.work_unit != "Mbp":
        return None
    return total(spans, "zmo.emission", "records") / rows
