"""DAG rounds run a tile: the mean `rounds` count of the window's
`cns.unitig` spans."""

from portbench.harness.spans import named, window_spans


def read(w):
    units = named(window_spans(w), "cns.unitig")
    if not units or w.work_unit != "kbp":
        return None
    return sum(s.counts.get("rounds", 0) for s in units) / len(units)
