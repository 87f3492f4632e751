"""Segment DP: the seconds of the `N segments in D dispatches` lines
(packing, transfers, kernels, fetch), in ms a kbp of layout span."""

from portbench.harness.stages import cns_splits


def read(w):
    s = cns_splits(w.lines)
    if not s or w.work_unit != "kbp":
        return None
    return 1e3 * s["segdp"] / w.work
