"""Probe anchoring and the backbone: the consensus iterations' `seed`
seconds, summed over iterations and tiles, in ms a kbp of layout span."""

from portbench.harness.stages import cns_splits


def read(w):
    s = cns_splits(w.lines)
    if not s or w.work_unit != "kbp":
        return None
    return 1e3 * s["seed"] / w.work
