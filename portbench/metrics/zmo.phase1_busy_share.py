"""Candidate scan: device-busy time inside the `zmo.phase1` spans over
their duration (the share of the stage in which the card works)."""

from portbench.harness.spans import busy_share


def read(w):
    if w.work_unit != "Mbp":
        return None
    return busy_share(w, "zmo.phase1")
