"""CIGAR stage: device-busy time inside the `zmo.cigars` spans over their
duration; the rest is the stage's host work and its waits."""

from portbench.harness.spans import busy_share


def read(w):
    if w.work_unit != "Mbp":
        return None
    return busy_share(w, "zmo.cigars")
