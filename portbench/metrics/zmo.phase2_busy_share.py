"""Z-mer matcher and dot matrix: device-busy time inside the `zmo.phase2`
spans over their duration; the rest is host work and launch gaps."""

from portbench.harness.spans import busy_share


def read(w):
    if w.work_unit != "Mbp":
        return None
    return busy_share(w, "zmo.phase2")
