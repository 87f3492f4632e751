"""Segment DP: device-busy time inside the `cns.segdp` spans over their
duration; the rest is the host's packing, uploads and unpacking."""

from portbench.harness.spans import busy_share


def read(w):
    if w.work_unit != "kbp":
        return None
    return busy_share(w, "cns.segdp")
