"""Refine of the whole-read engine: device-busy time inside the
`cns.refine` spans over their duration; the rest is the band, the track
packing and the decoding on the host, and their waits."""

from portbench.harness.spans import busy_share


def read(w):
    if w.work_unit != "kbp":
        return None
    return busy_share(w, "cns.refine")
