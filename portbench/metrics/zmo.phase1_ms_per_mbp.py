"""Candidate scan: `stage phase1` seconds over the window's passes, in ms
a Mbp of bank passed."""

from portbench.harness.stages import overlap_stages


def read(w):
    s = overlap_stages(w.lines)
    if "phase1" not in s or w.work_unit != "Mbp":
        return None
    return 1e3 * s["phase1"] / w.work
