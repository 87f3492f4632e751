"""Z-mer matcher and dot matrix: `stage phase2` plus `stage redispatch`
seconds over the window's passes, in ms a Mbp of bank passed."""

from portbench.harness.stages import overlap_stages


def read(w):
    s = overlap_stages(w.lines)
    if "phase2" not in s or w.work_unit != "Mbp":
        return None
    return 1e3 * (s["phase2"] + s.get("redispatch", 0.0)) / w.work
