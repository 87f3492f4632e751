"""Index build: the overlapper's `stage index` seconds, summed over the
window's passes, in ms a Mbp of bank passed."""

from portbench.harness.stages import overlap_stages


def read(w):
    s = overlap_stages(w.lines)
    if "index" not in s or w.work_unit != "Mbp":
        return None
    return 1e3 * s["index"] / w.work
