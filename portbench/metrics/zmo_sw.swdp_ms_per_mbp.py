"""SW local DP: the host seconds of the `zmo.swdp` spans (each
`sw_align_batch` call, from the dot matrix's end to the DP's end) over
the window's units, in ms a Mbp of the parts' queries."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "zmo.swdp") or w.work_unit != "Mbp":
        return None
    return 1e3 * seconds(spans, "zmo.swdp") / w.work
