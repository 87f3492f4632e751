"""Probe anchoring of the whole-read engine: the `cns.probe` spans (the
read and window upload, the K-mer probes on the device, the fetch and
the median-diagonal filter on the host), over the window's tiles, in ms a kbp of layout span."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "cns.probe") or w.work_unit != "kbp":
        return None
    return 1e3 * seconds(spans, "cns.probe") / w.work
