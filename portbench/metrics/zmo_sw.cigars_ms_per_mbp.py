"""CIGAR stage: the seconds of the `zmo.cigars` spans (each
`_attach_cigars` call: the segments, band centres, the `banded` kernel
with its fetch, the run-length encoding and the aligned strings) over
the window's units, in ms a Mbp of the parts' queries."""

from portbench.harness.spans import named, seconds, window_spans


def read(w):
    spans = window_spans(w)
    if not named(spans, "zmo.cigars") or w.work_unit != "Mbp":
        return None
    return 1e3 * seconds(spans, "zmo.cigars") / w.work
