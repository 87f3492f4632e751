"""CIGAR stage (host): the seconds of the `zmo.cigars` spans' children
that are host work (the segments, the band centres, the run-length
encoding and the aligned strings; not `banded`, the kernel and its
fetch), in ms a Mbp of the parts' queries."""

from portbench.harness.spans import named, window_spans

HOST = ("segs", "centers", "banded_rle", "strings")


def read(w):
    spans = window_spans(w)
    parents = {s.id for s in named(spans, "zmo.cigars")}
    if not parents or w.work_unit != "Mbp":
        return None
    ns = sum(s.t1 - s.t0 for s in spans
             if s.parent in parents and s.name in HOST)
    return 1e3 * ns / 1e9 / w.work
