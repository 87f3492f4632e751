"""Budget overflows: the batches re-run (`zmo.redispatch` count
`redispatched`), summed over the window's passes, a pass."""

from portbench.harness.spans import named, total, window_spans


def read(w):
    spans = window_spans(w)
    passes = len(named(spans, "zmo.pass"))
    if not passes or w.work_unit != "Mbp":
        return None
    return total(spans, "zmo.redispatch", "redispatched") / passes
