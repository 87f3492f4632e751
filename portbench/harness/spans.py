"""The program's own spans (smartdenovo_tpu_torch/utils/timing.py), read
in the process that ran them.

Each `overlap_dmo` or `consensus_unitig` call is one unit of spans: a
root span and its children, each with its start and end on
`time.perf_counter_ns()` (the clock of the window's `t0` and of the
trace's mark) and its integer counts.  A reader takes the spans of the
units whose root started inside the window, and maps their times onto
the device trace through the window's anchor.  A program that keeps no
spans gives none, and the readers then return None."""

from __future__ import annotations

import bisect


def window_spans(w) -> list:
    """The spans of the units whose root started inside [w.t0, w.t0 +
    w.seconds], in the order they closed."""
    try:
        from smartdenovo_tpu_torch.utils import timing
    except ImportError:
        return []
    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return []
    spans = list(rec.spans)
    lo, hi = w.t0 * 1e9, (w.t0 + w.seconds) * 1e9
    roots = {s.id for s in spans if s.parent is None and lo <= s.t0 <= hi}
    return [s for s in spans if s.unit in roots]


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def total(spans, name: str, key: str) -> int:
    """Sum of count `key` over the spans called `name`."""
    return sum(s.counts.get(key, 0) for s in spans if s.name == name)


def seconds(spans, name: str) -> float:
    return sum(s.t1 - s.t0 for s in spans if s.name == name) / 1e9


def to_trace_us(w, t_ns: int) -> float:
    """A host time (perf_counter_ns) on the trace's clock, in us."""
    dev0, host0 = w.anchor
    return dev0 + (t_ns / 1e3 - host0 * 1e6)


def busy_in(busy: list, starts: list, a: float, b: float) -> float:
    """us of the merged, sorted busy intervals `busy` (their starts in
    `starts`) that lie inside [a, b]."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(busy) and busy[i][0] < b:
        got += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return got


def busy_share(w, name: str):
    """Device-busy time inside the window's spans called `name` over
    their summed duration; None without a trace or such spans."""
    if w.trace is None or w.anchor is None:
        return None
    spans = named(window_spans(w), name)
    if not spans:
        return None
    busy = w.trace.busy
    starts = [a for a, _ in busy]
    got = dur = 0.0
    for s in spans:
        a, b = to_trace_us(w, s.t0), to_trace_us(w, s.t1)
        got += busy_in(busy, starts, a, b)
        dur += b - a
    return got / dur if dur > 0 else None


def fetch_residuals_ms(w, names=("zmo.index", "zmo.phase1", "zmo.phase2",
                                 "cns.segdp")) -> list[float]:
    """For each span that ends at a fetch: the end of the last device
    event that starts inside it less the span's end, in ms on the trace's
    clock.  At most a few us above 0 where the clocks agree: the host
    sees a fetch end after its copy ends."""
    if w.trace is None or w.anchor is None:
        return []
    events = sorted(w.trace.events, key=lambda e: e[2])
    starts = [e[2] for e in events]
    out = []
    for s in window_spans(w):
        if s.name not in names:
            continue
        a, b = to_trace_us(w, s.t0), to_trace_us(w, s.t1)
        i = bisect.bisect_right(starts, b) - 1
        if i >= 0 and starts[i] >= a:
            _n, _c, ts, dur = events[i]
            out.append((ts + dur - b) / 1e3)
    return out


def idle_by_span(w) -> dict:
    """Device-idle seconds of the window by innermost span (a span's idle
    time less its children's), and under "outside spans" the idle time
    that no span of the window's units covers."""
    if w.trace is None or w.anchor is None:
        return {}
    busy = w.trace.busy
    starts = [a for a, _ in busy]
    spans = window_spans(w)

    def idle(a_ns, b_ns):
        a, b = to_trace_us(w, a_ns), to_trace_us(w, b_ns)
        return (b - a) - busy_in(busy, starts, a, b)

    full = {s.id: idle(s.t0, s.t1) for s in spans}
    own = dict(full)
    for s in spans:
        if s.parent in own:
            own[s.parent] -= full[s.id]
    out: dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + own[s.id] / 1e6
    t0 = int(w.t0 * 1e9)
    window = idle(t0, t0 + int(w.seconds * 1e9)) / 1e6
    out["outside spans"] = window - sum(out.values())
    return out
