"""The port's one host clock: spans at the layer boundaries of the
overlapper and the consensus, and the seconds of the parts of a pass.

A span is a name, an id, its parent's id, its unit's id (the id of the
outermost span it lies in: one `overlap_dmo` or `consensus_unitig` call),
its start and end on `time.perf_counter_ns()` (the clock that
`time.perf_counter()` reads, in integer ns) and a small dict of integer
counts.  Spans are always on, at stage and round granularity: a span
costs the two clock reads a stage's log line took anyway, an id and a
record.  Closed spans go to a bounded ring in memory (`RECORDER.spans`),
which code in the same process reads; nothing is written out.

`child_seconds` sums the parts of a pass by name for the split log
lines: each DP kernel with the fetch of its outputs (which waits for the
device), and the host parts around them.
"""

from __future__ import annotations

import collections
import itertools
import time

now = time.perf_counter_ns


class Span:
    """One timed block; a context manager of the recorder that made it.
    `counts` may be filled while the block runs."""

    __slots__ = ("name", "id", "parent", "unit", "t0", "t1", "counts", "_rec")

    def __init__(self, rec: "Recorder", name: str, counts: dict):
        self._rec = rec
        self.name = name
        self.counts = counts
        self.t1 = None

    def __enter__(self) -> "Span":
        rec = self._rec
        up = rec.stack[-1] if rec.stack else None
        self.id = next(rec.ids)
        self.parent = up.id if up is not None else None
        self.unit = up.unit if up is not None else self.id
        rec.stack.append(self)
        self.t0 = now()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = now()
        self._rec.stack.pop()
        self._rec.spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        """Its duration; while it runs, the time since it started."""
        return ((now() if self.t1 is None else self.t1) - self.t0) / 1e9


class Recorder:
    """Closed spans in a ring of `maxlen`, oldest dropped first, and the
    stack of open ones.  Spans close in the order they opened: the port
    runs its pipeline on one thread, and no span is open across a
    `yield`."""

    def __init__(self, maxlen: int = 65536):
        self.spans: collections.deque = collections.deque(maxlen=maxlen)
        self.stack: list[Span] = []
        self.ids = itertools.count(1)

    def span(self, name: str, **counts) -> Span:
        return Span(self, name, counts)


RECORDER = Recorder()


def span(name: str, **counts) -> Span:
    """A span of the port's recorder: `with span("zmo.index") as sp:`."""
    return RECORDER.span(name, **counts)


def child_seconds(parents, rec: Recorder | None = None) -> dict:
    """The seconds of the closed spans whose parent is one of `parents`,
    summed by name."""
    ids = {s.id for s in parents}
    out: dict = {}
    for s in (rec or RECORDER).spans:
        if s.parent in ids:
            out[s.name] = out.get(s.name, 0.0) + (s.t1 - s.t0) / 1e9
    return out


def split_line(parents) -> str:
    """child_seconds as the split log lines print it."""
    return " ".join(f"{k} {v:.3f}s"
                    for k, v in sorted(child_seconds(parents).items()))
