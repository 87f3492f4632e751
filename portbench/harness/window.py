"""The measured window: whole units back to back until `seconds` have
passed; the unit that crosses that time finishes and counts.  A rate is
all the work of those units over all the time from the window's start
to the last unit's end."""

from __future__ import annotations

import dataclasses
import time

import torch

from .stages import host_intervals
from .trace import Trace, install_proxy, profiled_window, resolved


@dataclasses.dataclass
class Window:
    work_unit: str
    work: float = 0.0           # in work_unit, over the window's units
    units: int = 0
    unit_s: list = dataclasses.field(default_factory=list)  # per unit
    seconds: float = 0.0        # window start to the last unit's end
    t0: float = 0.0             # host clock at the window's start
    lines: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    trace: Trace | None = None
    launches: dict | None = None
    anchor: tuple | None = None  # (device us, host s) of the trace's mark

    @property
    def rate(self) -> float:
        return self.work / self.seconds


def sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def run_units(unit, seconds: float, mark=None) -> Window:
    w = Window(work_unit=unit.work_unit)
    on_card = unit.device == "cuda"
    sync(unit.device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    w.t0 = mark() if mark else time.perf_counter()
    while True:
        t = time.perf_counter()
        w.work += unit.run()
        w.units += 1
        sync(unit.device)
        w.unit_s.append(time.perf_counter() - t)
        w.seconds = time.perf_counter() - w.t0
        if w.seconds >= seconds:
            break
    w.peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    return w


def measure(unit, seconds: float, log, trace: bool) -> Window:
    """The window, under the profiler and the launch proxy when `trace`;
    `log` is the StageLog that the program writes to."""
    if not trace:
        w = run_units(unit, seconds)
    else:
        proxy = install_proxy()
        w, events, host_mark = profiled_window(
            lambda mark: run_units(unit, seconds, mark))
        w.trace = Trace(events, w.seconds)
        w.launches = {k: resolved(v) for k, v in proxy.records.items()}
        if events and host_mark is not None:
            first_two = sorted(events, key=lambda e: e[2])[:2]
            w.anchor = (max(e[2] + e[3] for e in first_two), host_mark)
    w.lines = log.between(w.t0, w.t0 + w.seconds)
    return w


def breakdown(w: Window, k: int = 10) -> dict | None:
    """The device operations with most time, and the longest idle gaps
    named by the stage the host was in (from the stage lines' clock)."""
    if w.trace is None:
        return None
    gaps = []
    if w.anchor is not None:
        dev0, host0 = w.anchor
        ivs = host_intervals(w.lines)
        for a, b in w.trace.gaps()[: 4 * k]:
            mid = host0 + ((a + b) / 2 - dev0) / 1e6
            names = [n for s, e, n in ivs if s <= mid <= e]
            gaps.append([names[-1] if names else "between units",
                         (b - a) / 1e6])
    longest = sorted(gaps, key=lambda g: -g[1])[:k]
    return {"device_ops": w.trace.top_ops(k), "idle_gaps": longest}
