"""Stage logging in the reference's style: '[date] message' to stderr.

cf. reference wtzmo.c (fprintf(zmo_debug_out, "[%s] ...", date())).
"""

import sys
import time


def date() -> str:
    return time.strftime("%a %b %d %H:%M:%S %Y")


def log(msg: str, *args) -> None:
    if args:
        msg = msg % args
    print(f"[{date()}] {msg}", file=sys.stderr, flush=True)


class StageTimer:
    """Wall-clock accounting per pipeline stage (cf. reference timer.h)."""

    def __init__(self):
        self.stages: list[tuple[str, float]] = []
        self._t0 = None
        self._name = None

    def start(self, name: str):
        self._name = name
        self._t0 = time.perf_counter()
        log("%s ...", name)

    def stop(self):
        dt = time.perf_counter() - self._t0
        self.stages.append((self._name, dt))
        log("%s done in %.2fs", self._name, dt)
        return dt

    def report(self):
        for name, dt in self.stages:
            log("  %-40s %8.2fs", name, dt)
