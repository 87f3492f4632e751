"""The program's stage lines, read as it writes them.

The port logs each stage of the overlapper (`stage <name>: <s>s`) and
each consensus iteration (`cns <u> iter k time: seed <s>s align <s>s dag
<s>s`, and inside `align` the segment DP's `cns <u>: N segments in D
dispatches of Bc, <s>s`) to standard error, each at the end of its stage
and each timed by a host clock around work that ends in a fetch from the
device.  `StageLog` stands in for sys.stderr, passes everything through
and keeps each line with the host time it arrived; the parsers turn the
lines into stage seconds and host intervals."""

from __future__ import annotations

import io
import re
import time

STAGE = re.compile(r"stage (\w+): ([0-9.]+)s")
CNS_ITER = re.compile(
    r"cns (\S+) iter (\d+) time: seed ([0-9.]+)s align ([0-9.]+)s "
    r"dag ([0-9.]+)s")
CNS_SEGDP = re.compile(
    r"cns (\S+): (\d+) segments in (\d+) dispatches of (\d+), ([0-9.]+)s")


class StageLog(io.TextIOBase):
    """A text stream that writes through and keeps (time, line)."""

    def __init__(self, through):
        self.through = through
        self.lines: list[tuple[float, str]] = []
        self._part = ""

    def write(self, s: str) -> int:
        t = time.perf_counter()
        self.through.write(s)
        self._part += s
        *done, self._part = self._part.split("\n")
        self.lines.extend((t, line) for line in done)
        return len(s)

    def flush(self):
        self.through.flush()

    def between(self, t0: float, t1: float) -> list[tuple[float, str]]:
        return [(t, s) for t, s in self.lines if t0 <= t <= t1]


def overlap_stages(lines) -> dict[str, float]:
    """Seconds of each `stage <name>` summed over the lines."""
    out: dict[str, float] = {}
    for _t, s in lines:
        m = STAGE.search(s)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
    return out


def cns_splits(lines) -> dict[str, float]:
    """Seconds of seed, align, dag and the segment DP summed over the
    lines; stitch is align less the segment DP (its packing and fetch
    included); empty where no iteration line was read."""
    out = {"seed": 0.0, "align": 0.0, "dag": 0.0, "segdp": 0.0}
    iters = 0
    for _t, s in lines:
        m = CNS_ITER.search(s)
        if m:
            iters += 1
            out["seed"] += float(m.group(3))
            out["align"] += float(m.group(4))
            out["dag"] += float(m.group(5))
            continue
        m = CNS_SEGDP.search(s)
        if m:
            out["segdp"] += float(m.group(5))
    if not iters:
        return {}
    out["stitch"] = out["align"] - out["segdp"]
    return out


def host_intervals(lines) -> list[tuple[float, float, str]]:
    """(start, end, name) of every stage the lines close, on the host's
    clock, innermost last where they nest (the segment DP and the
    stitcher inside align)."""
    out = []
    for t, s in lines:
        m = STAGE.search(s)
        if m:
            out.append((t - float(m.group(2)), t, m.group(1)))
            continue
        m = CNS_ITER.search(s)
        if m:
            seed, align, dag = (float(m.group(k)) for k in (3, 4, 5))
            out.append((t - dag, t, "dag"))
            out.append((t - dag - align, t - dag, "align"))
            out.append((t - dag - align - seed, t - dag - align, "seed"))
            continue
        m = CNS_SEGDP.search(s)
        if m:
            out.append((t - float(m.group(5)), t, "segdp"))
    # a stitcher interval from each segment DP's end to its align's end
    aligns = [iv for iv in out if iv[2] == "align"]
    for t0, t1, name in list(out):
        if name == "segdp":
            end = next((a1 for a0, a1, _ in aligns if a0 <= t1 <= a1), None)
            if end is not None:
                out.append((t1, end, "stitch"))
    return out
