"""The traced run's readings: device activity from torch.profiler (CUDA
activity only: CPU activity slows the host path that these units spend
most of their time in), and the sizes of the hand kernels' launches,
taken at the ctypes boundary by a proxy around the program's kernel
library.

The proxy stands in for `smartdenovo_tpu_torch.kernels._build.lib()` in
the traced run only.  For each C entry point that a roofline module names
(portbench/roofline/<kernel>.py, its ENTRY), it calls the real function
and hands the module the arguments; the module reads what it needs, its
data-dependent counts as device tensors copied on the launch's stream
after it, which are fetched once the window has closed."""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from . import bench

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")


class _Raw:
    """A CUDA pointer as an object torch.as_tensor reads."""

    def __init__(self, ptr: int, n: int, typestr: str):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": typestr, "data": (int(ptr), False),
            "version": 2}


def device_copy(ptr, n: int, typestr: str = "<i4") -> torch.Tensor:
    """A copy, on the current stream, of n values at a device pointer."""
    return torch.as_tensor(_Raw(ptr, n, typestr), device="cuda").clone()


class LaunchProxy:
    """The kernel library with the roofline modules' entry points
    recorded."""

    def __init__(self, real, modules: dict):
        self._real = real
        self._by_entry = {m.ENTRY: (k, m) for k, m in modules.items()}
        self.records: dict[str, list] = {k: [] for k in modules}

    def __getattr__(self, name):
        fn = getattr(self._real, name)
        hit = self._by_entry.get(name)
        if hit is None:
            return fn
        kernel, mod = hit

        def recorded(*args):
            err = fn(*args)
            if err == 0:
                self.records[kernel].append(mod.on_launch(args, device_copy))
            return err

        return recorded


def install_proxy():
    """Put the proxy in front of the program's library; returns it."""
    from smartdenovo_tpu_torch.kernels import _build

    modules = {k: bench.roofline(k) for k in bench.roofline_kernels()}
    proxy = LaunchProxy(_build.lib(), modules)
    _build.lib = lambda: proxy
    return proxy


def resolved(records: list) -> list[dict]:
    """Launch records with their device tensors fetched (after the
    window)."""
    out = []
    for rec in records:
        out.append({k: (v.cpu().tolist() if isinstance(v, torch.Tensor)
                        else v) for k, v in rec.items()})
    return out


class Trace:
    """The device's activity in the traced window."""

    def __init__(self, events: list, window_s: float):
        # (name, category, start us, duration us)
        self.events = events
        self.window_s = window_s
        spans = sorted((ts, ts + dur) for _n, _c, ts, dur in events)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy = merged
        self.busy_s = sum(b - a for a, b in merged) / 1e6

    def kernels(self, name_part: str) -> list:
        return [e for e in self.events
                if e[1] == "kernel" and name_part in e[0]]

    def top_ops(self, k: int = 10) -> list:
        tot: dict[str, float] = {}
        for name, _c, _ts, dur in self.events:
            tot[name[:120]] = tot.get(name[:120], 0.0) + dur / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def gaps(self) -> list[tuple[float, float]]:
        """(start us, end us) of the idle stretches between device
        activity, longest first."""
        g = [(a[1], b[0]) for a, b in zip(self.busy, self.busy[1:])]
        return sorted(g, key=lambda x: x[0] - x[1])


def profiled_window(run_window):
    """Run run_window() under torch.profiler with CUDA activity only.

    run_window(mark) calls mark() once, before its first unit: mark
    launches a tiny kernel and returns the host time at which it ended,
    which ties the trace's clock to the host's.  Returns (run_window's
    result, the device events as (name, category, start us, duration us),
    the mark's host time)."""
    from torch.profiler import ProfilerActivity, profile

    anchor = {}

    def mark():
        x = torch.ones(1, device="cuda")
        x.mul_(2)
        torch.cuda.synchronize()
        anchor["host"] = time.perf_counter()
        return anchor["host"]

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = run_window(mark)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            raw = json.load(fh)
    finally:
        os.remove(path)
    events = []
    for e in raw.get("traceEvents", []):
        cat = str(e.get("cat", "")).lower()
        if e.get("ph") == "X" and cat in DEVICE_CATS and "dur" in e:
            kind = "kernel" if cat == "kernel" else cat
            events.append((str(e.get("name", "")), kind, float(e["ts"]),
                           float(e["dur"])))
    events.sort(key=lambda e: e[2])
    return result, events, anchor.get("host")


def roofline_share(window, kernel: str):
    """Percent of the kernel's roofline: the summed least time its
    launches' work needs at the card's peaks over their summed device
    time.  None when the window traced none of its launches, or the
    launches recorded and the kernels traced do not pair up."""
    trace = window.trace
    recs = window.launches.get(kernel) if window.launches else None
    if trace is None or not recs:
        return None
    mod = bench.roofline(kernel)
    evs = trace.kernels(mod.KERNEL)
    if len(evs) != len(recs):
        return None
    device_s = sum(e[3] for e in evs) / 1e6
    if device_s <= 0:
        return None
    need = sum(mod.bound_s(r)[0] for r in recs)
    share = 100.0 * need / device_s
    if share > 105.0:
        raise RuntimeError(
            f"{kernel}: roofline share {share:.3f}% is over 105%: its "
            "operations or bytes are counted too high, or its device time "
            "leaves out part of the work")
    return share
