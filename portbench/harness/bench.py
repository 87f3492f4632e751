"""What the harness finds by name: the cell in BENCHMARK.json, its
configuration file, its traffic mix, the mix's unit kind, the per-layer
metric readers and the kernels' roofline counts.  Each is a file of its
own under the benchmark's directory, so a later cell, mix, metric or
kernel is a file added, not one edited."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent       # portbench/
ROOT = BENCH.parent                                  # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file's contents
    traffic: str
    mix: dict               # the traffic file's contents
    chips: int
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell_of(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name`, with its configuration and traffic mix loaded."""
    if not NAME.match(name):
        raise SystemExit(f"bad workload name {name!r}")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(root / cfg_entry["file"]) as fh:
        config = json.load(fh)
    with open(BENCH / "traffic" / f"{wl['traffic']}.json") as fh:
        mix = json.load(fh)
    rate = mix["metric"]
    e2e = [m for m in bench["end_to_end"]
           if ("workloads" not in m or name in m["workloads"])]
    if not any(m["name"] == rate for m in e2e):
        raise SystemExit(f"{name}: its mix's metric {rate} is not in "
                         "end_to_end")
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name=name, config=config, traffic=wl["traffic"], mix=mix,
                chips=int(wl["chips"]), end_to_end=e2e, per_layer=layer)


def _load(path: Path, modname: str):
    if not path.exists():
        raise SystemExit(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def unit_kind(mix: dict):
    """The module of the mix's unit kind: portbench/units/<unit>.py."""
    return _load(BENCH / "units" / f"{mix['unit']}.py",
                 f"portbench.units.{mix['unit']}")


def metric_reader(name: str):
    """The reader of a per-layer metric: portbench/metrics/<name>.py,
    whose read(window) returns the value or None."""
    return _load(BENCH / "metrics" / f"{name}.py",
                 "portbench.metrics." + name.replace(".", "_"))


def roofline(kernel: str):
    """A kernel's operations and bytes: portbench/roofline/<kernel>.py."""
    return _load(BENCH / "roofline" / f"{kernel}.py",
                 f"portbench.roofline.{kernel}")


def roofline_kernels() -> list[str]:
    return sorted(p.stem for p in (BENCH / "roofline").glob("*.py")
                  if not p.stem.startswith("_") and p.stem != "peaks")
