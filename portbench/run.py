"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Set-up makes the cell's inputs from the seed (portbench/gen/),
loads the program (smartdenovo_tpu_torch, whose kernels build into its
own _build/ directory at the first run of a checkout) and runs the mix's
warm-up units; the window then runs whole units for `--seconds`.  With
--trace 0 the last line of standard output is the cell's end-to-end
metrics, with --trace 1 its per-layer metrics (the window under
torch.profiler and the kernels' launch proxy).  Either way, once the
window has closed, the units' outputs are judged against the plain
reference (portbench/reference/); the numbers compared and their limits
are the last lines of standard error and the last key of the result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "smartdenovo_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def device_info(count: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """Set-up, the window and the judgement of one run; the result line
    as a dict.  `device` is "cpu" only where a test drives a run without
    the card (no trace there)."""
    import torch

    from portbench.harness import bench
    from portbench.harness.stages import StageLog
    from portbench.harness.window import breakdown, measure, sync

    with open(bench.BENCH / "limits" / f"{cell.name}.json") as fh:
        limits = json.load(fh)
    kind = bench.unit_kind(cell.mix)
    readers = {m["name"]: bench.metric_reader(m["name"])
               for m in cell.per_layer}
    log = StageLog(sys.stderr)
    sys.stderr = log
    try:
        unit = kind.Unit(cell.config, cell.mix, seed, device)
        t_in = time.perf_counter() - T_START
        warm = []
        for _ in range(int(cell.mix.get("warmup_units", 1))):
            t = time.perf_counter()
            unit.warm()
            sync(device)
            warm.append(time.perf_counter() - t)
        setup_s = time.perf_counter() - T_START
        w = measure(unit, seconds, log, trace)
    finally:
        sys.stderr = log.through
    print(f"portbench: set-up {setup_s:.3f}s (inputs and program loaded "
          f"at {t_in:.3f}s, warm-up units {warm}); window units "
          f"{[round(x, 3) for x in w.unit_s]}", file=sys.stderr, flush=True)
    dev = device_info(cell.chips) if device == "cuda" else \
        {"platform": "cpu", "count": 0}
    dev["memory_peak_bytes"] = int(w.peak_bytes)

    metrics = {}
    extra = None
    if not trace:
        values = {"setup_s": setup_s,
                  cell.mix["metric"]: w.rate,
                  "peak_mem_gib": w.peak_bytes / 2**30}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
        for m in cell.per_layer:
            v = readers[m["name"]].read(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = breakdown(w)

    # the judgement, once the window has closed and its peak is read
    unit.free()
    sync(device)
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers, failed = unit.checks(limits)
    result = {"correct": all(v <= lim for _n, v, lim in numbers),
              "attempted": w.units, "failed": failed,
              "metrics": metrics, "device": dev}
    if extra is not None:
        result["breakdown"] = extra
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import bench

    cell = bench.cell_of(bench.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False; the "
             "benchmark measures the card and does not fall back")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    torch.cuda.init()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        fail("the run loaded JAX or the JAX package: " + ", ".join(found))
    for n, c in result["check"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
