"""One traced run of a cell, as `run.py --trace 1` makes it, that also
checks the program's spans against the device trace:

    python3 portbench/span_check.py --workload <cell> --seed <n> \
        --seconds <s>

prints one JSON line: the run's result line (`result`), and under
`clock` the fetch residuals (for each span that ends at a fetch, the end
of the last device event that starts inside it less the span's end, in
ms on the trace's clock, mapped through the window's anchor), the share
of the window's device-idle time that falls inside some span of the
program, and the idle seconds by innermost span; under `spans` each span
name's seconds and summed counts over the window's units."""

import argparse
import json
import runpy
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUN = runpy.run_path(str(ROOT / "portbench" / "run.py"),
                     run_name="portbench_run")


def summary(w) -> dict:
    from portbench.harness import spans

    got = spans.window_spans(w)
    by_name: dict[str, dict] = {}
    for s in got:
        d = by_name.setdefault(s.name, {"n": 0, "seconds": 0.0})
        d["n"] += 1
        d["seconds"] += s.seconds
        for k, v in s.counts.items():
            d[k] = d.get(k, 0) + v
    res = spans.fetch_residuals_ms(w)
    idle = spans.idle_by_span(w)
    total = sum(idle.values())
    clock = {
        "fetch_residual_ms": {
            "n": len(res),
            "median": statistics.median(res) if res else None,
            "max": max(res, default=None), "min": min(res, default=None)},
        "idle_s": total,
        "idle_inside_spans_share": (1 - idle.get("outside spans", 0.0) / total
                                    if total > 0 else None),
        "idle_by_span_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
    }
    return {"clock": clock, "spans": by_name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import bench, window

    if not torch.cuda.is_available():
        RUN["fail"]("no CUDA device: the span check reads the card's trace")
    cell = bench.cell_of(bench.load_benchmark(), args.workload)
    kept = {}
    measure = window.measure

    def keep(*a, **k):
        kept["w"] = measure(*a, **k)
        return kept["w"]

    window.measure = keep
    torch.cuda.init()
    result = RUN["run_cell"](cell, args.seed, args.seconds, True)
    print(json.dumps({"result": result, **summary(kept["w"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
