"""The SW engine's banded local DP (csrc/swlocal.cu): its live cells, Σ
(i1 - i0 + 1) x W over the pairs' live rows, at 12 int32 operations a
cell (PERF.md's count for the SW cell), against the bytes these inputs
need read once (a query code and about a candidate code a live row, W
candidate codes and the seven 4-byte band and row parameters a pair) and
its outputs written once (four 4-byte values a pair).  The live rows
depend on the data: they are summed on the device from the launch's own
i0 and i1 after it."""

import torch

from portbench.roofline.peaks import bound

ENTRY = "swlocal_dp"
KERNEL = "swlocal_kernel"
OPS_PER_CELL = 12


def on_launch(args, device_copy) -> dict:
    # a, b, blen, tb, qb, slope, i0, i1, order, counter, B, LA, LB, W,
    # match, mismatch, gap, out, stream
    B, LA, LB, W = (int(args[k]) for k in range(10, 14))
    rows = (device_copy(args[7], B) - device_copy(args[6], B) + 1).clamp(
        min=0).sum(dtype=torch.int64)
    return {"B": B, "LA": LA, "LB": LB, "W": W, "rows": rows}


def bound_s(rec: dict) -> tuple[float, str]:
    rows, B, W = int(rec["rows"]), rec["B"], rec["W"]
    nbytes = 2 * rows + B * (W + 7 * 4 + 4 * 4)
    return bound(nbytes, rows * W * OPS_PER_CELL)
