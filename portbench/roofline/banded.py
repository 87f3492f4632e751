"""The banded global DP with its traceback (csrc/banded.cu: the CIGARs
of the SW overlaps, and the whole-read consensus engine's DP): Σ alen x W
band cells at 10 int32 operations a cell (PERF.md's count for the linear
cell), against the bytes these inputs need read once (each read's alen
codes and blen window codes, its band base of rows 0..alen, its lengths)
and its outputs written once (the direction plane of rows 0..alen, the
[T, B] move stream, score, end column and final column, and with the
row maxima their two [B, LA + 1] planes).  Σ alen and Σ blen depend on
the data: they are summed on the device from the launch's own lengths
after it."""

import torch

from portbench.roofline.peaks import bound

ENTRY = "banded_align_tb"
KERNEL = "banded_warp"
OPS_PER_CELL = 10


def on_launch(args, device_copy) -> dict:
    # a, b, alen, blen, base, B, LA, LB, W, T, match, mismatch, gap_a,
    # gap_b, semi, dirs, score, end_col, mvs, j_final, rmax, rcol, stream
    B, LA, LB, W, T = (int(args[k]) for k in range(5, 10))
    return {"B": B, "LA": LA, "LB": LB, "W": W, "T": T,
            "rowmax": args[20] is not None,
            "rows": device_copy(args[2], B).sum(dtype=torch.int64),
            "cols": device_copy(args[3], B).sum(dtype=torch.int64)}


def bound_s(rec: dict) -> tuple[float, str]:
    rows, B, W = int(rec["rows"]), rec["B"], rec["W"]
    planes = rows + B                           # rows 0..alen of each read
    nbytes = (rows + int(rec["cols"]) + 8 * B + 4 * planes
              + W * planes + rec["T"] * B + 12 * B
              + (8 * B * (rec["LA"] + 1) if rec["rowmax"] else 0))
    return bound(nbytes, rows * W * OPS_PER_CELL)
