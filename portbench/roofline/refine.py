"""The refine DP with its traceback (csrc/refine.cu: the whole-read
consensus engine's refine around each banded CIGAR, with the affine
costs or, for reads with f5q tracks, the quality-aware 5q costs): Σ alen
x W band cells at 14 int32 operations a cell in the 5q model and 12 in
the affine one (PERF.md's counts), against the bytes these inputs need
read once (each read's alen codes and blen window codes, its lengths,
its band base of rows 0..alen and, in the 5q model, its five int32
tracks of alen values) and its outputs written once (the direction plane
of rows 0..alen, the [T, B] move stream and the scores).  Σ alen and Σ
blen depend on the data: they are summed on the device from the launch's
own lengths after it."""

import torch

from portbench.roofline.peaks import bound

ENTRY = "refine_align_tb"
KERNEL = "refine_warp"
OPS_PER_CELL = {True: 14, False: 12}    # by q5


def on_launch(args, device_copy) -> dict:
    # a, b, alen, blen, base, subqv, insqv, delqv, subtag, deltag, B, LA,
    # LB, W, T, q5, c0..c4, dirs, score, mvs, stream
    B, LA, LB, W, T, q5 = (int(args[k]) for k in range(10, 16))
    return {"B": B, "LA": LA, "LB": LB, "W": W, "T": T, "q5": bool(q5),
            "rows": device_copy(args[2], B).sum(dtype=torch.int64),
            "cols": device_copy(args[3], B).sum(dtype=torch.int64)}


def bound_s(rec: dict) -> tuple[float, str]:
    rows, B, W = int(rec["rows"]), rec["B"], rec["W"]
    planes = rows + B                           # rows 0..alen of each read
    nbytes = (rows + int(rec["cols"]) + 8 * B + 4 * planes
              + (5 * 4 * rows if rec["q5"] else 0)
              + W * planes + rec["T"] * B + 4 * B)
    return bound(nbytes, rows * W * OPS_PER_CELL[rec["q5"]])
