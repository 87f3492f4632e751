"""The consensus segment DP (csrc/segdp.cu): Σ alen x W band cells at 12
int32 operations a cell (PERF.md's count for the affine cell), against
the bytes of its inputs read once (the segments' rows, the windows, the
lengths and band bases) and its outputs written once (score, both window
columns, the packed moves).  Σ alen depends on the data: it is summed on
the device from the launch's own lengths after it."""

import torch

from portbench.roofline.peaks import bound

ENTRY = "segdp_align_tb"
KERNEL = "segdp_warp"
OPS_PER_CELL = 12


def on_launch(args, device_copy) -> dict:
    # a, b, alen, blen, b16, Bc, SEGR, LBW, NB, W, T, match, mismatch,
    # open_i, open_d, ext, dirs, score, b_beg, b_end, mvp, stream
    Bc, SEGR, LBW, NB, W, T = (int(args[k]) for k in range(5, 11))
    rows = device_copy(args[2], Bc).sum(dtype=torch.int64)
    return {"Bc": Bc, "SEGR": SEGR, "LBW": LBW, "NB": NB, "W": W, "T": T,
            "rows": rows}


def bound_s(rec: dict) -> tuple[float, str]:
    rows = int(rec["rows"])
    Bc = rec["Bc"]
    cells = rows * rec["W"]
    nbytes = (rows + Bc * rec["LBW"] + Bc * (4 + 4 + 2 * rec["NB"])
              + Bc * (12 + rec["T"] // 4))
    return bound(nbytes, cells * OPS_PER_CELL)
