"""Alignment tracebacks of the whole-read DPs (port of
smartdenovo_tpu/ops/traceback.py, whose tracebacks are `jax.jit` over
`lax.scan`).

On the card the traceback is part of each DP kernel (csrc/banded.cu,
csrc/refine.cu): the warp that filled a read's direction plane walks it
and writes the move stream, so only the [T, B] moves leave the device.
`tb_banded` and `tb_refine` here are the plain PyTorch versions of those
traceback halves, one step of the JAX scan per loop turn over [B]
tensors; the plain DPs of ops/banded.py, ops/refine.py and
ops/refine5q.py call them.  Once every read is done the loop stops: the
later moves are all no-ops (0 for banded, 3 for refine).

`rle_moves` is a copy of the JAX package's host run-length encoder.
"""

from __future__ import annotations

import numpy as np
import torch

DIAG, UP, LEFT, STOP = 1, 2, 3, 0


def tb_banded(dirs, base, alen, end_col, *, T: int):
    """Move codes [T, B] int8 of banded tracebacks (0 = done / no-op) and
    the final column j [B] int32.  dirs [B, LR, W] u8, base [B, LR] i32;
    only rows 0..alen of each read are read."""
    B, LR, W = dirs.shape
    dev = dirs.device
    i32 = torch.int32
    bidx = torch.arange(B, device=dev)
    i = alen.to(i32).clone()
    j = end_col.to(i32).clone()
    base = base.to(i32)
    done = (i <= 0) & (j <= 0)
    mvs = torch.zeros((T, B), dtype=torch.int8, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    up = torch.full((), UP, dtype=i32, device=dev)
    for t in range(T):
        if t % 16 == 0 and bool(done.all()):
            break
        ic = i.clamp(0, LR - 1).long()
        lane = j - base[bidx, ic]
        ok = (~done) & (lane >= 0) & (lane < W)
        mv = torch.where(ok, dirs[bidx, ic, lane.clamp(0, W - 1).long()].to(i32),
                         zero)
        stuck = (~done) & (mv == 0)
        done = done | (stuck & (i <= 0))
        mv = torch.where(stuck & (i > 0), up, mv)
        mv = torch.where(done, zero, mv)
        i = i - ((mv == DIAG) | (mv == UP)).to(i32)
        j = j - ((mv == DIAG) | (mv == LEFT)).to(i32)
        done = done | ((i <= 0) & (j <= 0))
        mvs[t] = mv.to(torch.int8)
    return mvs, j


def tb_refine(dirs, base, alen, blen, *, T: int):
    """Move codes [T, B] int8 of refine tracebacks, the kswx two-bit state
    machine (0 = M, 1 = I, 2 = D, 3 = done / no-op)."""
    B, LR, W = dirs.shape
    dev = dirs.device
    i32 = torch.int32
    bidx = torch.arange(B, device=dev)
    i = alen.to(i32).clone()
    j = blen.to(i32).clone()
    base = base.to(i32)
    state = torch.zeros(B, dtype=i32, device=dev)
    done = (i <= 0) & (j <= 0)
    mvs = torch.full((T, B), 3, dtype=torch.int8, device=dev)
    c = {v: torch.full((), v, dtype=i32, device=dev) for v in (0, 1, 2, 3)}
    for t in range(T):
        if t % 16 == 0 and bool(done.all()):
            break
        ic = i.clamp(0, LR - 1).long()
        lane = j - base[bidx, ic]
        inband = (lane >= 0) & (lane < W)
        z = torch.where(inband & ~done,
                        dirs[bidx, ic, lane.clamp(0, W - 1).long()].to(i32),
                        c[0])
        mv = (z >> (2 * state)) & 3
        mv = torch.where(i <= 0, c[2], mv)
        mv = torch.where((j <= 0) & (i > 0), c[1], mv)
        mv = torch.where(done, c[3], mv)
        i = i - ((mv == 0) | (mv == 1)).to(i32)
        j = j - ((mv == 0) | (mv == 2)).to(i32)
        state = torch.where(mv == 3, state, mv)
        done = done | ((i <= 0) & (j <= 0))
        mvs[t] = mv.to(torch.int8)
    return mvs


def rle_moves(mv_col: np.ndarray, code2op, noop: int):
    """Reverse + run-length encode one read's move stream."""
    mv = mv_col[mv_col != noop][::-1]
    if mv.size == 0:
        return [], []
    cut = np.nonzero(np.diff(mv))[0]
    starts = np.concatenate([[0], cut + 1])
    ends = np.concatenate([cut + 1, [mv.size]])
    ops = [code2op[int(mv[s])] for s in starts]
    counts = [int(e - s) for s, e in zip(starts, ends)]
    return ops, counts
