"""The whole-read engine's banded alignment of a read (rows) against its
consensus window (columns), worked out again: a linear-gap DP whose end
gaps in the window are free (semiglobal), along a W-lane band through
the read's anchors; its score and end column (the first best lane of the
read's last row); the traceback from there, at most T moves; and the
column of the window where the alignment starts.

`reference/sw/cigar.py` is the same DP along a straight band, and its
`aligned` gives the strings here; its DP returns no score, which the
consensus keeps for the DAG's order, and its traceback takes its bound
from another length tier, so both are written out again below.

A pair's alignment depends on no other pair and not on how far its rows
are padded, so one call may take any pairs: in PyTorch on the tensors'
device, one row a loop turn over [n, W].  The traceback walks the fetched
plane on the host, all pairs a step at a time, each for at most its own
T moves."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -(1 << 28)
DIAG, UP, LEFT, STOP = 1, 2, 3, 0
# a call's direction plane, pairs x (rows + 1) x W bytes, stays under this
PLANE_CAP = 1 << 31
OP = {DIAG: "M", UP: "I", LEFT: "D"}


def band_from_anchors(anchors, alens, blens, LA: int, W: int) -> np.ndarray:
    """[n, LA + 1] int32 leftmost band column of each row: W/2 left of the
    piecewise-linear line through the pair's anchors (those inside the
    pair, strictly increasing in the read), carried along the diagonal to
    both ends of the read, or the line from (0, 0) to (alen, blen) where
    none is left; clipped to [-(W-1), blen] and made non-decreasing; rows
    past alen keep row alen's."""
    rows = np.arange(LA + 1)
    base = np.zeros((len(anchors), LA + 1), np.int32)
    for k, anc in enumerate(anchors):
        al, bl = int(alens[k]), int(blens[k])
        xs, ys = [], []
        for x, y in sorted((int(x), int(y)) for x, y in anc
                           if 0 <= x <= al and 0 <= y <= bl):
            if not xs or x > xs[-1]:
                xs.append(x)
                ys.append(y)
        if not xs:
            xs, ys = [0, al], [0, bl]
        else:
            if xs[0] > 0:
                xs, ys = [0] + xs, [ys[0] - xs[0]] + ys
            if xs[-1] < al:
                xs, ys = xs + [al], ys + [ys[-1] + al - xs[-1]]
        center = np.interp(np.minimum(rows, al), xs, ys)
        base[k] = np.clip(center.astype(np.int64) - W // 2, -(W - 1),
                          max(0, bl))
        np.maximum.accumulate(base[k], out=base[k])
    return base


def semiglobal(a, b, alen, blen, base, *, W: int, match: int,
               mismatch: int, gap: int):
    """(score [n], end_col [n], dirs [n, LA + 1, W] u8) on the tensors'
    device.  A cell takes the diagonal (match where the read's code equals
    the window's and is < 4, else mismatch) over the cell above (gap) on a
    tie, the in-row gap only where strictly better; column 0 is reached
    from above; cells off the window or past the read's rows are STOP.
    The in-row lane S[c] = max over k <= c of m[k] + gap (c - k) is
    gap c + cummax(m[k] - gap k)."""
    n, LA = a.shape
    LB = b.shape[1]
    dev = a.device
    i32, u8 = torch.int32, torch.uint8
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    c_match, c_mis = (torch.tensor(v, dtype=i32, device=dev)
                      for v in (match, mismatch))
    c_diag, c_up, c_left, c_stop = (torch.tensor(v, dtype=u8, device=dev)
                                    for v in (DIAG, UP, LEFT, STOP))
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    alen, blen_c, base = alen.to(i32), blen.to(i32)[:, None], base.to(i32)
    ai, bi = a.to(i32), b.to(torch.int64)

    def lane_of(x, at):
        return torch.where((at >= 0) & (at < W), torch.gather(
            x, 1, at.clamp(0, W - 1).long()), neg)

    j = base[:, 0:1] + lanes
    h = torch.where((j >= 0) & (j <= blen_c), torch.zeros_like(j), neg)
    dirs = torch.zeros((n, LA + 1, W), dtype=u8, device=dev)
    hold = h
    ramp = gap * lanes
    for i in range(1, min(int(alen.max()), LA) + 1):
        bs = base[:, i:i + 1]
        j = bs + lanes
        up_at = lanes + (bs - base[:, i - 1:i])
        up = lane_of(h, up_at)
        dg = lane_of(h, up_at - 1)
        ac = ai[:, i - 1:i]
        bc = torch.gather(bi, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        t_dg = dg + torch.where((ac == bc) & (ac < 4), c_match, c_mis)
        t_up = up + gap
        m = torch.maximum(t_dg, t_up)
        dirm = torch.where(t_dg >= t_up, c_diag, c_up)
        at0 = j == 0
        m = torch.where(at0, torch.full_like(m, gap * i), m)
        dirm = torch.where(at0, c_up, dirm)
        ok = (j >= 0) & (j <= blen_c) & (i <= alen)[:, None]
        m = torch.where(ok, m, neg)
        s = torch.cummax(m - ramp, dim=1).values + ramp
        d = torch.where(s > m, c_left, dirm)
        dirs[:, i] = torch.where(ok & (s > NEG_INF // 2), d, c_stop)
        h = torch.where(ok, s, neg)
        hold = torch.where((alen == i)[:, None], h, hold)
    last = base[torch.arange(n, device=dev), alen.long()]
    cols = last[:, None] + lanes
    masked = torch.where((cols >= 0) & (cols <= blen_c), hold, neg)
    lane = torch.argmax(masked, dim=1)
    score = masked[torch.arange(n, device=dev), lane]
    return score, last + lane.to(i32), dirs


def traceback(dirs: np.ndarray, base: np.ndarray, alen, end_col, T):
    """Per pair, (ops, counts) of its CIGAR (M both, I the read's, D the
    window's) and the window column where it starts.  From (alen,
    end_col), at most T[k] steps: the plane's move at the cell; a cell off
    the band, or STOP, moves UP while above row 0 and ends the walk on
    row 0; the walk also ends where both reach 0."""
    n, LR, W = dirs.shape
    flat = dirs.reshape(-1)
    i = np.asarray(alen, np.int64).copy()
    j = np.asarray(end_col, np.int64).copy()
    T = np.asarray(T, np.int64)
    done = (i <= 0) & (j <= 0)
    rows = np.arange(n)
    moves = []
    for t in range(int(T.max(initial=0))):
        done |= T <= t
        if done.all():
            break
        ic = np.clip(i, 0, LR - 1)
        lane = j - base[rows, ic]
        ok = ~done & (lane >= 0) & (lane < W)
        mv = np.where(ok, flat[(rows * LR + ic) * W + np.clip(lane, 0, W - 1)],
                      STOP).astype(np.int64)
        stuck = ~done & (mv == STOP)
        done |= stuck & (i <= 0)
        mv = np.where(stuck & (i > 0), UP, mv)
        mv = np.where(done, STOP, mv)
        i -= (mv == DIAG) | (mv == UP)
        j -= (mv == DIAG) | (mv == LEFT)
        done |= (i <= 0) & (j <= 0)
        moves.append(mv.astype(np.int8))
    mvs = np.stack(moves, 1) if moves else np.zeros((n, 0), np.int8)
    return [runs(mvs[k], OP, STOP) for k in range(n)], np.maximum(j, 0)


def runs(mv: np.ndarray, names: dict, noop: int):
    """A move stream, walked from the end, as (ops, counts) from the
    start."""
    mv = mv[mv != noop][::-1]
    if mv.size == 0:
        return [], []
    cut = np.flatnonzero(np.diff(mv)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [mv.size]])
    return ([names[int(mv[s])] for s in starts],
            [int(e - s) for s, e in zip(starts, ends)])
