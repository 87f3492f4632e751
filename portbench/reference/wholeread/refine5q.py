"""The quality-aware refine of a read's alignment to its consensus window
(kswx's 5q refine, kswx.h:871-1075, as wtcns runs it on reads with f5q
tracks, wtcns.c:372-381), worked out again: a global min-cost affine DP
from (0, 0) to (alen, blen), negated so that it maximises, in a W-lane
band around the banded alignment's CIGAR, and kswx's two-bit traceback.

Costs, smaller is better, with the read's tracks SubQV, InsQV, DelQV,
SubTag and DelTag (f5q tracks 1, 2, 3, 5, 6; 0-based read positions):
- read base i against window base c: 0 where c is the read's base,
  SubQV[i] where c is SubTag[i], QMIS otherwise;
- the read base i inserted: InsQV[i + 1] (on the last row QCLP), opening
  and extending alike;
- window base c deleted after read base i - 1, that is on row i: DelQV[i]
  where c is DelTag[i], QDEL otherwise, to open; QEXT to extend; on the
  last row QCLP;
- each window base before the alignment, and each read base on column 0,
  QCLP.
Ties: the diagonal over an insertion, a deletion only where strictly
better; the insertion's extension bit where extending is strictly better
than opening, the deletion's where the best deletion is not the one just
opened.

The band: the CIGAR's path as a centre for each row, W/2 to its left,
made non-decreasing; W is the batch's tier, W_base plus twice the longest
indel of its CIGARs, as a power of two in 64..1024.  A pair's result
depends on W and on T, the moves its traceback may take, 2 (LA + 1) + W
+ 4 for the power of two LA at or above its length (256 at least); not
on the other pairs of a call, so a call may take any pairs of one W."""

from __future__ import annotations

import numpy as np
import torch

from ..sw.cigar import groups
from .banded import PLANE_CAP, runs

NEG = -(1 << 24)
QCLP, QMIS, QDEL, QEXT = 251, 236, 241, 251   # wtcns.c:104-107, as uint8
TRACKS = (1, 2, 3, 5, 6)   # SubQV, InsQV, DelQV, SubTag, DelTag
M_, I_, D_, DONE = 0, 1, 2, 3
OP = {M_: "M", I_: "I", D_: "D"}


def pow2_len(n: int) -> int:
    return 1 << max(8, (n - 1).bit_length())


def band_width(cigars, W_base: int) -> int:
    """W for a batch of (ops, counts) CIGARs."""
    wmax = W_base
    for ops, counts in cigars:
        for op, ln in zip(ops, counts):
            if op != "M":
                wmax = max(wmax, W_base + 2 * int(ln))
    return 1 << max(6, (min(wmax, 1024) - 1).bit_length())


def band_from_cigar(cigars, alens, blens, LA: int, W: int) -> np.ndarray:
    """[n, LA + 1] int32 leftmost band column of each row around the
    CIGAR's path: row r's centre is the window column after the read's
    r-th base (an insertion keeps the column; a deletion run moves the
    centre of the row it follows), carried along the diagonal past the
    CIGAR's end; less W/2, clipped to [0, blen], made non-decreasing;
    rows past alen keep row alen's."""
    base = np.zeros((len(cigars), LA + 1), np.int32)
    for k, (ops, counts) in enumerate(cigars):
        al, bl = int(alens[k]), int(blens[k])
        centre = np.zeros(al + 1, np.int64)
        qx = tx = 0
        for op, ln in zip(ops, counts):
            ln = int(ln)
            if op == "D":
                tx += ln
                if qx <= al:
                    centre[qx] = tx
                continue
            w = max(0, min(ln, al - qx))
            centre[qx + 1: qx + w + 1] = tx + (np.arange(1, w + 1)
                                               if op == "M" else 0)
            qx += ln
            tx += ln if op == "M" else 0
            qx = min(qx, al)
        if qx < al:
            centre[qx + 1:] = centre[qx] + np.arange(1, al - qx + 1)
        b_ = np.clip(centre[np.minimum(np.arange(LA + 1), al)] - W // 2, 0,
                     max(0, bl))
        base[k] = np.maximum.accumulate(b_)
    return base


def dp(a, b, tracks, alen, blen, base, *, W: int):
    """(score [n], dirs [n, LA + 1, W] u8) on the tensors' device; tracks
    [5, n, LA] int32.  Direction byte: bits 0-1 the cell's source (0
    diagonal, 1 insertion, 2 deletion), bit 2 the insertion extended,
    bit 5 the deletion extended; one row a loop turn over [n, W]."""
    n, LA = a.shape
    LB = b.shape[1]
    dev = a.device
    i32, u8 = torch.int32, torch.uint8
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    ramp = QEXT * lanes
    ai, bi = a.to(i32), b.to(torch.int64)
    sq_t, iq_t, dq_t, st_t, dt_t = (t.to(i32) for t in tracks)
    alen, blen_c, base = alen.to(i32), blen.to(i32)[:, None], base.to(i32)
    neg_col = neg.expand(n, 1)

    def lane_of(x, at):
        return torch.where((at >= 0) & (at < W), torch.gather(
            x, 1, at.clamp(0, W - 1).long()), neg)

    j = base[:, 0:1] + lanes
    h = torch.where((j >= 0) & (j <= blen_c), -j * QCLP, neg)
    e = torch.full((n, W), NEG, dtype=i32, device=dev)
    hold = h
    dirs = torch.zeros((n, LA + 1, W), dtype=u8, device=dev)
    for i in range(1, min(int(alen.max()), LA) + 1):
        bs = base[:, i:i + 1]
        j = bs + lanes
        up_at = lanes + (bs - base[:, i - 1:i])
        hdg = lane_of(h, up_at - 1)
        eup = lane_of(e, up_at)
        last = (i >= alen)[:, None]
        nx = min(i, LA - 1)
        iq = torch.where(last, QCLP, iq_t[:, nx:nx + 1])
        bc = torch.gather(bi, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        sub = torch.where(bc == ai[:, i - 1:i], zero,
                          torch.where(bc == st_t[:, i - 1:i],
                                      sq_t[:, i - 1:i], QMIS))
        dcost = torch.where(last, QCLP, torch.where(
            bc == dt_t[:, nx:nx + 1], dq_t[:, nx:nx + 1], QDEL))
        ok = (j >= 1) & (j <= blen_c)
        m = torch.where(ok, hdg - sub, neg)
        d = (m < eup).to(u8)
        hh = torch.maximum(m, eup)
        v = torch.where(ok, m - dcost, neg)
        # the best deletion ending at each lane, opened at an earlier lane
        f = torch.cat([neg_col, (torch.cummax(v + ramp, dim=1).values
                                 - ramp)[:, :-1]], dim=1)
        d = torch.where(f > hh, torch.full_like(d, 2), d)
        hh = torch.maximum(hh, f)
        e_ext, e_open = eup - iq, m - iq
        d = d | ((e_ext > e_open).to(u8) << 2)
        d = d | ((f > torch.cat([neg_col, v[:, :-1]], dim=1)).to(u8) << 5)
        at0 = j == 0
        hh = torch.where(at0, torch.full_like(hh, -i * QCLP), hh)
        d = torch.where(at0, torch.ones_like(d), d)
        live = (i <= alen)[:, None]
        h = torch.where(live & (ok | at0), hh, neg)
        e = torch.where(live, torch.maximum(e_ext, e_open), neg)
        hold = torch.where((alen == i)[:, None], h, hold)
        dirs[:, i] = d
    rows = torch.arange(n, device=dev)
    lane = blen.to(i32) - base[rows, alen.long()]
    score = hold[rows, lane.clamp(0, W - 1).long()]
    return torch.where((lane >= 0) & (lane < W), score, neg), dirs


def traceback(dirs: np.ndarray, base: np.ndarray, alen, blen, T):
    """[n, steps] int8 moves (0 M, 1 I, 2 D, 3 none) of kswx's state
    machine from (alen, blen), at most T[k] for pair k: a state's move is
    its two bits of the cell's byte (0 off the band), an insertion on
    column 0, a deletion on row 0."""
    n, LR, W = dirs.shape
    flat = dirs.reshape(-1)
    i = np.asarray(alen, np.int64).copy()
    j = np.asarray(blen, np.int64).copy()
    T = np.asarray(T, np.int64)
    state = np.zeros(n, np.int64)
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
        z = np.where(ok, flat[(rows * LR + ic) * W + np.clip(lane, 0, W - 1)],
                     0).astype(np.int64)
        mv = (z >> (2 * state)) & 3
        mv = np.where(i <= 0, D_, mv)
        mv = np.where((j <= 0) & (i > 0), I_, mv)
        mv = np.where(done, DONE, mv)
        i -= (mv == M_) | (mv == I_)
        j -= (mv == M_) | (mv == D_)
        state = np.where(mv == DONE, state, mv)
        done |= (i <= 0) & (j <= 0)
        moves.append(mv.astype(np.int8))
    mvs = np.stack(moves, 1) if moves else np.zeros((n, 0), np.int8)
    return mvs


def refine(pairs, cigars, quals, *, W: int, device) -> list:
    """Per pair (read codes, window codes of its alignment), with its
    prior CIGAR and [7, len] tracks: the refined (ops, counts), at band
    width W, in calls of a plane under PLANE_CAP bytes."""
    dev = torch.device(device)
    alens = np.array([len(x) for x, _ in pairs], np.int64)
    out = [None] * len(pairs)
    for idx, LA in groups(alens, W, PLANE_CAP):
        n = len(idx)
        alen = alens[idx]
        blen = np.array([len(pairs[k][1]) for k in idx], np.int64)
        a = np.full((n, LA), 4, np.uint8)
        b = np.full((n, int(blen.max()) + 1), 4, np.uint8)
        tr = np.zeros((5, n, LA), np.int32)
        for r, k in enumerate(idx):
            x, y = pairs[k]
            a[r, : len(x)] = x
            b[r, : len(y)] = y
            tr[:, r, : len(x)] = quals[k][list(TRACKS), : len(x)]
        base = band_from_cigar([cigars[k] for k in idx], alen, blen, LA, W)
        _score, dirs = dp(*(torch.from_numpy(x).to(dev)
                            for x in (a, b, tr, alen, blen, base)), W=W)
        dirs = dirs.cpu().numpy()
        T = [2 * (pow2_len(int(x)) + 1) + W + 4 for x in alen]
        mvs = traceback(dirs, base, alen, blen, T)
        del dirs
        for r, k in enumerate(idx):
            out[k] = runs(mvs[r], OP, DONE)
    return out
