"""The SW overlaps' CIGARs, worked out again: each accepted overlap's
query segment `a` against its candidate segment `b` (strand-flipped) by a
linear-gap banded DP whose end gaps in `b` are free (semiglobal), along a
W-lane band on the straight line from (0, 0) to (alen, blen); the
traceback from the best cell of the last row; its moves run-length
encoded into M (both), I (a only) and D (b only); and the counts of the
aligned strings.

A pair's alignment depends on no other pair and not on how far its rows
are padded, so the DP runs on groups of pairs, longest first, each as
many as keep the group's direction plane (pairs x (longest + 1) x W
bytes) under DIRS_CAP: in PyTorch on the tensors' device, one row a loop
turn over [n, W].  The traceback walks the fetched plane on the host, all
of a group's pairs a step at a time, each for at most the length of the
move stream the program gives it, 2 (tier + 1) + W for its length
tier."""

from __future__ import annotations

import numpy as np
import torch

from ..overlap_ref import pad_tier

NEG_INF = -(1 << 28)
DIAG, UP, LEFT, STOP = 1, 2, 3, 0
DIRS_CAP = 1 << 34
OP = {DIAG: "M", UP: "I", LEFT: "D"}


def groups(alens, W: int, cap: int = DIRS_CAP):
    """(indices, LA): the pairs longest first, in groups whose plane,
    size x (LA + 1) x W bytes with LA the group's longest, stays under
    cap (one pair at least)."""
    order = np.argsort(-np.asarray(alens), kind="stable")
    i, n = 0, len(order)
    while i < n:
        LA = int(alens[order[i]])
        j = i + 1
        while j < n and (j + 1 - i) * (LA + 1) * W <= cap:
            j += 1
        yield order[i:j], max(LA, 1)
        i = j


def band_centers(alens, blens, LA: int, W: int) -> np.ndarray:
    """[n, LA + 1] int32 leftmost band column of each row: the line from
    (0, 0) to (alen, blen), less W/2, clipped to [-(W-1), blen] and made
    non-decreasing; rows past alen keep row alen's."""
    rows = np.arange(LA + 1)
    base = np.zeros((len(alens), LA + 1), np.int32)
    for k, (al, bl) in enumerate(zip(alens, blens)):
        al, bl = int(al), int(bl)
        xs, ys = ([0, al], [0, bl]) if al > 0 else ([0], [0])
        center = np.interp(np.minimum(rows, al), xs, ys)
        base[k] = np.clip(center.astype(np.int64) - W // 2, -(W - 1),
                          max(0, bl))
        np.maximum.accumulate(base[k], out=base[k])
    return base


def semiglobal_dp(a, b, alen, blen, base, *, W: int, match: int,
                  mismatch: int, gap: int):
    """(end_col [n], dirs [n, LA + 1, W] u8) on the tensors' device: the
    moves DIAG, UP (a only), LEFT (b only) and STOP of every band cell of
    rows 0..alen, and the column of the first best lane of row alen.  The
    in-row gap lane, S[c] = max over k <= c of m[k] + gap (c - k), is
    gap c + cummax(m[k] - gap k)."""
    n, LA = a.shape
    LB = b.shape[1]
    dev = a.device
    i32 = torch.int32
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    c_match, c_mis, c_gap = (torch.tensor(v, dtype=i32, device=dev)
                             for v in (match, mismatch, gap))
    u8 = torch.uint8
    c_diag, c_up, c_left, c_stop = (torch.tensor(v, dtype=u8, device=dev)
                                    for v in (DIAG, UP, LEFT, STOP))
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    alen, blen_c, base = alen.to(i32), blen.to(i32)[:, None], base.to(i32)

    j = base[:, 0:1] + lanes
    h = torch.where((j >= 0) & (j <= blen_c), torch.zeros_like(j), neg)
    dirs = torch.zeros((n, LA + 1, W), dtype=u8, device=dev)
    hold = h
    ramp = gap * lanes
    for i in range(1, min(int(alen.max()), LA) + 1):
        bs = base[:, i:i + 1]
        j = bs + lanes
        # the row before at this row's columns j (up) and j - 1 (diagonal)
        up_at = lanes + (bs - base[:, i - 1:i])
        up = torch.where((up_at >= 0) & (up_at < W), torch.gather(
            h, 1, up_at.clamp(0, W - 1).long()), neg)
        dg = torch.where((up_at >= 1) & (up_at <= W), torch.gather(
            h, 1, (up_at - 1).clamp(0, W - 1).long()), neg)
        ac = a[:, i - 1:i].to(i32)
        bc = torch.gather(b, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        t_dg = dg + torch.where((ac == bc) & (ac < 4), c_match, c_mis)
        t_up = up + c_gap
        m = torch.maximum(t_dg, t_up)
        dirm = torch.where(t_dg >= t_up, c_diag, c_up)
        at0 = j == 0
        m = torch.where(at0, torch.full_like(m, gap * i), m)
        dirm = torch.where(at0, c_up, dirm)
        okij = (j >= 0) & (j <= blen_c) & (i <= alen)[:, None]
        m = torch.where(okij, m, neg)
        s = torch.cummax(m - ramp, dim=1).values + ramp
        d = torch.where(s > m, c_left, dirm)
        dirs[:, i] = torch.where(okij & (s > NEG_INF // 2), d, c_stop)
        h = torch.where(okij, s, neg)
        hold = torch.where((alen == i)[:, None], h, hold)
    last = base[torch.arange(n, device=dev), alen.long()]
    cols = last[:, None] + lanes
    masked = torch.where((cols >= 0) & (cols <= blen_c), hold, neg)
    return last + torch.argmax(masked, dim=1).to(i32), dirs


def traceback(dirs: np.ndarray, base: np.ndarray, alen: np.ndarray,
              end_col: np.ndarray):
    """Per pair, (ops, counts) of its CIGAR and the column of `b` where
    the alignment starts.  From (alen, end_col) back to (0, 0), at most
    2 (tier + 1) + W steps: the plane's move at the cell; a cell off the
    band or of STOP moves UP above row 0 and ends the walk at row 0; the
    walk also ends where both reach 0."""
    n, LR, W = dirs.shape
    flat = dirs.reshape(-1)
    i = alen.astype(np.int64).copy()
    j = end_col.astype(np.int64).copy()
    done = (i <= 0) & (j <= 0)
    steps = np.array([2 * (pad_tier(int(x)) + 1) + W for x in alen])
    rows = np.arange(n)
    moves = []
    for t in range(int(steps.max(initial=0))):
        done |= steps <= t
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
    out = []
    for k in range(n):
        mv = mvs[k][mvs[k] != STOP][::-1]
        if mv.size == 0:
            out.append(([], []))
            continue
        cut = np.flatnonzero(np.diff(mv)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [mv.size]])
        out.append(([OP[int(mv[s])] for s in starts],
                    [int(e - s) for s, e in zip(starts, ends)]))
    return out, np.maximum(j, 0)


def aligned(a_codes, b_codes, ops, counts):
    """The aligned strings of a CIGAR over codes, 4 for a gap."""
    col = np.repeat(np.array(["MID".index(o) for o in ops], np.int8),
                    np.asarray(counts, np.int64))
    ra = np.full(col.size, 4, np.uint8)
    rb = np.full(col.size, 4, np.uint8)
    in_a, in_b = col != 2, col != 1
    ra[in_a] = np.asarray(a_codes)[np.cumsum(in_a)[in_a] - 1]
    rb[in_b] = np.asarray(b_codes)[np.cumsum(in_b)[in_b] - 1]
    return ra, rb


def cigars(segs, *, W: int, match: int, mismatch: int, gap: int, device):
    """Per (a, b) segment pair: None where the traceback is empty, else
    (cigar, mat, mis, ins, dl, aln)."""
    dev = torch.device(device)
    alen = np.array([len(x) for x, _ in segs], np.int64)
    blen = np.array([len(y) for _, y in segs], np.int64)
    out = [None] * len(segs)
    for idx, LA in groups(alen, W):
        n = len(idx)
        a = np.full((n, LA), 4, np.uint8)
        b = np.full((n, max(int(blen[idx].max()), 1)), 4, np.uint8)
        for k, i in enumerate(idx):
            a[k, :alen[i]] = segs[i][0]
            b[k, :blen[i]] = segs[i][1]
        base = band_centers(alen[idx], blen[idx], LA, W)
        end_col, dirs = semiglobal_dp(
            *(torch.from_numpy(x).to(dev) for x in (a, b, alen[idx],
                                                    blen[idx], base)),
            W=W, match=match, mismatch=mismatch, gap=gap)
        dirs = dirs.cpu().numpy()
        cg, b_beg = traceback(dirs, base, alen[idx], end_col.cpu().numpy())
        del dirs
        for k, i in enumerate(idx):
            ops, counts = cg[k]
            if not ops:
                continue
            ra, rb = aligned(segs[i][0], segs[i][1][int(b_beg[k]):], ops,
                             counts)
            both = (ra != 4) & (rb != 4)
            out[i] = ("".join(f"{c}{o}" for o, c in zip(ops, counts)),
                      int(np.sum(both & (ra == rb))),
                      int(np.sum(both & (ra != rb))),
                      int(np.sum((ra != 4) & (rb == 4))),
                      int(np.sum((ra == 4) & (rb != 4))), int(ra.shape[0]))
    return out
