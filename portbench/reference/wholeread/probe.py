"""Probe anchoring of reads against their consensus windows, worked out
again: S evenly spaced K-mers of each read, each matched inside +-D of
the read's expected diagonal in its window; the hit nearest the diagonal
wins (the first on a tie); the hits whose diagonal lies more than 512
from their median are dropped.

A read's anchors depend only on the read and its window: K-mers that
reach past the read or the window are never read, so the batch's padding
does not matter, and the reads run in groups of `GROUP` to keep the
[n, S, 2 D] planes small."""

from __future__ import annotations

import numpy as np
import torch

K, D, S = 14, 1024, 96
GROUP = 64
OUTLIER = 512
NO_HIT = -2 * D - 1


def _kmers(x: torch.Tensor):
    """(K-mer code at each start, whether its K bases are all < 4)."""
    n, L = x.shape
    code = torch.zeros((n, L), dtype=torch.int32, device=x.device)
    good = torch.ones((n, L), dtype=torch.bool, device=x.device)
    for t in range(K):
        nxt = torch.full((n, L), 4, dtype=x.dtype, device=x.device)
        nxt[:, : L - t] = x[:, t:]
        code = (code << 2) | (nxt & 3).to(torch.int32)
        good &= nxt < 4
    return code, good


def _group(reads, windows, doffs, dev):
    n = len(reads)
    LA = max(len(r) for r in reads)
    LW = max(max(len(w) for w in windows), 1)
    a = np.full((n, LA), 4, np.uint8)
    w = np.full((n, LW), 4, np.uint8)
    for k, (r, win) in enumerate(zip(reads, windows)):
        a[k, : len(r)] = r
        w[k, : len(win)] = win
    i32 = torch.int32
    a, w = torch.from_numpy(a).to(dev), torch.from_numpy(w).to(dev)
    alen = torch.tensor([len(r) for r in reads], dtype=i32, device=dev)
    wlen = torch.tensor([len(x) for x in windows], dtype=i32, device=dev)
    doff = torch.tensor(doffs, dtype=i32, device=dev)
    ka, va = _kmers(a)
    kw, vw = _kmers(w)
    s = torch.arange(S, dtype=i32, device=dev)
    px = torch.div(torch.clamp(alen[:, None] - K, min=1) * s, S,
                   rounding_mode="floor")
    pk = torch.gather(ka, 1, px.long())
    pv = torch.gather(va, 1, px.long()) & (px <= alen[:, None] - K)
    j = torch.arange(2 * D, dtype=i32, device=dev)
    wy = px[:, :, None] + doff[:, None, None] - D + j[None, None, :]
    inside = (wy >= 0) & (wy <= wlen[:, None, None] - K)
    at = wy.clamp(0, LW - 1).long().reshape(n, -1)
    hit = (pv[:, :, None] & inside
           & (torch.gather(kw, 1, at).reshape(wy.shape) == pk[:, :, None])
           & torch.gather(vw, 1, at).reshape(wy.shape))
    pref = torch.where(hit, -(j - D).abs()[None, None, :],
                       torch.tensor(NO_HIT, dtype=i32, device=dev))
    best = torch.argmax(pref, dim=2).to(i32)
    found = pref.amax(dim=2) > NO_HIT
    py = px + doff[:, None] - D + best
    return px.cpu().numpy(), py.cpu().numpy(), found.cpu().numpy()


def anchors(reads, windows, doffs, device) -> list:
    """Per read, its sorted (read pos, window pos) anchors, or []."""
    dev = torch.device(device)
    out = []
    for g in range(0, len(reads), GROUP):
        sl = slice(g, g + GROUP)
        px, py, found = _group(reads[sl], windows[sl], doffs[sl], dev)
        for k in range(px.shape[0]):
            xs, ys = px[k][found[k]], py[k][found[k]]
            if xs.size == 0:
                out.append([])
                continue
            d = ys.astype(np.int64) - xs
            keep = np.abs(d - np.median(d)) <= OUTLIER
            out.append(sorted(zip(xs[keep].tolist(), ys[keep].tolist())))
    return out
