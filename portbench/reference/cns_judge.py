"""The plain reference of the consensus units: how far a tile's consensus
lies from the genome stretch its reads were simulated from.

The consensus is cut into pieces of `piece_bp`.  Each piece is placed on
the truth by the median diagonal of its 16-mers that occur once in the
truth, and aligned there by an edit-distance DP that takes the whole
piece and any stretch of a window of the truth around it (plain PyTorch,
all pieces at once, a row of the DP a step).  Only the truth where the
simulated reads are `min_depth` deep or more is judged, so the tile's
thin ends do not count.  The error rate is

    (edit distance of the judged pieces + judged truth that no piece
     covers + judged truth that two pieces cover past the drift of their
     indels) / judged truth,

so a consensus that is wrong, cut short or repeated all read high.  A
piece's distance counts where the middle of its place is judged; every
piece counts for the cover.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

K = 16
MARGIN = 96
# two pieces' places may overlap by this much (drift from the indels
# inside a piece) before the overlap counts as truth covered twice
OVERLAP_SLACK = 64


def kmer_codes(x: np.ndarray, k: int = K) -> np.ndarray:
    """[len - k + 1] int64 2-bit codes of every k-mer (codes > 3 give
    junk codes that find no unique match)."""
    x = x.astype(np.int64) & 3
    n = x.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    code = np.zeros(n, np.int64)
    for j in range(k):
        code = (code << 2) | x[j: j + n]
    return code


def depth_of(starts: np.ndarray, ends: np.ndarray, length: int) -> np.ndarray:
    """The simulated reads' depth at each truth position."""
    return _cover(starts, ends, length)


def piece_diagonals(cns: np.ndarray, truth: np.ndarray, piece: int):
    """The median truth-minus-consensus diagonal of each piece's unique
    16-mer hits, and whether it had one; a piece without a hit takes the
    diagonal of the next piece that has one (or of the last)."""
    tk = kmer_codes(truth)
    keys, first, counts = np.unique(tk, return_index=True, return_counts=True)
    ukeys = keys[counts == 1]
    upos = first[counts == 1]
    ck = kmer_codes(cns)
    at = np.searchsorted(ukeys, ck)
    hit = (at < ukeys.shape[0]) & (ukeys[np.minimum(at, ukeys.shape[0] - 1)]
                                   == ck)
    cpos = np.flatnonzero(hit)
    diag = upos[at[hit]] - cpos
    npieces = (cns.shape[0] + piece - 1) // piece
    out = np.zeros(npieces, np.int64)
    has = np.zeros(npieces, bool)
    which = cpos // piece
    for p in np.unique(which):
        out[p] = int(np.median(diag[which == p]))
        has[p] = True
    if not has.any():
        return out, has
    idx = np.flatnonzero(has)
    near = idx[np.clip(np.searchsorted(idx, np.arange(npieces)), 0,
                       idx.shape[0] - 1)]
    out = out[near]
    return out, has


def piece_distances(cns: np.ndarray, truth: np.ndarray, diag: np.ndarray,
                    piece: int, device) -> np.ndarray:
    """Edit distance of every piece against any stretch of its truth
    window [start + diag - MARGIN, end + diag + MARGIN)."""
    dev = torch.device(device)
    npieces = diag.shape[0]
    W = piece + 2 * MARGIN
    pc = np.full((npieces, piece), 7, np.int64)
    plen = np.zeros(npieces, np.int64)
    tw = np.full((npieces, W), 6, np.int64)
    for p in range(npieces):
        seg = cns[p * piece: (p + 1) * piece]
        pc[p, : seg.shape[0]] = seg
        plen[p] = seg.shape[0]
        t0 = p * piece + int(diag[p]) - MARGIN
        lo, hi = max(0, t0), min(truth.shape[0], t0 + W)
        if hi > lo:
            tw[p, lo - t0: hi - t0] = truth[lo:hi]
    a = torch.from_numpy(pc).to(dev)
    b = torch.from_numpy(tw).to(dev)
    lens = torch.from_numpy(plen).to(dev)
    cols = torch.arange(W + 1, device=dev)
    prev = torch.zeros((npieces, W + 1), dtype=torch.int64, device=dev)
    for i in range(piece):
        sub = prev[:, :-1] + (a[:, i: i + 1] != b).to(torch.int64)
        cur = torch.empty_like(prev)
        cur[:, 0] = i + 1
        cur[:, 1:] = torch.minimum(sub, prev[:, 1:] + 1)
        cur = torch.cummin(cur - cols, dim=1).values + cols
        prev = torch.where((i < lens)[:, None], cur, prev)
    return prev.min(dim=1).values.cpu().numpy()


def _cover(beg: np.ndarray, end: np.ndarray, length: int) -> np.ndarray:
    """How many of the intervals [beg, end) hold each position."""
    c = np.zeros(length + 1, np.int64)
    np.add.at(c, np.clip(beg, 0, length), 1)
    np.add.at(c, np.clip(end, 0, length), -1)
    return np.cumsum(c)[:length]


@dataclasses.dataclass
class Judged:
    """A tile's consensus placed on its truth, piece by piece."""

    dist: np.ndarray        # [pieces] edit distance of each piece
    use: np.ndarray         # [pieces] bool: the middle of its place is judged
    uncovered: int          # judged truth that no piece covers
    double: int             # judged truth covered twice past the slack
    n_judged: int           # judged truth

    @property
    def rate(self) -> float:
        return (int(self.dist[self.use].sum()) + self.uncovered
                + self.double) / self.n_judged


def judge(cns: np.ndarray, truth: np.ndarray, read_starts: np.ndarray,
          read_ends: np.ndarray, *, piece: int = 1000, min_depth: int = 10,
          device="cpu") -> Judged | None:
    """The consensus against its truth; None where no piece can be placed
    (a consensus that shares no unique 16-mer with its truth)."""
    depth = depth_of(read_starts, read_ends, truth.shape[0])
    judged = depth >= min_depth
    n_judged = int(judged.sum())
    if n_judged == 0:
        raise ValueError("no truth is deep enough to judge")
    if cns.shape[0] < K:
        return None
    diag, has = piece_diagonals(cns, truth, piece)
    if not has.any():
        return None
    npieces = diag.shape[0]
    beg = np.arange(npieces) * piece + diag
    end = np.minimum(beg + piece, beg + (cns.shape[0] - np.arange(npieces)
                                         * piece))
    mid = np.clip((beg + end) // 2, 0, truth.shape[0] - 1)
    dist = piece_distances(cns, truth, diag, piece, device)
    half = OVERLAP_SLACK // 2
    uncovered = int((judged & (_cover(beg, end, truth.shape[0]) == 0)).sum())
    inner = _cover(beg + half, np.maximum(beg + half, end - half),
                   truth.shape[0])
    double = int(np.maximum(inner[judged] - 1, 0).sum())
    return Judged(dist=dist, use=judged[mid], uncovered=uncovered,
                  double=double, n_judged=n_judged)
