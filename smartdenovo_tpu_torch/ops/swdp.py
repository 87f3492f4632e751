"""Batched global (Needleman-Wunsch) alignment over anti-diagonals, with
a direction plane for a host traceback (port of smartdenovo_tpu/ops/swdp.py,
which is `jax.jit` over `lax.scan`).

Linear gap (M=2 X=-5 gap=-3 by default).  Cell (i, j) of pair k, i a
position in `a` and j in `b`, lies on anti-diagonal d = i + j; the plane
`dirs[k, d, i]` holds its move: DIAG, UP (from (i-1, j)), LEFT (from
(i, j-1)) or STOP, which is also every byte outside i <= alen, j <= blen.
Ties go DIAG > UP > LEFT; a match needs equal codes below 4, so an N (4)
inside a read mismatches; row 0 and column 0 hold gap * j and gap * i.

`batch_global_align` dispatches on the tensors' device: on CUDA it
launches the hand-written kernel of csrc/nwglobal.cu, whose instance
`nw_plan` picks by shape (the register instance up to L NW_REG_MAX_L,
rows in registers and a warp a strip of them, in the shape `nw_shape`
gives; past it the wide instance, a block a pair); on the CPU it runs
`batch_global_align_plain`, the JAX scan step for step in PyTorch, int32
throughout.  `traceback_batch` is a copy of the JAX package's host
traceback; `align_strings` is the port's (ops/banded.py), under this
module's name as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from .banded import align_strings  # noqa: F401  (the JAX module's name)

NEG_INF = -(1 << 28)

# traceback codes
DIAG, UP, LEFT, STOP = 1, 2, 3, 0

# dynamic shared memory a block may take on Hopper; past it the wide
# instance keeps its three diagonals in a global scratch
NW_SMEM_CAP = 232448
# the register instance's rows a lane (its template instances in
# csrc/nwglobal.cu), and the rows a lane below which nw_shape stops
# spreading a pair over more warps (fewer independent groups a warp)
NW_PS = (1, 2, 3, 4, 6, 8, 10, 12, 14, 17, 20, 24, 28, 32)
NW_MIN_P = 4
# warp schedulers of an H100 (132 SMs x 4): the warps that fill the card
NW_FILL_WARPS = 528


def nw_max_warps(P: int) -> int:
    """Warps a block of the register instance may hold at P rows a lane
    (csrc/nwglobal.cu NW_REG_THREADS: ~3 P + 30 registers a thread within
    the SM's 65,536)."""
    return 32 if P <= 8 else (16 if P <= 20 else 12)


# the longest L the register instance covers (32 P rows a warp, at most
# nw_max_warps(P) warps a pair); past it the wide instance
NW_REG_MAX_L = max(32 * P * nw_max_warps(P) for P in NW_PS) - 1


def nw_shape(L: int, B: int):
    """(P, warps, pairs) of the register instance for B pairs at L: the
    fewest warps a pair whose 32 P rows a warp cover the L + 1 rows, with
    P the smallest instance that does; while B x warps leaves some of the
    card's NW_FILL_WARPS schedulers without a warp, more warps a pair at a
    smaller P, down to NW_MIN_P.  Pairs a block: 8 one-warp pairs, else
    one pair (its warps meet at a named barrier a diagonal).  None past
    NW_REG_MAX_L."""
    rows = L + 1
    shapes = []                       # (warps, P), P falling
    for w in range(1, 33):
        need = -(-rows // (32 * w))
        P = next((p for p in NW_PS if p >= need), None)
        if P is not None and w <= nw_max_warps(P) and (
                not shapes or P < shapes[-1][1]):
            shapes.append((w, P))
    if L < 1 or not shapes:
        return None
    w, P = shapes[0]
    for w2, P2 in shapes[1:]:
        if B * w >= NW_FILL_WARPS or P2 < NW_MIN_P:
            break
        w, P = w2, P2
    return P, w, 8 if w == 1 else 1


def nw_plan(L: int, B: int):
    """The instance batch_global_align launches on CUDA for B pairs at L:
    ("register", P, warps, pairs) or ("wide", in_smem)."""
    shape = nw_shape(L, B) if L <= NW_REG_MAX_L else None
    if shape is not None:
        return ("register",) + shape
    return ("wide", 3 * (L + 1) * 4 <= NW_SMEM_CAP)


def batch_global_align(a, b, alen, blen, *, max_len: int, match: int = 2,
                       mismatch: int = -5, gap: int = -3):
    """Global alignment of B pairs.  a, b [B, max_len] uint8 codes (4 =
    pad), alen, blen [B] int32 in [0, max_len].  Returns (score [B] int32,
    dirs [B, 2 max_len + 1, max_len + 1] uint8) on the device of `a`,
    where dirs[k, d, i] is the move of cell (i, d - i)."""
    if a.device.type == "cuda":
        return _nw_cuda(a, b, alen, blen, max_len=max_len, match=match,
                        mismatch=mismatch, gap=gap)
    if a.device.type == "cpu":
        return batch_global_align_plain(a, b, alen, blen, max_len=max_len,
                                        match=match, mismatch=mismatch,
                                        gap=gap)
    raise ValueError(f"batch_global_align: unsupported device {a.device}")


def batch_global_align_plain(a, b, alen, blen, *, max_len: int,
                             match: int = 2, mismatch: int = -5,
                             gap: int = -3):
    """Plain PyTorch version: one step of the JAX scan (swdp.py:61-86)
    per anti-diagonal, over [B, max_len + 1] rows."""
    B, L = a.shape
    assert L == max_len
    dev = a.device
    i32 = torch.int32
    W = max_len + 1
    ai = a.to(torch.int64)
    bi = b.to(torch.int64)
    alen = alen.to(i32)[:, None]
    blen = blen.to(i32)[:, None]
    i = torch.arange(W, dtype=i32, device=dev)[None, :]
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    c_match = torch.tensor(match, dtype=i32, device=dev)
    c_mismatch = torch.tensor(mismatch, dtype=i32, device=dev)
    c_diag, c_up, c_left, c_stop = (torch.tensor(v, dtype=torch.uint8,
                                                 device=dev)
                                    for v in (DIAG, UP, LEFT, STOP))
    hm2 = torch.full((B, W), NEG_INF, dtype=i32, device=dev)
    hm1 = hm2.clone()
    dirs = torch.empty((B, 2 * max_len + 1, W), dtype=torch.uint8, device=dev)
    score = torch.zeros(B, dtype=i32, device=dev)
    d_end = (alen + blen)[:, 0]
    row_end = alen.clamp(0, W - 1).long()
    ac = torch.gather(ai, 1, (i - 1).clamp(0, L - 1).expand(B, W).long()
                      ).to(i32)
    for d in range(2 * max_len + 1):
        j = d - i
        inb = (i <= alen) & (j >= 0) & (j <= blen)
        up = torch.where(i > 0, torch.roll(hm1, 1, dims=1), neg) + gap
        left = hm1 + gap
        bc = torch.gather(bi, 1, (j - 1).clamp(0, L - 1).expand(B, W).long()
                          ).to(i32)
        sub = torch.where((ac == bc) & (ac < 4), c_match, c_mismatch)
        dg = torch.where((i > 0) & (j > 0), torch.roll(hm2, 1, dims=1),
                         neg) + sub
        h = torch.maximum(dg, torch.maximum(up, left))
        dirc = torch.where(h == dg, c_diag,
                           torch.where(h == up, c_up, c_left))
        origin = (i == 0) & (j == 0)
        first_row = (i == 0) & (j > 0)
        first_col = (j == 0) & (i > 0)
        h = torch.where(origin, 0, h)
        h = torch.where(first_row, gap * j, h)
        h = torch.where(first_col, gap * i, h)
        dirc = torch.where(origin, c_stop, dirc)
        dirc = torch.where(first_row, c_left, dirc)
        dirc = torch.where(first_col, c_up, dirc)
        h = torch.where(inb, h, neg)
        dirs[:, d] = torch.where(inb, dirc, c_stop)
        # the score at (alen, blen): diagonal alen + blen, row alen
        score = torch.where(d_end == d, h.gather(1, row_end)[:, 0], score)
        hm2, hm1 = hm1, h
    return score, dirs


def _nw_cuda(a, b, alen, blen, *, max_len, match, mismatch, gap):
    B, L = a.shape
    dev = a.device
    if (a.dtype != torch.uint8 or b.dtype != torch.uint8
            or alen.dtype != torch.int32 or blen.dtype != torch.int32):
        raise ValueError("batch_global_align: dtypes must be u8, u8, i32, i32")
    if (L != max_len or L < 1 or tuple(b.shape) != (B, L)
            or tuple(alen.shape) != (B,) or tuple(blen.shape) != (B,)):
        raise ValueError(f"batch_global_align: bad shapes {tuple(a.shape)} "
                         f"{tuple(b.shape)} {tuple(alen.shape)} "
                         f"{tuple(blen.shape)} for max_len {max_len}")
    if any(t.device != dev for t in (b, alen, blen)):
        raise ValueError("batch_global_align: inputs on different devices")
    a, b, alen, blen = (t.contiguous() for t in (a, b, alen, blen))
    W = L + 1
    score = torch.empty(B, dtype=torch.int32, device=dev)
    dirs = torch.empty((B, 2 * L + 1, W), dtype=torch.uint8, device=dev)
    if B == 0:
        return score, dirs
    plan = nw_plan(L, B)
    if plan[0] == "register":
        P, warps, pairs = plan[1:]
        in_smem = 1
    else:
        # the wide instance's three diagonals of int32: shared memory
        # where they fit, else a scratch of the same layout in device memory
        P = warps = pairs = 0
        in_smem = plan[1]
    scratch = (torch.empty(0, dtype=torch.int32, device=dev) if in_smem
               else torch.empty((B, 3, W), dtype=torch.int32, device=dev))
    _build.LAUNCHES["nwglobal"] += 1
    _build.check(_build.lib().nwglobal_align(
        a.data_ptr(), b.data_ptr(), alen.data_ptr(), blen.data_ptr(), B, L,
        match, mismatch, gap, P, warps, pairs, int(in_smem),
        scratch.data_ptr(), score.data_ptr(), dirs.data_ptr(),
        _build.stream_of(a)), "nwglobal_align")
    return score, dirs


def traceback_batch(dirs: np.ndarray, alen: np.ndarray, blen: np.ndarray):
    """Vectorised host traceback.  Returns list of (ops, counts) per pair —
    a run-length CIGAR-like encoding with ops in {'M','I','D'} where I is
    an insertion in `a` (consumes a) and D consumes b."""
    dirs = np.asarray(dirs)
    B = dirs.shape[0]
    i = alen.astype(np.int64).copy()
    j = blen.astype(np.int64).copy()
    done = (i == 0) & (j == 0)
    paths = [[] for _ in range(B)]
    maxsteps = dirs.shape[1]
    bidx = np.arange(B)
    for _ in range(maxsteps):
        if done.all():
            break
        d = i + j
        mv = dirs[bidx, d, i]
        mv = np.where(done, 0, mv)
        for k in np.nonzero(mv)[0]:
            paths[k].append(int(mv[k]))
        step_i = (mv == DIAG) | (mv == UP)
        step_j = (mv == DIAG) | (mv == LEFT)
        i -= step_i
        j -= step_j
        done = (i <= 0) & (j <= 0)
    out = []
    code2op = {DIAG: "M", UP: "I", LEFT: "D"}
    for path in paths:
        path.reverse()
        ops, counts = [], []
        for c in path:
            op = code2op[c]
            if ops and ops[-1] == op:
                counts[-1] += 1
            else:
                ops.append(op)
                counts.append(1)
        out.append((ops, counts))
    return out
