"""Anchor-guided banded alignment of whole reads, with its traceback (port
of smartdenovo_tpu/ops/banded.py, which is `jax.jit` over `lax.scan`).

A linear-gap DP of read `a` (rows) against window `b` (columns) along a
W-lane band whose leftmost column per row, `base`, is precomputed from
z-mer anchors (`make_band_centers`).  `semiglobal_b` makes the end gaps
in `b` free: the mode of read-vs-consensus alignment.

`banded_align` dispatches on the tensors' device: on CUDA it launches the
hand-written kernel of csrc/banded.cu (one warp per read: the row loop,
then the traceback out of the same warp's direction plane), on the CPU
it runs `banded_align_plain`, a row loop in PyTorch that follows the JAX
scan step for step, int32 throughout, and `traceback.tb_banded`.  Both
return the move stream of the traceback with the DP, so the host fetches
[T, B] moves and never the direction plane.

`make_band_centers` is a copy of the JAX package's; `align_strings`
computes what smartdenovo_tpu/ops/swdp.py's does, with array operations
in place of its per-base loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from .traceback import rle_moves, tb_banded

NEG_INF = -(1 << 28)
DIAG, UP, LEFT, STOP = 1, 2, 3, 0


def banded_align(a, b, alen, blen, base, *, LA: int, W: int = 256,
                 match: int = 2, mismatch: int = -5, gap: int = -3,
                 gap_a: int | None = None, gap_b: int | None = None,
                 semiglobal_b: bool = False, return_rowmax: bool = False):
    """Returns (score [B] i32, end_col [B] i32, dirs [B, LA+1, W] u8,
    mvs [T, B] i8, j_final [B] i32) with T = 2 (LA + 1) + W.

    a [B, LA] u8 read codes (4 = N or pad), b [B, LB] u8 window codes,
    alen, blen [B] i32, base [B, LA+1] i32 leftmost band column per row
    (non-decreasing).  score, end_col and the rows 0..alen of dirs are the
    JAX function's (later rows are unspecified); mvs and j_final are
    JAX's `tb_banded_device` from (alen, end_col): move codes DIAG 1, UP
    2, LEFT 3, 0 once done.  return_rowmax (wtext's per-row best cell)
    appends (rmax, rcol) [B, LA+1] i32: per row the first maximum of H
    over the band lanes with 0 <= col <= blen and its column; a row with
    every lane masked, and every row past alen, gives NEG_INF at base."""
    gap_a = gap if gap_a is None else gap_a
    gap_b = gap if gap_b is None else gap_b
    kw = dict(LA=LA, W=W, match=match, mismatch=mismatch, gap_a=gap_a,
              gap_b=gap_b, semiglobal_b=semiglobal_b)
    if a.device.type == "cuda":
        return _banded_cuda(a, b, alen, blen, base,
                            return_rowmax=return_rowmax, **kw)
    if a.device.type == "cpu":
        out = banded_align_plain(a, b, alen, blen, base,
                                 return_rowmax=return_rowmax, **kw)
        score, end_col, dirs = out[:3]
        mvs, j_final = tb_banded(dirs, base, alen, end_col,
                                 T=2 * (LA + 1) + W)
        return (score, end_col, dirs, mvs, j_final) + tuple(out[3:])
    raise ValueError(f"banded_align: unsupported device {a.device}")


def banded_align_plain(a, b, alen, blen, base, *, LA, W, match, mismatch,
                       gap_a, gap_b, semiglobal_b, return_rowmax=False):
    """Plain PyTorch version of the DP: one row of the JAX scan per loop
    turn over [B, W].  Rows past a read's alen are masked as in JAX;
    rows past the batch's largest alen are skipped (their dirs stay 0).
    The in-row gap lane, S[c] = max_{k<=c} m[k] + gap_b (c - k), is
    gap_b c + cummax(m[k] - gap_b k).  Returns (score, end_col, dirs) and,
    with return_rowmax, (rmax, rcol)."""
    B = a.shape[0]
    LB = b.shape[1]
    dev = a.device
    i32 = torch.int32
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    ai = a.to(i32)
    bi = b.to(torch.int64)
    alen = alen.to(i32)
    blen_c = blen.to(i32)[:, None]
    base = base.to(i32)
    c_match = torch.tensor(match, dtype=i32, device=dev)
    c_mismatch = torch.tensor(mismatch, dtype=i32, device=dev)
    u8 = torch.uint8
    c_diag, c_up, c_left, c_stop = (torch.tensor(v, dtype=u8, device=dev)
                                    for v in (DIAG, UP, LEFT, STOP))

    def shifted(x, idx):
        ok = (idx >= 0) & (idx < W)
        return torch.where(ok, torch.gather(x, 1, idx.clamp(0, W - 1).long()),
                           neg)

    j = base[:, 0:1] + lanes
    ok = (j >= 0) & (j <= blen_c)
    h = torch.zeros_like(j) if semiglobal_b else gap_b * j
    h = torch.where(ok, h, neg)
    if semiglobal_b:
        d = torch.zeros((B, W), dtype=u8, device=dev)
    else:
        d = torch.where(j == 0, c_stop, c_left)
        d = torch.where(ok, d, c_stop)
    rows = max(0, min(int(alen.max()) if B else 0, LA))
    dirs = torch.zeros((B, LA + 1, W), dtype=u8, device=dev)
    dirs[:, 0] = d
    hs = [h] if return_rowmax else None
    hold = h
    ramp = gap_b * lanes
    for i in range(1, rows + 1):
        bs = base[:, i:i + 1]
        j = bs + lanes
        idx_up = lanes + (bs - base[:, i - 1:i])
        up = shifted(h, idx_up)
        dg = shifted(h, idx_up - 1)
        ac = ai[:, i - 1:i]
        bc = torch.gather(bi, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        sub = torch.where((ac == bc) & (ac < 4), c_match, c_mismatch)
        t_dg = dg + sub
        t_up = up + gap_a
        m = torch.maximum(t_dg, t_up)
        dirm = torch.where(t_dg >= t_up, c_diag, c_up)
        at0 = j == 0
        m = torch.where(at0, torch.full_like(m, gap_a * i), m)
        dirm = torch.where(at0, c_up, dirm)
        okij = (j >= 0) & (j <= blen_c) & (i <= alen)[:, None]
        m = torch.where(okij, m, neg)
        s = torch.cummax(m - ramp, dim=1).values + ramp
        d = torch.where(s > m, c_left, dirm)
        d = torch.where(okij & (s > NEG_INF // 2), d, c_stop)
        h = torch.where(okij, s, neg)
        hold = torch.where((alen == i)[:, None], h, hold)
        dirs[:, i] = d
        if return_rowmax:
            hs.append(h)
    bidx = torch.arange(B, device=dev)
    last_base = base[bidx, alen.long()]
    if semiglobal_b:
        cols = last_base[:, None] + lanes
        masked = torch.where((cols >= 0) & (cols <= blen_c), hold, neg)
        lane_end = torch.argmax(masked, dim=1)          # first maximum
        score = masked[bidx, lane_end]
        end_col = last_base + lane_end.to(i32)
    else:
        lane_end = blen.to(i32) - last_base
        score = hold[bidx, lane_end.clamp(0, W - 1).long()]
        score = torch.where((lane_end >= 0) & (lane_end < W), score, neg)
        end_col = blen.to(i32).clone()
    if not return_rowmax:
        return score, end_col, dirs
    hs += [torch.full((B, W), NEG_INF, dtype=i32, device=dev)] * (LA - rows)
    hrows = torch.stack(hs, dim=1)                      # [B, LA+1, W]
    cols = base[:, :, None] + lanes[None]
    okc = (cols >= 0) & (cols <= blen_c[:, :, None])
    masked = torch.where(okc, hrows, neg)
    rlane = torch.argmax(masked, dim=2, keepdim=True)
    return (score, end_col, dirs, torch.gather(masked, 2, rlane)[:, :, 0],
            torch.gather(cols, 2, rlane)[:, :, 0])


def _banded_cuda(a, b, alen, blen, base, *, LA, W, match, mismatch, gap_a,
                 gap_b, semiglobal_b, return_rowmax=False):
    B, LB = b.shape
    dev = a.device
    if (a.dtype != torch.uint8 or b.dtype != torch.uint8
            or alen.dtype != torch.int32 or blen.dtype != torch.int32
            or base.dtype != torch.int32):
        raise ValueError("banded_align: dtypes must be u8, u8, i32, i32, i32")
    if (tuple(a.shape) != (B, LA) or tuple(alen.shape) != (B,)
            or tuple(blen.shape) != (B,) or tuple(base.shape) != (B, LA + 1)
            or LA < 1 or LB < 1):
        raise ValueError(f"banded_align: bad shapes {tuple(a.shape)} "
                         f"{tuple(b.shape)} {tuple(alen.shape)} "
                         f"{tuple(blen.shape)} {tuple(base.shape)}")
    if W % 32 or not 32 <= W <= 256:
        raise ValueError(f"banded_align: W={W} must be a multiple of 32 up "
                         f"to 256")
    if not (-128 <= match <= 127 and -128 <= mismatch <= 127):
        raise ValueError("banded_align: match and mismatch must fit in int8 "
                         "(the kernel's score table holds bytes)")
    if any(t.device != dev for t in (b, alen, blen, base)):
        raise ValueError("banded_align: inputs on different devices")
    a, b, alen, blen, base = (t.contiguous() for t in (a, b, alen, blen, base))
    T = 2 * (LA + 1) + W
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_col = torch.empty(B, dtype=torch.int32, device=dev)
    j_final = torch.empty(B, dtype=torch.int32, device=dev)
    mvs = torch.empty((T, B), dtype=torch.int8, device=dev)
    dirs = torch.empty((B, LA + 1, W), dtype=torch.uint8, device=dev)
    extra = ()
    if return_rowmax:
        extra = tuple(torch.empty((B, LA + 1), dtype=torch.int32, device=dev)
                      for _ in range(2))
    if B == 0:
        return (score, end_col, dirs, mvs, j_final) + extra
    lib = _build.lib()
    _build.LAUNCHES["banded"] += 1
    _build.check(lib.banded_align_tb(
        a.data_ptr(), b.data_ptr(), alen.data_ptr(), blen.data_ptr(),
        base.data_ptr(), B, LA, LB, W, T, match, mismatch, gap_a, gap_b,
        int(semiglobal_b), dirs.data_ptr(), score.data_ptr(),
        end_col.data_ptr(), mvs.data_ptr(), j_final.data_ptr(),
        *(t.data_ptr() for t in extra) if extra else (None, None),
        _build.stream_of(a)), "banded_align_tb")
    return (score, end_col, dirs, mvs, j_final) + extra


def make_band_centers(anchors_list, alens, blens, LA: int, W: int) -> np.ndarray:
    """Build per-row leftmost band columns from (a_pos, b_pos) anchors.

    anchors_list: per pair, array [(a_pos, b_pos), ...] (may be empty).
    Endpoints (0,0) and (alen, blen) are always included; centers are the
    piecewise-linear interpolation, clamped so the band stays in range.
    """
    B = len(anchors_list)
    base = np.zeros((B, LA + 1), np.int32)
    rows = np.arange(LA + 1)
    for i, anc in enumerate(anchors_list):
        al, bl = int(alens[i]), int(blens[i])
        pts = sorted((int(x), int(y)) for x, y in anc if 0 <= x <= al and 0 <= y <= bl)
        xs, ys = [], []
        lastx = -1
        for x, y in pts:
            if x <= lastx:
                continue
            xs.append(x)
            ys.append(y)
            lastx = x
        if not xs:
            xs, ys = [0, al], [0, bl]
        else:
            # extrapolate the chain's diagonal to the sequence ends instead of
            # pinning (0,0)/(al,bl): the window may extend past the read span
            if xs[0] > 0:
                xs.insert(0, 0)
                ys.insert(0, ys[0] - xs[1])
            if xs[-1] < al:
                ys.append(ys[-1] + (al - xs[-1]))
                xs.append(al)
        center = np.interp(np.minimum(rows, al), xs, ys)
        base[i] = np.clip(center.astype(np.int64) - W // 2, -(W - 1), max(0, bl))
        # monotone non-decreasing so shifts are >= 0
        np.maximum.accumulate(base[i], out=base[i])
    return base


def traceback_banded(mvs: np.ndarray, j_final: np.ndarray):
    """CIGARs from `banded_align`'s move stream (host run-length encode).

    mvs [T, B] i8 and j_final [B] as numpy.  Returns (cigars, b_beg): per
    pair (ops, counts) run-length lists with ops M/I/D (I consumes a/row,
    D consumes b/col), and the column in b where the alignment starts
    (meaningful for semiglobal_b)."""
    code2op = {DIAG: "M", UP: "I", LEFT: "D"}
    out = [rle_moves(mvs[:, k], code2op, 0) for k in range(mvs.shape[1])]
    return out, np.maximum(np.asarray(j_final, np.int64), 0)


_OP_CODE = {"M": 0, "I": 1, "D": 2}


def align_strings(a_codes, b_codes, ops, counts):
    """Expand a traceback into aligned strings over codes, with '-' = 4:
    M takes the next code of both, I of a only, D of b only."""
    if not len(ops):
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    col = np.repeat(np.array([_OP_CODE[o] for o in ops], np.int8),
                    np.asarray(counts, np.int64))
    ra = np.full(col.size, 4, np.uint8)
    rb = np.full(col.size, 4, np.uint8)
    in_a = col != 2
    in_b = col != 1
    ra[in_a] = np.asarray(a_codes)[np.cumsum(in_a)[in_a] - 1]
    rb[in_b] = np.asarray(b_codes)[np.cumsum(in_b)[in_b] - 1]
    return ra, rb
