"""Score-only banded local DP, the zmo (SW) engine's alignment kernel (port
of smartdenovo_tpu/ops/overlap_dp.py, which is `jax.jit` over `lax.scan`).

A Smith-Waterman local alignment of `a` (rows) against `b` (columns)
inside a W-lane band that follows a linear chain diagonal: the band's
leftmost column in row i is

    clip(qb + (((i - tb) * slope) >> 12) - W/2, -(W-1), max(0, blen))

in int32 arithmetic (the product wraps, the shift is a floor).  Every
cell may restart at 0, which clears its match count; the gap is linear.
The DP keeps no direction matrix and returns, per pair, the best score,
the matches on its path and its end cell (a, b).

`banded_local_dp` dispatches on the tensors' device: on CUDA it launches
a hand-written kernel, csrc/swlocal.cu for W a multiple of 32 up to 256
(the zmo engine's widths; one warp a pair) and csrc/swwide.cu for any
other W up to SWWIDE_MAX_W (wtcyc's 1600; one block a pair); on the CPU
it runs `banded_local_dp_plain`, a row loop in PyTorch that follows the
JAX scan step for step.  Both kernels run only each pair's live rows
(`live_rows`), pairs longest first (`longest_first`), taking the next
pair from a counter; swwide keeps a pair's rows in registers where its
band moves 0 or 1 column a row (`unit_steps`), in a block cut to W
(`swwide_shape`).  `chain_band_params` and `reverse_batch` are copies of
the JAX package's host helpers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

NEG_INF = -(1 << 28)
SLOPE_SHIFT = 12
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
SWWIDE_MAX_W = 4096   # the widest band csrc/swwide.cu takes
SWWIDE_MAX_P = 12     # its lanes a thread (the kernel's template instances)
SWWIDE_MAX_WARPS = 16
# its warps a block where its launch bounds hold fewer: P 10 (W 1600's
# instance) is built for 2 blocks of 10 warps a SM (csrc/swwide.cu max_warps)
SWWIDE_WARP_CAPS = {10: 10}


def chain_band_params(tb, te, qb, qe):
    """Fixed-point linear band parameters from chain extents (host or device).

    The band center follows the chain's global diagonal; the Brownian-
    bridge residual of indel noise over a 10-20kb overlap stays well
    within W/2 = 128 (sigma ~ 30bp at 13% error).
    """
    tb = np.asarray(tb, np.int64)
    te = np.asarray(te, np.int64)
    qb = np.asarray(qb, np.int64)
    qe = np.asarray(qe, np.int64)
    slope = ((qe - qb) << SLOPE_SHIFT) // np.maximum(1, te - tb)
    return tb.astype(np.int32), qb.astype(np.int32), slope.astype(np.int32)


def banded_local_dp(a, b, alen, blen, band_tb, band_qb, band_slope, *,
                    LA: int, W: int = 256, match: int = 2,
                    mismatch: int = -5, gap: int = -3):
    """Returns (best_score, best_mat, end_a, end_b), each [B] int32.

    a [B, LA] u8 and b [B, LB] u8 codes (>= 4 never match), alen, blen,
    band_tb (anchor row), band_qb (anchor column) and band_slope
    (dcol/drow << 12) [B] int32.  end_a is the best cell's row (1-based),
    end_b its column; a pair with no positive cell gives (0, 0, 0, 0)."""
    kw = dict(LA=LA, W=W, match=match, mismatch=mismatch, gap=gap)
    args = (a, b, alen, blen, band_tb, band_qb, band_slope)
    if a.device.type == "cuda":
        return _sw_cuda(*args, **kw)
    if a.device.type == "cpu":
        return banded_local_dp_plain(*args, **kw)
    raise ValueError(f"banded_local_dp: unsupported device {a.device}")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's complement, as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def band_bases(alen, blen, band_tb, band_qb, band_slope, rows: int, W: int):
    """[B, rows + 1] int32: the band's leftmost column of rows 0..rows,
    computed as the JAX function does in int32 (the product and the sum
    wrap; `>>` is an arithmetic shift, i.e. a floor)."""
    dev = alen.device
    i = torch.arange(rows + 1, dtype=torch.int64, device=dev)[None, :]
    d = _wrap32(i - band_tb.to(torch.int64)[:, None])
    prod = _wrap32(d * band_slope.to(torch.int64)[:, None])
    c = _wrap32(band_qb.to(torch.int64)[:, None] + (prod >> SLOPE_SHIFT))
    c = _wrap32(c - W // 2)
    hi = blen.to(torch.int64).clamp(min=0)[:, None]
    return torch.minimum(torch.clamp(c, min=-(W - 1)), hi).to(torch.int32)


def banded_local_dp_plain(a, b, alen, blen, band_tb, band_qb, band_slope, *,
                          LA: int, W: int = 256, match: int = 2,
                          mismatch: int = -5, gap: int = -3):
    """Plain PyTorch version: one row of the JAX scan per loop turn over
    [B, W] int32 tensors.  Rows past a pair's alen can never raise its
    best (every cell is NEG_INF there), so the loop stops at the batch's
    largest min(alen, LA); a pair with alen or blen <= 0 has no cell and
    gives zeros, so only the others enter the loop.  The in-row left scan
    with its match-count payload is a log2(W)-round doubling scan of the
    JAX combine, which keeps the rightmost maximiser."""
    live = (alen > 0) & (blen > 0)
    if not bool(live.all()):
        out = torch.zeros((4, a.shape[0]), dtype=torch.int32, device=a.device)
        idx = torch.nonzero(live)[:, 0]
        if idx.numel():
            res = banded_local_dp_plain(
                a[idx], b[idx], alen[idx], blen[idx], band_tb[idx],
                band_qb[idx], band_slope[idx], LA=LA, W=W, match=match,
                mismatch=mismatch, gap=gap)
            out[:, idx] = torch.stack(res)
        return tuple(out)
    B = a.shape[0]
    LB = b.shape[1]
    dev = a.device
    i32 = torch.int32
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    alen = alen.to(i32)
    blen = blen.to(i32)
    best = torch.zeros(B, dtype=i32, device=dev)
    bmat = torch.zeros(B, dtype=i32, device=dev)
    benda = torch.zeros(B, dtype=i32, device=dev)
    bendb = torch.zeros(B, dtype=i32, device=dev)
    rows = max(0, min(int(alen.max()) if B else 0, LA))
    if rows == 0:
        return best, bmat, benda, bendb
    bases = band_bases(alen, blen, band_tb, band_qb, band_slope, rows, W)
    bl = blen[:, None]
    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    c_match = torch.tensor(match, dtype=i32, device=dev)
    c_mis = torch.tensor(mismatch, dtype=i32, device=dev)
    bi = b.to(torch.int64)
    acodes = a[:, :rows].to(i32)
    h = torch.zeros((B, W), dtype=i32, device=dev)
    hm = torch.zeros((B, W), dtype=i32, device=dev)
    steps = []
    d = 1
    while d < W:
        steps.append((d, lanes >= d, gap * d))
        d *= 2

    def gat(x, idx, fill):
        ok = (idx >= 0) & (idx < W)
        return torch.where(ok, torch.gather(x, 1, idx.clamp(0, W - 1).long()),
                           fill)

    for i in range(1, rows + 1):
        bs = bases[:, i:i + 1]
        j = bs + lanes
        idx_up = lanes + (bs - bases[:, i - 1:i])
        up = gat(h, idx_up, neg)
        upm = gat(hm, idx_up, zero)
        dg = gat(h, idx_up - 1, neg)
        dgm = gat(hm, idx_up - 1, zero)
        ac = acodes[:, i - 1:i]
        bc = torch.gather(bi, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        is_m = (ac == bc) & (ac < 4) & (bc < 4)
        cand_d = dg + torch.where(is_m, c_match, c_mis)
        cand_u = up + gap
        take_d = cand_d >= cand_u
        m = torch.where(take_d, cand_d, cand_u)
        mm = torch.where(take_d, dgm + is_m.to(i32), upm)
        restart = m < 0
        m = torch.where(restart, zero, m)
        mm = torch.where(restart, zero, mm)
        ok = (j >= 1) & (j <= bl) & (i <= alen)[:, None]
        s = torch.where(ok, m, neg)
        sm = mm
        for dd, has, gd in steps:
            cand = torch.cat([s[:, :1].expand(B, dd), s[:, :-dd]], 1) + gd
            take = has & (cand > s)
            s = torch.where(take, cand, s)
            sm = torch.where(take, torch.cat([sm[:, :1].expand(B, dd),
                                              sm[:, :-dd]], 1), sm)
        s = torch.where(ok, s, neg)
        sm = torch.where(ok, sm, zero)
        row_arg = torch.argmax(s, dim=1, keepdim=True)   # first maximum
        row_best = torch.gather(s, 1, row_arg)[:, 0]
        row_mat = torch.gather(sm, 1, row_arg)[:, 0]
        upd = row_best > best
        best = torch.where(upd, row_best, best)
        bmat = torch.where(upd, row_mat, bmat)
        benda = torch.where(upd, torch.full_like(benda, i), benda)
        bendb = torch.where(upd, bs[:, 0] + row_arg[:, 0].to(i32), bendb)
        h = torch.where(s < 0, zero, s)       # local semantics in the carry
        hm = torch.where(h == 0, zero, sm)
    return best, bmat, benda, bendb


def _ceil_div(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return -torch.div(-x, d, rounding_mode="floor")


def _monotone(alen, blen, band_tb, band_qb, band_slope, LA: int, W: int):
    """The inputs as int64 (alen, blen, tb, qb, slope), R = min(alen, LA),
    and mono [B] bool: slope >= 0 and none of band_bases' int32 steps wraps
    over rows 0 .. R (which holds for every row when it holds at both
    ends, each step being monotone), so the band start is non-decreasing."""
    # every step runs on both ends of the pair (rows 0 and R) and on both
    # thresholds at once: a few dozen small ops a call, not a hundred
    al, bl, tb, qb, sl = torch.stack(
        (alen, blen, band_tb, band_qb, band_slope)).to(torch.int64)
    R = al.clamp(max=LA)
    d = torch.stack((torch.zeros_like(R), R.clamp(min=0))) - tb
    p = d * sl
    c = qb + (p >> SLOPE_SHIFT)
    steps = torch.stack((d, p, c, c - W // 2))
    fits = ((steps >= _I32_MIN) & (steps <= _I32_MAX)).flatten(0, 1).all(0)
    return al, bl, tb, qb, sl, R, (sl >= 0) & fits


def unit_steps(alen, blen, band_tb, band_qb, band_slope, LA: int, W: int):
    """[B] bool: the pairs whose band start moves 0 or 1 column from each
    row to the next over rows 0 .. min(alen, LA), so over every live row:
    a monotone band (`_monotone`) with 0 <= slope <= 1 << 12, whose
    unclipped start floor((i - tb) slope / 4096) rises by 0 or 1 a row and
    whose clip keeps that.  csrc/swwide.cu keeps these pairs' rows in
    registers; the others read theirs from shared memory."""
    *_, sl, _R, mono = _monotone(alen, blen, band_tb, band_qb, band_slope,
                                 LA, W)
    return mono & (sl <= 1 << SLOPE_SHIFT)


def live_rows(alen, blen, band_tb, band_qb, band_slope, LA: int, W: int, *,
              match: int = 2, mismatch: int = -5, gap: int = -3):
    """Per pair, the first and last row (i0, i1), [B] int32 each, that can
    change banded_local_dp's outputs (with these scores); (0, -1) for a
    pair with none.

    Rows are 1 .. min(alen, LA); a pair with alen or blen <= 0 has none.
    Where the band start is non-decreasing in the row (`_monotone`), two
    runs of rows are dead:
    - the head, whose band start is clipped to -(W-1): every column is
      <= 0, so the row is masked whole and leaves the carry at zeros, the
      starting state; i0 is the first row whose band reaches column 1;
    - the tail, once a row's band start and the one before it both equal
      blen: the one live column (blen) is its column of the row before
      plus the gap, its diagonal (outside the band) NEG_INF plus match or
      mismatch, or a restart at 0; where gap <= 0 and NEG_INF + match and
      + mismatch are <= 0, it never strictly raises the best, and i1 is
      the last row before that; with other scores the tail stays.
    Any other pair gets the whole range.  Closed forms of band_bases'
    formula in int64: floor(x / 4096) >= T holds iff x >= 4096 T."""
    al, bl, tb, qb, sl, R, mono = _monotone(alen, blen, band_tb, band_qb,
                                            band_slope, LA, W)
    # the head, c(i) > -(W-1): floor((i - tb) sl / 4096) >= T; the tail, the
    # first i whose row i - 1 starts at blen, c(i-1) >= blen: >= U
    th = torch.stack((2 - W + W // 2 - qb, bl + W // 2 - qb))
    first = torch.where(
        sl > 0, tb + _ceil_div(th * (1 << SLOPE_SHIFT), sl.clamp(min=1)),
        torch.where(th <= 0, 0, R + 1)).clamp(min=0)
    i0 = torch.where(mono, first[0].clamp(min=1), 1)
    tail = gap <= 0 and max(match, mismatch) + NEG_INF <= 0
    i1 = torch.where(mono, torch.minimum(R, first[1]), R) if tail else R
    none = (R <= 0) | (bl <= 0) | (i0 > i1)
    i0 = torch.where(none, 0, i0)
    i1 = torch.where(none, -1, i1)
    return i0.to(torch.int32), i1.to(torch.int32)


def longest_first(i0, i1):
    """[B] int32: the pairs in order of live rows, longest first, ties in
    pair order (a stable sort on the pairs' device)."""
    n = (i1.to(torch.int64) - i0 + 1).clamp(min=0)
    return torch.sort(n, descending=True, stable=True).indices.to(torch.int32)


def sw_kernel(W: int) -> str:
    """The kernel that banded_local_dp launches on CUDA at band width W:
    swlocal (one warp a pair) for W a multiple of 32 up to 256, swwide
    (one block a pair) for any other W from 1 to SWWIDE_MAX_W."""
    if W % 32 == 0 and 32 <= W <= 256:
        return "swlocal"
    if 1 <= W <= SWWIDE_MAX_W:
        return "swwide"
    raise ValueError(f"banded_local_dp: W={W} must be 1 to {SWWIDE_MAX_W}")


def swwide_shape(W: int) -> tuple[int, int]:
    """(P, warps): csrc/swwide.cu's block at band width W, warps x 32
    threads of P lanes each covering the W lanes: the fewest dead lanes
    (32 P warps - W), then the most lanes a thread (the fewest scan and
    barrier instructions a cell).  W 1600 is 5 warps of 10 lanes."""
    shapes = [(P, -(-W // (32 * P))) for P in range(1, SWWIDE_MAX_P + 1)]
    return min(((P, w) for P, w in shapes
                if w <= SWWIDE_WARP_CAPS.get(P, SWWIDE_MAX_WARPS)),
               key=lambda s: (32 * s[0] * s[1] - W, -s[0]))


def _sw_cuda(a, b, alen, blen, band_tb, band_qb, band_slope, *, LA, W,
             match=2, mismatch=-5, gap=-3):
    """The launch of sw_kernel(W) on the pairs' live rows, longest first."""
    B, LB = b.shape
    dev = a.device
    if a.dtype != torch.uint8 or b.dtype != torch.uint8 or any(
            t.dtype != torch.int32
            for t in (alen, blen, band_tb, band_qb, band_slope)):
        raise ValueError("banded_local_dp: dtypes must be u8, u8 and i32")
    if (tuple(a.shape) != (B, LA) or LA < 1 or LB < 1 or any(
            tuple(t.shape) != (B,)
            for t in (alen, blen, band_tb, band_qb, band_slope))):
        raise ValueError(f"banded_local_dp: bad shapes {tuple(a.shape)} "
                         f"{tuple(b.shape)}")
    kernel = sw_kernel(W)
    # swwide's scan keys hold a score in 26 bits: a row raises the best by
    # at most max(match, mismatch, gap, 0) + max(gap, 0) W
    if kernel == "swwide" and (abs(gap) > SWWIDE_MAX_W or LA * (
            max(match, mismatch, gap, 0) + max(gap, 0) * W) >= 1 << 24):
        raise ValueError("banded_local_dp: swwide takes |gap| <= 4096 and "
                         "scores under 2^24")
    if any(t.device != dev
           for t in (b, alen, blen, band_tb, band_qb, band_slope)):
        raise ValueError("banded_local_dp: inputs on different devices")
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    if B == 0:
        return tuple(out)
    i0, i1 = live_rows(alen, blen, band_tb, band_qb, band_slope, LA, W,
                       match=match, mismatch=mismatch, gap=gap)
    per_pair, shape = [i0, i1], ()
    if kernel == "swwide":
        per_pair.append(unit_steps(alen, blen, band_tb, band_qb, band_slope,
                                   LA, W))
        shape = swwide_shape(W)
    order = longest_first(i0, i1)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    args = [t.contiguous() for t in (a, b, blen, band_tb, band_qb,
                                     band_slope)]
    fn = getattr(_build.lib(), kernel + "_dp")
    _build.LAUNCHES[kernel] += 1
    _build.check(fn(
        *(t.data_ptr() for t in args + per_pair), order.data_ptr(),
        counter.data_ptr(), B, LA, LB, W, *shape, match, mismatch, gap,
        out.data_ptr(), _build.stream_of(a)),
        kernel + "_dp")
    return tuple(out)


def reverse_batch(x: np.ndarray, lens: np.ndarray, pad: int = 4) -> np.ndarray:
    """Reverse each row's first lens[i] entries (host helper)."""
    out = np.full_like(x, pad)
    for i in range(x.shape[0]):
        n = int(lens[i])
        out[i, :n] = x[i, :n][::-1]
    return out
