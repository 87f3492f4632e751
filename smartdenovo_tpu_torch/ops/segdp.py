"""Segment-parallel consensus DP: affine banded alignment of read segments
against consensus windows, with traceback to 2-bit moves (port of
smartdenovo_tpu/ops/segdp.py, which is `jax.jit` over `lax.scan`).

Every read of a unitig is cut into SEGR-row segments; each segment is
aligned against an LBW-column consensus window along a W-lane band whose
base column is given every 16 rows.  Scoring is kswx_refine_alignment's
affine recurrence (E/F lanes open from the diagonal candidate, F strictly
greater), semiglobal in b.

`seg_align_tb` dispatches on the tensors' device: on CUDA it launches the
hand-written kernel of csrc/segdp.cu (one block per segment, the row loop
inside the block); on the CPU it runs `seg_align_tb_plain`, a row loop in
PyTorch that follows the JAX scan step for step, int32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

NEG = -10000

# move codes in the packed traceback stream
MV_M, MV_I, MV_D, MV_NONE = 0, 1, 2, 3


def seg_align_tb(seg_a, seg_b, seg_alen, seg_blen, seg_b16, *, SEGR: int,
                 LBW: int, W: int = 256, T: int = 3072, match: int = 2,
                 mismatch: int = -5, open_i: int = -3, open_d: int = -3,
                 ext: int = -1):
    """Align Bc segments; returns (score [Bc] i32, b_beg [Bc] i32,
    b_end [Bc] i32, mvp [T//4, Bc] u8), laid out as in the JAX package.

    seg_a [Bc, SEGR] u8 read codes (4 = pad), seg_b [Bc, LBW] u8 window
    codes, seg_alen [Bc] i32 rows (0 <= alen <= SEGR), seg_blen [Bc] i32
    window length, seg_b16 [Bc, NB] i16 band base every 16 rows
    (NB > SEGR // 16).  mvp packs 4 moves per byte (bits 2u of byte t),
    the stream stored backwards from (alen, b_end); code 3 = past the
    start.  b_beg / b_end are window-relative columns."""
    kw = dict(SEGR=SEGR, LBW=LBW, W=W, T=T, match=match, mismatch=mismatch,
              open_i=open_i, open_d=open_d, ext=ext)
    if seg_a.device.type == "cuda":
        return _seg_align_cuda(seg_a, seg_b, seg_alen, seg_blen, seg_b16, **kw)
    if seg_a.device.type == "cpu":
        return seg_align_tb_plain(seg_a, seg_b, seg_alen, seg_blen, seg_b16,
                                  **kw)
    raise ValueError(f"seg_align_tb: unsupported device {seg_a.device}")


def _band_bases(b16, blen, SEGR):
    """[Bc, SEGR + 1] i32 per-row band base: the stride-16 samples
    interpolated with floor division (the numerator is negative where the
    base steps down), clipped to the window, then made monotone."""
    NB = b16.shape[1]
    dev = b16.device
    k = torch.arange(SEGR + 1, dtype=torch.int64, device=dev)
    ki = k // 16
    kf = (k % 16).to(torch.int32)
    b32 = b16.to(torch.int32)
    lo = b32[:, ki]
    hi = b32[:, torch.clamp(ki + 1, max=NB - 1)]
    base = lo + torch.div((hi - lo) * kf, 16, rounding_mode="floor")
    base = torch.minimum(torch.clamp(base, min=0),
                         torch.clamp(blen[:, None] - 1, min=0))
    return torch.cummax(base, dim=1).values


def seg_align_tb_plain(seg_a, seg_b, seg_alen, seg_blen, seg_b16, *, SEGR,
                       LBW, W=256, T=3072, match=2, mismatch=-5, open_i=-3,
                       open_d=-3, ext=-1):
    """Plain PyTorch version: one step of the JAX row scan per loop turn
    over [Bc, W], then the traceback state machine over [Bc].  Rows past
    a segment's alen are masked as in JAX; rows past the batch's largest
    alen are skipped (the traceback never reads them).  The padding
    segments of a batch (alen 0) run apart from the others, with no rows."""
    kw = dict(SEGR=SEGR, LBW=LBW, W=W, T=T, match=match, mismatch=mismatch,
              open_i=open_i, open_d=open_d, ext=ext)
    args = (seg_a, seg_b, seg_alen, seg_blen, seg_b16)
    live = seg_alen > 0
    if bool(live.all()) or not bool(live.any()):
        return _plain_rows(*args, **kw)
    parts = [(sel, _plain_rows(*(x[sel] for x in args), **kw))
             for sel in (live, ~live)]
    out = [torch.empty((seg_alen.shape[0],), dtype=torch.int32,
                       device=seg_a.device) for _ in range(3)]
    out.append(torch.empty((T // 4, seg_alen.shape[0]), dtype=torch.uint8,
                           device=seg_a.device))
    for sel, res in parts:
        for k in range(3):
            out[k][sel] = res[k]
        out[3][:, sel] = res[3]
    return tuple(out)


def _plain_rows(seg_a, seg_b, seg_alen, seg_blen, seg_b16, *, SEGR, LBW, W,
                T, match, mismatch, open_i, open_d, ext):
    Bc = seg_alen.shape[0]
    dev = seg_a.device
    i32 = torch.int32
    negc = torch.tensor(NEG, dtype=i32, device=dev)
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    ai = seg_a.to(i32)
    bi = seg_b.to(torch.int64)
    alen = seg_alen.to(i32)
    blen = seg_blen.to(i32)[:, None]
    base = _band_bases(seg_b16, seg_blen.to(i32), SEGR)
    Tp = T // 4

    def shifted(x, idx):
        ok = (idx >= 0) & (idx < W)
        return torch.where(ok, torch.gather(x, 1, idx.clamp(0, W - 1).long()),
                           negc)

    # row 0: semiglobal in b — H = 0 across the whole band
    j0 = base[:, 0:1] + lanes
    h = torch.where((j0 >= 0) & (j0 <= blen), torch.zeros_like(j0), negc)
    e = torch.full((Bc, W), NEG, dtype=i32, device=dev)
    hold = h.clone()
    rows = int(alen.max()) if Bc else 0
    rows = max(0, min(rows, SEGR))
    dirs = torch.zeros((rows + 1, Bc, W), dtype=torch.uint8, device=dev)
    ramp = lanes * ext                          # ext * k for the F scan
    neg_col = torch.full((Bc, 1), NEG, dtype=i32, device=dev)
    c_match = torch.tensor(match, dtype=i32, device=dev)
    c_mismatch = torch.tensor(mismatch, dtype=i32, device=dev)
    for i in range(1, rows + 1):
        bs = base[:, i:i + 1]
        shift = bs - base[:, i - 1:i]
        j = bs + lanes
        idx_up = lanes + shift
        hdg = shifted(h, idx_up - 1)
        eup = shifted(e, idx_up)
        ac = ai[:, i - 1:i]
        bc = torch.gather(bi, 1, (j - 1).clamp(0, LBW - 1).long()).to(i32)
        sub = torch.where((ac == bc) & (ac < 4) & (bc < 4), c_match,
                          c_mismatch)
        okj = (j >= 1) & (j <= blen)
        m = torch.where(okj, hdg + sub, negc)
        d = (m < eup).to(torch.uint8)
        hh = torch.maximum(m, eup)
        # F lane: s_k = max_{k' <= k}(v_k' + ext (k - k')) =
        # cummax(v - ext k) + ext k, shifted right by one with NEG in lane 0
        v = m + (open_d + ext)
        s = torch.cummax(v - ramp, dim=1).values + ramp
        f = torch.cat([neg_col, s[:, :-1]], dim=1)
        use_f = f > hh
        d = torch.where(use_f, torch.full_like(d, 2), d)
        hh = torch.maximum(hh, f)
        e_ext = eup + ext
        e_open = m + (open_i + ext)
        d = d | ((e_ext > e_open).to(torch.uint8) << 2)
        e_next = torch.maximum(e_ext, e_open)
        f1 = torch.cat([neg_col, v[:, :-1]], dim=1)
        d = d | ((f > f1).to(torch.uint8) << 5)
        oki = (i <= alen)[:, None]
        h = torch.where(okj & oki, hh, negc)
        e = torch.where(oki, e_next, negc)
        hold = torch.where((alen == i)[:, None], h, hold)
        dirs[i] = d

    bidx = torch.arange(Bc, device=dev)
    last_base = base[bidx, alen.long()]
    cols = last_base[:, None] + lanes
    okc = (cols >= 0) & (cols <= blen)
    masked = torch.where(okc, hold, negc)
    lane_end = torch.argmax(masked, dim=1)          # first maximum
    score = masked[bidx, lane_end]
    end_col = last_base + lane_end.to(i32)

    # traceback (kswx state machine, semiglobal stop at row 0)
    i = alen.clone()
    j = end_col.clone()
    state = torch.zeros(Bc, dtype=i32, device=dev)
    done = i <= 0
    mvp = torch.full((Tp, Bc), 0xFF, dtype=torch.uint8, device=dev)
    c_i = torch.tensor(MV_I, dtype=i32, device=dev)
    c_none = torch.tensor(MV_NONE, dtype=i32, device=dev)
    for t in range(Tp):
        if t % 16 == 0 and bool(done.all()):
            break              # every later move is NONE: bytes stay 0xFF
        mv4 = torch.zeros(Bc, dtype=i32, device=dev)
        for u in range(4):
            ic = i.clamp(0, SEGR).long()
            lane = j - base[bidx, ic]
            inband = (lane >= 0) & (lane < W)
            z = torch.where(inband & ~done,
                            dirs[ic.clamp(max=rows), bidx,
                                 lane.clamp(0, W - 1).long()].to(i32), 0)
            mv = (z >> (2 * state)) & 3
            mv = torch.where(j <= 0, c_i, mv)
            mv = torch.where((i <= 0) | done, c_none, mv)
            i = i - ((mv == MV_M) | (mv == MV_I)).to(i32)
            j = j - ((mv == MV_M) | (mv == MV_D)).to(i32)
            state = torch.where(mv == MV_NONE, state, mv)
            done = done | (i <= 0)
            mv4 = mv4 | (mv << (2 * u))
        mvp[t] = mv4.to(torch.uint8)
    return score, torch.clamp(j, min=0), end_col, mvp


def _seg_align_cuda(seg_a, seg_b, seg_alen, seg_blen, seg_b16, *, SEGR, LBW,
                    W, T, match, mismatch, open_i, open_d, ext):
    Bc = seg_alen.shape[0]
    NB = seg_b16.shape[-1]
    dev = seg_a.device
    if (seg_a.dtype != torch.uint8 or seg_b.dtype != torch.uint8
            or seg_alen.dtype != torch.int32 or seg_blen.dtype != torch.int32
            or seg_b16.dtype != torch.int16):
        raise ValueError("seg_align_tb: dtypes must be u8, u8, i32, i32, i16")
    if (tuple(seg_a.shape) != (Bc, SEGR) or tuple(seg_b.shape) != (Bc, LBW)
            or tuple(seg_blen.shape) != (Bc,)
            or tuple(seg_b16.shape) != (Bc, NB) or NB <= SEGR // 16):
        raise ValueError(f"seg_align_tb: bad shapes {tuple(seg_a.shape)} "
                         f"{tuple(seg_b.shape)} {tuple(seg_alen.shape)} "
                         f"{tuple(seg_blen.shape)} {tuple(seg_b16.shape)}")
    if W % 32 or not 32 <= W <= 1024 or T % 4 or SEGR < 1 or LBW < 1:
        raise ValueError(f"seg_align_tb: W={W} must be a multiple of 32 in "
                         f"[32, 1024], T={T} a multiple of 4")
    if any(t.device != dev for t in (seg_b, seg_alen, seg_blen, seg_b16)):
        raise ValueError("seg_align_tb: inputs on different devices")
    seg_a, seg_b, seg_alen, seg_blen, seg_b16 = (
        t.contiguous() for t in (seg_a, seg_b, seg_alen, seg_blen, seg_b16))
    score = torch.empty(Bc, dtype=torch.int32, device=dev)
    b_beg = torch.empty(Bc, dtype=torch.int32, device=dev)
    b_end = torch.empty(Bc, dtype=torch.int32, device=dev)
    mvp = torch.empty((T // 4, Bc), dtype=torch.uint8, device=dev)
    if Bc == 0:
        return score, b_beg, b_end, mvp
    dirs = torch.empty((Bc, SEGR, W), dtype=torch.uint8, device=dev)
    lib = _build.lib()
    _build.LAUNCHES["segdp"] += 1
    _build.check(lib.segdp_align_tb(
        seg_a.data_ptr(), seg_b.data_ptr(), seg_alen.data_ptr(),
        seg_blen.data_ptr(), seg_b16.data_ptr(), Bc, SEGR, LBW, NB, W, T,
        match, mismatch, open_i, open_d, ext, dirs.data_ptr(),
        score.data_ptr(), b_beg.data_ptr(), b_end.data_ptr(), mvp.data_ptr(),
        _build.stream_of(seg_a)), "segdp_align_tb")
    return score, b_beg, b_end, mvp


def unpack_moves(mvp: np.ndarray) -> np.ndarray:
    """[C, Tp, Bc] packed bytes -> [C, 4*Tp, Bc] 2-bit move codes."""
    C, Tp, Bc = mvp.shape
    out = np.empty((C, Tp, 4, Bc), np.uint8)
    for u in range(4):
        out[:, :, u] = (mvp >> (2 * u)) & 3
    return out.reshape(C, 4 * Tp, Bc)


def moves_to_cigar(mv_col: np.ndarray):
    """One segment's backward move stream -> forward (ops, counts) lists."""
    mv = mv_col[mv_col != MV_NONE][::-1]
    if mv.size == 0:
        return [], []
    cut = np.nonzero(np.diff(mv))[0]
    starts = np.concatenate([[0], cut + 1])
    ends = np.concatenate([cut + 1, [mv.size]])
    ops = ["MID"[int(mv[s])] for s in starts]
    counts = [int(e - s) for s, e in zip(starts, ends)]
    return ops, counts
