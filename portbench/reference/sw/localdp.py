"""The SW engine's scoring of a batch's chains: a plain copy of
`sw_align_batch` (the top C chains of each query, their sequences
strand-flipped, the band from the chain's extents, a forward and a
reversed pass) over the banded local DP's row loop, in PyTorch on the
tensors' device.

The DP: a Smith-Waterman alignment of `a` (rows) against `b` (columns)
inside a W-lane band whose leftmost column in row i is

    clip(qb + (((i - tb) * slope) >> 12) - W/2, -(W-1), max(0, blen))

in int32 arithmetic; every cell may restart at 0, which clears its match
count; the gap is linear.  Per pair: the best score (the first row that
reaches it, the first lane of that row), the matches on its path and its
end cell."""

from __future__ import annotations

import torch

NEG_INF = -(1 << 28)
SLOPE_SHIFT = 12


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def band_bases(blen, band_tb, band_qb, band_slope, rows: int, W: int):
    """[B, rows + 1] int32: the band's leftmost column of rows 0..rows,
    in int32 arithmetic (the product and sums wrap, `>>` floors)."""
    i = torch.arange(rows + 1, dtype=torch.int64, device=blen.device)[None, :]
    d = _wrap32(i - band_tb.to(torch.int64)[:, None])
    prod = _wrap32(d * band_slope.to(torch.int64)[:, None])
    c = _wrap32(band_qb.to(torch.int64)[:, None] + (prod >> SLOPE_SHIFT))
    c = _wrap32(c - W // 2)
    hi = blen.to(torch.int64).clamp(min=0)[:, None]
    return torch.minimum(torch.clamp(c, min=-(W - 1)), hi).to(torch.int32)


def local_dp(a, b, alen, blen, band_tb, band_qb, band_slope, *, LA: int,
             W: int, match: int, mismatch: int, gap: int):
    """(best, mat, end_a, end_b), [B] int32 each; a pair with no cell
    (alen or blen <= 0) or no positive cell gives zeros.  One row a loop
    turn over [B, W]; the in-row left scan, which carries the match count
    of its rightmost maximiser, is a doubling scan."""
    B = a.shape[0]
    dev = a.device
    i32 = torch.int32
    out = torch.zeros((4, B), dtype=i32, device=dev)
    live = torch.nonzero((alen > 0) & (blen > 0))[:, 0]
    if live.numel() == 0:
        return tuple(out)
    a, b, alen, blen = a[live], b[live], alen[live].to(i32), blen[live].to(i32)
    band_tb, band_qb, band_slope = (band_tb[live], band_qb[live],
                                    band_slope[live])
    n, LB = b.shape
    rows = min(int(alen.max()), LA)
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    bases = band_bases(blen, band_tb, band_qb, band_slope, rows, W)
    zero, neg, c_match, c_mis, c_gap = (
        torch.tensor(v, dtype=i32, device=dev)
        for v in (0, NEG_INF, match, mismatch, gap))
    best = torch.zeros(n, dtype=i32, device=dev)
    bmat = torch.zeros(n, dtype=i32, device=dev)
    benda = torch.zeros(n, dtype=i32, device=dev)
    bendb = torch.zeros(n, dtype=i32, device=dev)
    h = torch.zeros((n, W), dtype=i32, device=dev)
    hm = torch.zeros((n, W), dtype=i32, device=dev)
    ramp = gap * lanes
    blen_c = blen[:, None]
    for i in range(1, rows + 1):
        bs = bases[:, i:i + 1]
        j = bs + lanes
        # the row before, read at this row's columns j (up) and j - 1
        # (diagonal); off its band it is NEG_INF with no matches
        up_at = lanes + (bs - bases[:, i - 1:i])
        ok_u = (up_at >= 0) & (up_at < W)
        ok_d = (up_at >= 1) & (up_at <= W)
        iu = up_at.clamp(0, W - 1).long()
        idg = (up_at - 1).clamp(0, W - 1).long()
        up = torch.where(ok_u, torch.gather(h, 1, iu), neg)
        upm = torch.where(ok_u, torch.gather(hm, 1, iu), zero)
        dg = torch.where(ok_d, torch.gather(h, 1, idg), neg)
        dgm = torch.where(ok_d, torch.gather(hm, 1, idg), zero)
        ac = a[:, i - 1:i].to(i32)
        bc = torch.gather(b, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        is_m = (ac == bc) & (ac < 4) & (bc < 4)
        cand_d = dg + torch.where(is_m, c_match, c_mis)
        cand_u = up + c_gap
        take_d = cand_d >= cand_u
        m = torch.where(take_d, cand_d, cand_u)
        mm = torch.where(take_d, dgm + is_m.to(i32), upm)
        restart = m < 0
        m = torch.where(restart, zero, m)
        mm = torch.where(restart, zero, mm)
        ok = (j >= 1) & (j <= blen_c) & (i <= alen)[:, None]
        # the in-row left gap: s[c] = max over k <= c of m[k] + gap (c - k),
        # carrying the matches of its rightmost maximiser (cummax keeps
        # the last index of equal maxima)
        run = torch.cummax(torch.where(ok, m, neg) - ramp, dim=1)
        s = torch.where(ok, run.values + ramp, neg)
        sm = torch.where(ok, torch.gather(mm, 1, run.indices), zero)
        arg = torch.argmax(s, dim=1, keepdim=True)
        row_best = torch.gather(s, 1, arg)[:, 0]
        upd = row_best > best
        best = torch.where(upd, row_best, best)
        bmat = torch.where(upd, torch.gather(sm, 1, arg)[:, 0], bmat)
        benda = torch.where(upd, torch.full_like(benda, i), benda)
        bendb = torch.where(upd, bs[:, 0] + arg[:, 0].to(i32), bendb)
        h = torch.where(s < 0, zero, s)
        hm = torch.where(h == 0, zero, sm)
    out[:, live] = torch.stack([best, bmat, benda, bendb])
    return tuple(out)


def sw_tail(pair_id, dm_score, dm_tb, dm_te, dm_qb, dm_qe, csorted, qbatch,
            qlens, flat_bases, read_offs, read_lens, *, Q: int, A: int,
            C: int, Ltier: int, W: int, match: int, mismatch: int, gap: int):
    """The SW engine's pack of one batch without its budget totals: cand,
    dir, chain score, score, mat, beg_a, end_a, beg_b, end_b, [Q*C]
    int32 each, from the dot matrix's rows (pair_id, score, tb, te, qb,
    qe), the sorted candidates [Q, A], the query codes [Q, Ltier] and the
    flat bank.  The top C chains of a query take the lower slot first on
    a tie, the strand is 0 on a tie, the slope is a floor division."""
    dev = pair_id.device
    i32 = torch.int32
    NP2 = Q * A * 2
    pid = torch.clamp(pair_id, max=NP2).to(torch.int64)
    hits = torch.zeros(NP2 + 1, dtype=i32, device=dev)
    hits.index_add_(0, pid, torch.ones_like(pid, dtype=i32))
    if bool((hits[:NP2] > 1).any()):
        raise AssertionError("sw_tail: duplicate live pair ids")

    def dense(v):
        out = torch.zeros(NP2 + 1, dtype=i32, device=dev)
        out[pid] = v.to(i32)
        return out[:NP2].reshape(Q, A, 2)

    ds = dense(dm_score)
    dtb, dte, dqb, dqe = (dense(v) for v in (dm_tb, dm_te, dm_qb, dm_qe))
    bdir = (ds[:, :, 1] > ds[:, :, 0]).to(i32)
    order = torch.sort(ds.max(dim=2).values, dim=1, descending=True,
                       stable=True)
    top_val = order.values[:, :C]
    slot = order.indices[:, :C]
    valid = top_val > 0
    qidx = torch.arange(Q, device=dev)[:, None].expand(Q, C)
    cand = torch.where(valid, csorted[qidx, slot].to(i32), -1).reshape(-1)
    q_l, sl = qidx.reshape(-1), slot.reshape(-1)
    dr = bdir[qidx, slot].reshape(-1)
    validf = valid.reshape(-1)
    drl = dr.long()
    tb, te = dtb[q_l, sl, drl], dte[q_l, sl, drl]
    qb, qe = dqb[q_l, sl, drl], dqe[q_l, sl, drl]
    a = qbatch[q_l]
    alen = qlens[q_l].to(i32)
    candc = cand.clamp(0, read_lens.shape[0] - 1).long()
    blen = torch.where(validf, read_lens[candc].to(i32), 0)
    lanes = torch.arange(Ltier, dtype=i32, device=dev)[None, :]
    pos = read_offs[candc].to(i32)[:, None] + lanes
    inb = lanes < blen[:, None]
    four = torch.tensor(4, dtype=torch.uint8, device=dev)
    bfwd = torch.where(
        inb, flat_bases[pos.clamp(0, flat_bases.shape[0] - 1).long()], four)
    del pos
    ridx = (blen[:, None] - 1 - lanes).clamp(0, Ltier - 1).long()
    brev = torch.where(inb, 3 - torch.gather(bfwd, 1, ridx), four)
    b = torch.where((dr == 1)[:, None], brev, bfwd)
    del bfwd, brev
    slope = torch.div((qe - qb) << SLOPE_SHIFT, torch.clamp(te - tb, min=1),
                      rounding_mode="floor").clamp(1, 4 << SLOPE_SHIFT)
    slope = slope.to(i32)
    aridx = (alen[:, None] - 1 - lanes).clamp(0, Ltier - 1).long()
    ar = torch.where(lanes < alen[:, None], torch.gather(a, 1, aridx), four)
    del aridx
    br = torch.where(inb, torch.gather(b, 1, ridx), four)
    del ridx, inb
    n = q_l.shape[0]
    sc, mt, ea, eb = local_dp(
        torch.cat([a, ar]), torch.cat([b, br]), torch.cat([alen, alen]),
        torch.cat([blen, blen]), torch.cat([tb, alen - te]),
        torch.cat([qb, blen - qe]), torch.cat([slope, slope]), LA=Ltier, W=W,
        match=match, mismatch=mismatch, gap=gap)
    return torch.cat([cand, dr, top_val.reshape(-1).to(i32), sc[:n], mt[:n],
                      alen - ea[n:], ea[:n], blen - eb[n:], eb[:n]])
