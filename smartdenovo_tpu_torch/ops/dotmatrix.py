"""Dot-matrix overlap alignment (port of smartdenovo_tpu/ops/dotmatrix.py:
the index-sweep and sort-join z-mer matchers and `dot_matrix_align`).

Seed pairs of a batch of (query, candidate) pairs are produced by one of
two matchers, then grouped into diagonal blocks, merged by single
linkage into windows and chained per pair by an O(nb^2) DP
(hzm_aln.h:721-1181).  The segment reductions run through K1
(ops/sseg.py); the join matcher's post-sort phase through K2 and K3
(ops/jpost.py, ops/pexpand.py).  Semantics, budgets and field layouts
are the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .flatops import (arange32, cumsum32, expand_ranges, lexsort_perm,
                      scatter_set, segment_sum, shift_left, shift_right)
from .flatseeds import RM_BLK
from .jpost import join_emitters
from .pexpand import expand_emit
from .sseg import BLOCK_OPS, DEFAULT_OPS, seg_reduce_compact

I32 = torch.int32
INT32_MAX = 0x7FFFFFFF
NEG_BIG = -1000000


class PairBatch(NamedTuple):
    pair_id: torch.Tensor   # [PB] int32 = ((q*A + slot)*2 + dir), BIGP if dead
    o1l1: torch.Tensor      # [PB] int32 query raw offset<<8 | span
    o2l2: torch.Tensor      # [PB] int32 candidate offset<<8 | span (flipped)
    match_cnt: torch.Tensor  # [Q*A*2] int32 (filled by dot_matrix_align)
    total: torch.Tensor     # 0-d: pairs before pair-budget truncation
    expand_total: torch.Tensor  # 0-d: expansion size before budget


def _zeros(n, dev):
    return torch.zeros(n, dtype=I32, device=dev)


# ---------------------------------------------------------------------------
# z-mer matchers
# ---------------------------------------------------------------------------


def extract_zmer_pairs_join(qz, qdir, qoff, qspan, qvalid, cands_sorted,
                            rm_zsd, rm_pk, rm_start, read_lens, *,
                            expand_budget: int, pair_budget: int, kvar: int = 2,
                            zbits: int = 20, max_per_read: int = 16,
                            qprobe_budget: int = 0) -> PairBatch:
    """Per-pair z-mer intersection via one global sort (sort-join matcher).

    1. expand every (query, candidate) pair into the candidate's RM_BLK-
       aligned read-major posting slice, at block granularity;
    2. one stable sort of [query entries + candidate entries] keyed by
       (query, zmer, side) puts each zmer's query occurrences first;
    3. K2 counts each candidate entry's query occurrences and K3 emits the
       n x m co-occurrences.
    The per-read occurrence cap (hzm_aln.h:107) drops query (read, zmer)
    groups with >= max_per_read occurrences."""
    dev = qz.device
    Q, L = qz.shape
    A = cands_sorted.shape[1]
    assert Q * (1 << (zbits + 1)) < (1 << 31), "key packing overflow: shrink Q or zsize"
    assert expand_budget % RM_BLK == 0, "expand budget must be RM_BLK-aligned"
    R = read_lens.shape[0]
    BIGP = Q * A * 2
    ZS = 1 << zbits

    # ---- phase 1: expand candidate posting slices (block granularity) ----
    c = cands_sorted.clamp(0, R - 1)
    cvalid = (cands_sorted >= 0) & (cands_sorted < R)
    cstart = torch.where(cvalid, rm_start[c], 0).reshape(-1)
    asz = torch.where(cvalid, rm_start[c + 1] - rm_start[c], 0).reshape(-1)
    n1 = asz.shape[0]
    NB1 = expand_budget // RM_BLK
    bsrc, bwithin, balive, btot = expand_ranges(asz // RM_BLK, NB1)
    rows = torch.where(balive, cstart[bsrc] // RM_BLK + bwithin, 0)
    zsd = rm_zsd.reshape(-1, RM_BLK)[rows].reshape(-1)
    cpk = rm_pk.reshape(-1, RM_BLK)[rows].reshape(-1)
    src1c = bsrc[:, None].expand(NB1, RM_BLK).reshape(-1)
    total1 = btot * RM_BLK
    alive1 = (balive[:, None].expand(NB1, RM_BLK).reshape(-1)
              & ((zsd >> 9) < ZS))
    q1 = src1c // A

    # ---- phase 2: global sort join ----
    qpk0 = ((qoff.reshape(-1).to(I32) << 9)
            | (qspan.reshape(-1).clamp(max=255).to(I32) << 1)
            | qdir.reshape(-1).to(I32))
    q_of0 = arange32(Q * L, dev) // L
    qv0 = qvalid.reshape(-1)
    if qprobe_budget:
        QK = qprobe_budget
        qdst = cumsum32(qv0) - 1
        qdst = torch.where(qv0, qdst.clamp(max=QK), QK)
        qpk = scatter_set(QK, qdst, qpk0, 0)
        q_of = scatter_set(QK, qdst, q_of0, Q)
        qzc = scatter_set(QK, qdst, qz.reshape(-1).to(I32), 0)
        qkey = torch.where(q_of < Q, (q_of << (zbits + 1)) | (qzc << 1),
                           INT32_MAX)
        NQ = QK
    else:
        qpk = qpk0
        qkey = torch.where(
            qv0, (q_of0 << (zbits + 1)) | (qz.reshape(-1).to(I32) << 1),
            INT32_MAX)
        NQ = Q * L
    ckey = torch.where(alive1, (q1 << (zbits + 1)) | ((zsd >> 9) << 1) | 1,
                       INT32_MAX)
    key = torch.cat([qkey, ckey])
    perm = torch.sort(key, stable=True).indices
    key = key[perm]
    pay = torch.cat([qpk, cpk])[perm]
    aux = torch.cat([_zeros(NQ, dev), src1c])[perm]
    p2 = arange32(pair_budget, dev)

    # ---- phase 3: emit n x m co-occurrences (K2 + K3) ----
    # Emitters (candidate entries with 1 <= qcnt < max_per_read) own
    # contiguous runs of qcnt output slots.  Emitters past EB are dropped,
    # but then the slot total, which counts every emitter's qcnt, already
    # exceeds pair_budget <= EB and the caller redispatches bigger.
    EB = max(pair_budget, 1 << 14)
    eout, nem, total2 = join_emitters(key, pay, aux, max_per_read=max_per_read,
                                      out_budget=EB)
    cnt_c = torch.where(arange32(EB, dev) < nem, eout[0], 0)
    cg, auxs, bases = expand_emit(cnt_c, eout[1], eout[2], eout[3],
                                  pair_budget=pair_budget)
    alive2 = p2 < total2
    # compact query-payload table: the query entries alone, stably sorted
    qpayc = qpk[torch.sort(qkey, stable=True).indices]
    qg = qpayc[(bases + p2).clamp(0, NQ - 1)]
    qslot2 = auxs.clamp(0, n1 - 1)
    cand2 = c.reshape(-1)[qslot2].clamp(0, R - 1)
    clen2 = read_lens[cand2].to(I32)
    q_span = (qg >> 1) & 0xFF
    p_off = cg >> 9
    p_span = (cg >> 1) & 0xFF
    pairdir = (qg ^ cg) & 1
    o2 = torch.where(pairdir == 1, clen2 - (p_off + p_span), p_off)
    len_ok = alive2 & ((q_span - p_span).abs() <= kvar)
    pair_id = torch.where(len_ok, qslot2 * 2 + pairdir, BIGP)
    return PairBatch(pair_id=pair_id, o1l1=qg >> 1, o2l2=(o2 << 8) | p_span,
                     match_cnt=_zeros(BIGP, dev), total=total2,
                     expand_total=total1)


def extract_zmer_pairs_sweep(qrids, qskip, cands_sorted, rm_zsd, rm_pk, rm_rd,
                             rm_start, read_lens, rm_cnt=None, *,
                             cross_budget: int, occ_budget: int, kvar: int = 2,
                             zbits: int = 20,
                             pair_budget: int | None = None) -> PairBatch:
    """Index-sweep z-mer matcher: sweep the whole posting index once per
    batch and probe a per-batch zmer -> query-occurrence table; every
    (query occurrence, candidate posting) pair of a shared zmer is emitted
    (hzm_aln.h:114-240)."""
    dev = qrids.device
    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    P = rm_zsd.shape[0]
    ZS = 1 << zbits

    # ---- slot table: (q, rd) -> candidate slot + 1 ----
    # A query's candidates are distinct, so live targets are unique; every
    # other entry goes to the junk column R, which no live posting reads.
    # int8 as in the JAX package: slot + 1 wraps past 127 (see ROADMAP).
    qi = arange32(Q, dev)[:, None]
    slot_i = arange32(A, dev)[None, :]
    cok = (cands_sorted >= 0) & (cands_sorted < R) & ~qskip[:, None]
    slot_table = torch.zeros((Q, R + 1), dtype=torch.int8, device=dev)
    slot_val = ((((slot_i + 1) + 128) & 0xFF) - 128).to(torch.int8)
    slot_table[torch.where(cok, qi, Q - 1).reshape(-1).to(torch.int64),
               torch.where(cok, cands_sorted.clamp(0, R - 1), R).reshape(-1)
               .to(torch.int64)] = slot_val.expand(Q, A).reshape(-1)

    # ---- batch query occurrence table, zmer-sorted ----
    r = qrids.clamp(0, R - 1)
    qlive = rm_cnt[r] if rm_cnt is not None else rm_start[r + 1] - rm_start[r]
    qcnt = torch.where(qskip, 0, qlive)
    qsrc, qwithin, qalive, qtotal = expand_ranges(qcnt, occ_budget)
    qidx = (rm_start[r][qsrc] + qwithin).clamp(0, P - 1)
    qz = torch.where(qalive, rm_zsd[qidx] >> 9, ZS)
    qpk0 = torch.where(qalive, rm_pk[qidx], 0)
    perm = torch.sort(qz, stable=True).indices
    qz = qz[perm]
    occ_q = torch.where(qalive, qsrc, Q)[perm]
    occ_pk = qpk0[perm]
    bq_cnt = segment_sum(torch.ones_like(qz), qz.clamp(max=ZS), ZS)
    bq_start = torch.cat([_zeros(1, dev), cumsum32(bq_cnt)])
    return _sweep_emit(qrids, cands_sorted, slot_table, rm_zsd, rm_pk, rm_rd,
                       rm_start, read_lens, bq_cnt, bq_start, occ_q, occ_pk,
                       cross_budget=cross_budget, kvar=kvar, zbits=zbits,
                       pair_budget=pair_budget)


def _sweep_emit(qrids, cands_sorted, slot_table, rm_zsd, rm_pk, rm_rd,
                rm_start, read_lens, bq_cnt, bq_start, occ_q, occ_pk, *,
                cross_budget: int, kvar: int, zbits: int,
                pair_budget: int | None = None) -> PairBatch:
    dev = qrids.device
    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    P = rm_zsd.shape[0]
    BIGP = Q * A * 2
    ZS = 1 << zbits
    occ_budget = occ_q.shape[0]
    live_p = arange32(P, dev) < rm_start[min(R, rm_start.shape[0] - 1)]
    # aligned-layout gap entries carry the sentinel zsd (zmer == ZS)
    z_p = torch.where(live_p, rm_zsd >> 9, ZS)
    cnt_p = torch.where(z_p < ZS, bq_cnt[z_p.clamp(0, ZS - 1)], 0)
    src, within, alive, total = expand_ranges(cnt_p, cross_budget)
    src_c = src.clamp(0, P - 1)
    z_e = z_p[src_c]
    cpk = rm_pk[src_c]
    rd_e = rm_rd[src_c]
    occ_idx = (bq_start[z_e.clamp(0, ZS - 1)] + within).clamp(0, occ_budget - 1)
    q_e = occ_q[occ_idx]
    qpk = occ_pk[occ_idx]
    q_ec = q_e.clamp(0, Q - 1)
    slot = slot_table[q_ec, rd_e.clamp(0, R)].to(I32) - 1
    q_span = (qpk >> 1) & 0xFF
    p_span = (cpk >> 1) & 0xFF
    ok = (alive & (q_e < Q) & (slot >= 0) & (rd_e != qrids[q_ec])
          & ((q_span - p_span).abs() <= kvar))
    pairdir = (qpk ^ cpk) & 1
    cln = read_lens[rd_e.clamp(0, R - 1)]
    p_off = cpk >> 9
    o2 = torch.where(pairdir == 1, cln - (p_off + p_span), p_off)
    pair_id = torch.where(ok, (q_ec * A + slot) * 2 + pairdir, BIGP)
    if pair_budget is None or pair_budget >= cross_budget:
        return PairBatch(pair_id=pair_id, o1l1=qpk >> 1,
                         o2l2=(o2 << 8) | p_span, match_cnt=_zeros(BIGP, dev),
                         total=total, expand_total=total)
    # compact the survivors so the block phases run at match width
    dst = cumsum32(ok) - 1
    n_match = dst[-1] + 1
    dsti = torch.where(ok, dst.clamp(max=pair_budget), pair_budget)
    return PairBatch(
        pair_id=scatter_set(pair_budget, dsti, pair_id, BIGP),
        o1l1=scatter_set(pair_budget, dsti, qpk >> 1, 0),
        o2l2=scatter_set(pair_budget, dsti, (o2 << 8) | p_span, 0),
        match_cnt=_zeros(BIGP, dev),
        total=n_match,
        # the sweep's expansion axis is the cross product: reporting it
        # lets the caller detect cross-budget overflow
        expand_total=total,
    )


# ---------------------------------------------------------------------------
# blocks, merge, chain
# ---------------------------------------------------------------------------


class DotMatrixResult(NamedTuple):
    match_cnt: torch.Tensor  # [Q*A*2] int32 seed matches per pair id
    blk_total: torch.Tensor  # 0-d int32: blocks formed (vs nbk budget)
    row_total: torch.Tensor  # 0-d int32: live pair rows (vs pd budget)
    pair_id: torch.Tensor    # [PD] int32 (BIGP pad)
    score: torch.Tensor      # [PD] int32 chained coverage weight
    tb: torch.Tensor         # [PD] int32 query begin
    te: torch.Tensor         # [PD] int32 query end
    qb: torch.Tensor         # [PD] int32 candidate begin
    qe: torch.Tensor         # [PD] int32 candidate end
    blk_b0: torch.Tensor     # [PD, NB] int32 query-axis begin
    blk_e0: torch.Tensor     # [PD, NB] int32 query-axis end
    blk_b1: torch.Tensor     # [PD, NB] int32 candidate-axis begin
    blk_e1: torch.Tensor     # [PD, NB] int32 candidate-axis end
    blk_on: torch.Tensor     # [PD, NB] bool  block on the chain


def dot_matrix_align(pairs: PairBatch, qlens_of_pair, clens_of_pair, *,
                     n_pairs: int, nb: int = 32, xvar: int = 128,
                     yvar: int = 64, min_block_len: int = 160,
                     max_overhang: int = 256, deviation_penalty: float = 1.0,
                     gap_penalty: float = 0.05, nbk: int | None = None,
                     pd: int | None = None,
                     max_len: int = 1 << 17) -> DotMatrixResult:
    """Blocks -> single-linkage merge -> chain DP for one batch of pairs.

    Matches sort by (pair, diag // yvar, off1); blocks are runs within a
    diagonal bucket split by x-gaps > xvar; sub-threshold blocks drop
    before the merge (hzm_aln.h:833-846) except boundary splits; windows
    merge blocks at (xvar, 2*yvar); the top-nb windows per pair are chained
    by the DP of hzm_aln.h:1056-1132."""
    dev = pairs.pair_id.device
    PB = pairs.pair_id.shape[0]
    if nbk is None:
        nbk = PB
    BIGP = qlens_of_pair.shape[0]
    diag = (pairs.o1l1 >> 8) - (pairs.o2l2 >> 8)
    dead = pairs.pair_id >= BIGP
    ndq_need = 2 * (max_len // max(yvar, 1)) + 4
    NDQ = 1 << (ndq_need - 1).bit_length()
    HALF = NDQ // 2
    dq = (torch.div(diag, yvar, rounding_mode="floor") + HALF).clamp(0, NDQ - 1)
    assert (n_pairs + 1) * NDQ < (1 << 31) - 1, (
        "pair/diag key packing overflow: lower batch_q*ncand or max_len")
    kq = torch.where(dead, INT32_MAX, pairs.pair_id * NDQ + dq)
    ko = torch.where(dead, INT32_MAX, pairs.o1l1)
    perm = lexsort_perm([kq, ko])
    kq, ko, o2l2s = kq[perm], ko[perm], pairs.o2l2[perm]
    live = kq != INT32_MAX
    pid = torch.where(live, kq >> int(NDQ - 1).bit_length(), BIGP)
    o1 = torch.where(live, ko >> 8, 0)
    l1 = torch.where(live, ko & 255, 0)
    o2 = o2l2s >> 8
    l2 = o2l2s & 255
    grp_change = kq != shift_right(kq, 0)
    grp_change[0] = True
    prev_end1 = shift_right(o1 + l1, 0)
    # only live elements open blocks
    blk_new = live & (grp_change | (o1 > prev_end1 + xvar))
    contrib = torch.where(blk_new, l1, (o1 + l1) - prev_end1)
    contrib = torch.where(live, contrib, 0)
    nseg = nbk
    v8 = torch.stack([
        contrib,
        torch.where(live, o1, INT32_MAX),
        torch.where(live, o2, INT32_MAX),
        torch.where(live, o1 + l1, 0),
        torch.where(live, o2 + l2, 0),
        pid,
        live.to(I32),
        torch.zeros_like(o1),
    ])
    out8, blk_total = seg_reduce_compact(
        blk_new, v8, ops=BLOCK_OPS, out_budget=nseg)
    bmask = arange32(nseg, dev) < blk_total
    b_w = torch.where(bmask, out8[0], 0)
    b_beg0 = torch.where(bmask, out8[1], INT32_MAX)
    b_beg1 = torch.where(bmask, out8[2], INT32_MAX)
    b_end0 = torch.where(bmask, out8[3], 0)
    b_end1 = torch.where(bmask, out8[4], 0)
    b_pid = torch.where(bmask, out8[5], BIGP)
    b_cnt = torch.where(bmask, out8[6], 0)
    # per-pair seed-match counts from the block counts
    match_cnt = segment_sum(b_cnt, b_pid.clamp(max=BIGP), BIGP)
    # min_block_len gates blocks before the merge; a half-threshold block
    # survives when the adjacent bucket continues it (boundary split)
    b_half = (b_pid < BIGP) & (b_w >= (min_block_len + 1) // 2)
    nxt_pid = shift_left(b_pid, BIGP)
    nxt_b0 = shift_left(b_beg0, 0)
    nxt_half = shift_left(b_half, False)
    prv_pid = shift_right(b_pid, BIGP)
    prv_e0 = shift_right(b_end0, 0)
    prv_half = shift_right(b_half, False)
    join_nxt = nxt_half & (nxt_pid == b_pid) & (nxt_b0 <= b_end0 + xvar)
    join_prv = prv_half & (prv_pid == b_pid) & (b_beg0 <= prv_e0 + xvar)
    b_live = (b_pid < BIGP) & (
        (b_w >= min_block_len) | (b_half & (join_nxt | join_prv)))
    # ---- single-linkage merge over blocks at (xvar, 2*yvar) scale, at the
    # narrower NBL width (the sort compacts the live blocks to the front)
    NBL = max(nbk // 8, 1 << 14)
    live_total = b_live.to(I32).sum(dtype=I32)
    m1 = torch.where(b_live, b_pid, BIGP)
    m2 = torch.where(b_live, b_beg0 - b_beg1, INT32_MAX)
    m3 = torch.where(b_live, b_beg0, INT32_MAX)
    perm = lexsort_perm([m1, m2, m3])[:NBL]
    m1, m2, m3 = m1[perm], m2[perm], m3[perm]
    me0, mb1, me1, mw = b_end0[perm], b_beg1[perm], b_end1[perm], b_w[perm]
    nseg = NBL
    mlive = m1 < BIGP
    mp_new = m1 != shift_right(m1, 0)
    mg_new = mp_new | ((m2 - shift_right(m2, 0)) > 2 * yvar)
    mg_new[0] = True
    mg_id = cumsum32(mg_new) - 1
    h1 = torch.where(mlive, mg_id, INT32_MAX)
    perm = lexsort_perm([h1, m3])
    h1, hb0, he0, hb1 = h1[perm], m3[perm], me0[perm], mb1[perm]
    he1, hw, hpid = me1[perm], mw[perm], m1[perm]
    hlive = h1 < INT32_MAX
    prev_he0 = shift_right(he0, 0)
    h_new = h1 != shift_right(h1, 0)
    h_new[0] = True
    w_new = hlive & (h_new | (hb0 > prev_he0 + xvar))
    zw = torch.zeros_like(hw)
    outw, wtot = seg_reduce_compact(
        w_new, torch.stack([
            torch.where(hlive, hw, 0),
            torch.where(hlive, hb0, INT32_MAX),
            torch.where(hlive, hb1, INT32_MAX),
            torch.where(hlive, he0, 0),
            torch.where(hlive, he1, 0),
            hpid, zw, zw]),
        ops=DEFAULT_OPS, out_budget=nseg)
    wmask = arange32(nseg, dev) < wtot
    W_w = torch.where(wmask, outw[0], 0)
    W_b0 = torch.where(wmask, outw[1], INT32_MAX)
    W_b1 = torch.where(wmask, outw[2], INT32_MAX)
    W_e0 = torch.where(wmask, outw[3], 0)
    W_e1 = torch.where(wmask, outw[4], 0)
    W_pid = torch.where(wmask, outw[5], BIGP)
    W_live = (W_pid < BIGP) & (W_w >= min_block_len)
    # ---- top-nb windows per pair into dense [pd, nb]; live rows first ----
    if pd is None:
        pd = n_pairs
    s1 = torch.where(W_live, W_pid, BIGP)
    s2 = torch.where(W_live, INT32_MAX - W_w, INT32_MAX)
    perm = lexsort_perm([s1, s2])
    s1, s2 = s1[perm], s2[perm]
    sb0, se0, sb1, se1 = W_b0[perm], W_e0[perm], W_b1[perm], W_e1[perm]
    sw = torch.where(s1 < BIGP, INT32_MAX - s2, 0)
    srow_new = (s1 != shift_right(s1, 0))
    srow_new[0] = True
    srow_new &= s1 < BIGP
    row_of = cumsum32(srow_new) - 1
    row_total = row_of[-1] + 1
    pos = arange32(nseg, dev)
    first_at = torch.where(srow_new & (row_of < pd), row_of, pd)
    row_first = scatter_set(pd, first_at, pos, 0)
    col = pos - row_first[row_of.clamp(0, pd - 1)]
    ok = (s1 < BIGP) & (col < nb) & (row_of < pd)
    # (row, col) targets are unique for ok entries; the rest land in the
    # junk row pd
    r = torch.where(ok, row_of, pd).to(torch.int64)
    c = torch.where(ok, col, 0).to(torch.int64)

    def dense(vals, fill):
        out = torch.full((pd + 1, nb), fill, dtype=I32, device=dev)
        out[r, c] = vals
        return out[:pd]

    D_b0 = dense(sb0, INT32_MAX)
    D_e0 = dense(se0, 0)
    D_b1 = dense(sb1, INT32_MAX)
    D_e1 = dense(se1, 0)
    D_w = dense(sw, 0)
    D_pid = scatter_set(pd, first_at, s1, BIGP)
    D_valid = D_w > 0
    # re-sort each row by beg0 for the chain DP
    key = torch.where(D_valid, D_b0, INT32_MAX)
    order = torch.sort(key, dim=1, stable=True).indices
    key = torch.take_along_dim(key, order, 1)
    D_e0, D_b1, D_e1, D_w, D_b0 = (torch.take_along_dim(x, order, 1)
                                   for x in (D_e0, D_b1, D_e1, D_w, D_b0))
    D_valid = key < INT32_MAX
    # ---- chain DP (hzm_aln.h:1056-1132) ----
    qlen = qlens_of_pair[D_pid.clamp(0, BIGP - 1)]
    clen = clens_of_pair[D_pid.clamp(0, BIGP - 1)]
    tail_margin = xvar
    head = ((D_b0 <= tail_margin) | (D_b1 <= tail_margin)).to(I32)
    tail = ((D_e0 + tail_margin > qlen[:, None])
            | (D_e1 + tail_margin > clen[:, None])).to(I32)
    head = torch.where(D_valid, head, 0)
    tail = torch.where(D_valid, tail, 0)
    colix = arange32(nb, dev)[None, :]
    NP = D_w.shape[0]
    # float32 as in JAX; the divisor is a device tensor so that CUDA runs
    # a true division (a CPU scalar divisor becomes a multiply by its
    # reciprocal), and mul and add stay separate kernels (no FMA)
    gp = torch.tensor(gap_penalty, dtype=torch.float32, device=dev)
    dpen = torch.tensor(deviation_penalty, dtype=torch.float32, device=dev)
    weight = torch.zeros((NP, nb), dtype=I32, device=dev)
    hd = head
    bt = torch.full((NP, nb), -1, dtype=I32, device=dev)
    mw = torch.full((NP,), NEG_BIG, dtype=I32, device=dev)
    btg = torch.full((NP,), -1, dtype=I32, device=dev)
    for i in range(nb):
        wi = weight[:, i] + D_w[:, i]
        hi_ = hd[:, i]
        ti = tail[:, i]
        vi = D_valid[:, i]
        e0 = D_e0[:, i]
        e1 = D_e1[:, i]
        cand_total = torch.div(wi * ((hi_ + 3) * (ti + 3)), 16,
                               rounding_mode="floor")
        better = vi & (cand_total > mw)
        mw = torch.where(better, cand_total, mw)
        btg = torch.where(better, i, btg)
        Wlim = (wi.to(torch.float32) / gp).to(I32)
        d0 = D_b0 - e0[:, None]
        d1 = D_b1 - e1[:, None]
        allowed = ((colix > i) & D_valid & vi[:, None]
                   & (D_b0 + max_overhang >= e0[:, None])
                   & (D_b1 + max_overhang >= e1[:, None])
                   & (d0 <= Wlim[:, None]))
        band = (d0 - d1).abs()
        gap = torch.maximum(d0, d1).abs()
        pen = (band.to(torch.float32) * dpen
               + gap.to(torch.float32) * gp).to(I32)
        score = wi[:, None] - pen
        upd = allowed & (weight <= score)
        weight = torch.where(upd, score, weight)
        bt = torch.where(upd, i, bt)
        hd = torch.where(upd, hi_[:, None], hd)
        weight[:, i] = wi
    # traceback: follow bt pointers from btg, marking chain membership
    mark = torch.zeros((NP, nb), dtype=torch.bool, device=dev)
    cur = btg
    rows_np = torch.arange(NP, device=dev)
    for _ in range(nb):
        okc = cur >= 0
        curc = cur.clamp(0, nb - 1).to(torch.int64)
        mark[rows_np, curc] = mark[rows_np, curc] | okc
        cur = torch.where(okc, bt[rows_np, curc], -1)
    mark = mark & D_valid
    score = torch.where(mark, D_w, 0).sum(1, dtype=I32)
    tb_ = torch.where(mark, D_b0, INT32_MAX).amin(1)
    te_ = torch.where(mark, D_e0, 0).amax(1)
    qb_ = torch.where(mark, D_b1, INT32_MAX).amin(1)
    qe_ = torch.where(mark, D_e1, 0).amax(1)
    # live blocks past the NBL merge width report the real requirement so
    # the caller's redispatch regrows nbk (and with it NBL = nbk/8)
    if NBL < nbk:
        blk_total = torch.where(
            live_total > NBL - 2048,
            torch.maximum(blk_total, 8 * (live_total + 2048)), blk_total)
    return DotMatrixResult(
        match_cnt=match_cnt, blk_total=blk_total, row_total=row_total,
        pair_id=D_pid, score=score, tb=tb_, te=te_, qb=qb_, qe=qe_,
        blk_b0=D_b0, blk_e0=D_e0, blk_b1=D_b1, blk_e1=D_e1, blk_on=mark,
    )
