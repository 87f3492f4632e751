"""Dot-matrix overlap alignment (port of smartdenovo_tpu/ops/dotmatrix.py:
the index-sweep and sort-join z-mer matchers, the legacy budgeted matcher
`extract_zmer_pairs` that wtgbo's rescue uses, and `dot_matrix_align`).

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

from .flatops import (arange32, bounded_bisect, cumsum32, expand_ranges,
                      lexsort_perm,
                      scatter_set, segment_sum, shift_left, shift_right)
from .flatseeds import RM_BLK
from .kernels_plain import join_emitters
from .kernels_plain import expand_emit
from .kernels_plain import BLOCK_OPS, DEFAULT_OPS, seg_reduce_compact

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


def extract_zmer_pairs(qz, qdir, qoff, qspan, qvalid, qrids, cands_sorted,
                       zmers, post_rd, post_packed, read_lens, *,
                       expand_budget: int, pair_budget: int,
                       kvar: int = 2) -> PairBatch:
    """Budgeted z-mer match extraction against the legacy z-mer index
    (ops/index.py), in two phases: at expand_budget width every posting
    of a query z-mer maps to its read and one lookup in a dense (query,
    read) table answers "is it a candidate" and "how long is it"; the
    survivors compact into pair_budget, where their fields give the
    coordinates and the kvar span filter (hzm_aln.h:173).

    qz [Q, L] int64 (uint32 codes), qdir/qvalid bool, qoff/qspan int32,
    qrids [Q], cands_sorted [Q, A] candidate ids (pad INT32_MAX), each row
    a set; zmers [P] int64 sorted, post_rd, post_packed [P] int32."""
    dev = qz.device
    Q, L = qz.shape
    A = cands_sorted.shape[1]
    assert A <= 511, "slot packing uses 9 bits; keep dm_cand <= 511"
    R = read_lens.shape[0]
    P = post_rd.shape[0]
    # dense (q, read) -> (clen<<9 | slot+1); a row's candidates are a set,
    # so its live targets are distinct, and every pad goes to column R
    qq = arange32(Q, dev)[:, None].expand(Q, A)
    col = torch.where((cands_sorted >= 0) & (cands_sorted < R), cands_sorted,
                      R).to(I32)
    clen_cand = read_lens[col.clamp(0, R - 1).long()].to(I32)
    slot_val = (clen_cand << 9) | arange32(A, dev)[None, :].add(1)
    slot_ctab = torch.zeros((Q, R + 1), dtype=I32, device=dev)
    slot_ctab[qq.long(), col.long()] = slot_val
    slot_ctab = slot_ctab[:, :R]
    BIGP = Q * A * 2
    flat_z = qz.reshape(-1)
    flat_valid = qvalid.reshape(-1)
    q_of = arange32(Q * L, dev) // L
    start = torch.searchsorted(zmers, flat_z).to(I32)
    end = torch.searchsorted(zmers, flat_z, right=True).to(I32)
    # global repeat guard: mega-frequency zmers would waste the budget
    rng_ok = (end - start) <= 4096
    # own-read membership: the per-read cap kept this (read, zmer) group
    qr = qrids.to(I32)[q_of.long()]
    own_lb = bounded_bisect(post_rd, qr, start, end, 13)
    own_ok = (own_lb < end) & (post_rd[own_lb.clamp(0, max(P - 1, 0)).long()]
                               == qr) if P else torch.zeros_like(flat_valid)
    cnt = torch.where(flat_valid & own_ok & rng_ok, end - start, 0)
    qpk = ((qoff.reshape(-1).to(I32) << 9)
           | (torch.clamp(qspan.reshape(-1), max=255).to(I32) << 1)
           | qdir.reshape(-1).to(I32))

    # phase 1: range mapping, the posting's read, the slot lookup
    cum = cumsum32(cnt)
    total_exp = cum[-1]
    ostarts = cum - cnt
    nsrc = cnt.shape[0]
    idx = torch.where(cnt > 0, ostarts.clamp(0, expand_budget),
                      expand_budget).long()
    mark = torch.zeros(expand_budget + 1, dtype=I32, device=dev)
    mark.scatter_reduce_(0, idx, arange32(nsrc, dev) + 1, reduce="amax")
    src = torch.cummax(mark[:expand_budget], 0).values - 1
    src_c = src.clamp(0, nsrc - 1)
    p = arange32(expand_budget, dev)
    sl = src_c.long()
    within = p - ostarts[sl]
    pidx = (start[sl] + within).clamp(0, max(P - 1, 0))
    alive = (p < total_exp) & (src >= 0)
    c_rd = post_rd[pidx.long()] if P else torch.zeros_like(pidx)
    sv = slot_ctab[(src_c // L).long(), c_rd.clamp(0, R - 1).long()]
    keep = alive & ((sv & 0x1FF) > 0)
    # compact slot-filter survivors into [pair_budget]
    dst = cumsum32(keep) - 1
    total = dst[-1] + 1
    dst = torch.where(keep & (dst < pair_budget), dst, pair_budget)

    def scat(vals):
        return scatter_set(pair_budget, dst, vals, 0)

    src2 = scat(src_c)
    pidx2 = scat(pidx)
    sv2 = scat(sv)
    live2 = scat(torch.ones_like(src_c)) > 0

    # phase 2: field gathers on survivors only
    qg = qpk[src2.long()]
    ppk = post_packed[pidx2.long()] if P else torch.zeros_like(pidx2)
    q_span = (qg >> 1) & 0xFF
    p_off = ppk >> 9
    p_span = (ppk >> 1) & 0xFF
    len_ok = live2 & ((q_span - p_span).abs() <= kvar)
    pairdir = (qg ^ ppk) & 1
    clen = sv2 >> 9
    slot = (sv2 & 0x1FF) - 1
    o2 = torch.where(pairdir == 1, clen - (p_off + p_span), p_off)
    pair_id = torch.where(len_ok, ((src2 // L) * A + slot) * 2 + pairdir, BIGP)
    return PairBatch(
        pair_id=pair_id.to(I32),
        o1l1=qg >> 1,
        o2l2=(o2 << 8) | p_span,
        match_cnt=_zeros(Q * A * 2, dev),   # filled by dot_matrix_align
        total=total,
        expand_total=total_exp,
    )



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


def extract_zmer_pairs_vtab(qrids, cands_sorted, rm_zsd, rm_pk, rm_start,
                            read_lens, rm_cnt=None, *, expand_budget: int,
                            pair_budget: int, qm_budget: int, kvar: int = 2,
                            zbits: int = 20,
                            max_per_read: int = 16) -> PairBatch:
    """Sort-free per-pair z-mer intersection through a direct-addressed
    (query, zmer) table, the reference's per-read zmer filter
    (hzm_aln.h:114,152,206):

    1. vt build: each query's postings are one (rd, zmer)-sorted slice, so
       its zmer runs are contiguous; each run start stores
       (global start index + 1) << 6 | min(run length, 63) at
       vt[(q << zbits) | zmer];
    2. candidate expansion: every posting of every candidate slice reads
       its zsd and one vt entry; zmers the query lacks die there;
    3. the matches expand into the n x m co-occurrences, the query
       occurrences straight from the vt start index.

    qrids [Q] read ids, cands_sorted [Q, A] (pad INT32_MAX), the read-major
    index (rm_zsd, rm_pk [P], rm_start [R+1], rm_cnt [R] live postings).
    Requires P < 2^25 (the start index packs into 25 bits) and
    max_per_read <= 64 (the run length into 6)."""
    dev = qrids.device
    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    P = rm_zsd.shape[0]
    assert P < (1 << 25), "vt start packing needs P < 2^25; shard the index (-G)"
    assert max_per_read <= 64, "vt count packing uses 6 bits"
    BIGP = Q * A * 2
    VT = Q << zbits

    # ---- phase 1: direct-addressed query zmer table ----
    r = qrids.clamp(0, R - 1)
    qcnt = rm_cnt[r] if rm_cnt is not None else rm_start[r + 1] - rm_start[r]
    qsrc, qwithin, qalive, qtotal = expand_ranges(qcnt, qm_budget)
    qidx = (rm_start[r][qsrc] + qwithin).clamp(0, P - 1)
    qzmer = rm_zsd[qidx] >> 9
    run_new = qalive & ((qwithin == 0) | (qzmer != shift_right(qzmer, -1))
                        | (qsrc != shift_right(qsrc, -1)))
    run_id = cumsum32(run_new) - 1
    pq = arange32(qm_budget, dev)
    # S[k] = start of run k in the expanded axis, S[runs] = qtotal: run ids
    # are distinct at run starts, the other slots go to the dropped junk
    # slot (the JAX package's S[qm_budget] is read only when every slot
    # starts a run, and then holds qtotal as here)
    S = torch.cat([scatter_set(qm_budget, torch.where(run_new, run_id,
                                                      qm_budget), pq, 0),
                   _zeros(1, dev)])
    S[(run_id[-1] + 1).clamp(0, qm_budget).reshape(1).long()] = \
        qtotal.reshape(1)
    run_cnt = S[(run_id + 1).clamp(0, qm_budget)] - pq   # valid at run starts
    # A query's slice is zmer-sorted, so its run starts have distinct
    # zmers and distinct targets; amax keeps even a repeated target
    # deterministic on CUDA (every value is > 0).  Dead slots go to entry
    # VT, zeroed after: the probe of a dead element reads 0 there.
    vt_idx = torch.where(run_new, (qsrc << zbits) | qzmer, VT).long()
    vt_val = ((qidx + 1) << 6) | run_cnt.clamp(max=63)
    vt = torch.zeros(VT + 1, dtype=I32, device=dev)
    vt.scatter_reduce_(0, vt_idx, vt_val, reduce="amax")
    vt[VT] = 0

    # ---- phase 2: candidate expansion + table probe ----
    c = cands_sorted.clamp(0, R - 1)
    cvalid = (cands_sorted >= 0) & (cands_sorted < R)
    cstart = torch.where(cvalid, rm_start[c], 0).reshape(-1)
    clive = rm_cnt[c] if rm_cnt is not None else rm_start[c + 1] - rm_start[c]
    cnt1 = torch.where(cvalid, clive, 0).reshape(-1)
    clen_flat = torch.where(cvalid, read_lens[c], 0).reshape(-1).to(I32)
    src1, within1, alive1, total1 = expand_ranges(cnt1, expand_budget)
    pidx = (cstart[src1] + within1).clamp(0, P - 1)
    zsd = torch.where(alive1, rm_zsd[pidx], 0)
    probe = torch.where(alive1, ((src1 // A) << zbits) | (zsd >> 9), VT)
    qinfo = vt[probe.clamp(max=VT)]
    qstart1 = (qinfo >> 6) - 1
    cnt2 = torch.where(alive1 & (qinfo != 0), qinfo & 63, 0)

    # ---- phase 3: emit n x m co-occurrences ----
    src2, within2, alive2, total2 = expand_ranges(cnt2, pair_budget)
    qslot2 = src1[src2].clamp(0, Q * A - 1)
    qg = rm_pk[(qstart1[src2] + within2).clamp(0, P - 1)]
    cg = rm_pk[pidx[src2].clamp(0, P - 1)]
    cln = clen_flat[qslot2]
    q_span = (qg >> 1) & 0xFF
    p_off = cg >> 9
    p_span = (cg >> 1) & 0xFF
    pairdir = (qg ^ cg) & 1
    o2 = torch.where(pairdir == 1, cln - (p_off + p_span), p_off)
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


def build_query_occ_rows(qz_rows, qpk_rows, qvalid, *, occ_budget: int,
                         zbits: int, max_per_read: int):
    """Zmer-sorted occurrence table from [Q, L] query seed rows, for the
    drivers whose queries' postings may live in another index part
    (parallel/gpass.py, parallel/sharded.py).  The per-(q, zmer) cap is
    the index build's (hzm_aln.h:107), so matching equals the one-index
    sweep.  Returns (bq_cnt, bq_start, occ_q, occ_pk, qtotal); the table
    is cut to occ_budget entries and qtotal counts them all."""
    dev = qz_rows.device
    Q, L = qz_rows.shape
    ZS = 1 << zbits
    assert Q * (ZS + 1) + ZS < (1 << 31), "(q, zmer) key packing overflow"
    qf = torch.where(qvalid, qz_rows.to(I32), ZS).reshape(-1)
    qq = arange32(Q, dev)[:, None].expand(Q, L).reshape(-1)
    pk = qpk_rows.to(I32).reshape(-1)
    # sort by (q, zmer) to apply the per-(q, zmer) cap on runs
    key = torch.where(qf < ZS, qq * (ZS + 1) + qf, Q * (ZS + 1) + ZS)
    key, perm = torch.sort(key, stable=True)
    qf2, qq2, pk2 = qf[perm], qq[perm], pk[perm]
    new = key != shift_right(key, 0)
    new[0] = True
    gid = cumsum32(new) - 1
    live = qf2 < ZS
    gcnt = segment_sum(live.to(I32), torch.where(live, gid, Q * L), Q * L)
    keep = live & (gcnt[gid.clamp(0, Q * L - 1)] < max_per_read)
    # re-sort by zmer alone for the occurrence table
    qz, perm = torch.sort(torch.where(keep, qf2, ZS), stable=True)
    occ_q = torch.where(keep, qq2, Q)[perm]
    occ_pk = pk2[perm]
    qtotal = keep.to(I32).sum(dtype=I32)
    bq_cnt = segment_sum(torch.ones_like(qz), qz.clamp(max=ZS), ZS)
    bq_start = torch.cat([_zeros(1, dev), cumsum32(bq_cnt)])
    return bq_cnt, bq_start, occ_q[:occ_budget], occ_pk[:occ_budget], qtotal


def extract_zmer_pairs_sweep_rows(qrids, cands_sorted, occ_tables, rm_zsd,
                                  rm_pk, rm_rd, rm_start, read_lens, *,
                                  cross_budget: int, kvar: int = 2,
                                  zbits: int = 20,
                                  pair_budget: int | None = None) -> PairBatch:
    """The index sweep with a precomputed occurrence table
    (`build_query_occ_rows`).  Skipped queries carry no occurrences (their
    rows are masked when the table is built), so the slot table does not
    mask them."""
    dev = qrids.device
    Q = qrids.shape[0]
    A = cands_sorted.shape[1]
    R = read_lens.shape[0]
    bq_cnt, bq_start, occ_q, occ_pk, _qtotal = occ_tables
    qi = arange32(Q, dev)[:, None]
    slot_i = arange32(A, dev)[None, :]
    cok = (cands_sorted >= 0) & (cands_sorted < R)
    # live targets are unique (a query's candidates are distinct); the
    # int8 slot + 1 wraps past 127 as in the JAX package
    slot_table = torch.zeros((Q, R + 1), dtype=torch.int8, device=dev)
    slot_val = ((((slot_i + 1) + 128) & 0xFF) - 128).to(torch.int8)
    slot_table[torch.where(cok, qi, Q - 1).reshape(-1).to(torch.int64),
               torch.where(cok, cands_sorted.clamp(0, R - 1), R).reshape(-1)
               .to(torch.int64)] = slot_val.expand(Q, A).reshape(-1)
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
