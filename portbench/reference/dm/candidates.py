"""Candidate selection for a batch of query reads
(port of smartdenovo_tpu/ops/candidates.py).

Posting ranges come from a binary search into the sorted k16 index, a
budgeted expansion materialises (query, candidate) seed events, a sort
groups them by (query, candidate, dir) and the streaming segment reduce
(K1, ops/sseg.py) scores each group by its non-overlapping covered query
length ("ol", wtzmo.c:559-563).  The two strands of a candidate merge by
max (wtzmo.c:525-535) and the top `ncand` per query are kept.
"""

from __future__ import annotations

import torch

from .flatops import (arange32, cumsum32, expand_ranges, scatter_set,
                      shift_left, shift_right, sort_pairs)
from .kernels_plain import CAND_OPS, seg_reduce_compact

I32 = torch.int32
INT32_MAX = 0x7FFFFFFF


def _binary_search_rows(table, row_ids, values, row_cnt):
    """Membership of values in per-row sorted int32 rows (manual bisect)."""
    S = table.shape[1]
    if S == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    steps = max(1, (S - 1).bit_length())
    lo = torch.zeros(values.shape, dtype=I32, device=values.device)
    hi = row_cnt[row_ids].clamp(max=S).to(I32)
    for _ in range(steps + 1):
        mid = (lo + hi) >> 1
        mv = table[row_ids, mid.clamp(0, S - 1)]
        go_right = (mv < values) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, torch.where(mid < hi, mid, hi))
    found = table[row_ids, lo.clamp(0, S - 1)] == values
    return found & (lo < row_cnt[row_ids].clamp(max=S))


def scan_candidates(qkmer, qoff, qspan, qvalid, qrids, qlens, qskip,
                    idx_kmers, post_rd, post_dir, read_lens, suppress,
                    suppress_cnt, *, budget: int, ncand: int, kovl: int,
                    len_ratio: float = 1.2, probe_budget: int = 0):
    """Returns (cands [Q, ncand] int32 (-1 pad, ol-desc order), ols
    [Q, ncand] int32, total expansion, total probes) — see the JAX
    function of the same name for the argument layouts (uint32 k-mer codes
    as int64 here)."""
    dev = qkmer.device
    Q, L = qkmer.shape
    q_row = arange32(Q * L, dev) // L
    pvalid = qvalid.reshape(-1) & ~qskip[q_row]
    if probe_budget:
        # compact live probes to a tight width before the index search
        K = probe_budget
        pdst = cumsum32(pvalid) - 1
        probe_total = pdst[-1] + 1
        pdst = torch.where(pvalid, pdst, Q * L).clamp(max=K)
        flat_k = scatter_set(K, pdst, qkmer.reshape(-1), 0xFFFFFFFF,
                             dtype=torch.int64)
        p_q = scatter_set(K, pdst, q_row, Q)
        p_off = scatter_set(K, pdst, qoff.reshape(-1), 0)
        p_span = scatter_set(K, pdst, qspan.reshape(-1), 0)
        p_live = (arange32(K, dev) < probe_total) & (p_q < Q)
    else:
        K = Q * L
        flat_k = qkmer.reshape(-1)
        p_q = q_row
        p_off = qoff.reshape(-1)
        p_span = qspan.reshape(-1)
        p_live = pvalid
        probe_total = torch.tensor(K, dtype=I32, device=dev)
    start = torch.searchsorted(idx_kmers, flat_k).to(I32)
    end = torch.searchsorted(idx_kmers, flat_k, right=True).to(I32)
    cnt = torch.where(p_live, end - start, 0)
    src_c, within, alive, total = expand_ranges(cnt, budget)
    pidx = (start[src_c] + within).clamp(0, post_rd.shape[0] - 1)
    q_local = p_q[src_c].clamp(0, Q - 1)
    qpos = p_off[src_c]
    span = p_span[src_c]
    cand = post_rd[pidx]
    cdir = post_dir[pidx].to(I32)
    qrid = qrids[q_local]
    clen = read_lens[cand.clamp(0, read_lens.shape[0] - 1)]
    # float32 compare as in JAX: 1.2 rounds to float32 before the multiply
    ratio = torch.tensor(len_ratio, dtype=torch.float32, device=dev)
    keep = (alive & (cand != qrid)
            & (clen.to(torch.float32) <= ratio * qlens[q_local].to(torch.float32))
            & ~qskip[q_local])
    if suppress.shape[1] > 0:
        keep &= ~_binary_search_rows(suppress, q_local, cand, suppress_cnt)
    # sort events by (query, candidate*2+dir, qpos); dead events last
    R2 = 2 * read_lens.shape[0] + 2
    assert Q * R2 < (1 << 31) - 1, "pack overflow: shard the bank (-G)"
    assert Q <= 255, "top-A key packing supports batch_q <= 255"
    kq = torch.where(keep, q_local * R2 + cand * 2 + cdir, INT32_MAX)
    k3s = torch.where(keep, (qpos << 8) | span.clamp(max=255), INT32_MAX)
    kq, k3s = sort_pairs(kq, k3s)
    live = kq != INT32_MAX
    qpos_s = torch.where(live, k3s >> 8, 0)
    span_s = torch.where(live, k3s & 0xFF, 0)
    seg_new = kq != shift_right(kq, 0)
    seg_new[0] = True
    prev_end = shift_right(qpos_s + span_s, 0)
    contrib = torch.where(
        seg_new, span_s,
        torch.minimum(span_s, qpos_s + span_s - prev_end).clamp(min=0))
    contrib = torch.where(live, contrib, 0)
    # one record per (q, cand, dir) group plus the dead tail: the group
    # table is bounded by the packed key space, far narrower than budget
    n_seg = min(Q * R2 + 1, budget)
    zz = torch.zeros_like(kq)
    out8, g_total = seg_reduce_compact(
        seg_new, torch.stack([contrib, torch.where(live, kq, INT32_MAX),
                              zz, zz, zz, zz, zz, zz]),
        ops=CAND_OPS, out_budget=n_seg)
    gmask = arange32(n_seg, dev) < g_total
    seg_ol0 = torch.where(gmask, out8[0], 0)
    seg_kq = torch.where(gmask & (out8[1] != INT32_MAX), out8[1], INT32_MAX)
    # merge the two strands of each (q, cand) by max ol: strands are
    # adjacent in the packed key space, so every merge group is <= 2
    # sorted-adjacent entries
    seg_qc = torch.where(seg_kq == INT32_MAX, INT32_MAX, seg_kq >> 1)
    nxt_qc = shift_left(seg_qc, INT32_MAX)
    nxt_ol = shift_left(seg_ol0, 0)
    m_new = seg_qc != shift_right(seg_qc, 0)
    m_new[0] = True
    first_live = m_new & (seg_kq != INT32_MAX)
    seg_ol = torch.where(nxt_qc == seg_qc, torch.maximum(seg_ol0, nxt_ol),
                         seg_ol0)
    seg_q = torch.where(first_live, seg_qc // (R2 // 2), Q)
    seg_c = torch.where(first_live, seg_qc % (R2 // 2), INT32_MAX)
    # top-ncand per query: sort by (q, -ol, cand)
    seg_live = first_live & (seg_q < Q) & (seg_ol >= kovl)
    s12 = torch.where(
        seg_live,
        (seg_q << 23) | (((1 << 23) - 1) - seg_ol.clamp(max=(1 << 23) - 1)),
        INT32_MAX)
    s3 = torch.where(seg_live, seg_c, INT32_MAX)
    s12, s3 = sort_pairs(s12, s3)
    qkeys = arange32(Q, dev) << 23
    q_first = torch.searchsorted(s12, qkeys).to(I32)
    idx = q_first[:, None] + arange32(ncand, dev)[None, :]
    idxc = idx.clamp(0, n_seg - 1)
    v12 = s12[idxc]
    v3 = s3[idxc]
    valid = ((idx < n_seg) & (v12 != INT32_MAX)
             & ((v12 >> 23) == arange32(Q, dev)[:, None]))
    cands = torch.where(valid, v3, -1)
    ols = torch.where(valid, ((1 << 23) - 1) - (v12 & ((1 << 23) - 1)), 0)
    return cands, ols, total, probe_total
