"""The plain reference of the overlap units: the dm engine's records of
every query batch, worked out again from the reads.

It runs the frozen plain copy of the overlapper's device path
(`reference/dm/`: the flat seeds and both posting indexes, the candidate
scan, the z-mer matchers, the dot matrix and its chains, with the three
hand kernels in plain PyTorch) and a copy of the host emission, over the
whole bank: phase 1 a chunk of 16 batches at a time, so that the budgets
and the matcher pick are the program's, then phase 2 of each batch of
the chunk.

The emission is sequential: whether a query is already covered (nbest)
and whether a pair was emitted depend on every batch before it.  The
reference carries that state through its own records, batch after batch,
and reads nothing that the program made.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch

from .dm.candidates import scan_candidates
from .dm.dotmatrix import (dot_matrix_align, extract_zmer_pairs_join,
                           extract_zmer_pairs_sweep)
from .dm.flatseeds import build_bank_indexes, gather_query_rows, pad_pow2
from .dm.seeds import subsample_mask

INT32_MAX = np.int32(0x7FFFFFFF)
CHUNK = 16
# a record: rid1, rid2, dir2, beg1, end1, beg2, end2, score, aln
RECORD_FIELDS = 9


@dataclasses.dataclass(frozen=True)
class DmParams:
    """The dm engine's parameters (wtzmo's defaults; the dmo flags come
    from the configuration)."""

    ksize: int = 16
    zsize: int = 10
    hz: bool = True
    ksave: int = 4
    max_kmer_freq: int = 0
    max_zmer_freq: int = 64
    kvar: int = 2
    kovl: int = 300
    ztot: int = 300
    ncand: int = 500
    nbest: int = 100
    min_score: int = 200
    min_id: float = 0.5
    max_unalign_dovetail: int = 200
    len_ratio: float = 1.2
    xvar: int = 128
    yvar: int = 64
    min_block_len: int = 160
    max_overhang: int = 256
    deviation_penalty: float = 1.0
    gap_penalty: float = 0.05
    batch_q: int = 64
    expand_budget_cap: int = 1 << 26
    nb: int = 32
    matcher: str = "auto"

    @classmethod
    def of(cls, zmo: dict) -> "DmParams":
        kw = {k: v for k, v in zmo.items() if k in cls.__dataclass_fields__}
        return cls(**kw)


def pad_tier(n: int, tiers=(2048, 4096, 8192, 16384, 32768, 65536)) -> int:
    for t in tiers:
        if n <= t:
            return t
    return ((n + 65535) // 65536) * 65536


class Bank:
    """Reads in the order both sides index them (length descending)."""

    def __init__(self, bases: np.ndarray, lengths: np.ndarray):
        self.bases = bases
        self.lengths = lengths.astype(np.int32)
        self.offsets = np.zeros(lengths.shape[0] + 1, np.int64)
        np.cumsum(self.lengths, out=self.offsets[1:])

    def __len__(self):
        return self.lengths.shape[0]

    def avg_len(self) -> int:
        return max(1, int(self.offsets[-1] // len(self))) if len(self) \
            else 10000


def reference_candidates(bank: Bank, p: DmParams,
                         device) -> list[tuple[np.ndarray, np.ndarray]]:
    """The candidate overlaps and attempted pairs of every query batch, in
    batch order (the stateless half of the emission; see
    extract_candidates)."""
    dev = torch.device(device)
    n = len(bank)
    T = pad_pow2(int(bank.offsets[-1]) + 1)
    Npad = pad_pow2(n, lo=1 << 8)
    flat = np.full(T, 4, np.uint8)
    flat[: bank.offsets[-1]] = bank.bases
    offs = np.full(Npad + 1, bank.offsets[-1], np.int64)
    offs[: n + 1] = bank.offsets
    flat_d = torch.from_numpy(flat).to(dev)
    offs_d = torch.from_numpy(offs.astype(np.int32)).to(dev)
    k16, z10, didx = build_bank_indexes(
        flat_d, offs_d, ksize=p.ksize, zsize=p.zsize, hz=p.hz,
        ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
        max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)
    stats = didx.stats.cpu().numpy()
    zcnt = stats[:Npad][:n].astype(np.int64)
    kneed = stats[Npad: 2 * Npad][:n].astype(np.int64)
    kprobes = stats[2 * Npad: 3 * Npad][:n].astype(np.int64)
    comp_len = stats[3 * Npad: 4 * Npad][:n].astype(np.int64)
    cross = stats[4 * Npad: 5 * Npad][:n].astype(np.int64)
    max_comp = int(stats[5 * Npad])
    distinct_kept = int(stats[5 * Npad + 3])
    kavg = int(comp_len.sum() // max(1, distinct_kept * p.ksave))

    A = p.ncand
    Adm = A
    Q = p.batch_q
    Lc = pad_pow2(max_comp, lo=1 << 10)
    qarr = np.arange(n)
    all_batches = [qarr[i: i + Q] for i in range(0, n, Q)]
    B = len(all_batches)
    chunks = []
    c0 = 0
    while c0 < B:
        sz = min(CHUNK, 1 << (B - c0).bit_length() - 1)
        while sz > B - c0:
            sz >>= 1
        chunks.append((c0, sz))
        c0 += sz
    Ltier = pad_tier(int(bank.lengths[0]))
    read_lens_d = torch.from_numpy(bank.lengths.astype(np.int32)).to(dev)

    def batch_inputs(rids_np):
        rids = np.concatenate(
            [rids_np, np.full(Q - len(rids_np), rids_np[-1], rids_np.dtype)]
        ).astype(np.int32)
        qskip = np.zeros(Q, bool)
        qskip[len(rids_np):] = True
        return rids, bank.lengths[rids].astype(np.int32), qskip

    cbud = min(pad_pow2(max(int(kneed[b].sum()) for b in all_batches)
                        + 1024, lo=1 << 14), p.expand_budget_cap)
    kq = pad_pow2(max(int(kprobes[b].sum()) for b in all_batches) + Q,
                  lo=1 << 12)
    rids_all = np.stack([batch_inputs(b)[0] for b in all_batches])
    qkb_z = pad_pow2(max(int(zcnt[rids_all[bi]].sum()) for bi in range(B))
                     + Q, lo=1 << 13)
    qkb_c = pad_pow2(max(int(comp_len[b].sum()) for b in all_batches) + Q,
                     lo=1 << 13)
    qkb = {"sweep": qkb_z, "join": qkb_c}.get(p.matcher, max(qkb_z, qkb_c))

    def phase1(bi):
        rids, qlens, qskip = batch_inputs(all_batches[bi])
        return _cand_core(
            torch.from_numpy(rids).to(dev), torch.from_numpy(qlens).to(dev),
            torch.from_numpy(qskip).to(dev), k16, didx, read_lens_d,
            Q=Q, Lc=Lc, A=A, Adm=Adm, cbud=cbud, kq=kq, ksave=p.ksave,
            kovl=p.kovl, len_ratio=p.len_ratio)

    def pair_budgets(zneed, matcher):
        mb = min(pad_pow2(int(zneed) + 1024, lo=1 << 14), p.expand_budget_cap)
        pb = min(pad_pow2(int(zneed) * 3 // 4 + 1024, lo=1 << 14), mb)
        nbk = pad_pow2(max(pb * 3 // 16, 1 << 14))
        return dict(mb=mb, pb=pb, nbk=nbk, cx=0, matcher=matcher)

    def sweep_budgets(bi_lo, bi_hi):
        occ = max(int(zcnt[rids_all[bi]].sum()) for bi in range(bi_lo, bi_hi))
        cxn = max(int(cross[rids_all[bi]].sum()) for bi in range(bi_lo, bi_hi))
        mb = pad_pow2(occ + Q, lo=1 << 12)
        cx = min(pad_pow2(cxn + 1024, lo=1 << 14), p.expand_budget_cap)
        pb = max(cx // (2 if kavg >= 10 else 4), 1 << 14)
        return dict(mb=mb, cx=cx, pb=pb, nbk=max(pb // 4, 1 << 14),
                    matcher="sweep")

    def chunk_budgets(c0, sz, sizes):
        if p.matcher == "sweep":
            return sweep_budgets(c0, c0 + sz)
        join_need = int(sizes[:, 0].max())
        if p.matcher == "join":
            return pair_budgets(join_need, "join")
        cross_need = max(int(cross[rids_all[bi]].sum())
                         for bi in range(c0, c0 + sz))
        if cross_need <= join_need and cross_need < p.expand_budget_cap:
            return sweep_budgets(c0, c0 + sz)
        return pair_budgets(join_need, "join")

    out = []
    for c0, sz in chunks:
        sizes, cs_all = [], []
        for bj in range(c0, c0 + sz):
            cs, _os, size = phase1(bj)
            sizes.append(size.cpu().numpy())
            cs_all.append(cs)
        sizes = np.stack(sizes)
        pd = pad_pow2(2 * int(sizes[:, 3].max()) + 64, lo=1 << 12)
        budgets = chunk_budgets(c0, sz, sizes)
        for bi in range(c0, c0 + sz):
            out.append(_batch_candidates(
                bank, p, all_batches[bi], batch_inputs, cs_all[bi - c0],
                z10, didx, read_lens_d, dict(
                    Q=Q, Lc=Lc, Adm=Adm, qkb=qkb, nb=p.nb, kvar=p.kvar,
                    zbits=2 * p.zsize, max_per_read=p.max_zmer_freq,
                    xvar=p.xvar, yvar=p.yvar,
                    min_block_len=p.min_block_len,
                    max_overhang=p.max_overhang,
                    deviation_penalty=p.deviation_penalty,
                    gap_penalty=p.gap_penalty, pd=pd, max_len=Ltier,
                    **budgets)))
    return out


def _batch_candidates(bank, p, rids_np, batch_inputs, cs_b, z10, didx,
                      read_lens_d, st):
    """Phase 2 of one batch, run again at grown budgets while a total
    overflows them (overlap_dmo's redispatch), and its candidates."""
    dev = cs_b.device
    Q, Adm = st["Q"], st["Adm"]
    rids, qlens, _ = batch_inputs(rids_np)
    args = (torch.from_numpy(rids).to(dev), torch.from_numpy(qlens).to(dev),
            cs_b, z10, didx, read_lens_d)
    row = _pair_pack(*_pair_core(*args, **st)).cpu().numpy()
    for _attempt in range(4):
        ptot, etot, btot, rtot = (int(x) for x in row[-4:])
        ov = {}
        exp_key = "cx" if st["matcher"] == "sweep" else "mb"
        if etot > st[exp_key]:
            ov[exp_key] = min(pad_pow2(etot + 1024), p.expand_budget_cap)
            if ov[exp_key] <= st[exp_key]:
                ov.pop(exp_key)
        if ptot > st["pb"]:
            ov["pb"] = pad_pow2(ptot + 1024)
        if btot > st["nbk"]:
            ov["nbk"] = pad_pow2(btot + 4096)
            if ov["nbk"] <= st["nbk"]:
                ov.pop("nbk")
        if rtot > st["pd"]:
            ov["pd"] = pad_pow2(rtot + 64)
        if not ov:
            break
        st = dict(st, **ov)
        row = _pair_pack(*_pair_core(*args, **st)).cpu().numpy()
    csorted = cs_b.cpu().numpy().reshape(Q, Adm)
    return extract_candidates(bank, p, rids, row, csorted, Q, Adm,
                              pd=st["pd"])


def reference_records(bank: Bank, p: DmParams, device,
                      ledger: bool = True) -> np.ndarray:
    """The records of the whole bank, [k, RECORD_FIELDS] int64 in emission
    order.  With ledger False the emission drops its pair ledger (a pair
    emitted once may be emitted again): the check's control."""
    return emit(bank, p, reference_candidates(bank, p, device), ledger)


def emit(bank: Bank, p: DmParams, cands, ledger: bool = True) -> np.ndarray:
    """The sequential acceptance of every batch's candidates, in order."""
    em = Emission(bank, p, ledger)
    recs = [em.batch(c, a) for c, a in cands]
    return np.concatenate(recs) if recs else \
        np.zeros((0, RECORD_FIELDS), np.int64)


def _cand_core(rids, qlens, qskip, k16, didx, read_lens, *, Q, Lc, A, Adm,
               cbud, kq, ksave, kovl, len_ratio):
    n = read_lens.shape[0]
    dev = rids.device
    qk, qoff, qspan, qdir, qvalid = gather_query_rows(k16, rids, Lc)
    kvalid = qvalid & subsample_mask(qk, ksave)
    sup0 = torch.zeros((Q, 0), dtype=torch.int32, device=dev)
    supc0 = torch.zeros((Q,), dtype=torch.int32, device=dev)
    cands, ols, cand_total, probe_total = scan_candidates(
        qk, qoff, qspan, kvalid, rids, qlens, qskip,
        didx.k_kmers, didx.k_rd, didx.k_dir, read_lens,
        sup0, supc0, budget=cbud, ncand=A, kovl=kovl, len_ratio=len_ratio,
        probe_budget=kq,
    )
    cands_dm = cands[:, :Adm]
    key = torch.where(cands_dm < 0, int(INT32_MAX), cands_dm)
    order = torch.argsort(key, dim=1, stable=True)
    csorted = torch.take_along_dim(key, order, 1)
    osorted = torch.take_along_dim(ols[:, :Adm], order, 1)
    c = csorted.clamp(0, n - 1)
    zneed = torch.where(csorted < n, didx.rm_start[c + 1] - didx.rm_start[c],
                        0).sum(dtype=torch.int32)
    live_cands = (csorted < n).sum(dtype=torch.int32)
    sizes = torch.stack([zneed, cand_total.to(torch.int32),
                         probe_total.to(torch.int32), live_cands])
    return csorted, osorted, sizes


def _pair_core(rids, qlens, csorted, z10, didx, read_lens, *, Q, Lc, Adm, mb,
               pb, nbk, qkb, nb, kvar, zbits, max_per_read, xvar, yvar,
               min_block_len, max_overhang, deviation_penalty, gap_penalty,
               matcher="sweep", cx=0, pd=None, max_len=1 << 17):
    n = read_lens.shape[0]
    dev = rids.device
    if matcher == "sweep":
        pairs = extract_zmer_pairs_sweep(
            rids, torch.zeros(Q, dtype=torch.bool, device=dev), csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_rd, didx.rm_start, read_lens,
            didx.rm_cnt,
            cross_budget=cx or pb, occ_budget=mb, kvar=kvar, zbits=zbits,
            pair_budget=pb if cx else None,
        )
    else:
        zk, zoff, zspan, zdir, zvalid = gather_query_rows(z10, rids, Lc)
        pairs = extract_zmer_pairs_join(
            zk, zdir, zoff, zspan, zvalid, csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_start, read_lens,
            expand_budget=mb, pair_budget=pb, kvar=kvar, zbits=zbits,
            max_per_read=max_per_read, qprobe_budget=qkb,
        )
    clen_of_pair = torch.repeat_interleave(
        torch.where(csorted < n, read_lens[csorted.clamp(0, n - 1)], 0)
        .to(torch.int32).reshape(-1), 2)
    qlen_of_pair = torch.repeat_interleave(qlens.to(torch.int32), Adm * 2)
    res = dot_matrix_align(
        pairs, qlen_of_pair, clen_of_pair,
        n_pairs=Q * Adm * 2, nb=nb, xvar=xvar, yvar=yvar,
        min_block_len=min_block_len, max_overhang=max_overhang,
        deviation_penalty=deviation_penalty, gap_penalty=gap_penalty, nbk=nbk,
        pd=pd, max_len=max_len,
    )
    totals = torch.stack([
        pairs.total.to(torch.int32), pairs.expand_total.to(torch.int32),
        res.blk_total.to(torch.int32), res.row_total.to(torch.int32),
    ])
    return res, totals


def _pair_pack(res, totals):
    return torch.cat([res.pair_id, res.score, res.tb, res.te, res.qb, res.qe,
                      res.match_cnt, totals])


def _nbest_of(p, length, avg_len):
    return max(p.nbest, p.nbest * int(length) // max(1, avg_len))


def extract_candidates(bank, p, rids, row, csorted, Q, A, pd):
    """Candidate overlaps of a batch in emission order, and its attempted
    pairs (the stateless half of the emission)."""
    n = len(bank)
    NP = Q * A * 2
    W = pd
    pair_id = row[0: W]
    score_a = row[W: 2 * W]
    tb_a = row[2 * W: 3 * W]
    te_a = row[3 * W: 4 * W]
    qb_a = row[4 * W: 5 * W]
    qe_a = row[5 * W: 6 * W]
    match_cnt = row[6 * W: 6 * W + NP]
    lens = bank.lengths[rids]
    rowmap = np.full(NP + 1, -1, np.int64)
    livep = pair_id < NP
    rowmap[pair_id[livep]] = np.nonzero(livep)[0]
    mc = match_cnt.reshape(Q, A, 2).sum(axis=2)
    live_slot = csorted < n
    attempted_mask = live_slot & (mc * p.zsize >= p.ztot)
    pid0 = (np.arange(Q)[:, None] * A + np.arange(A)[None, :]) * 2
    r0 = rowmap[np.minimum(pid0, NP)]
    r1 = rowmap[np.minimum(pid0 + 1, NP)]
    w0 = np.where(r0 >= 0, score_a[np.clip(r0, 0, W - 1)], 0)
    w1 = np.where(r1 >= 0, score_a[np.clip(r1, 0, W - 1)], 0)
    d_best = (w0 < w1).astype(np.int64)
    r_best = np.where(d_best == 1, r1, r0)
    w_best = np.where(d_best == 1, w1, w0)
    has_row = r_best >= 0
    rb_c = np.clip(r_best, 0, W - 1)
    tb = tb_a[rb_c]
    te = te_a[rb_c]
    qb = qb_a[rb_c]
    qe = qe_a[rb_c]
    ol = np.maximum(te - tb, qe - qb)
    ok = (attempted_mask & has_row & (ol > 0)
          & (w_best >= p.min_score)
          & (w_best >= (p.min_id * ol).astype(np.int64)))
    qs, ss = np.nonzero(ok)
    order = np.lexsort((-w_best[qs, ss], qs))
    qs, ss = qs[order], ss[order]
    cand_arr = np.stack([
        qs, rids[qs], lens[qs], csorted[qs, ss], w_best[qs, ss],
        d_best[qs, ss], tb[qs, ss], te[qs, ss], qb[qs, ss], qe[qs, ss],
        ol[qs, ss],
    ], axis=1).astype(np.int64) if qs.size else np.zeros((0, 11), np.int64)
    aq, as_ = np.nonzero(attempted_mask)
    att_arr = np.stack([aq, rids[aq], lens[aq], csorted[aq, as_]],
                       axis=1).astype(np.int64) \
        if aq.size else np.zeros((0, 4), np.int64)
    return cand_arr, att_arr


class Emission:
    """The host emission's sequential acceptance, batch after batch: how
    many dovetail records each read has (nbest) and the pairs emitted
    (the pair ledger, dropped when `ledger` is False)."""

    def __init__(self, bank, p, ledger: bool = True):
        self.p, self.ledger = p, ledger
        self.lens = bank.lengths.astype(np.int64)
        self.avg_len = bank.avg_len()
        self.rdcovs = np.zeros(len(bank), np.int64)
        self.emitted = set()

    def batch(self, cand_arr, att_arr) -> np.ndarray:
        p, lens, rdcovs = self.p, self.lens, self.rdcovs
        dead = {}
        for arr in (att_arr, cand_arr):
            for r in arr[:, :3].tolist():
                if r[1] not in dead:
                    dead[r[1]] = rdcovs[r[1]] >= _nbest_of(p, r[2],
                                                           self.avg_len)
        attempted_now = set()
        for _qo, qrid, _qlen, cand in att_arr.tolist():
            if qrid != cand and not dead[qrid]:
                attempted_now.add((qrid, cand))
        out = []
        for _qo, qrid, qlen, cand, sc, dr, tb, te, qb, qe, o in \
                cand_arr.tolist():
            if cand == qrid or dead[qrid]:
                continue
            key = (min(qrid, cand), max(qrid, cand))
            if self.ledger and key in self.emitted:
                continue
            if self.ledger and (cand, qrid) in attempted_now and cand < qrid:
                continue
            self.emitted.add(key)
            out.append((qrid, cand, dr, tb, te, qb, qe, sc, o))
            x1 = min(tb, qb)
            x2 = min(qlen - te, int(lens[cand]) - qe)
            if x1 + x2 <= p.max_unalign_dovetail:
                rdcovs[qrid] += 1
                rdcovs[cand] += 1
        return np.array(out, np.int64).reshape(-1, RECORD_FIELDS)


def mismatches(ref: np.ndarray, got: np.ndarray) -> int:
    """Records in one list and not in the other (as multisets), or 1
    where both hold the same records in another order."""
    a = Counter(map(tuple, ref.tolist()))
    b = Counter(map(tuple, got.tolist()))
    diff = sum(((a - b) + (b - a)).values())
    if diff == 0 and not np.array_equal(ref, got):
        return 1
    return diff
