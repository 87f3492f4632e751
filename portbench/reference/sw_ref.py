"""The plain reference of the `overlap_sw` units: the SW (zmo) engine's
records of a `-P/-p` part's query batches, worked out again from the
reads, and the check of any record's CIGAR against the reads alone.

`part_records` runs, over the whole bank, the frozen plain dm path
(`reference/dm/`: the flat seeds and both posting indexes, the candidate
scan, the z-mer matchers and the dot matrix's chains) at the budgets and
matcher pick of the part's own batches; then, batch by batch, the SW
tail (`sw/localdp.py`: the top C chains of each query through the banded
local DP, both strands' passes), a copy of the SW emission (DP score and
identity filters, the pair ledger, nbest and the contained mask, carried
from batch to batch) and the accepted overlaps' CIGARs (`sw/cigar.py`).
The first batch of a part starts from an empty emission state, so it is
judged from the reads alone.

`cigar_faults` replays each record's CIGAR over its two segments, the
query's [beg1, end1) and the candidate's [beg2, end2) on its strand, as
the reference's check_kswx_cigar does (hzm_aln.h:226-276): it must take
exactly end1 - beg1 query bases, stay inside the candidate's segment,
and give the record's mat, mis, ins, dl, aln and identity.

It imports nothing of the program and reads nothing that it made.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter

import numpy as np
import torch

from .dm.flatseeds import build_bank_indexes, pad_pow2
from .overlap_ref import (CHUNK, Bank, DmParams, _cand_core, _nbest_of,
                          _pair_core, pad_tier)
from .sw.cigar import cigars
from .sw.localdp import sw_tail

# a record: the 17 columns of a .ovl line (read ids for names) and aln
FIELDS = ("rid1", "dir1", "len1", "beg1", "end1", "rid2", "dir2", "len2",
          "beg2", "end2", "score", "identity", "mat", "mis", "ins", "dl",
          "cigar", "aln")


@dataclasses.dataclass(frozen=True)
class SwParams(DmParams):
    """The SW engine's parameters (wtzmo's defaults; the zmo flags come
    from the configuration)."""

    sw_match: int = 2
    sw_mismatch: int = -5
    sw_gap: int = -3
    band_w: int = 256
    align_cap: int = 64
    emit_cigar: bool = True
    refine: bool = False


def part_queries(n: int, parts: int, part: int) -> np.ndarray:
    """The query ids of part `part` of `parts` (wtzmo -P/-p)."""
    q = np.arange(n)
    return q if parts <= 1 else q[part::parts]


def part_records(bank: Bank, p: SwParams, parts: int, part: int, device,
                 batches: int | None = None) -> list[tuple]:
    """The records of the part's first `batches` query batches (all where
    None), in emission order, each a tuple in FIELDS' order."""
    if p.refine:
        raise NotImplementedError("the reference has no -n refine pass")
    # no float product runs here; TF32 stays off, as in every plain reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    n = len(bank)
    # the bank on the device: quarter-pow2 padded, as every side indexes it
    total = int(bank.offsets[-1])
    Npad = pad_pow2(n, lo=1 << 8)
    flat = np.full(pad_pow2(total + 1), 4, np.uint8)
    flat[:total] = bank.bases
    offs = np.full(Npad + 1, total, np.int64)
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
    kavg = int(comp_len.sum() // max(1, int(stats[5 * Npad + 3]) * p.ksave))
    A, Q = p.ncand, p.batch_q
    Lc = pad_pow2(int(stats[5 * Npad]), lo=1 << 10)
    qarr = part_queries(n, parts, part)
    bl = [qarr[i: i + Q] for i in range(0, len(qarr), Q)]
    B = len(bl)
    chunks, c0 = [], 0
    while c0 < B:
        sz = min(CHUNK, 1 << (B - c0).bit_length() - 1)
        while sz > B - c0:
            sz >>= 1
        chunks.append((c0, sz))
        c0 += sz
    C = min(p.align_cap, A)
    Ltier = pad_tier(int(bank.lengths[0]))
    lens_d = torch.from_numpy(bank.lengths.astype(np.int32)).to(dev)

    def batch_inputs(rids_np):
        rids = np.concatenate(
            [rids_np, np.full(Q - len(rids_np), rids_np[-1], rids_np.dtype)]
        ).astype(np.int32)
        qskip = np.zeros(Q, bool)
        qskip[len(rids_np):] = True
        return rids, bank.lengths[rids].astype(np.int32), qskip

    # phase 1 of every batch of the part: its sizes set the budgets
    cbud = min(pad_pow2(max(int(kneed[b].sum()) for b in bl) + 1024,
                        lo=1 << 14), p.expand_budget_cap)
    kq = pad_pow2(max(int(kprobes[b].sum()) for b in bl) + Q, lo=1 << 12)
    rids_all = np.stack([batch_inputs(b)[0] for b in bl])
    cands, sizes = [], []
    for b in bl:
        rids, qlens, qskip = (torch.from_numpy(x).to(dev)
                              for x in batch_inputs(b))
        cs, _os, size = _cand_core(
            rids, qlens, qskip, k16, didx, lens_d, Q=Q, Lc=Lc, A=A, Adm=A,
            cbud=cbud, kq=kq, ksave=p.ksave, kovl=p.kovl,
            len_ratio=p.len_ratio)
        cands.append(cs)
        sizes.append(size.cpu().numpy())
    sizes = np.stack(sizes)
    qkb_z = pad_pow2(max(int(zcnt[r].sum()) for r in rids_all) + Q,
                     lo=1 << 13)
    qkb_c = pad_pow2(max(int(comp_len[b].sum()) for b in bl) + Q, lo=1 << 13)
    qkb = {"sweep": qkb_z, "join": qkb_c}.get(p.matcher, max(qkb_z, qkb_c))
    static = dict(
        Q=Q, Lc=Lc, Adm=A, qkb=qkb, nb=p.nb, kvar=p.kvar, zbits=2 * p.zsize,
        max_per_read=p.max_zmer_freq, xvar=p.xvar, yvar=p.yvar,
        min_block_len=p.min_block_len, max_overhang=p.max_overhang,
        deviation_penalty=p.deviation_penalty, gap_penalty=p.gap_penalty,
        pd=pad_pow2(2 * int(sizes[:, 3].max()) + 64, lo=1 << 12),
        max_len=Ltier)

    def sweep_budgets(lo, hi):
        occ = max(int(zcnt[rids_all[bi]].sum()) for bi in range(lo, hi))
        cxn = max(int(cross[rids_all[bi]].sum()) for bi in range(lo, hi))
        cx = min(pad_pow2(cxn + 1024, lo=1 << 14), p.expand_budget_cap)
        pb = max(cx // (2 if kavg >= 10 else 4), 1 << 14)
        return dict(mb=pad_pow2(occ + Q, lo=1 << 12), cx=cx, pb=pb,
                    nbk=max(pb // 4, 1 << 14), matcher="sweep")

    def join_budgets(zneed):
        mb = min(pad_pow2(zneed + 1024, lo=1 << 14), p.expand_budget_cap)
        pb = min(pad_pow2(zneed * 3 // 4 + 1024, lo=1 << 14), mb)
        return dict(mb=mb, pb=pb, nbk=pad_pow2(max(pb * 3 // 16, 1 << 14)),
                    cx=0, matcher="join")

    def chunk_budgets(c0, sz):
        join_need = int(sizes[c0: c0 + sz, 0].max())
        if p.matcher == "sweep":
            return sweep_budgets(c0, c0 + sz)
        if p.matcher == "join":
            return join_budgets(join_need)
        cross_need = max(int(cross[rids_all[bi]].sum())
                         for bi in range(c0, c0 + sz))
        if cross_need <= join_need and cross_need < p.expand_budget_cap:
            return sweep_budgets(c0, c0 + sz)
        return join_budgets(join_need)

    em = Emission(bank, p)
    sw_kw = dict(Q=Q, A=A, C=C, Ltier=Ltier, W=p.band_w, match=p.sw_match,
                 mismatch=p.sw_mismatch, gap=p.sw_gap)
    out = []
    last = B if batches is None else min(batches, B)
    for c0, sz in chunks:
        if c0 >= last:
            break
        bud = chunk_budgets(c0, sz)
        for bi in range(c0, min(c0 + sz, last)):
            rids, qlens, _ = batch_inputs(bl[bi])
            rids_d = torch.from_numpy(rids).to(dev)
            qlens_d = torch.from_numpy(qlens).to(dev)
            res = _dm_chains(rids_d, qlens_d, cands[bi], z10, didx, lens_d,
                             p, {**static, **bud})
            # the query batch from the flat bank
            lanes = torch.arange(Ltier, dtype=torch.int32, device=dev)[None]
            pos = offs_d[rids_d.long()][:, None] + lanes
            qbatch = torch.where(
                lanes < qlens_d[:, None],
                flat_d[pos.clamp(0, flat_d.shape[0] - 1).long()],
                torch.tensor(4, dtype=torch.uint8, device=dev))
            del pos
            row = sw_tail(res.pair_id, res.score, res.tb, res.te, res.qb,
                          res.qe, cands[bi], qbatch, qlens_d, flat_d, offs_d,
                          lens_d, **sw_kw).cpu().numpy()
            del res, qbatch
            out += em.batch(rids, row, C, device=dev)
    return out


def _dm_chains(rids, qlens, csorted, z10, didx, lens_d, p, st):
    """The dot matrix's chains of a batch, run again at grown budgets
    while a total overflows them (up to four times, as the program's
    redispatch; the SW engine does not check the pair-row budget)."""
    res, totals = _pair_core(rids, qlens, csorted, z10, didx, lens_d, **st)
    for _attempt in range(4):
        ptot, etot, btot, _rtot = (int(x) for x in totals.cpu().tolist())
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
        if not ov:
            break
        st = dict(st, **ov)
        res, totals = _pair_core(rids, qlens, csorted, z10, didx, lens_d,
                                 **st)
    return res


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


class Emission:
    """The SW emission's sequential acceptance, batch after batch: the
    dovetail records of each read (nbest), the contained mask and the
    pairs emitted; then the accepted overlaps' CIGARs."""

    def __init__(self, bank: Bank, p: SwParams):
        self.bank, self.p = bank, p
        self.avg_len = bank.avg_len()
        self.rdcovs = np.zeros(len(bank), np.int64)
        self.rdmask = np.zeros(len(bank), bool)
        self.emitted: set = set()

    def read(self, rid: int) -> np.ndarray:
        o = self.bank.offsets
        return self.bank.bases[o[rid]: o[rid + 1]]

    def batch(self, rids, row, C, device) -> list[tuple]:
        p, lens = self.p, self.bank.lengths
        QC = rids.shape[0] * C
        cand, drs, _chain, score, mat, ba, ea, bb, eb = (
            row[k * QC: (k + 1) * QC] for k in range(9))
        attempted = set()
        hits = []
        for i in range(QC):
            c, qrid = int(cand[i]), int(rids[i // C])
            if c < 0 or c == qrid:
                continue
            qlen = int(lens[qrid])
            if self.rdmask[qrid] or self.rdcovs[qrid] >= _nbest_of(
                    p, qlen, self.avg_len):
                continue
            attempted.add((qrid, c))
            sc = int(score[i])
            aln = max(int(ea[i] - ba[i]), int(eb[i] - bb[i]))
            if aln <= 0 or sc < p.min_score or mat[i] / aln < p.min_id:
                continue
            hits.append((qrid, qlen, c, int(drs[i]), int(ba[i]), int(ea[i]),
                         int(bb[i]), int(eb[i]), sc, int(mat[i]), aln))
        recs = []
        for qrid, qlen, c, dr, tb, te, qb, qe, sc, m, aln in hits:
            key = (min(qrid, c), max(qrid, c))
            if ((c, qrid) in attempted and c < qrid) or key in self.emitted:
                continue
            self.emitted.add(key)
            clen = int(lens[c])
            recs.append([qrid, 0, qlen, tb, te, c, dr, clen, qb, qe, sc,
                         m / aln, m, 0, 0, 0, f"{aln}M", aln])
            if min(tb, qb) + min(qlen - te, clen - qe) \
                    <= p.max_unalign_dovetail:
                self.rdcovs[qrid] += 1
                self.rdcovs[c] += 1
            if qb <= 0 and qe >= clen:
                self.rdmask[c] = True
        if p.emit_cigar and recs:
            segs = []
            for r in recs:
                cb = self.read(r[5])
                segs.append((self.read(r[0])[r[3]: r[4]],
                             (revcomp(cb) if r[6] else cb)[r[8]: r[9]]))
            got = cigars(segs, W=p.band_w, match=p.sw_match,
                         mismatch=p.sw_mismatch, gap=p.sw_gap, device=device)
            for r, g in zip(recs, got):
                if g is not None:
                    r[16], r[12], r[13], r[14], r[15], r[17] = g
                    r[11] = r[12] / max(1, r[17])
        return [tuple(r) for r in recs]


def mismatches(ref: list[tuple], got: list[tuple]) -> int:
    """Records in one list and not in the other (as multisets), or 1
    where both hold the same records in another order."""
    a, b = Counter(ref), Counter(got)
    diff = sum(((a - b) + (b - a)).values())
    return 1 if diff == 0 and ref != got else diff


CIGAR = re.compile(rb"(?:[0-9]+[MID])+")


def _parse(cigars: list[bytes]):
    """(op codes 0 M / 1 I / 2 D, counts, ops a CIGAR) of well-formed
    CIGAR strings laid end to end."""
    s = np.frombuffer(b"".join(cigars), np.uint8)
    is_op = s >= 65
    at = np.flatnonzero(is_op)
    digits = np.flatnonzero(~is_op)
    val = np.zeros(s.size, np.int64)
    val[digits] = (s[digits].astype(np.int64) - 48) * 10 ** (
        at[np.searchsorted(at, digits)] - digits - 1)
    counts = np.add.reduceat(val, np.concatenate([[0], at[:-1] + 1]))
    ops = np.select([s[at] == 77, s[at] == 73], [0, 1], 2)
    return ops, counts, np.array([c.count(b"M") + c.count(b"I")
                                  + c.count(b"D") for c in cigars])


def cigar_faults(records: list[tuple], bank: Bank, chunk: int = 1024) -> int:
    """Records whose CIGAR does not replay over their two segments into
    their own mat, mis, ins, dl, aln and identity (see the module's
    docstring).  Where the CIGAR takes fewer candidate bases than the
    segment holds, it may start at any offset that keeps it inside, and
    one such offset must give the counts.  A chunk of records at a time,
    their ops laid end to end."""
    # the bank and, after it, its reverse complement read for read: a
    # candidate's segment on either strand is a run of increasing indices
    both = np.concatenate([bank.bases, revcomp(bank.bases)])
    faults = 0
    for c0 in range(0, len(records), chunk):
        recs = [r for r in records[c0: c0 + chunk]
                if CIGAR.fullmatch(r[16].encode())]
        faults += min(chunk, len(records) - c0) - len(recs)
        if recs:
            faults += _replay_faults(recs, bank, both)
    return faults


def _replay_faults(recs: list[tuple], bank: Bank, both: np.ndarray) -> int:
    """cigar_faults of well-formed CIGARs; `both` is the bank's bases and
    their reverse complement."""
    (rid1, _d1, _l1, beg1, end1, rid2, dir2, _l2, beg2, end2, _sc, ident,
     mat, mis, ins, dl, aln) = (np.array(c) for c in zip(*(
         r[:16] + r[17:] for r in recs)))
    ops, counts, nops = _parse([r[16].encode() for r in recs])
    R = len(recs)
    rec = np.repeat(np.arange(R), nops)               # each op's record

    def per_rec(x):
        return np.bincount(rec, weights=x, minlength=R)

    in_a, in_b = np.where(ops == 2, 0, counts), np.where(ops == 1, 0, counts)
    slack = (end2 - beg2) - per_rec(in_b)
    size = np.diff(bank.offsets)
    ok = ((per_rec(in_a) == end1 - beg1) & (slack >= 0)
          & (0 <= beg1) & (end1 <= size[rid1]) & (0 <= beg2)
          & (end2 <= size[rid2])
          & (per_rec(counts * (ops == 1)) == ins)
          & (per_rec(counts * (ops == 2)) == dl) & (per_rec(counts) == aln)
          & (per_rec(counts * (ops == 0)) == mat + mis))
    ok &= np.array([i == m / max(1, n) for i, m, n in zip(
        ident.tolist(), mat.tolist(), aln.tolist())])
    # each M op of a sound record: its first column in the query segment
    # and, at offset 0, in the candidate's (on its strand), then its run
    first = np.cumsum(nops) - nops
    pa = np.cumsum(in_a) - in_a
    pb = np.cumsum(in_b) - in_b
    pa -= np.repeat(pa[first], nops)
    pb -= np.repeat(pb[first], nops)
    m = np.flatnonzero((ops == 0) & ok[rec])
    r, c = rec[m], counts[m]
    o, total = bank.offsets, int(bank.offsets[-1])
    q0 = o[rid1[r]] + beg1[r] + pa[m]
    c0 = np.where(dir2[r] == 1, 2 * total - o[rid2[r] + 1],
                  o[rid2[r]]) + beg2[r] + pb[m]
    run_end = np.cumsum(c)
    col = np.arange(int(run_end[-1]) if c.size else 0, dtype=np.int64)
    same = np.concatenate([[0], np.cumsum(
        bank.bases[col + np.repeat(q0 - (run_end - c), c)]
        == both[col + np.repeat(c0 - (run_end - c), c)])])
    got = np.bincount(r, weights=same[run_end] - same[run_end - c],
                      minlength=R)
    faults = int((~ok).sum() + (ok & (slack == 0) & (got != mat)).sum())
    # a CIGAR shorter than its candidate segment: any offset that fits
    for k in np.flatnonzero(ok & (slack > 0)):
        faults += not _fits_at_some_offset(recs[k], bank)
    return faults


def _fits_at_some_offset(r: tuple, bank: Bank) -> bool:
    (rid1, _d1, _l1, beg1, end1, rid2, dir2, _l2, beg2, end2, _sc, _id,
     mat, _mis, _ins, _dl, cigar, _aln) = r
    ops, counts, _n = _parse([cigar.encode()])
    col = np.repeat(ops, counts)
    o = bank.offsets
    qa = bank.bases[o[rid1]: o[rid1 + 1]][beg1:end1]
    cb = bank.bases[o[rid2]: o[rid2 + 1]]
    cb = (revcomp(cb) if dir2 else cb)[beg2:end2]
    both = col == 0
    pa = (np.cumsum(col != 2) - 1)[both]
    pb = (np.cumsum(col != 1) - 1)[both]
    slack = cb.size - int((col != 1).sum())
    return any(int((qa[pa] == cb[pb + k]).sum()) == mat
               for k in range(slack + 1))
