"""Overlap re-extension — equivalent of the reference `wtext` (port of
smartdenovo_tpu/pipeline/ext.py; the CIGAR helpers are copies, the
alignments run on a torch device).

Faithful port of `extending_overlap_wtext` (reference wtext.c:128-293):

  1. trim each overlap's CIGAR so the alignment respects the NEW clip
     windows (from wtobt/wtclp) — the front/back CIGAR walks with the
     cx/cy margins (wtext.c:170-215);
  2. recompute the trimmed core's mat/mis/ins/del and affine score
     (wtext.c:225-247);
  3. where an end lies within `max_ext` of the clipped read end
     (wtext.c:248, :266), run a banded extension alignment toward the
     read ends.  The reference's end-clip logic (kswx T penalty) becomes:
     pick the extension end cell maximizing score + (0 if the cell
     touches either sequence end else T) over per-row band maxima —
     batched on device via ops/banded.banded_align(return_rowmax=True)
     (csrc/banded.cu's row-max instance on the card).  The extension's
     CIGAR is the traceback from that chosen cell: a second banded_align
     of the same band over the rows and columns up to it, whose cells
     there are those of the first (a cell depends on none to its right
     or below), walked back from its corner, and run-length encoded by
     native/cigars.cpp (`native.cigar_rle`).

CIGAR convention: 'I' consumes read1 (column 1 of the overlap record),
'D' consumes read2 — the in-repo convention of ops/banded traceback.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.readbank import ReadBank, revcomp_codes
from ..ops.align import pow2_tier, run_lists
from ..ops.banded import banded_align, make_band_centers
from ..utils.log import log
from ..utils.native import Segments, cigar_band, cigar_rle


@dataclasses.dataclass
class ExtParams:
    band_w: int = 256        # -W (reference 800 full width ~ +-400)
    match: int = 2           # -M
    mismatch: int = -5       # -X
    gap_open: int = -3       # -O
    gap_ext: int = -1        # -E  (core rescoring only; DP is linear)
    end_clip: int = -100     # -T
    max_ext: int = 400       # -S


def _parse_cigar(s: str):
    ops, counts = [], []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            if n > 0:
                ops.append(ch)
                counts.append(n)
            n = 0
    return ops, counts


def _cigar_str(ops, counts):
    return "".join(f"{c}{o}" for o, c in zip(ops, counts)) or "0M"


def _trim_front(ops, counts, c1, c2):
    """Walk from the front until >= c1 consumed on read1 and c2 on read2
    (wtext.c:170-192).  Returns (k, cut_len, n1, n2) or None if the
    CIGAR runs out."""
    n1 = n2 = 0
    k = 0
    while k < len(ops):
        op, ln = ops[k], counts[k]
        if op == "I":
            n1 += ln
        elif op == "D":
            n2 += ln
        else:
            if n1 >= c1 and n2 >= c2:
                return k, 0, n1, n2
            d = min(ln, max(c1 - n1, c2 - n2))
            n1 += d
            n2 += d
            if d < ln:
                return k, d, n1, n2
        k += 1
    if n1 >= c1 and n2 >= c2:
        return len(ops), 0, n1, n2
    return None


def _core_stats(a, b, ops, counts, x1, x2):
    """mat/mis/ins/del + affine score of a cigar core (wtext.c:225-247)."""
    mat = mis = ins = dl = 0
    score = 0
    for op, ln in zip(ops, counts):
        if op == "I":
            ins += ln
            x1 += ln
        elif op == "D":
            dl += ln
            x2 += ln
        else:
            seg = int(np.sum(a[x1: x1 + ln] == b[x2: x2 + ln]))
            mat += seg
            mis += ln - seg
            x1 += ln
            x2 += ln
    return mat, mis, ins, dl


def run_ext(rb: ReadBank, overlaps, clips=None, params: ExtParams | None = None,
            *, device="cuda"):
    """Trim overlaps to new clips and re-extend toward read ends, on
    `device`.

    clips: dict name -> (offset, length) (wtobt/wtclp mask) or None for
    whole reads.  Returns a new Overlap list; overlaps whose trimmed core
    vanishes are dropped (like the reference's RET with KSWX_NULL)."""
    from .zmo import Overlap, resolve_device

    p = params or ExtParams()
    dev = resolve_device(device)
    out = []
    ext_jobs = []   # (ovl_index, side, a_codes, b_codes)
    realign_jobs = []  # (ovl_index, core_a, core_b) placeholder cores
    results = {}

    def clip_of(rid):
        if clips is None:
            return 0, int(rb.lengths[rid])
        c = clips.get(rb.names[rid])
        if c is None:
            return 0, int(rb.lengths[rid])
        return int(c[0]), int(c[1])

    kept = []
    for ov in overlaps:
        l1, l2 = int(rb.lengths[ov.rid1]), int(rb.lengths[ov.rid2])
        co1, cl1 = clip_of(ov.rid1)
        co2, cl2 = clip_of(ov.rid2)
        if cl1 <= 0 or cl2 <= 0:
            continue
        ops, counts = _parse_cigar(ov.cigar)
        if not ops or (len(ops) == 1 and ops[0] == "M" and ov.mis == 0
                       and ov.ins == 0 and ov.dl == 0 and ov.identity < 0.999):
            # placeholder cigar (dot-matrix records) — approximate with a
            # single M run over the aligned span
            ops, counts = ["M"], [max(ov.end1 - ov.beg1, ov.end2 - ov.beg2)]
        # oriented-frame left/right margins introduced by the new clip
        dxy = []
        for rid, d, co, cl, L in ((ov.rid1, ov.dir1, co1, cl1, l1),
                                  (ov.rid2, ov.dir2, co2, cl2, l2)):
            dx = L - co - cl if d else co
            dy = co if d else L - co - cl
            dxy.append((dx, dy))
        x = (ov.beg1, ov.beg2)
        y = (l1 - ov.end1, l2 - ov.end2)
        cx = [max(0, dxy[k][0] - x[k]) for k in (0, 1)]
        cy = [max(0, dxy[k][1] - y[k]) for k in (0, 1)]
        front = _trim_front(ops, counts, cx[0], cx[1])
        if front is None:
            continue
        rops = ops[::-1]
        rcnt = counts[::-1]
        back = _trim_front(
            [("I" if o == "I" else "D" if o == "D" else "M") for o in rops],
            rcnt, cy[0], cy[1])
        if back is None:
            continue
        k0, cut0, nx1, nx2 = front
        k1, cut1, ny1, ny2 = back
        core_ops = list(ops[k0: len(ops) - k1])
        core_cnt = list(counts[k0: len(ops) - k1])
        if cut0 and core_ops:
            core_cnt[0] -= cut0
        if cut1 and core_ops:
            core_cnt[-1] -= cut1
        core_ops = [o for o, c in zip(core_ops, core_cnt) if c > 0]
        core_cnt = [c for c in core_cnt if c > 0]
        if not core_ops:
            continue
        # new coordinates in the CLIPPED oriented frame
        tb = ov.beg1 + nx1 - dxy[0][0]
        qb = ov.beg2 + nx2 - dxy[1][0]
        te = ov.end1 - ny1 - dxy[0][0]
        qe = ov.end2 - ny2 - dxy[1][0]
        if tb >= te or qb >= qe:
            continue
        a1 = rb.get(ov.rid1)
        if ov.dir1:
            a1 = revcomp_codes(a1)
        a1 = a1[dxy[0][0]: dxy[0][0] + cl1]
        a2 = rb.get(ov.rid2)
        if ov.dir2:
            a2 = revcomp_codes(a2)
        a2 = a2[dxy[1][0]: dxy[1][0] + cl2]
        idx = len(kept)
        # placeholder single-M cores (dot-matrix records carry no CIGAR)
        # cannot represent unequal spans — realign them with the refine
        # kernel so downstream consumers get true CIGARs + stats
        placeholder = (len(core_ops) == 1 and core_ops[0] == "M"
                       and (te - tb != qe - qb or ov.identity < 0.999))
        if not placeholder:
            mat, mis, ins, dl = _core_stats(a1, a2, core_ops, core_cnt, tb, qb)
        else:
            mat = mis = ins = dl = 0
            realign_jobs.append((idx, a1[tb:te].copy(), a2[qb:qe].copy()))
        kept.append(dict(ov=ov, tb=tb, te=te, qb=qb, qe=qe, cl1=cl1, cl2=cl2,
                         ops=core_ops, cnt=core_cnt,
                         mat=mat, mis=mis, ins=ins, dl=dl))
        if tb <= p.max_ext or qb <= p.max_ext:
            ext_jobs.append((idx, 0, a1[:tb][::-1].copy(), a2[:qb][::-1].copy()))
        if cl1 - te <= p.max_ext or cl2 - qe <= p.max_ext:
            ext_jobs.append((idx, 1, a1[te:].copy(), a2[qe:].copy()))

    # ---- realign placeholder cores (refine around the diagonal) ----
    if realign_jobs:
        from ..ops.refine import refine_alignment_batch

        for g0 in range(0, len(realign_jobs), 64):
            grp = realign_jobs[g0: g0 + 64]
            wb = max(64, max(2 * abs(len(a_) - len(b_)) + 64
                             for _, a_, b_ in grp))
            res = refine_alignment_batch(
                [(a_, b_) for _, a_, b_ in grp],
                [(["M"], [max(len(a_), len(b_))]) for _, a_, b_ in grp],
                W_base=min(wb, 1024), match=p.match, mismatch=p.mismatch,
                open_i=p.gap_open, open_d=p.gap_open, ext=p.gap_ext,
                device=dev)
            for (idx, _a, _b), r in zip(grp, res):
                kept[idx].update(ops=r["ops"], cnt=r["counts"], mat=r["mat"],
                                 mis=r["mis"], ins=r["ins"], dl=r["dl"])

    # ---- batched extension alignments ----
    for g0 in range(0, len(ext_jobs), 64):
        group = [j for j in ext_jobs[g0: g0 + 64]
                 if len(j[2]) > 0 and len(j[3]) > 0]
        if not group:
            continue
        B = len(group)
        segs = Segments.from_pairs([(ja, jb) for _, _, ja, jb in group])
        LA = pow2_tier(int(segs.alen.max()))
        a, b, _ = cigar_band(segs, np.arange(B), LA, p.band_w)
        alen, blen = segs.alen.astype(np.int32), segs.blen.astype(np.int32)
        # extension continues on the alignment's diagonal (slope 1 from
        # the overlap edge), not the (0,0)->(al,bl) interpolation
        anchors = [[(0, 0), (int(min(alen[i], blen[i])),
                             int(min(alen[i], blen[i])))] for i in range(B)]
        base = make_band_centers(anchors, alen, blen, LA, p.band_w)
        kw = dict(LA=LA, W=p.band_w, match=p.match, mismatch=p.mismatch,
                  gap=p.gap_open, semiglobal_b=False)
        fwd = banded_align(
            *(torch.from_numpy(x).to(dev) for x in (a, b, alen, blen, base)),
            return_rowmax=True, **kw)
        rmax = fwd[5].cpu().numpy()
        rcol = fwd[6].cpu().numpy()
        del fwd
        rows = np.arange(LA + 1)[None, :]
        at_end = (rows >= alen[:, None]) | (rcol >= blen[:, None])
        bonus = np.where(at_end, 0, p.end_clip)
        eff = np.where(rows <= alen[:, None], rmax + bonus, -(1 << 30))
        besti = np.argmax(eff, axis=1)
        bests = rmax[np.arange(B), besti]
        # the traceback from each chosen cell (besti, its column): the DP
        # again over the rows and columns up to that cell, walked back
        # from its corner
        cigs = [([], [])] * B
        sel = np.nonzero(bests > 0)[0]
        if sel.size:
            ecol = rcol[sel, besti[sel]].astype(np.int32)
            _s, _e, _d, mvs, j_fin = banded_align(
                *(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (a[sel], b[sel], besti[sel].astype(np.int32),
                            ecol, base[sel])), **kw)
            del _d
            ops, cnt, offs, _bb = cigar_rle(mvs.t().contiguous().cpu().numpy(),
                                            j_fin.cpu().numpy())
            sc = run_lists(ops, cnt, offs[:-1], offs[1:])
            for k, i in enumerate(sel):
                cigs[i] = sc[k]
        for i, (idx, side, ja, jb) in enumerate(group):
            if bests[i] <= 0:
                continue
            ei = int(besti[i])
            ej = int(rcol[i, besti[i]])
            eops, ecnt = cigs[i]
            m, ms, inn, dll = _core_stats(ja, jb, eops, ecnt, 0, 0)
            results[(idx, side)] = (ei, ej, eops, ecnt, m, ms, inn, dll)

    for idx, rec in enumerate(kept):
        ov = rec["ov"]
        tb, te, qb, qe = rec["tb"], rec["te"], rec["qb"], rec["qe"]
        ops, cnt = rec["ops"], rec["cnt"]
        mat, mis, ins, dl = rec["mat"], rec["mis"], rec["ins"], rec["dl"]
        left = results.get((idx, 0))
        if left:
            ei, ej, eops, ecnt, m, ms, inn, dll = left
            tb -= ei
            qb -= ej
            ops = eops[::-1] + ops
            cnt = ecnt[::-1] + cnt
            mat += m; mis += ms; ins += inn; dl += dll
        right = results.get((idx, 1))
        if right:
            ei, ej, eops, ecnt, m, ms, inn, dll = right
            te += ei
            qe += ej
            ops = ops + eops
            cnt = cnt + ecnt
            mat += m; mis += ms; ins += inn; dl += dll
        aln = mat + mis + ins + dl
        n_gaps = sum(1 for o in ops if o != "M")
        score = (mat * p.match + mis * p.mismatch
                 + n_gaps * p.gap_open + (ins + dl) * p.gap_ext)
        out.append(Overlap(
            rid1=ov.rid1, dir1=ov.dir1, beg1=tb, end1=te,
            rid2=ov.rid2, dir2=ov.dir2, beg2=qb, end2=qe,
            score=score, identity=mat / max(1, aln), mat=mat, mis=mis,
            ins=ins, dl=dl, aln=aln, cigar=_cigar_str(ops, cnt),
        ))
    log("wtext: %d overlaps in, %d out, %d extensions",
        len(overlaps), len(out), len(results))
    return out
