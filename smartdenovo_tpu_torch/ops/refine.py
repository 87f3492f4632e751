"""CIGAR-guided refine alignment: a global affine banded DP around a prior
alignment path, with its traceback (port of smartdenovo_tpu/ops/refine.py,
`jax.jit` over `lax.scan`; the reference's `kswx_refine_alignment`,
kswx.h:483-659).

Cell recurrences are kswx.h:602-631's, gap lanes opening from the
diagonal candidate m:

    m      = H[i-1][j-1] + sub(a_i, b_j)
    h      = max(m, E[j], F)        (ties: m wins over E; F only if >)
    E[j]   = max(E[j] + ext, m + open_i + ext)
    F      = max(F    + ext, m + open_d + ext)

Direction byte: bits 0-1 the argmax of h (0 diag, 1 E, 2 F), bit 2 E
extended, bit 5 F extended; the traceback is the reference's state
machine (`traceback.tb_refine`).

`refine_banded_affine` dispatches on the tensors' device: on CUDA the
kernel of csrc/refine.cu (one warp per alignment, DP then traceback, the
affine cost model), on the CPU `refine_banded_affine_plain` and
`traceback.tb_refine`.  `band_from_cigar` is a copy of the JAX package's.
`refine_batch` is the host side of one batch of either refine (the
quality-aware one in ops/refine5q.py passes its DP and tracks); it
decodes the moves with `native.cigar_rle`, held equal to the plain
`traceback_refine`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from ..utils.native import cigar_rle
from ..utils.timing import span
from .align import plane_fits, pow2_tier, run_lists, tier_chunks
from .traceback import rle_moves, tb_refine

NEG = -10000
_OP_CODE = {"M": 0, "I": 1, "D": 2}
W_TIERS = (64, 128, 256, 512, 1024)   # band widths refine.cu takes
# refine's move codes (0 M, 1 I, 2 D, 3 no-op) as banded_align's (1 M,
# 2 I, 3 D, 0 no-op), which cigar_rle decodes
BANDED_MOVES = np.array([1, 2, 3, 0], np.int8)


def refine_banded_affine(a, b, alen, blen, base, *, LA: int, W: int = 128,
                         match: int = 2, mismatch: int = -5, open_i: int = -3,
                         open_d: int = -3, ext: int = -1):
    """Global alignment (0, 0) -> (alen, blen) in the band `base`.

    a [B, LA] u8 (query rows), b [B, LB] u8 (target columns), alen, blen
    [B] i32, base [B, LA+1] i32.  Returns (score [B] i32, dirs [B, LA+1,
    W] u8, mvs [T, B] i8), T = 2 (LA + 1) + W + 4: score and the rows
    0..alen of dirs are the JAX function's, mvs its `tb_refine_device`
    (0 M, 1 I, 2 D, 3 done)."""
    kw = dict(LA=LA, W=W, match=match, mismatch=mismatch, open_i=open_i,
              open_d=open_d, ext=ext)
    if a.device.type == "cuda":
        return refine_cuda(a, b, alen, blen, base, None, **kw)
    if a.device.type == "cpu":
        score, dirs = refine_banded_affine_plain(a, b, alen, blen, base, **kw)
        return score, dirs, tb_refine(dirs, base, alen, blen,
                                      T=2 * (LA + 1) + W + 4)
    raise ValueError(f"refine_banded_affine: unsupported device {a.device}")


def fscan_excl(v, ext, neg):
    """F[c] = max_{k<c} v[k] + ext (c - 1 - k), NEG in lane 0: the JAX
    associative max-plus scan shifted by one, as ext (c - 1) +
    cummax(v[k] - ext k)."""
    W = v.shape[1]
    ramp = ext * torch.arange(W, dtype=torch.int32, device=v.device)[None, :]
    s = torch.cummax(v - ramp, dim=1).values + ramp
    return torch.cat([neg.expand(v.shape[0], 1), s[:, :-1]], dim=1)


def refine_banded_affine_plain(a, b, alen, blen, base, *, LA, W, match,
                               mismatch, open_i, open_d, ext):
    """Plain PyTorch version of the DP: one row of the JAX scan per loop
    turn over [B, W], int32.  Rows past a read's alen are masked as in
    JAX; rows past the batch's largest alen are skipped (dirs 0).
    Returns (score, dirs)."""
    B = a.shape[0]
    LB = b.shape[1]
    dev = a.device
    i32, u8 = torch.int32, torch.uint8
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    ai = a.to(i32)
    bi = b.to(torch.int64)
    alen = alen.to(i32)
    blen_c = blen.to(i32)[:, None]
    base = base.to(i32)
    c_match = torch.tensor(match, dtype=i32, device=dev)
    c_mismatch = torch.tensor(mismatch, dtype=i32, device=dev)
    neg_col = neg.expand(B, 1)

    def shifted(x, idx):
        ok = (idx >= 0) & (idx < W)
        return torch.where(ok, torch.gather(x, 1, idx.clamp(0, W - 1).long()),
                           neg)

    j = base[:, 0:1] + lanes
    h = torch.where((j == 0) & (j <= blen_c), torch.zeros_like(j), neg)
    e = torch.full((B, W), NEG, dtype=i32, device=dev)
    hold = h
    rows = max(0, min(int(alen.max()) if B else 0, LA))
    dirs = torch.zeros((B, LA + 1, W), dtype=u8, device=dev)
    for i in range(1, rows + 1):
        bs = base[:, i:i + 1]
        j = bs + lanes
        idx_up = lanes + (bs - base[:, i - 1:i])
        hdg = shifted(h, idx_up - 1)
        eup = shifted(e, idx_up)
        ac = ai[:, i - 1:i]
        bc = torch.gather(bi, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        sub = torch.where((ac == bc) & (ac < 4) & (bc < 4), c_match,
                          c_mismatch)
        okj = (j >= 1) & (j <= blen_c)
        m = torch.where(okj, hdg + sub, neg)
        d = (m < eup).to(u8)
        hh = torch.maximum(m, eup)
        v = m + (open_d + ext)
        f = fscan_excl(v, ext, neg)
        use_f = f > hh
        d = torch.where(use_f, torch.full_like(d, 2), d)
        hh = torch.maximum(hh, f)
        e_ext = eup + ext
        e_open = m + (open_i + ext)
        d = d | ((e_ext > e_open).to(u8) << 2)
        e_next = torch.maximum(e_ext, e_open)
        f1 = torch.cat([neg_col, v[:, :-1]], dim=1)
        d = d | ((f > f1).to(u8) << 5)
        oki = (i <= alen)[:, None]
        h = torch.where(okj & oki, hh, neg)
        e = torch.where(oki, e_next, neg)
        hold = torch.where((alen == i)[:, None], h, hold)
        dirs[:, i] = d
    return _final_score(hold, base, alen, blen, W, neg), dirs


def _final_score(hold, base, alen, blen, W, neg):
    """H of row alen at column blen, NEG when that column is off the band."""
    bidx = torch.arange(hold.shape[0], device=hold.device)
    lane_end = blen.to(torch.int32) - base[bidx, alen.long()]
    score = hold[bidx, lane_end.clamp(0, W - 1).long()]
    return torch.where((lane_end >= 0) & (lane_end < W), score, neg)


def refine_cuda(a, b, alen, blen, base, tracks, *, LA, W, **costs):
    """The kernel of csrc/refine.cu with the affine costs (tracks None:
    match, mismatch, open_i, open_d, ext) or the 5q costs (tracks =
    (subqv, insqv, delqv, subtag, deltag), each [B, LA] i32: qclp, qmis,
    qdel, qext).  Returns (score, dirs, mvs) as the plain versions do."""
    B, LB = b.shape
    dev = a.device
    name = "refine" if tracks is None else "refine5q"
    ins = (a, b, alen, blen, base) + (tuple(tracks) if tracks else ())
    if (a.dtype != torch.uint8 or b.dtype != torch.uint8
            or any(t.dtype != torch.int32 for t in ins[2:])):
        raise ValueError(f"{name}: dtypes must be u8 codes and i32 lengths, "
                         f"bases and tracks")
    if (tuple(a.shape) != (B, LA) or tuple(alen.shape) != (B,)
            or tuple(blen.shape) != (B,) or tuple(base.shape) != (B, LA + 1)
            or any(tuple(t.shape) != (B, LA) for t in ins[5:]) or LA < 1
            or LB < 1):
        raise ValueError(f"{name}: bad shapes "
                         f"{[tuple(t.shape) for t in ins]}")
    if W not in W_TIERS:
        raise ValueError(f"{name}: W={W} must be one of {W_TIERS}")
    if tracks is None and not all(-128 <= costs[k] <= 127
                                  for k in ("match", "mismatch")):
        raise ValueError(f"{name}: match and mismatch must fit in int8 (the "
                         f"kernel's score table holds bytes)")
    if any(t.device != dev for t in ins):
        raise ValueError(f"{name}: inputs on different devices")
    ins = tuple(t.contiguous() for t in ins)
    T = 2 * (LA + 1) + W + 4
    score = torch.empty(B, dtype=torch.int32, device=dev)
    mvs = torch.empty((T, B), dtype=torch.int8, device=dev)
    dirs = torch.empty((B, LA + 1, W), dtype=torch.uint8, device=dev)
    if B == 0:
        return score, dirs, mvs
    if tracks is None:
        q5 = 0
        tptr = [0] * 5
        c = [costs[k] for k in ("match", "mismatch", "open_i", "open_d",
                                "ext")]
    else:
        q5 = 1
        tptr = [t.data_ptr() for t in ins[5:]]
        c = [costs[k] for k in ("qclp", "qmis", "qdel", "qext")] + [0]
    lib = _build.lib()
    _build.LAUNCHES[name] += 1
    _build.check(lib.refine_align_tb(
        *(t.data_ptr() for t in ins[:5]), *tptr, B, LA, LB, W, T, q5, *c,
        dirs.data_ptr(), score.data_ptr(), mvs.data_ptr(),
        _build.stream_of(a)), "refine_align_tb")
    return score, dirs, mvs


def band_from_cigar(cigars, alens, blens, LA: int, W: int) -> np.ndarray:
    """Per-row leftmost band columns following a prior CIGAR path.

    cigars: per pair (ops, counts) with ops in M/I/D (I consumes a).
    Mirrors the reference's band construction (kswx.h:562-600) with a
    fixed width W; monotone non-decreasing so row shifts are >= 0.
    """
    B = len(cigars)
    base = np.zeros((B, LA + 1), np.int32)
    for i, (ops, counts) in enumerate(cigars):
        al, bl = int(alens[i]), int(blens[i])
        centers = np.zeros(al + 1, np.int64)
        qx = tx = 0
        for op, ln in zip(ops, counts):
            ln = int(ln)
            if op == "M":
                w = max(0, min(ln, al - qx))
                centers[qx + 1: qx + w + 1] = tx + np.arange(1, w + 1)
                qx += ln
                tx += ln
            elif op == "I":
                w = max(0, min(ln, al - qx))
                centers[qx + 1: qx + w + 1] = tx
                qx += ln
            else:  # D
                tx += ln
                if qx <= al:
                    centers[qx] = tx
            if qx >= al:
                qx = min(qx, al)
        if qx < al:  # prior cigar shorter than a: extend diagonally
            centers[qx + 1:] = centers[qx] + np.arange(1, al - qx + 1)
        rows = np.minimum(np.arange(LA + 1), al)
        c = centers[rows]
        b_ = np.clip(c - W // 2, 0, max(0, bl))
        np.maximum.accumulate(b_, out=b_)
        base[i] = b_
    return base


def traceback_refine(mvs: np.ndarray):
    """Per pair (ops, counts) from a refine move stream [T, B] (numpy)."""
    code2op = {0: "M", 1: "I", 2: "D"}
    return [rle_moves(mvs[:, k], code2op, 3) for k in range(mvs.shape[1])]


def band_tier(cigars, W_base: int) -> int:
    """The band width for a batch: W_base + twice the largest indel run of
    its prior CIGARs (the reference widens by the run around each indel),
    rounded up to a power of two in 64..1024."""
    wmax = W_base
    for ops, counts in cigars:
        for op, ln in zip(ops, counts):
            if op != "M":
                wmax = max(wmax, W_base + 2 * int(ln))
    return 1 << max(6, (min(wmax, 1024) - 1).bit_length())


def cigar_stats(pairs, new_cigars, score):
    """The reference's refine outputs per pair (kswx.h:633-657): dicts
    {score, ops, counts, mat, mis, ins, dl, aln}.  The JAX package's
    per-op loop, with array operations: the CIGAR expanded to one code a
    column, mat the equal codes on its M columns."""
    out = []
    for k, (ops, counts) in enumerate(new_cigars):
        ac, bc = pairs[k]
        col = np.repeat(np.array([_OP_CODE.get(o, 2) for o in ops], np.int8),
                        np.asarray(counts, np.int64))
        in_a, in_b, is_m = col != 2, col != 1, col == 0
        ia = (np.cumsum(in_a) - 1)[is_m]
        ib = (np.cumsum(in_b) - 1)[is_m]
        nm = int(is_m.sum())
        mat = int(np.sum(np.asarray(ac)[ia] == np.asarray(bc)[ib]))
        ins = int((col == 1).sum())
        dl = int((col == 2).sum())
        out.append(dict(score=int(score[k]), ops=ops, counts=counts,
                        mat=mat, mis=nm - mat, ins=ins, dl=dl,
                        aln=nm + ins + dl))
    return out


def refine_batch(dp, key, pairs, cigars, quals, *, W_base, device,
                 counts=None, **costs):
    """One refine batch through the DP function `dp` (refine_banded_affine,
    or refine5q_banded with quals): pad the pairs to a power-of-two LA,
    build the band around the prior CIGARs at the batch's tier, run the DP
    on `device`, fetch score and moves, and run-length encode them into
    the reference's outputs, in the order of pairs.  quals: per pair a
    [7, len(a)] u8 track array, of which tracks 1, 2, 3, 5 and 6 become
    the DP's five track arguments.  The DP with its fetch is a span named
    `key` (count `cells`: its band cells, Σ alen x W), beside the spans
    `band` and `rle`.  counts: a span's counts, to which the batch adds
    its `cells`.

    The band width is the whole batch's tier; the DP runs in calls of one
    pow2_tier under DIRS_CAP (ops/align.py tier_chunks): a pair's result
    depends on the width, not on its call's other pairs or LA."""
    if not pairs:
        return []
    W = band_tier(cigars, W_base)
    if counts is not None:
        counts["cells"] = counts.get("cells", 0) + W * sum(
            len(a) for a, _ in pairs)
    out = [None] * len(pairs)
    for idx, LA in tier_chunks([len(a) for a, _ in pairs], plane_fits(W),
                               tier=pow2_tier):
        res = _refine_call(dp, key, [pairs[k] for k in idx],
                           [cigars[k] for k in idx],
                           None if quals is None else [quals[k] for k in idx],
                           LA=LA, W=W, device=device, **costs)
        for k, r in zip(idx, res):
            out[k] = r
    return out


def _refine_call(dp, key, pairs, cigars, quals, *, LA, W, device, **costs):
    B = len(pairs)
    alens = np.array([len(a) for a, _ in pairs], np.int32)
    blens = np.array([len(b) for _, b in pairs], np.int32)
    LB = int(blens.max()) + 1
    a = np.full((B, LA), 4, np.uint8)
    b = np.full((B, LB), 4, np.uint8)
    for k, (ac, bc) in enumerate(pairs):
        a[k, : len(ac)] = ac
        b[k, : len(bc)] = bc
    tracks = ()
    if quals is not None:
        qv = np.zeros((5, B, LA), np.int32)  # subqv insqv delqv subtag deltag
        for k, ((ac, _), qk) in enumerate(zip(pairs, quals)):
            qv[:, k, : len(ac)] = qk[[1, 2, 3, 5, 6], : len(ac)]
        tracks = tuple(qv)
    with span("band"):
        base = band_from_cigar(cigars, alens, blens, LA, W)
    with span(key, cells=int(alens.sum()) * W):
        score, _dirs, mvs = dp(
            *(torch.from_numpy(x).to(device)
              for x in (a, b, *tracks, alens, blens, base)),
            LA=LA, W=W, **costs)
        del _dirs
        score = score.cpu().numpy()
        mvs = mvs.cpu().numpy()
    with span("rle"):
        ops, counts, offs, _ = cigar_rle(BANDED_MOVES[mvs.T],
                                         np.zeros(B, np.int64))
        return cigar_stats(pairs, run_lists(ops, counts, offs[:-1], offs[1:]),
                           score)


def refine_alignment_batch(pairs, cigars, *, W_base: int = 64, match: int = 2,
                           mismatch: int = -5, open_i: int = -3,
                           open_d: int = -3, ext: int = -1, device="cuda",
                           counts=None):
    """Refine a batch of alignments around their prior CIGARs on `device`.

    pairs: list of (a_codes, b_codes) numpy uint8 arrays (already
    oriented and sliced to the aligned region, reference qb/tb..qe/te).
    cigars: list of (ops, counts) prior CIGARs in the same coordinates.

    Returns list of dicts: {score, ops, counts, mat, mis, ins, dl, aln}.
    Mirrors kswx_refine_alignment's outputs (kswx.h:633-657).  counts: as
    `refine_batch`'s.
    """
    return refine_batch(refine_banded_affine, "refine", pairs, cigars, None,
                        W_base=W_base, device=device, counts=counts,
                        match=match, mismatch=mismatch, open_i=open_i,
                        open_d=open_d, ext=ext)
