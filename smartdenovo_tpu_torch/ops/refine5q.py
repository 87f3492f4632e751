"""Quality-aware refine alignment: a min-cost affine banded DP from five
per-base quality tracks, negated so that it maximises like its unweighted
sibling (port of smartdenovo_tpu/ops/refine5q.py, `jax.jit` over
`lax.scan`; the reference's `kswx_refine_affine_alignment_5q`,
kswx.h:871-1075, the wtcns polish of layouts with f5q tracks,
wtcns.c:372-381).  Costs (smaller = better):

  substitution of query base i by target base b:
      0 if b == query[i]; SubQV[i] if b == SubTag[i]; QMIS otherwise
  insertion (consume query base i): InsQV[i+1], open and extend alike
  deletion of target base b at row i: DelQV[i+1] if b == DelTag[i+1]
      else QDEL; extension QEXT
  clip: QCLP per unaligned edge base; at the last row the insertion and
      deletion costs become QCLP

`refine5q_banded` dispatches on the tensors' device: on CUDA the kernel of
csrc/refine.cu with its 5q cost model (the affine refine's kernel, the
same traceback), on the CPU `refine5q_banded_plain` and
`traceback.tb_refine`.
"""

from __future__ import annotations

import torch

from .refine import fscan_excl, refine_batch, refine_cuda, _final_score
from .traceback import tb_refine

NEG = -(1 << 24)

QCLP = 251   # uint8 wrap of -5  (wtcns.c:104)
QMIS = 236   # uint8 wrap of -20 (wtcns.c:105)
QDEL = 241   # uint8 wrap of -15 (wtcns.c:106)
QEXT = 251   # uint8 wrap of -5  (wtcns.c:107)


def refine5q_banded(a, b, subqv, insqv, delqv, subtag, deltag, alen, blen,
                    base, *, LA: int, W: int = 128, qclp: int = QCLP,
                    qmis: int = QMIS, qdel: int = QDEL, qext: int = QEXT):
    """Returns (score [B] i32, the negated total cost; dirs [B, LA+1, W]
    u8; mvs [T, B] i8, T = 2 (LA + 1) + W + 4), as
    `refine.refine_banded_affine` does.  The five tracks are [B, LA] i32."""
    tracks = (subqv, insqv, delqv, subtag, deltag)
    kw = dict(LA=LA, W=W, qclp=qclp, qmis=qmis, qdel=qdel, qext=qext)
    if a.device.type == "cuda":
        return refine_cuda(a, b, alen, blen, base, tracks, **kw)
    if a.device.type == "cpu":
        score, dirs = refine5q_banded_plain(a, b, *tracks, alen, blen, base,
                                            **kw)
        return score, dirs, tb_refine(dirs, base, alen, blen,
                                      T=2 * (LA + 1) + W + 4)
    raise ValueError(f"refine5q_banded: unsupported device {a.device}")


def refine5q_banded_plain(a, b, subqv, insqv, delqv, subtag, deltag, alen,
                          blen, base, *, LA, W, qclp, qmis, qdel, qext):
    """Plain PyTorch version of the DP: one row of the JAX scan per loop
    turn over [B, W], int32; rows past the batch's largest alen skipped.
    Returns (score, dirs)."""
    B = a.shape[0]
    LB = b.shape[1]
    dev = a.device
    i32, u8 = torch.int32, torch.uint8
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    ai = a.to(i32)
    bi = b.to(torch.int64)
    sq_t, iq_t, dq_t, st_t, dt_t = (t.to(i32) for t in (subqv, insqv, delqv,
                                                        subtag, deltag))
    alen = alen.to(i32)
    blen_c = blen.to(i32)[:, None]
    base = base.to(i32)
    zero = torch.zeros((), dtype=i32, device=dev)
    c_qclp, c_qmis, c_qdel = (torch.tensor(v, dtype=i32, device=dev)
                              for v in (qclp, qmis, qdel))
    neg_col = neg.expand(B, 1)

    def shifted(x, idx):
        ok = (idx >= 0) & (idx < W)
        return torch.where(ok, torch.gather(x, 1, idx.clamp(0, W - 1).long()),
                           neg)

    j = base[:, 0:1] + lanes
    h = torch.where(j >= 0, -j * qclp, neg)            # target clip
    h = torch.where((j >= 0) & (j <= blen_c), h, neg)
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
        ic, nxt = i - 1, min(i, LA - 1)
        qb, st, sq = ai[:, ic:ic + 1], st_t[:, ic:ic + 1], sq_t[:, ic:ic + 1]
        last = (i >= alen)[:, None]
        iq = torch.where(last, c_qclp, iq_t[:, nxt:nxt + 1])
        dq, dt = dq_t[:, nxt:nxt + 1], dt_t[:, nxt:nxt + 1]
        bc = torch.gather(bi, 1, (j - 1).clamp(0, LB - 1).long()).to(i32)
        sub = torch.where(bc == qb, zero, torch.where(bc == st, sq, c_qmis))
        delc = torch.where(last, c_qclp, torch.where(bc == dt, dq, c_qdel))
        okj = (j >= 1) & (j <= blen_c)
        m = torch.where(okj, hdg - sub, neg)
        d = (m < eup).to(u8)
        hh = torch.maximum(m, eup)
        v = torch.where(okj, m - delc, neg)
        f = fscan_excl(v, -qext, neg)
        d = torch.where(f > hh, torch.full_like(d, 2), d)
        hh = torch.maximum(hh, f)
        e_ext = eup - iq
        e_open = m - iq
        d = d | ((e_ext > e_open).to(u8) << 2)
        e_next = torch.maximum(e_ext, e_open)
        f1 = torch.cat([neg_col, v[:, :-1]], dim=1)
        d = d | ((f > f1).to(u8) << 5)
        # query-clip entry at column 0 (reference h1 = i*QCLP, kswx.h:992)
        at0 = j == 0
        hh = torch.where(at0, torch.full_like(hh, -i * qclp), hh)
        d = torch.where(at0, torch.ones_like(d), d)
        oki = (i <= alen)[:, None]
        h = torch.where(oki & (okj | at0), hh, neg)
        e = torch.where(oki, e_next, neg)
        hold = torch.where((alen == i)[:, None], h, hold)
        dirs[:, i] = d
    return _final_score(hold, base, alen, blen, W, neg), dirs


def refine5q_alignment_batch(pairs, quals, cigars, *, W_base: int = 64,
                             qclp: int = QCLP, qmis: int = QMIS,
                             qdel: int = QDEL, qext: int = QEXT,
                             device="cuda", split: dict | None = None):
    """Quality-aware refine of a batch of alignments around prior CIGARs,
    on `device`.

    pairs: list of (a_codes, b_codes) oriented aligned-region slices.
    quals: list of [7, len(a)] uint8 track arrays (tracks 0-4 phred,
           5-6 base codes), oriented like `a`.
    cigars: list of (ops, counts) prior CIGARs ('I' consumes a).
    split: a dict the host seconds of band, refine5q and rle are added to.

    Returns list of dicts {score, ops, counts, mat, mis, ins, dl, aln}
    mirroring ops.refine.refine_alignment_batch.
    """
    return refine_batch(refine5q_banded, "refine5q", pairs, cigars, quals,
                        W_base=W_base, device=device, split=split, qclp=qclp,
                        qmis=qmis, qdel=qdel, qext=qext)
