"""The plain reference of the `cns_f5q` units: the first round of the
consensus's whole-read engine on a tile whose reads carry f5q tracks,
worked out again from the layout (reads, offsets, Y flags) and the
tracks alone.

The first round's consensus is the layout's own backbone (the Y reads laid
end to end at their offsets), so it needs no DAG.  Each read is aligned to
its window of the backbone (its offset less `win_margin` to its end plus
`win_margin`):
1. probe anchoring (`wholeread/probe.py`);
2. the semiglobal banded DP along the anchors' band, with its traceback,
   at most 2 (LA + 1) + band moves for LA its batch's length tier (the
   batch's longest read, rounded up to 1,024 · 2^k up to 65,536, then to
   a multiple of 65,536; `wholeread/banded.py`);
3. the quality-aware refine around that CIGAR of each read whose CIGAR,
   read and aligned window are not empty, at the band width of its batch
   of `batch_reads` (`wholeread/refine5q.py`);
4. the aligned strings of the read and the window from the alignment's
   first column (`sw/cigar.py aligned`).
A read aligns where its strings are not empty; its alignment is (score,
the backbone columns where it begins and ends, the read's row, the
backbone's row).

Departure copied from the program: the score is the banded DP's, not the
refine's.  wtcns sorts the DAG's insertions by the refined score
(wtcns.c:381); the JAX package keeps the banded score of f5q reads, the
port copies it (`pipeline/cns.py`, its test
`test_torch_cns_wholeread.py::test_f5q_reads_keep_banded_score`), and
repairing it would change the consensus.

It imports nothing of the program and reads nothing that it made."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .sw.cigar import aligned, groups
from .wholeread import banded, probe, refine5q


@dataclasses.dataclass(frozen=True)
class WholeReadParams:
    """The configuration's `cns` values that the first round reads; each
    must be stated there."""

    batch_reads: int
    band: int
    win_margin: int
    refine_w: int
    match: int
    mismatch: int
    gap: int
    refine: bool
    use_qv: bool

    @classmethod
    def of(cls, cns: dict) -> "WholeReadParams":
        return cls(**{f.name: cns[f.name] for f in dataclasses.fields(cls)})


def length_tier(n: int) -> int:
    for t in (1024, 2048, 4096, 8192, 16384, 32768, 65536):
        if n <= t:
            return t
    return -(-n // 65536) * 65536


def backbone(reads, offs, flags) -> np.ndarray:
    """The Y reads laid at their offsets, each from where the last one
    placed ended."""
    ln = max((o + len(r) for r, o, y in zip(reads, offs, flags) if y),
             default=0)
    out = np.zeros(ln, np.uint8)
    built = 0
    for r, o, y in zip(reads, offs, flags):
        if y and o + len(r) > built:
            out[o: o + len(r)] = r
            built = o + len(r)
    return out[:built]


def round1(reads, offs, flags, quals, p: WholeReadParams, device) -> list:
    """The first round's alignments, in read order: (rid, score, beg,
    end, read row, backbone row) of each read that aligned."""
    if not (p.refine and p.use_qv) or any(q is None for q in quals):
        raise NotImplementedError("the reference runs the 5q refine of "
                                  "reads that all carry tracks")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cns = backbone(reads, offs, flags)
    n = len(reads)
    wstart, windows = [], []
    for r, o in zip(reads, offs):
        ws = max(0, o - p.win_margin)
        we = min(len(cns), o + len(r) + p.win_margin)
        if we <= ws:
            ws, we = 0, min(len(cns), len(r) + 2 * p.win_margin)
        wstart.append(ws)
        windows.append(cns[ws:we])
    anchors = probe.anchors(reads, windows,
                            [o - ws for o, ws in zip(offs, wstart)], device)

    alen = np.array([len(r) for r in reads], np.int64)
    blen = np.array([len(w) for w in windows], np.int64)
    batches = [range(b0, min(n, b0 + p.batch_reads))
               for b0 in range(0, n, p.batch_reads)]
    T = np.zeros(n, np.int64)
    for rng in batches:
        T[rng.start: rng.stop] = 2 * (length_tier(
            int(alen[rng.start: rng.stop].max())) + 1) + p.band
    score = np.zeros(n, np.int64)
    end_col = np.zeros(n, np.int64)
    b_beg = np.zeros(n, np.int64)
    cigars = [None] * n
    for idx, LA in groups(alen, p.band, banded.PLANE_CAP):
        a = np.full((len(idx), LA), 4, np.uint8)
        b = np.full((len(idx), max(int(blen[idx].max()), 1)), 4, np.uint8)
        for r, k in enumerate(idx):
            a[r, : alen[k]] = reads[k]
            b[r, : blen[k]] = windows[k]
        base = banded.band_from_anchors([anchors[k] for k in idx], alen[idx],
                                        blen[idx], LA, p.band)
        sc, ec, dirs = banded.semiglobal(
            *(torch.from_numpy(x).to(dev)
              for x in (a, b, alen[idx], blen[idx], base)),
            W=p.band, match=p.match, mismatch=p.mismatch, gap=p.gap)
        ec = ec.cpu().numpy()
        cg, bb = banded.traceback(dirs.cpu().numpy(), base, alen[idx], ec,
                                  T[idx])
        del dirs
        score[idx], end_col[idx], b_beg[idx] = sc.cpu().numpy(), ec, bb
        for r, k in enumerate(idx):
            cigars[k] = cg[r]

    # the refine: each batch's band width from its own CIGARs, then all
    # reads of one width together
    by_w: dict = {}
    for rng in batches:
        ks = [k for k in rng if cigars[k][0] and alen[k] > 0
              and end_col[k] > b_beg[k]]
        if ks:
            W = refine5q.band_width([cigars[k] for k in ks], p.refine_w)
            by_w.setdefault(W, []).extend(ks)
    for W, ks in sorted(by_w.items()):
        got = refine5q.refine(
            [(reads[k], windows[k][b_beg[k]: end_col[k]]) for k in ks],
            [cigars[k] for k in ks], [quals[k] for k in ks], W=W,
            device=device)
        for k, cg in zip(ks, got):
            cigars[k] = cg

    out = []
    for k in range(n):
        ops, counts = cigars[k]
        if not ops:
            continue
        ra, rb = aligned(reads[k], windows[k][b_beg[k]:], ops, counts)
        out.append((k, int(score[k]), wstart[k] + int(b_beg[k]),
                    wstart[k] + int(end_col[k]), ra, rb))
    return out


def mismatches(ref: list, got: list) -> int:
    """Reads whose alignment differs between the two lists, or that one
    of them lacks."""
    a = {x[0]: x[1:] for x in ref}
    b = {x[0]: x[1:] for x in got}
    if len(a) != len(ref) or len(b) != len(got):
        raise ValueError("a read aligned twice in one round")

    def same(x, y):
        return (x[:3] == y[:3] and np.array_equal(x[3], y[3])
                and np.array_equal(x[4], y[4]))

    return sum(not (k in a and k in b and same(a[k], b[k]))
               for k in a.keys() | b.keys())
