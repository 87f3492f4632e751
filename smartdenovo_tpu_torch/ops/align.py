"""The batched banded-alignment stage over `ops.banded.banded_align`
(csrc/banded.cu on the card): pairs of code segments in, CIGAR runs out.

`banded_runs` cuts the pairs into calls by length tier (shortest first,
input order inside a tier), each call's direction plane under DIRS_CAP;
a call pads the codes and builds the band (`native.cigar_band`, or
`make_band_centers` of anchors), runs the kernel, fetches the moves
transposed and run-length encodes them (`native.cigar_rle`), recording
`centers`, `banded` and `banded_rle` (`overlaps`) as spans of the
enclosing span.  A pair's result depends on no other pair of its call;
LA sets only the traceback's length, T = 2 (LA + 1) + W moves, which
cuts a longer path short, so a caller held to the JAX package passes its
tier.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.native import Segments, cigar_band, cigar_rle
from ..utils.timing import span
from .banded import banded_align, make_band_centers

# a call's direction plane, pairs x (LA + 1) x W bytes, stays under this
DIRS_CAP = 1 << 31
_LETTERS = np.array(["M", "I", "D"])


def pad_tier(n: int, tiers=(2048, 4096, 8192, 16384, 32768, 65536)) -> int:
    """Pad lengths to a few fixed tiers so device kernels compile once."""
    for t in tiers:
        if n <= t:
            return t
    return ((n + 65535) // 65536) * 65536


def pow2_tier(n: int) -> int:
    """The JAX package's one-pair LA for n bases (its tools and refine)."""
    return 1 << max(8, (n - 1).bit_length())


def plane_fits(W: int):
    """fits for tier_chunks: a call's direction plane under DIRS_CAP."""
    return lambda n, LA, _widest: n * (LA + 1) * W <= DIRS_CAP


def tier_chunks(lens, fits, widths=None, tier=pad_tier):
    """Indices grouped by tier(lens[k]), shortest tier first, in input
    order inside a tier, cut so that fits(pairs, LA, the largest of their
    widths) holds (one pair a chunk at least).  Yields (indices, LA)."""
    tiers = {}
    for k, n in enumerate(lens):
        tiers.setdefault(tier(int(n)), []).append(k)
    for LA in sorted(tiers):
        idx = np.array(tiers[LA], np.int64)
        i = 0
        while i < len(idx):
            j, m = i + 1, 0 if widths is None else widths[idx[i]]
            while j < len(idx):
                m2 = m if widths is None else max(m, widths[idx[j]])
                if not fits(j + 1 - i, LA, m2):
                    break
                j, m = j + 1, m2
            yield idx[i:j], LA
            i = j


class BandedRuns(NamedTuple):
    """Pair i's runs are ops/counts[run_beg[i]:run_end[i]] (0 = M, 1 = I,
    2 = D; I consumes the query) over target columns b_beg[i] to
    end_col[i], with its banded score; calls: `banded_align` launches."""

    ops: np.ndarray
    counts: np.ndarray
    run_beg: np.ndarray
    run_end: np.ndarray
    b_beg: np.ndarray
    end_col: np.ndarray
    score: np.ndarray
    calls: int


def banded_runs(segs: Segments, W: int, *, match: int = 2,
                mismatch: int = -5, gap_a: int = -3, gap_b: int = -3,
                semiglobal_b: bool = True, anchors=None, tier=pad_tier,
                device="cuda") -> BandedRuns:
    """Align each query segment of segs to its target along a W-lane band
    on `device`: the band from (0, 0) to (alen, blen), or, with anchors
    (per pair a list of (a_pos, b_pos)), `make_band_centers` of them.
    tier(alen) is a pair's padded length LA."""
    alen, blen = segs.alen, segs.blen
    n = len(alen)
    b_beg, end_col = np.zeros(n, np.int64), np.zeros(n, np.int64)
    score = np.zeros(n, np.int32)
    run_beg, run_end = np.zeros(n, np.int64), np.zeros(n, np.int64)
    ops, counts, nrun = [], [], 0
    for idx, LA in tier_chunks(alen, plane_fits(W), tier=tier):
        with span("centers"):
            a, b, base = cigar_band(segs, idx, LA, W)
            if anchors is not None:
                base = make_band_centers([anchors[i] for i in idx],
                                         alen[idx], blen[idx], LA, W)
        with span("banded"):
            sc, ecol, _dirs, mvs, j_final = banded_align(
                *(torch.from_numpy(x).to(device)
                  for x in (a, b, alen[idx].astype(np.int32),
                            blen[idx].astype(np.int32), base)),
                LA=LA, W=W, match=match, mismatch=mismatch, gap_a=gap_a,
                gap_b=gap_b, semiglobal_b=semiglobal_b)
            del _dirs
            # a row a pair, so the host reads each one's moves in order
            mvs, j_final, end_col[idx], score[idx] = (
                t.cpu().numpy()
                for t in (mvs.t().contiguous(), j_final, ecol, sc))
        with span("banded_rle", overlaps=len(idx)):
            g_ops, g_counts, offs, b_beg[idx] = cigar_rle(mvs, j_final)
            run_beg[idx] = nrun + offs[:-1]
            run_end[idx] = nrun + offs[1:]
            ops.append(g_ops)
            counts.append(g_counts)
            nrun += len(g_ops)
    return BandedRuns(np.concatenate(ops or [np.zeros(0, np.uint8)]),
                      np.concatenate(counts or [np.zeros(0, np.int32)]),
                      run_beg, run_end, b_beg, end_col, score, len(ops))


def run_lists(ops, counts, run_beg, run_end) -> list:
    """Per pair its runs as the plain helpers give them (rle_moves,
    band_from_cigar, align_strings): (ops list of "M"/"I"/"D", counts
    list)."""
    letters, cl = _LETTERS[ops].tolist(), counts.tolist()
    return [(letters[b:e], cl[b:e])
            for b, e in zip(run_beg.tolist(), run_end.tolist())]
