"""Consensus tiles whose reads carry f5q quality tracks, the 7 x L tracks
that pbh5tof5q writes from an RS II movie (QV, SubQV, InsQV, DelQV,
MergeQV, SubTag, DelTag), worked out from each read's own simulated error
events.

`f5q_tiles` makes the tiles of `workload.unitig_tiles` (the same reads,
offsets, flags and truth, from the same streams: the tile body below is
that function's, keeping the reads it draws) and, beside each tile, its
reads' tracks as `LayUnitig.quals` holds them: [7, len] uint8, tracks 0-4
phred values, 5-6 base codes (4 for N).  The tracks' own draws come from
a stream of their own, so the reads do not depend on them.

The profile (the configuration's `assumed` states it):
- QV (track 0) and MergeQV (track 4) are the stated QV and MERGE_QV;
- SubQV, InsQV and DelQV (tracks 1-3) are, at a base with no event of
  their kind, the phred of that kind's rate in the error model (err x
  sub_frac, ins_frac, del_frac) plus a whole number drawn from
  -JITTER..JITTER; at a base with one, a whole number drawn from
  EVENT_QV;
- a substitution's base is one written once that differs from its
  template base; an insertion's is the first of the two bases written
  for one template base (the random base of a plain insertion, the first
  copy of a homopolymer's); a deletion's is the base written next after
  the deleted template base (none at a read's end; the first of several
  deleted bases before one base);
- SubTag (track 5) is the template base at a substitution, DelTag (track
  6) the deleted template base at a deletion's base, N elsewhere.
"""

from __future__ import annotations

import math

import numpy as np

from .simulate import (ErrorModel, Reads, random_genome, rng_for,
                       sample_reads, template_lengths)
from .workload import _TILE, Tile, filtered, tiling_path

# stream tag of the tracks' draws (the bank's and the tiles' are 1 and 2)
_TRACKS = 3
QV = 9              # phred of the model's 13% error
MERGE_QV = 15
JITTER = 2
EVENT_QV = (2, 8)   # inclusive
N_CODE = 4


def kind_phred(cfg: dict) -> dict[str, int]:
    """The phred of each error kind's rate in the configuration's model."""
    m = ErrorModel.of(cfg)
    rate = {"sub": m.err * m.sub_frac, "ins": m.err * m.ins_frac,
            "del": m.err * m.del_frac}
    return {k: int(round(-10 * math.log10(r))) for k, r in rate.items()}


def events(reads: Reads, k: int, genome: np.ndarray):
    """Read k's error events as read positions, for a forward read of a
    linear genome: (substituted bases and their template bases, inserted
    bases, the bases after a deletion and the deleted template bases)."""
    t0, n = int(reads.tflat[k]), int(reads.tlen[k])
    seq = reads.read(k)
    tmpl = genome[int(reads.start[k]): int(reads.start[k]) + n]

    def local(pos):
        return pos[np.searchsorted(pos, t0): np.searchsorted(pos, t0 + n)] - t0

    twos, zeros = local(reads.twos), local(reads.zeros)

    def at(t):
        """The read position of template offset t's first written base."""
        return t + np.searchsorted(twos, t) - np.searchsorted(zeros, t)

    once = np.ones(n, bool)
    once[twos] = False
    once[zeros] = False
    t1 = np.flatnonzero(once)
    sub = t1[seq[at(t1)] != tmpl[t1]]
    dpos = at(zeros)
    first = np.unique(dpos, return_index=True)[1]
    keep = first[dpos[first] < seq.shape[0]]
    return (at(sub), tmpl[sub], at(twos), dpos[keep], tmpl[zeros[keep]])


def read_tracks(reads: Reads, k: int, genome: np.ndarray, phred: dict,
                rng: np.random.Generator) -> np.ndarray:
    """Read k's [7, len] uint8 tracks (the profile above)."""
    L = int(reads.bounds[k + 1] - reads.bounds[k])
    sub_at, sub_tag, ins_at, del_at, del_tag = events(reads, k, genome)
    q = np.empty((7, L), np.uint8)
    q[0] = QV
    q[4] = MERGE_QV
    for row, kind, where in ((1, "sub", sub_at), (2, "ins", ins_at),
                             (3, "del", del_at)):
        q[row] = phred[kind] + rng.integers(-JITTER, JITTER + 1, L)
        q[row, where] = rng.integers(EVENT_QV[0], EVENT_QV[1] + 1,
                                     where.shape[0])
    q[5] = N_CODE
    q[5, sub_at] = sub_tag
    q[6] = N_CODE
    q[6, del_at] = del_tag
    return q


def f5q_tiles(cfg: dict, seed: int, count: int) -> tuple[list, list]:
    """(tiles, tracks): `unitig_tiles(cfg, seed, count)` and, per tile, the
    tracks of its reads in the tile's order."""
    L = int(cfg["unitig_bp"])
    model = ErrorModel.of(cfg)
    phred = kind_phred(cfg)
    tiles, tracks = [], []
    for t in range(count):
        rng = rng_for(seed, _TILE, t)
        genome = random_genome(rng, L)
        lens = template_lengths(cfg["sizes_seed"] + 1 + t,
                                int(cfg["coverage"] * L), cfg["mean_len"],
                                cfg["min_len"], L)
        reads = filtered(sample_reads(rng, genome, lens, model,
                                      circular=False, strands=False),
                         cfg["filter_min_len"])
        order = np.lexsort((-reads.tlen, reads.start))
        start = reads.start[order]
        end = start + reads.tlen[order]
        y = tiling_path(start, end)
        path = np.flatnonzero(y)
        offs = np.zeros(order.shape[0], np.int64)
        for a, b in zip(path, path[1:]):
            offs[b] = offs[a] + reads.read_coord(
                order[a], start[b] - start[a])
        owner = path[np.searchsorted(start[path], start, side="right") - 1]
        offs = offs[owner] + reads.read_coord(order[owner],
                                              start - start[owner])
        s0 = int(start[0])
        by_off = np.argsort(offs, kind="stable")
        seqs = [reads.read(int(order[k])).copy() for k in by_off]
        flags = y[by_off]
        offl = offs[by_off].tolist()
        span = max(o + len(r) for o, r, b in zip(offl, seqs, flags) if b)
        tiles.append(Tile(name=f"tile{t}", reads=seqs, offs=offl,
                          backbone=flags.tolist(),
                          truth=genome[s0: int(end.max())].copy(),
                          tstart=start[by_off] - s0, tend=end[by_off] - s0,
                          span=int(span)))
        trng = rng_for(seed, _TRACKS, t)
        tracks.append([read_tracks(reads, int(order[k]), genome, phred, trng)
                       for k in by_off])
    return tiles, tracks
