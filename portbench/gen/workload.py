"""Inputs of the two unit kinds, made from a configuration and a seed:
the filtered read bank of a genome (the overlap units) and unitig tiles
in the form wtlay writes (the consensus units).  Nothing is written to
disk."""

from __future__ import annotations

import dataclasses

import numpy as np

from .simulate import (ErrorModel, Reads, random_genome, rng_for,
                       sample_reads, template_lengths)

# stream tags under the run's seed
_BANK, _TILE = 1, 2
# Y reads of a tile's tiling path overlap by at least this many bases
MIN_TILE_OVERLAP = 1000


def filtered(reads: Reads, min_len: int) -> Reads:
    """wtpre -J: drop the reads shorter than min_len."""
    return reads.subset(reads.lengths() >= min_len)


def genome_bank(cfg: dict, seed: int) -> tuple[np.ndarray, Reads]:
    """The configuration's genome and its reads at the stated depth,
    filtered at `filter_min_len`."""
    rng = rng_for(seed, _BANK)
    glen = int(cfg["genome_bp"])
    genome = random_genome(rng, glen)
    lens = template_lengths(cfg["sizes_seed"], int(cfg["coverage"] * glen),
                            cfg["mean_len"], cfg["min_len"], glen)
    reads = sample_reads(rng, genome, lens, ErrorModel.of(cfg),
                         circular=cfg["circular"], strands=True)
    return genome, filtered(reads, cfg["filter_min_len"])


@dataclasses.dataclass
class Tile:
    """One unitig layout as wtlay writes it: reads on the forward strand
    sorted by offset, a greedy tiling path marked Y, and each read's
    offset in the coordinates of the backbone that the Y reads make (a Y
    read starts where its true start lies in the Y read before it, any
    other read where its true start lies in the last Y read that starts
    at or before it); and the truth it was read from."""

    name: str
    reads: list            # uint8 code arrays, forward strand
    offs: list             # int, backbone coordinates
    backbone: list         # bool, Y
    truth: np.ndarray      # the genome stretch from the first read's start
    tstart: np.ndarray     # each read's template start in `truth`
    tend: np.ndarray       # and its end
    span: int              # backbone bp: max over Y reads of off + len


def tiling_path(start: np.ndarray, end: np.ndarray,
                min_overlap: int = MIN_TILE_OVERLAP) -> np.ndarray:
    """Greedy best-extension path over intervals sorted by start: from the
    longest of the first reads, take the read that reaches farthest among
    those that overlap the path's end by min_overlap or more, or by any
    length where none of those reaches further.  Returns a bool mask of
    the path, which has no gap."""
    n = start.shape[0]
    y = np.zeros(n, bool)
    if n == 0:
        return y
    at0 = np.flatnonzero(start == start[0])
    cur = int(at0[np.argmax(end[at0])])
    y[cur] = True
    reach = int(end[cur])
    while True:
        nxt = -1
        for need in (min_overlap, 1):
            lim = int(np.searchsorted(start, reach - need, side="right"))
            if lim:
                k = int(np.argmax(end[:lim]))
                if end[k] > reach:
                    nxt = k
                    break
        if nxt < 0:
            break
        y[nxt] = True
        reach = int(end[nxt])
    return y


def unitig_tiles(cfg: dict, seed: int, count: int) -> list[Tile]:
    """`count` tiles of `unitig_bp` each, every one its own stretch of
    random genome with its reads at the configuration's depth and
    error, filtered at `filter_min_len`."""
    L = int(cfg["unitig_bp"])
    model = ErrorModel.of(cfg)
    tiles = []
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
    return tiles
