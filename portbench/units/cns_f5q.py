"""The `cns_f5q` unit: one `consensus_unitig` call on a unitig tile whose
reads carry f5q quality tracks (portbench/gen/f5q.py: the `cns` unit's
tiles, with tracks from each read's own error events), which sends the
tile through the whole-read engine and its quality-aware refine.  Tiles
are fixed by the seed and cycled in order; the work of a unit is the
tile's layout span, in kbp, as in the `cns` unit.

The checks: the `cns` unit's two numbers against the truth
(portbench/reference/cns_judge.py), and `aln_mismatches`, the reads of
the first round of the window's first tile whose alignment (score, begin
and end, the read's row, the consensus's row) differs from the plain
reference's (portbench/reference/cns_f5q_ref.py), which works the round
out again from the tile's layout and tracks.  `failed` counts the tiles
that the judge cannot place or whose own error rate is over the limit,
and one more where the first round differs; the weak-piece share is a
number of the window alone: a tile's ~180 judged pieces are too few for
it (a sound tile reads 5 weak pieces, over this cell's limit, in about
one window of six)."""

from __future__ import annotations

import sys
import time

from portbench.gen.f5q import f5q_tiles
from portbench.reference import cns_f5q_ref
from portbench.units import cns


class Unit(cns.Unit):
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.tiles, self.tracks = f5q_tiles(cfg, seed, int(mix["tiles"]))
        self.next = 0
        self.outputs = []
        self.first = None       # (tile index, its first round's alignments)

    def run(self) -> float:
        from smartdenovo_tpu_torch.pipeline.cns import (CnsParams, LayUnitig,
                                                        consensus_unitig)

        i = self.next % len(self.tiles)
        self.next += 1
        tile = self.tiles[i]
        keep = [] if not self.outputs else None
        cns_ = consensus_unitig(
            LayUnitig(name=tile.name, reads=tile.reads, offs=tile.offs,
                      backbone=tile.backbone, quals=self.tracks[i]),
            CnsParams(**self.cfg["cns"]), device=self.device,
            first_round=keep)
        if keep is not None:
            self.first = (i, keep)
        self.outputs.append((i, cns_))
        return tile.span / 1e3

    def checks(self, limits: dict) -> tuple[list, int]:
        numbers, failed = super().checks(dict(limits,
                                              cns_weak_piece_share=1.0))
        numbers = [(n, v, limits[n]) for n, v, _lim in numbers]
        lim = limits["aln_mismatches"]
        t0 = time.perf_counter()
        i, got = self.first
        tile = self.tiles[i]
        ref = cns_f5q_ref.round1(tile.reads, tile.offs, tile.backbone,
                                 self.tracks[i],
                                 cns_f5q_ref.WholeReadParams.of(
                                     self.cfg["cns"]), self.device)
        diff = cns_f5q_ref.mismatches(ref, got)
        print(f"portbench: check: round 1 of {tile.name}, {len(tile.reads)} "
              f"reads, {len(got)} aligned, judged in "
              f"{time.perf_counter() - t0:.3f}s ({diff} differ)",
              file=sys.stderr, flush=True)
        return (numbers + [("aln_mismatches", diff, lim)],
                failed + (diff > lim))
