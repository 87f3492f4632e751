"""The `cns` unit: one `consensus_unitig` call on a unitig tile of the
configuration (`unitig_bp` of random genome, its reads at the stated
depth and error, filtered, laid out as wtlay writes them), the tiles
fixed by the seed and cycled in order.  The work of a unit is the tile's
layout span (backbone bp, fixed by the input), in kbp.

The check: each timed tile's consensus against the genome it was read
from (portbench/reference/cns_judge.py), by two numbers: the mean of the
tiles' error rates (one tile at fault, such as another tile's consensus,
reads 1.0 and lifts the mean past any limit), and the share of the
judged pieces of all the tiles whose edit distance is `weak_piece_edits`
or more (a consensus with fewer rounds than the configuration states
leaves its errors in clusters, which the mean dilutes)."""

from __future__ import annotations

from portbench.gen.workload import unitig_tiles
from portbench.reference.cns_judge import judge

WORK_UNIT = "kbp"


class Unit:
    work_unit = WORK_UNIT

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.tiles = unitig_tiles(cfg, seed, int(mix["tiles"]))
        self.next = 0
        self.outputs = []

    def layout(self, tile):
        from smartdenovo_tpu_torch.pipeline.cns import LayUnitig

        return LayUnitig(name=tile.name, reads=tile.reads, offs=tile.offs,
                         backbone=tile.backbone)

    def run(self) -> float:
        from smartdenovo_tpu_torch.pipeline.cns import (CnsParams,
                                                        consensus_unitig)

        i = self.next % len(self.tiles)
        self.next += 1
        tile = self.tiles[i]
        cns = consensus_unitig(self.layout(tile), CnsParams(**self.cfg["cns"]),
                               device=self.device)
        self.outputs.append((i, cns))
        return tile.span / 1e3

    def warm(self):
        self.run()
        self.outputs.clear()
        self.next = 0

    def free(self):
        pass

    def checks(self, limits: dict) -> tuple[list, int]:
        lim_rate = limits["cns_error_rate"]
        lim_weak = limits["cns_weak_piece_share"]
        weak_at = int(self.mix["weak_piece_edits"])
        rates, weak, pieces, failed = [], 0, 0, 0
        for i, cns in self.outputs:
            t = self.tiles[i]
            j = judge(cns, t.truth, t.tstart, t.tend,
                      piece=int(self.mix["piece_bp"]), device=self.device)
            if j is None:
                rates.append(1.0)
                failed += 1
                continue
            rates.append(j.rate)
            d = j.dist[j.use]
            w = int((d >= weak_at).sum())
            weak += w
            pieces += d.shape[0]
            failed += j.rate > lim_rate or w > lim_weak * d.shape[0]
        mean = sum(rates) / len(rates) if rates else 1.0
        share = weak / pieces if pieces else 1.0
        return ([("cns_error_rate", mean, lim_rate),
                 ("cns_weak_piece_share", share, lim_weak)], failed)
