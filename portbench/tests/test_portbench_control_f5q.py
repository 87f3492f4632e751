"""The f5q consensus cell's controls on the card, at the cell's own size,
on three seeds: each must come out not correct while the program comes
out correct.  Run on the card with

    python -m pytest -m cuda portbench/tests/test_portbench_control_f5q.py -s

(`-s` prints the readings that portbench/limits/ecoli_pb_f5q.cns.json
was set from).

- `aln_mismatches`: the program's first round of the first tile with the
  affine refine in the 5q refine's place (`use_qv` off), and with every
  read's tracks one base late, each against the reference's first round;
- the truth numbers: the program with half of the layout's N reads left
  out (a depth cut), and with one round of consensus where the
  configuration states `n_iter` 6.
"""

import json

import numpy as np
import pytest

from portbench.harness import bench
from portbench.reference import cns_f5q_ref
from portbench.units import cns

CELL = "ecoli_pb_f5q.cns"
SEEDS = [4_200_000_001, 4_200_000_002, 4_200_000_003]
# a window's tiles: the most any 51 s window of the cell reached
TILES = 4


def _unit(cell, seed, card, **params):
    cfg = dict(cell.config, cns=dict(cell.config["cns"], **params))
    return bench.unit_kind(cell.mix).Unit(cfg, dict(cell.mix, tiles=TILES),
                                          seed, card)


def _first_round(unit, tracks=None, **params):
    """The program's first round of tile 0, with other tracks or
    parameters."""
    from smartdenovo_tpu_torch.pipeline.cns import (CnsParams, LayUnitig,
                                                    consensus_unitig)

    tile = unit.tiles[0]
    got = []
    consensus_unitig(LayUnitig(name=tile.name, reads=tile.reads,
                               offs=tile.offs, backbone=tile.backbone,
                               quals=tracks or unit.tracks[0]),
                     CnsParams(**dict(unit.cfg["cns"], n_iter=1, **params)),
                     device=unit.device, first_round=got)
    return got


def _halve(unit):
    """Keep the Y reads and every other N read of each tile, tracks
    with them."""
    for t, tile in enumerate(unit.tiles):
        keep = [i for i, y in enumerate(tile.backbone) if y or i % 2 == 0]
        for k in ("reads", "offs", "backbone"):
            setattr(tile, k, [getattr(tile, k)[i] for i in keep])
        unit.tracks[t] = [unit.tracks[t][i] for i in keep]


def _truth(unit, limits):
    """The truth numbers of a window of TILES tiles (the `cns` unit's
    check)."""
    for _ in range(TILES):
        unit.run()
    numbers, _failed = cns.Unit.checks(unit, limits)
    return {n: (v, lim) for n, v, lim in numbers}


@pytest.mark.cuda
def test_f5q_controls(card):
    cell = bench.cell_of(bench.load_benchmark(), CELL)
    with open(bench.BENCH / "limits" / f"{CELL}.json") as fh:
        limits = json.load(fh)
    lim = limits["aln_mismatches"]
    for seed in SEEDS:
        unit = _unit(cell, seed, card)
        sound = _truth(unit, limits)
        tile = unit.tiles[0]
        ref = cns_f5q_ref.round1(tile.reads, tile.offs, tile.backbone,
                                 unit.tracks[0],
                                 cns_f5q_ref.WholeReadParams.of(
                                     unit.cfg["cns"]), card)
        sound["aln_mismatches"] = (
            cns_f5q_ref.mismatches(ref, unit.first[1]), lim)
        print(f"{CELL} seed {seed}: program {sound}")
        assert all(v <= lim_ for v, lim_ in sound.values())
        late = [np.roll(q, 1, axis=1) for q in unit.tracks[0]]
        for name, got in (("affine refine", _first_round(unit, use_qv=False)),
                          ("tracks one base late", _first_round(unit, late))):
            diff = cns_f5q_ref.mismatches(ref, got)
            print(f"{CELL} seed {seed}: control {name}: aln_mismatches "
                  f"{diff} of {len(ref)} reads, limit {lim}")
            assert diff > lim
        for variant in ("half", {"n_iter": 1}):
            u = _unit(cell, seed, card, **(variant if variant != "half"
                                           else {}))
            if variant == "half":
                _halve(u)
            got = _truth(u, limits)
            print(f"{CELL} seed {seed}: control {variant} {got}")
            assert any(v > lim_ for v, lim_ in got.values())
