"""The checks' controls on the card, at the cells' own sizes, on three
seeds: each must come out not correct while the program comes out
correct.  Run on the card with

    python -m pytest -m cuda portbench/tests/test_portbench_control.py -s

(`-s` prints the readings that the limits in portbench/limits/ were set
from).

- overlap cell: the control is the reference's own emission without its
  pair ledger (a pair emitted once may be emitted again), put in the
  program's place and judged as the program is;
- consensus cell: two controls, each the program with one thing the
  configuration states broken: half of the layout's N reads left out (a
  depth cut), and one round of consensus where the configuration states
  `n_iter` 6.  A second round is read and printed too: it is not told
  apart from six (PERF.md, section 2).
"""

import json

import pytest

from portbench.harness import bench
from portbench.reference import overlap_ref

SEEDS = [4_100_000_001, 4_100_000_002, 4_100_000_003]
# a window's tiles: the most any 51 s window of the cell reached
CNS_TILES = 8


def _cell(name):
    cell = bench.cell_of(bench.load_benchmark(), name)
    with open(bench.BENCH / "limits" / f"{name}.json") as fh:
        return cell, json.load(fh)


@pytest.mark.cuda
def test_overlap_control(card):
    cell, limits = _cell("ecoli_pb.overlap")
    lim = limits["record_mismatches"]
    unit_kind = bench.unit_kind(cell.mix)
    for seed in SEEDS:
        unit = unit_kind.Unit(cell.config, cell.mix, seed, card)
        unit.run()
        got = unit_kind.records_of(unit.outputs[0])
        unit.outputs.clear()
        unit.free()
        p = overlap_ref.DmParams.of(cell.config["zmo"])
        cands = overlap_ref.reference_candidates(unit.bank, p, card)
        ref = overlap_ref.emit(unit.bank, p, cands)
        ctl = overlap_ref.emit(unit.bank, p, cands, ledger=False)
        sound = overlap_ref.mismatches(ref, got)
        control = overlap_ref.mismatches(ref, ctl)
        print(f"ecoli_pb.overlap seed {seed}: record_mismatches program "
              f"{sound} control {control} limit {lim}")
        assert sound <= lim < control


def cns_readings(cell, seed, card, variant=None):
    """The cell's check numbers over a window's tiles, for the program as
    configured (variant None), with half of the N reads left out
    ("half"), or at another number of rounds ({"n_iter": k})."""
    base = bench.unit_kind(cell.mix).Unit
    cfg = cell.config
    if isinstance(variant, dict):
        cfg = dict(cfg, cns=dict(cfg["cns"], **variant))

    class Half(base):
        def layout(self, tile):
            lay = super().layout(tile)
            keep = [i for i, y in enumerate(lay.backbone) if y or i % 2 == 0]
            return type(lay)(lay.name, [lay.reads[i] for i in keep],
                             [lay.offs[i] for i in keep],
                             [lay.backbone[i] for i in keep])

    unit = (Half if variant == "half" else base)(cfg, cell.mix, seed, card)
    for _ in range(CNS_TILES):
        unit.run()
    with open(bench.BENCH / "limits" / f"{cell.name}.json") as fh:
        numbers, _failed = unit.checks(json.load(fh))
    return {n: (v, lim) for n, v, lim in numbers}


@pytest.mark.cuda
def test_cns_control(card):
    cell, _limits = _cell("ecoli_pb.cns")
    for seed in SEEDS:
        sound = cns_readings(cell, seed, card)
        print(f"ecoli_pb.cns seed {seed}: program {sound}")
        assert all(v <= lim for v, lim in sound.values())
        for variant in ("half", {"n_iter": 1}, {"n_iter": 2}):
            got = cns_readings(cell, seed, card, variant)
            print(f"ecoli_pb.cns seed {seed}: control {variant} {got}")
            if variant != {"n_iter": 2}:
                assert any(v > lim for v, lim in got.values())
