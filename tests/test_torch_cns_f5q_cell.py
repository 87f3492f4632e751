"""The benchmark's f5q consensus cell on the CPU: the `cns_f5q` unit (one
`consensus_unitig` call on a tile whose reads carry f5q tracks, the
whole-read engine with its quality-aware refine) on a tiny configuration
against its plain reference (portbench/reference/cns_f5q_ref.py), read
for read over the first round; two broken programs the check must catch;
the tracks' generator against `unitig_tiles` and its profile; the spans
`cns.probe`, `cns.banded`, `cns.refine` and `cns.strings` with their
counts and the readers of them; the `refine` roofline count; and the
reference's imports."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.gen import f5q  # noqa: E402
from portbench.gen.workload import unitig_tiles  # noqa: E402
from portbench.harness import bench, spans  # noqa: E402
from portbench.harness.stages import StageLog  # noqa: E402
from portbench.harness.trace import Trace, resolved  # noqa: E402
from portbench.harness.window import Window, measure  # noqa: E402
from portbench.reference import cns_f5q_ref  # noqa: E402
from smartdenovo_tpu_torch.pipeline.cns import (CnsParams, LayUnitig,  # noqa: E402
                                                consensus_unitig)
from smartdenovo_tpu_torch.utils import timing  # noqa: E402

CELL = "ecoli_pb_f5q.cns"
# a 12 kb tile at 6x in reads of 1.2-4.5 kb (~30 reads, one batch of 64)
# and one round: the plain DPs are row loops on the CPU
TINY = dict(unitig_bp=12_000, coverage=6, mean_len=2000,
            filter_min_len=1200)
SEED = 2**34 + 23
READERS = ("cns_f5q.probe_ms_per_kbp", "cns_f5q.banded_ms_per_kbp",
           "cns_f5q.refine_ms_per_kbp", "cns_f5q.strings_ms_per_kbp",
           "cns_f5q.refine_busy_share", "cns_f5q.qv_share",
           "refine_roofline")
ALIGN_PARTS = ["cns.probe", "cns.banded", "cns.refine", "cns.strings"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _tiny():
    cell = bench.cell_of(bench.load_benchmark(), CELL)
    cfg = dict(cell.config, **TINY)
    cfg["cns"] = dict(cfg["cns"], n_iter=1)
    return dataclasses.replace(cell, config=cfg,
                               mix=dict(cell.mix, warmup_units=0, tiles=1))


@pytest.fixture(scope="module")
def ran():
    """(cell, unit, window, reference's first round) of one tiny unit."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        cell = _tiny()
        unit = bench.unit_kind(cell.mix).Unit(cell.config, cell.mix, SEED,
                                              "cpu")
        log = StageLog(sys.stderr)
        sys.stderr = log
        try:
            w = measure(unit, 0.01, log, trace=False)
        finally:
            sys.stderr = log.through
        tile = unit.tiles[0]
        ref = cns_f5q_ref.round1(
            tile.reads, tile.offs, tile.backbone, unit.tracks[0],
            cns_f5q_ref.WholeReadParams.of(cell.config["cns"]), "cpu")
    finally:
        torch.set_num_threads(n)
    assert w.units == 1
    return cell, unit, w, ref


def test_first_round_equals_the_reference(ran):
    _cell, unit, _w, ref = ran
    i, got = unit.first
    assert i == 0 and len(got) == len(ref) == len(unit.tiles[0].reads)
    assert cns_f5q_ref.mismatches(ref, got) == 0
    # the reads not on the backbone's path align with indels
    assert sum((r[4] == 4).any() and (r[5] == 4).any() for r in got) > len(
        got) // 2


def test_unit_checks_read_no_mismatch(ran):
    _cell, unit, _w, _ref = ran
    numbers, failed = unit.checks({"cns_error_rate": 1.0,
                                   "cns_weak_piece_share": 0.0,
                                   "aln_mismatches": 0})
    assert [x[0] for x in numbers] == ["cns_error_rate",
                                       "cns_weak_piece_share",
                                       "aln_mismatches"]
    assert numbers[2] == ("aln_mismatches", 0, 0)
    # the weak-piece share is judged over the window, not a tile at a time
    assert numbers[1][2] == 0.0 and failed == 0


@pytest.mark.parametrize("fault", ["affine_refine", "tracks_shifted"])
def test_broken_programs_read_mismatches(ran, fault):
    """The affine refine in the 5q refine's place, and every read's tracks
    one base late: the program's first round differs from the
    reference's."""
    cell, unit, _w, ref = ran
    tile = unit.tiles[0]
    quals = unit.tracks[0]
    kw = dict(cell.config["cns"])
    if fault == "affine_refine":
        kw["use_qv"] = False
    else:
        quals = [np.roll(q, 1, axis=1) for q in quals]
    got = []
    consensus_unitig(LayUnitig(name=tile.name, reads=tile.reads,
                               offs=tile.offs, backbone=tile.backbone,
                               quals=quals),
                     CnsParams(**kw), device="cpu", first_round=got)
    assert len(got) == len(ref)
    assert cns_f5q_ref.mismatches(ref, got) > 0


def test_generator_keeps_unitig_tiles():
    cfg = dict(_tiny().config, unitig_bp=20_000)
    tiles, tracks = f5q.f5q_tiles(cfg, 2**40 + 3, 3)
    want = unitig_tiles(cfg, 2**40 + 3, 3)
    assert len(tiles) == len(want) == len(tracks) == 3
    for a, b, tr in zip(tiles, want, tracks):
        assert (a.name, a.offs, a.backbone, a.span) == (b.name, b.offs,
                                                        b.backbone, b.span)
        assert all(np.array_equal(x, y) for x, y in zip(a.reads, b.reads))
        for k in ("truth", "tstart", "tend"):
            assert np.array_equal(getattr(a, k), getattr(b, k))
        assert [q.shape for q in tr] == [(7, len(r)) for r in a.reads]
        assert all(q.dtype == np.uint8 for q in tr)


def test_error_bases_read_lower_qvs():
    """Each QV track is lower at its kind's error bases than elsewhere, the
    tags name the template's bases there and N elsewhere, and the events
    are the simulator's (a read's length is its template's plus its
    insertions less its deletions)."""
    from portbench.gen.simulate import (ErrorModel, random_genome, rng_for,
                                        sample_reads, template_lengths)
    from portbench.gen.workload import filtered

    cfg = _tiny().config
    phred = f5q.kind_phred(cfg)
    assert phred == {"sub": 17, "ins": 11, "del": 14}
    rng = rng_for(99, 2, 0)
    L = cfg["unitig_bp"]
    genome = random_genome(rng, L)
    reads = filtered(sample_reads(
        rng, genome, template_lengths(5, 6 * L, 2000, 1000, L),
        ErrorModel.of(cfg), circular=False, strands=False), 1200)
    trng = rng_for(99, 3, 0)
    seen = {"sub": 0, "ins": 0, "del": 0}
    for k in range(len(reads)):
        q = f5q.read_tracks(reads, k, genome, phred, trng)
        sub_at, sub_tag, ins_at, del_at, del_tag = f5q.events(reads, k,
                                                              genome)
        seq = reads.read(k)
        assert (q[0] == f5q.QV).all() and (q[4] == f5q.MERGE_QV).all()
        for row, kind, at in ((1, "sub", sub_at), (2, "ins", ins_at),
                              (3, "del", del_at)):
            mark = np.zeros(len(seq), bool)
            mark[at] = True
            assert (q[row][mark] <= f5q.EVENT_QV[1]).all()
            assert (q[row][mark] >= f5q.EVENT_QV[0]).all()
            assert (np.abs(q[row][~mark].astype(int) - phred[kind])
                    <= f5q.JITTER).all()
            seen[kind] += int(mark.sum())
        assert (seq[sub_at] != sub_tag).all()
        assert np.array_equal(q[5][sub_at], sub_tag)
        assert np.array_equal(q[6][del_at], del_tag)
        assert (np.delete(q[5], sub_at) == 4).all()
        assert (np.delete(q[6], del_at) == 4).all()
        t0, n = int(reads.tflat[k]), int(reads.tlen[k])
        twos = np.sum((reads.twos >= t0) & (reads.twos < t0 + n))
        zeros = np.sum((reads.zeros >= t0) & (reads.zeros < t0 + n))
        assert len(seq) == n + twos - zeros
        assert len(ins_at) == twos and len(del_at) <= zeros
    # ~1.95%, 7.15% and 3.9% of the bases (hp shrinks that write c once
    # are no deletion)
    total = sum(len(reads.read(k)) for k in range(len(reads)))
    assert 0.012 < seen["sub"] / total < 0.028
    assert 0.055 < seen["ins"] / total < 0.09
    assert 0.015 < seen["del"] / total < 0.04


def test_align_parts_nest_and_carry_their_counts(ran):
    _cell, unit, w, _ref = ran
    got = spans.window_spans(w)
    by_id = {s.id: s for s in got}
    (align,) = spans.named(got, "cns.align")
    parts = [s for s in got if s.parent == align.id]
    tile = unit.tiles[0]
    nb = -(-len(tile.reads) // 64)
    assert [s.name for s in parts] == ALIGN_PARTS * nb
    alen = sum(len(r) for r in tile.reads)
    banded, refine = parts[1], parts[2]
    assert banded.counts == {"reads": len(tile.reads), "cells": alen * 256}
    assert refine.counts["reads"] == refine.counts["reads_5q"] == len(
        tile.reads)
    # cells: Σ alen × W at the batch's band width; the 5q refine's calls,
    # one a length tier, carry their own
    dp = [s for s in got if s.parent == refine.id and s.name == "refine5q"]
    cells = sum(s.counts["cells"] for s in dp)
    W = cells // alen
    assert cells == W * alen and W in (64, 128, 256, 512, 1024)
    assert refine.counts["cells"] == cells and len(dp) > 1
    kids = {s.name for s in got if s.parent == refine.id}
    assert kids == {"band", "refine5q", "rle"}
    assert {s.name for s in got if s.parent == banded.id} == {
        "centers", "banded", "banded_rle"}
    for s in parts:
        assert align.t0 <= s.t0 <= s.t1 <= align.t1
        assert by_id[s.parent] is align
    (rnd,) = spans.named(got, "cns.round")
    assert rnd.counts["reads_aligned"] == len(unit.first[1])


def test_readers_read_the_spans(ran):
    cell, _unit, w, _ref = ran
    got = {n: bench.metric_reader(n).read(w) for n in READERS}
    for n in READERS[:4]:
        assert isinstance(got[n], float) and got[n] > 0, n
    assert got["cns_f5q.qv_share"] == 1.0
    # no trace and no launches in this run
    assert got["cns_f5q.refine_busy_share"] is None
    assert got["refine_roofline"] is None
    assert [m["name"] for m in cell.per_layer] == [
        "cns.dag_ms_per_kbp", "device.idle_share.cns", "cns.rounds_per_tile",
        "cns.accept_share", *READERS]
    assert [m["name"] for m in cell.end_to_end] == ["cns_kbp_per_s",
                                                    "setup_s"]


def _launch(mod, ints: dict, arrays: dict):
    """A launch record of roofline module `mod` from an argument list with
    `ints` at their positions and fake pointers to `arrays` elsewhere."""
    args = [None] * 25
    for k, v in ints.items():
        args[k] = v
    for k in arrays:
        args[k] = 1000 + k

    def device_copy(ptr, count, typestr="<i4"):
        return torch.as_tensor(arrays[ptr - 1000][:count], dtype=torch.int32)

    return resolved([mod.on_launch(tuple(args), device_copy)])[0]


def test_refine_roofline_gives_the_kernel_tables_bounds():
    """PERF.md's kernel table at B 64, LA 32,768, W 128: refine5q ~0.18 ms
    for 2.17e8 cells x 14, the affine refine 0.158 ms for 2.20e8 x 12."""
    rf = bench.roofline("refine")
    for q5, cells, ms in ((1, 217_000_000, 0.182), (0, 220_000_000, 0.158)):
        alen = np.full(64, cells // 128 // 64)
        rec = _launch(rf, {10: 64, 11: 32768, 12: 40000, 13: 128,
                           14: 2 * 32769 + 128 + 4, 15: q5},
                      {2: alen, 3: alen + 100})
        assert rec["rows"] == alen.sum() and rec["q5"] == bool(q5)
        s, by = rf.bound_s(rec)
        assert by == "operations" and round(s * 1e3, 3) == ms


def test_busy_share_and_roofline_on_a_hand_made_trace(monkeypatch):
    rec = timing.Recorder()
    monkeypatch.setattr(timing, "RECORDER", rec)
    made = []
    for k, (name, parent, t0, t1, counts) in enumerate([
            ("cns.unitig", None, 0, 600_000, {"rounds": 1}),
            ("cns.round", 1, 10_000, 590_000,
             {"reads_aligned": 4, "reads_accepted": 4}),
            ("cns.align", 2, 20_000, 500_000, {}),
            ("cns.refine", 3, 200_000, 400_000,
             {"reads": 4, "reads_5q": 4, "cells": 4000})]):
        s = rec.span(name, **counts)
        s.id, s.parent, s.unit = k + 1, parent, 1
        s.t0, s.t1 = 10**12 + t0, 10**12 + t1
        made.append(s)
    rec.spans.extend(made[::-1])
    events = [("void (anonymous namespace)::refine_warp<4, true>(int)",
               "kernel", 250.0, 50.0)]
    launch = {"B": 4, "LA": 2048, "LB": 2048, "W": 128, "T": 4230,
              "q5": True, "rows": 4000 // 128, "cols": 40}
    w = Window(work_unit="kbp", work=1.0, units=1, t0=1000.0, seconds=6e-4,
               trace=Trace(events, 6e-4), anchor=(0.0, 1000.0),
               launches={"refine": [launch]})
    read = {n: bench.metric_reader(n).read(w) for n in READERS}
    assert read["cns_f5q.refine_busy_share"] == pytest.approx(0.25)
    assert read["cns_f5q.qv_share"] == 1.0
    assert read["cns_f5q.refine_ms_per_kbp"] == pytest.approx(0.2)
    need = bench.roofline("refine").bound_s(launch)[0]
    assert read["refine_roofline"] == pytest.approx(100 * need / 50e-6)
    assert read["cns_f5q.probe_ms_per_kbp"] is None      # no such spans
    w.launches = {"refine": [launch, launch]}             # do not pair up
    assert bench.metric_reader("refine_roofline").read(w) is None


def test_readers_return_none_where_the_program_keeps_no_spans(monkeypatch):
    """The parent commit's program lacks the new spans; a program without
    the recorder gives no spans at all: every new reader returns None."""
    monkeypatch.delattr(timing, "RECORDER")
    w = Window(work_unit="kbp", work=1.0, units=1, t0=0.0, seconds=1.0,
               trace=Trace([("k", "kernel", 0.0, 1.0)], 1.0),
               anchor=(0.0, 0.0), launches={})
    for name in READERS:
        assert bench.metric_reader(name).read(w) is None, name


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import json, sys; sys.path.insert(0, '.');"
            "import portbench.reference.cns_f5q_ref, portbench.gen.f5q;"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "smartdenovo_tpu",
                        "smartdenovo_tpu_torch"}
