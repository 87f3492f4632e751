"""The benchmark's SW (zmo) overlap cell on the CPU: the `overlap_sw`
unit (one `overlap_dmo(parts=16, part=p)` job with the zmo flags) on a
tiny configuration against its plain reference (portbench/reference/
sw_ref.py), record for record over every query batch of two parts; the
reference's CIGAR check against records put wrong on purpose; the
`zmo.swdp` and `zmo.cigars` spans with their counts and the readers of
them; the `swlocal` and `banded` roofline counts; and the reference's
imports."""

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

from portbench.harness import bench, spans  # noqa: E402
from portbench.harness.stages import STAGE, StageLog  # noqa: E402
from portbench.harness.trace import Trace, resolved  # noqa: E402
from portbench.harness.window import Window, measure  # noqa: E402
from portbench.reference import sw_ref  # noqa: E402
from smartdenovo_tpu_torch.utils import timing  # noqa: E402
from smartdenovo_tpu_torch.utils.timing import Recorder  # noqa: E402

CELL = "ecoli_pb_zmo.overlap_sw"
# ~60 kb of genome at 8x in reads of 1.5-1.65 kb (one length tier: the
# plain SW DP is a row loop on the CPU), 20 queries a part in two batches
TINY = dict(genome_bp=60_000, coverage=8, mean_len=600, min_len=1500,
            filter_min_len=1500)
TINY_ZMO = dict(batch_q=10, align_cap=8)
SEED = 2**34 + 5
READERS = ("zmo_sw.swdp_ms_per_mbp", "zmo_sw.cigars_ms_per_mbp",
           "zmo_sw.cigar_host_ms_per_mbp", "zmo_sw.cigar_busy_share",
           "swlocal_roofline", "banded_roofline")
CIGAR_PARTS = {"segs", "centers", "banded", "banded_rle", "strings"}


@pytest.fixture(scope="module")
def ran():
    """(unit, window): one unit in a measured window, then a second
    unit (the next part) after it, on the CPU."""
    cell = bench.cell_of(bench.load_benchmark(), CELL)
    cfg = dict(cell.config, **TINY)
    cfg["zmo"] = dict(cfg["zmo"], **TINY_ZMO)
    mix = dict(cell.mix, warmup_units=0)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    unit = bench.unit_kind(mix).Unit(cfg, mix, SEED, "cpu")
    log = StageLog(sys.stderr)
    sys.stderr = log
    try:
        w = measure(unit, 0.01, log, trace=False)
        unit.run()
    finally:
        sys.stderr = log.through
        torch.set_num_threads(n)
    assert w.units == 1 and len(unit.outputs) == 2
    return unit, w


def _records(unit, k):
    return unit.outputs[k][1], sw_ref.part_queries(len(unit.bank),
                                                   unit.parts,
                                                   unit.outputs[k][0])


def test_every_batch_of_two_parts_equals_the_reference(ran):
    unit, _w = ran
    from portbench.units.overlap_sw import records_of

    p = sw_ref.SwParams.of(unit.cfg["zmo"])
    assert unit.outputs[0][0] == SEED % 16
    assert unit.outputs[1][0] == (SEED + 1) % 16
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for k in range(2):
            ovl, queries = _records(unit, k)
            got = records_of(ovl, unit.bank.lengths)
            ref = sw_ref.part_records(unit.bank, p, unit.parts,
                                      unit.outputs[k][0], "cpu")
            assert got == ref
            # both of the part's batches emitted, with real CIGARs
            batch = {int(q): i // p.batch_q for i, q in enumerate(queries)}
            assert {batch[r[0]] for r in got} == {0, 1}
            assert all(r[16] != f"{r[17]}M" and r[13] + r[14] + r[15] > 0
                       for r in got)
            assert unit.work[unit.outputs[k][0]] == pytest.approx(
                unit.bank.lengths[queries].sum() / 1e6)
    finally:
        torch.set_num_threads(n)


def test_unit_checks_pass(ran):
    unit, _w = ran
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        numbers, failed = unit.checks({"record_mismatches": 0,
                                       "cigar_inconsistent": 0})
    finally:
        torch.set_num_threads(n)
    assert numbers == [("record_mismatches", 0, 0),
                       ("cigar_inconsistent", 0, 0)] and failed == 0


def _moved(cigar: str):
    """The CIGAR with its first inner I or D op moved one column later,
    or None."""
    ops, counts, _n = sw_ref._parse([cigar.encode()])
    for k in range(1, len(ops) - 1):
        if ops[k] != 0 and ops[k - 1] == 0 and ops[k + 1] == 0 \
                and counts[k + 1] > 1:
            c = counts.copy()
            c[k - 1] += 1
            c[k + 1] -= 1
            return "".join(f"{int(n)}{'MID'[o]}" for o, n in zip(ops, c))
    return None


def test_check_catches_a_moved_op_and_a_wrong_count(ran):
    unit, _w = ran
    from portbench.units.overlap_sw import records_of

    good = records_of(unit.outputs[0][1], unit.bank.lengths)
    assert sw_ref.cigar_faults(good, unit.bank) == 0
    k = next(i for i, r in enumerate(good) if _moved(r[16]))
    moved = list(good)
    moved[k] = good[k][:16] + (_moved(good[k][16]),) + good[k][17:]
    assert sw_ref.cigar_faults(moved, unit.bank) == 1
    assert sw_ref.mismatches(good, moved) == 2
    wrong = list(good)
    r = good[k + 1]
    wrong[k + 1] = r[:13] + (r[13] + 1,) + r[14:]
    assert sw_ref.cigar_faults(wrong, unit.bank) == 1
    assert sw_ref.mismatches(good, wrong) == 2
    assert sw_ref.mismatches(good, good[::-1]) == 1
    # a candidate segment a base longer than the CIGAR takes, at either
    # end: it fits at offset 0 or 1; with a match counted as a mismatch
    # it fits nowhere
    r = next(r for r in good if 0 < r[8] and r[9] < r[7])
    wider = [r[:9] + (r[9] + 1,) + r[10:], r[:8] + (r[8] - 1,) + r[9:]]
    assert sw_ref.cigar_faults(wider, unit.bank) == 0
    off = [x[:12] + (x[12] - 1, x[13] + 1) + x[14:] for x in wider]
    off = [x[:11] + ((x[12]) / x[17],) + x[12:] for x in off]
    assert sw_ref.cigar_faults(off, unit.bank) == 2


def test_spans_nest_and_carry_their_counts(ran):
    unit, w = ran
    got = spans.window_spans(w)
    by_id = {s.id: s for s in got}
    p = unit.params
    ovl, queries = _records(unit, 0)
    nbatch = -(-len(queries) // p.batch_q)
    (rd,) = spans.named(got, "zmo.redispatch")
    sw = spans.named(got, "zmo.swdp")
    assert len(sw) == nbatch + rd.counts["redispatched"]
    for s in sw:
        assert by_id[s.parent].name in ("zmo.phase2", "zmo.redispatch")
        assert s.counts == {"pairs": 2 * p.batch_q * p.align_cap}
    cig = spans.named(got, "zmo.cigars")
    (em,) = spans.named(got, "zmo.emission")
    assert len(cig) == nbatch
    assert all(s.parent == em.id for s in cig)
    assert sum(s.counts["overlaps"] for s in cig) == len(ovl) > 0
    assert sum(s.counts["cells"] for s in cig) == p.band_w * sum(
        o.end1 - o.beg1 for o in ovl)
    assert all(1 <= s.counts["calls"] <= s.counts["overlaps"] for s in cig)
    # the five parts keep their names; the host reader sums all but the
    # kernel's
    assert CIGAR_PARTS == {"segs", "centers", "banded", "banded_rle",
                           "strings"}
    host = bench.metric_reader("zmo_sw.cigar_host_ms_per_mbp").HOST
    assert set(host) == CIGAR_PARTS - {"banded"}
    decoded = 0
    for s in cig:
        kids = [c for c in got if c.parent == s.id]
        assert {c.name for c in kids} == CIGAR_PARTS
        assert sum(c.name == "banded" for c in kids) == s.counts["calls"]
        assert all(s.t0 <= c.t0 <= c.t1 <= s.t1 for c in kids)
        rle = [c for c in kids if c.name == "banded_rle"]
        assert len(rle) == s.counts["calls"]
        assert all(c.counts["overlaps"] >= 1 for c in rle)
        decoded += sum(c.counts["overlaps"] for c in rle)
    # every record's moves are decoded once: those given a CIGAR and the
    # empty tracebacks, which keep the emission's placeholder
    empty = sum(o.cigar == f"{o.aln}M" and o.mis + o.ins + o.dl == 0
                for o in ovl)
    assert decoded == sum(s.counts["overlaps"] for s in cig) + empty
    assert decoded == len(ovl)
    printed = {}
    for _t, line in w.lines:
        m = STAGE.search(line)
        if m:
            printed[m.group(1)] = m.group(2)
    t_cig = sum(s.seconds for s in cig)
    assert printed["cigars"] == f"{t_cig:.3f}"
    assert printed["emission"] == f"{em.seconds - t_cig:.3f}"


def test_readers_read_the_spans(ran):
    _unit, w = ran
    got = {n: bench.metric_reader(n).read(w) for n in READERS}
    for n in READERS[:3]:
        assert isinstance(got[n], float) and got[n] > 0, n
    assert got["zmo_sw.cigar_host_ms_per_mbp"] < got[
        "zmo_sw.cigars_ms_per_mbp"]
    # no trace and no launches in this run
    assert [got[n] for n in READERS[3:]] == [None] * 3
    cell = bench.cell_of(bench.load_benchmark(), CELL)
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    assert [m["name"] for m in cell.end_to_end] == ["overlap_mbp_per_s",
                                                    "setup_s"]


def _launch(mod, ints: dict, arrays: dict):
    """A launch record of roofline module `mod` from an argument list with
    `ints` at their positions and fake pointers to `arrays` elsewhere."""
    n = 1 + max(list(ints) + list(arrays))
    args = [None] * n
    for k, v in ints.items():
        args[k] = v
    for k in arrays:
        args[k] = 1000 + k

    def device_copy(ptr, count, typestr="<i4"):
        return torch.as_tensor(arrays[ptr - 1000][:count], dtype=torch.int32)

    return resolved([mod.on_launch(tuple(args), device_copy)])[0]


def test_roofline_counts_give_the_kernel_tables_bounds():
    """PERF.md's kernel table: swlocal 1.914 ms for 2.67e9 live cells x 12
    (B 2,048, W 256, 10,420,476 live rows); banded 0.270 ms for 4.52e8
    cells x 10 (B 64, LA 32,768, W 256)."""
    sw = bench.roofline("swlocal")
    i0 = np.zeros(2048, np.int64)
    i1 = np.full(2048, 10_420_476 // 2048 - 1)
    i1[: 10_420_476 % 2048] += 1
    rec = _launch(sw, {10: 2048, 11: 65536, 12: 65536, 13: 256},
                  {6: i0, 7: i1})
    assert rec["rows"] == 10_420_476
    s, by = sw.bound_s(rec)
    assert by == "operations" and round(s * 1e3, 3) == 1.914
    bd = bench.roofline("banded")
    alen = np.full(64, 452_000_000 // 256 // 64)
    rec = _launch(bd, {5: 64, 6: 32768, 7: 40000, 8: 256, 9: 2 * 32769 + 256,
                       20: None}, {2: alen, 3: alen + 100})
    assert rec["rows"] == alen.sum() and not rec["rowmax"]
    s, by = bd.bound_s(rec)
    assert by == "operations" and round(s * 1e3, 3) == 0.270


def test_busy_share_and_rooflines_on_a_hand_made_trace(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(timing, "RECORDER", rec)
    root = rec.span("zmo.pass")
    root.id, root.parent, root.unit = 1, None, 1
    root.t0, root.t1 = 10**12, 10**12 + 600_000
    em = rec.span("zmo.emission")
    em.id, em.parent, em.unit = 2, 1, 1
    em.t0, em.t1 = 10**12 + 100_000, 10**12 + 500_000
    cig = rec.span("zmo.cigars", overlaps=3, calls=1, cells=768)
    cig.id, cig.parent, cig.unit = 3, 2, 1
    cig.t0, cig.t1 = 10**12 + 200_000, 10**12 + 400_000
    rec.spans.extend([cig, em, root])
    # the kernels: swlocal [50, 90] us, banded [250, 300] us
    events = [("void (anonymous namespace)::swlocal_kernel<8>(int)",
               "kernel", 50.0, 40.0),
              ("void (anonymous namespace)::banded_warp<8, false>(int)",
               "kernel", 250.0, 50.0)]
    sw_rec = {"B": 4, "LA": 2048, "LB": 2048, "W": 256, "rows": 4000}
    bd_rec = {"B": 3, "LA": 2048, "LB": 2048, "W": 256, "T": 4354,
              "rowmax": False, "rows": 3, "cols": 3}
    w = Window(work_unit="Mbp", work=1.0, units=1, t0=1000.0, seconds=6e-4,
               trace=Trace(events, 6e-4), anchor=(0.0, 1000.0),
               launches={"swlocal": [sw_rec], "banded": [bd_rec]})
    read = {n: bench.metric_reader(n).read(w) for n in READERS}
    # 50 us busy in the 200 us of zmo.cigars
    assert read["zmo_sw.cigar_busy_share"] == pytest.approx(0.25)
    for name, r, dur in (("swlocal", sw_rec, 40e-6), ("banded", bd_rec,
                                                      50e-6)):
        need = bench.roofline(name).bound_s(r)[0]
        assert read[f"{name}_roofline"] == pytest.approx(100 * need / dur)
    assert read["zmo_sw.swdp_ms_per_mbp"] is None       # no such spans
    assert read["zmo_sw.cigars_ms_per_mbp"] == pytest.approx(0.2)
    w.launches = {"swlocal": [sw_rec, sw_rec]}           # do not pair up
    assert bench.metric_reader("swlocal_roofline").read(w) is None


def test_readers_return_none_where_the_program_keeps_no_spans(monkeypatch):
    """The parent commit's program lacks the new spans; a program without
    the recorder gives no spans at all: every new reader returns None."""
    monkeypatch.delattr(timing, "RECORDER")
    w = Window(work_unit="Mbp", work=1.0, units=1, t0=0.0, seconds=1.0,
               trace=Trace([("k", "kernel", 0.0, 1.0)], 1.0),
               anchor=(0.0, 0.0), launches={})
    for name in READERS:
        assert bench.metric_reader(name).read(w) is None, name


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import json, sys; sys.path.insert(0, '.');"
            "import portbench.reference.sw_ref, portbench.units.overlap_sw;"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "smartdenovo_tpu",
                        "smartdenovo_tpu_torch"}
