"""The port's span recorder (smartdenovo_tpu_torch/utils/timing.py) and
the benchmark's readers of it (portbench/harness/spans.py and the metrics
that read spans): the recorder's nesting, ids, ring bound and counts;
the spans of tiny overlap and consensus units on the CPU (the benchmark
rehearsal's configurations), against the stage lines printed from them;
and the busy-share, fetch-residual and idle arithmetic on a hand-made
trace."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import bench, spans  # noqa: E402
from portbench.harness.stages import (CNS_ITER, CNS_SEGDP, STAGE,  # noqa: E402
                                      StageLog, overlap_stages)
from portbench.harness.trace import Trace  # noqa: E402
from portbench.harness.window import Window, measure  # noqa: E402
from smartdenovo_tpu_torch.utils import timing  # noqa: E402
from smartdenovo_tpu_torch.utils.timing import Recorder  # noqa: E402

# the benchmark rehearsal's cuts (portbench/tests/test_portbench_rehearsal.py)
TINY_OVERLAP = dict(genome_bp=80_000, coverage=10, mean_len=3000,
                    filter_min_len=1000)
TINY_CNS = dict(unitig_bp=15_000, coverage=20, mean_len=2500,
                filter_min_len=1000)
NEW_READERS = {
    "ecoli_pb.overlap": ("zmo.phase1_busy_share", "zmo.phase2_busy_share",
                         "zmo.redispatch_per_pass", "zmo.pair_yield"),
    "ecoli_pb.cns": ("cns.segplan_ms_per_kbp", "cns.stitch_self_ms_per_kbp",
                     "cns.segdp_busy_share", "cns.rounds_per_tile",
                     "cns.accept_share"),
}


# ---------------------------------------------------------------- recorder


def test_spans_nest_with_parent_and_unit_ids():
    rec = Recorder()
    with rec.span("a") as a:
        with rec.span("b") as b:
            pass
        with rec.span("c") as c:
            with rec.span("d") as d:
                pass
    with rec.span("e") as e:
        pass
    assert list(rec.spans) == [b, d, c, a, e]      # in the order they closed
    assert a.parent is None and e.parent is None
    assert (b.parent, c.parent, d.parent) == (a.id, a.id, c.id)
    assert {s.unit for s in (a, b, c, d)} == {a.id}
    assert e.unit == e.id != a.id
    assert len({s.id for s in rec.spans}) == 5
    assert a.t0 <= b.t0 <= b.t1 <= c.t0 <= d.t0 <= d.t1 <= c.t1 <= a.t1
    assert a.seconds == (a.t1 - a.t0) / 1e9 and not rec.stack


def test_span_closes_on_an_exception():
    rec = Recorder()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("inner"):
                raise ValueError
    assert [s.name for s in rec.spans] == ["inner", "outer"]
    assert all(s.t1 >= s.t0 for s in rec.spans) and not rec.stack
    with rec.span("next") as nxt:
        pass
    assert nxt.parent is None


def test_ring_keeps_the_newest():
    rec = Recorder(maxlen=4)
    for k in range(10):
        with rec.span(f"s{k}"):
            pass
    assert [s.name for s in rec.spans] == ["s6", "s7", "s8", "s9"]


def test_counts_start_as_given_and_grow_while_open():
    rec = Recorder()
    with rec.span("round", reads=0, kept=3) as sp:
        for _ in range(5):
            sp.counts["reads"] += 1
        sp.counts["late"] = 7
    assert rec.spans[-1].counts == {"reads": 5, "kept": 3, "late": 7}


def test_child_seconds_sums_the_children_of_the_given_spans_by_name():
    rec = Recorder()
    with rec.span("pass") as a:
        for _ in range(2):
            with rec.span("probe"):
                with rec.span("inner"):
                    sum(range(1000))
        with rec.span("band"):
            pass
    with rec.span("pass") as b:
        with rec.span("probe"):
            pass
    with rec.span("other") as c:
        with rec.span("band"):
            pass
    kids = {p.id: [s for s in rec.spans if s.parent == p.id]
            for p in (a, b, c)}
    got = timing.child_seconds([a, b], rec)
    assert set(got) == {"probe", "band"}         # not a grandchild's name
    probes = [s for s in kids[a.id] + kids[b.id] if s.name == "probe"]
    assert len(probes) == 3
    assert got["probe"] == pytest.approx(sum(s.seconds for s in probes),
                                         abs=1e-12)
    assert got["band"] == kids[a.id][-1].seconds
    assert timing.child_seconds([c], rec) == {"band": kids[c.id][0].seconds}
    assert timing.child_seconds([], rec) == {}


# ----------------------------------------------- spans of tiny units (CPU)


def _tiny_cell(name):
    cell = bench.cell_of(bench.load_benchmark(), name)
    with open(ROOT / "portbench" / "configs" / "ecoli_pb.json") as fh:
        cfg = json.load(fh)
    if cell.mix["unit"] == "overlap":
        cfg.update(TINY_OVERLAP)
        cfg["zmo"] = dict(cfg["zmo"], batch_q=8)
        mix = dict(cell.mix, warmup_units=0)
    else:
        cfg.update(TINY_CNS)
        cfg["cns"] = dict(cfg["cns"], n_iter=3)
        mix = dict(cell.mix, warmup_units=0, tiles=1)
    return dataclasses.replace(cell, config=cfg, mix=mix)


@pytest.fixture(scope="module", params=["ecoli_pb.overlap", "ecoli_pb.cns"])
def ran(request):
    """(cell, unit, window) of one tiny unit of the cell on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    cell = _tiny_cell(request.param)
    unit = bench.unit_kind(cell.mix).Unit(cell.config, cell.mix, 2**34 + 17,
                                          "cpu")
    log = StageLog(sys.stderr)
    sys.stderr = log
    try:
        w = measure(unit, 0.01, log, trace=False)
    finally:
        sys.stderr = log.through
        torch.set_num_threads(n)
    assert w.units == 1
    return cell, unit, w


def test_children_lie_inside_their_parents(ran):
    _cell, _unit, w = ran
    got = spans.window_spans(w)
    assert got
    by_id = {s.id: s for s in got}
    roots = [s for s in got if s.parent is None]
    assert len(roots) == 1 and roots[0].name in ("zmo.pass", "cns.unitig")
    for s in got:
        assert s.unit == roots[0].id
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.t0 <= s.t0 <= s.t1 <= up.t1, (s, up)


def test_stage_lines_are_the_spans_durations(ran):
    cell, unit, w = ran
    got = spans.window_spans(w)
    lines = [s for _t, s in w.lines]
    if cell.mix["unit"] == "overlap":
        printed = {}
        for s in lines:
            m = STAGE.search(s)
            if m:
                printed[m.group(1)] = m.group(2)
        assert set(overlap_stages(w.lines)) == set(printed) == {
            "index", "phase1", "phase2", "redispatch", "emission"}
        for k, v in printed.items():
            (sp,) = spans.named(got, f"zmo.{k}")
            assert v == f"{sp.seconds:.3f}", k
        (em,) = spans.named(got, "zmo.emission")
        assert em.counts["records"] == len(unit.outputs[-1]) > 0
        (p1,) = spans.named(got, "zmo.phase1")
        (p2,) = spans.named(got, "zmo.phase2")
        assert p1.counts["batches"] > 0 and p2.counts["pair_rows"] > 0
        assert 0 <= p2.counts["chunks_sweep"] <= p2.counts["chunks"] > 0
        (rd,) = spans.named(got, "zmo.redispatch")
        assert rd.counts["redispatched"] == sum("budget overflow" in s
                                               for s in lines)
        assert rd.counts["attempts"] >= p1.counts["batches"]
    else:
        iters = [CNS_ITER.search(s) for s in lines]
        iters = [m.groups()[2:] for m in iters if m]
        segdp = [CNS_SEGDP.search(s) for s in lines]
        segdp = [m.groups()[1:] for m in segdp if m]
        (root,) = spans.named(got, "cns.unitig")
        assert root.counts["rounds"] == len(iters) == 3
        rounds = spans.named(got, "cns.round")
        assert len(rounds) == 3
        for k, (seed, align, dag) in enumerate(iters):
            kids = {s.name: s for s in got if s.parent == rounds[k].id}
            assert [seed, align, dag] == [
                f"{kids[n].seconds:.3f}" for n in ("cns.seed", "cns.align",
                                                   "cns.dag")]
            r = rounds[k].counts
            assert 0 < r["reads_accepted"] <= r["reads_aligned"]
            # the align pass's own parts lie inside it, one after another
            parts = [s for s in got if s.parent == kids["cns.align"].id]
            assert [s.name for s in parts] == ["cns.segplan", "cns.segdp",
                                               "cns.stitch"]
            assert sum(s.seconds for s in parts) <= kids["cns.align"].seconds
            nseg, ndisp, bc, sec = segdp[k]
            assert sec == f"{parts[1].seconds:.3f}"
            assert parts[1].counts == {"segments": int(nseg),
                                       "dispatches": int(ndisp),
                                       "Bc": int(bc)}


def test_new_readers_read_the_spans(ran):
    cell, _unit, w = ran
    for name in NEW_READERS[cell.name]:
        v = bench.metric_reader(name).read(w)
        if "busy" in name:
            assert v is None, name         # no trace in this run
        else:
            assert isinstance(v, float) and v >= 0, (name, v)
    if cell.name == "ecoli_pb.cns":
        assert bench.metric_reader("cns.rounds_per_tile").read(w) == 3.0
        assert 0 < bench.metric_reader("cns.accept_share").read(w) <= 1
    else:
        assert bench.metric_reader("zmo.redispatch_per_pass").read(w) == 0.0
        assert 0 < bench.metric_reader("zmo.pair_yield").read(w) <= 1


def test_redispatches_are_counted(monkeypatch):
    """A tandem-repeat bank whose vtab batches outgrow their pair budget:
    each `budget overflow` line is one re-run in `redispatched`."""
    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.pipeline import zmo
    from smartdenovo_tpu_torch.utils.simulate import (random_genome,
                                                      simulate_reads)

    rng = np.random.default_rng(31)
    unit = random_genome(rng, 400)
    copies = []
    for _ in range(30):
        u = unit.copy()
        m = rng.random(400) < 0.03
        u[m] = rng.integers(0, 4, int(m.sum()))
        copies.append(u)
    g = np.concatenate([random_genome(rng, 3000), *copies,
                        random_genome(rng, 3000)])
    names, seqs = simulate_reads(g, coverage=8, mean_len=3000, err=0.13,
                                 seed=32)
    lines = []
    monkeypatch.setattr(zmo, "log", lambda m, *a: lines.append(m % a))
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = zmo.overlap_dmo(ReadBank(names, seqs),
                              zmo.ZmoParams.dmo(matcher="vtab", batch_q=8,
                                                ncand=64), device="cpu")
    finally:
        torch.set_num_threads(n)
    rd = next(s for s in reversed(timing.RECORDER.spans)
              if s.name == "zmo.redispatch")
    over = [m for m in lines if "budget overflow" in m]
    assert len(over) >= 2 and rd.counts["redispatched"] == len(over)
    assert rd.counts["attempts"] >= len(over) + 1
    summary = [m for m in lines if m.startswith("redispatched ")]
    assert summary == [f"redispatched {len(over)} of "
                       f"{rd.counts['attempts']} overflow checks"]
    em = next(s for s in reversed(timing.RECORDER.spans)
              if s.name == "zmo.emission")
    assert em.counts["records"] == len(out)


def test_stitch_span_counts_the_plain_stitchers_outcome(monkeypatch):
    """Each round's `cns.stitch` span on the 12 kb unit of tests/test_cns.py
    counts what the plain stitcher makes of the same inputs: the reads it
    yields, those with segments it yields not (their column maps dropped
    for reseeding) and its fallbacks."""
    import copy

    from smartdenovo_tpu_torch.pipeline import cns
    from test_torch_cuda import unit_12kb

    expected = []
    real = cns._stitch_native

    def both(unit, st, spans_, arr, b_beg, mv_all, cns_pad, Lc, p, oi, od,
             counts=None):
        plain = copy.copy(st)
        plain.colmap16 = list(st.colmap16)
        lines = []
        with monkeypatch.context() as m:
            m.setattr(cns, "log", lambda f, *a: lines.append(f % a))
            out = list(cns._stitch_reads(unit, plain, spans_, arr, b_beg,
                                         mv_all, cns_pad, Lc, p, oi, od))
        yielded = {r[0] for r in out}
        expected.append(dict(
            reads=len(out),
            reseeded=sum(sp[1] > 0 and i not in yielded
                         for i, sp in enumerate(spans_)),
            fallbacks=int(lines[0].split()[2]) if lines else 0))
        return real(unit, st, spans_, arr, b_beg, mv_all, cns_pad, Lc, p,
                    oi, od, counts)

    monkeypatch.setattr(cns, "_stitch_native", both)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cns.consensus_unitig(unit_12kb(), cns.CnsParams(n_iter=2),
                             device="cpu")
    finally:
        torch.set_num_threads(n)
    got = [s.counts for s in timing.RECORDER.spans
           if s.name == "cns.stitch"][-2:]
    assert got == expected and len(expected) == 2
    assert all(c["reads"] > 20 for c in got)


# ------------------------------------------------ hand-made trace and spans


def _span(rec, name, t0_us, t1_us, parent=None, unit=None, **counts):
    """A closed span at host times 1000 s + t us."""
    sp = rec.span(name, **counts)
    sp.id = next(rec.ids)
    sp.parent = parent.id if parent else None
    sp.unit = parent.unit if parent else sp.id
    sp.t0 = 10**12 + int(t0_us * 1e3)
    sp.t1 = 10**12 + int(t1_us * 1e3)
    rec.spans.append(sp)
    return sp


def test_busy_share_residuals_and_idle_on_a_hand_made_trace(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(timing, "RECORDER", rec)
    # a unit before the window, left out
    early = _span(rec, "zmo.pass", -300, -100)
    _span(rec, "zmo.phase2", -250, -150, parent=early)
    root = _span(rec, "zmo.pass", 0, 600)
    _span(rec, "zmo.phase2", 50, 150, parent=root, pair_rows=10)
    _span(rec, "zmo.phase2", 350, 450, parent=root, pair_rows=5)
    # device time 0 us is host time 1000 s; busy [100, 180] and [400, 500]
    events = [("k1", "kernel", 100.0, 50.0), ("k2", "kernel", 120.0, 60.0),
              ("cp", "gpu_memcpy", 400.0, 100.0),
              ("k0", "kernel", -280.0, 20.0)]
    w = Window(work_unit="Mbp", t0=1000.0, seconds=1e-3,
               trace=Trace(events, 1e-3), anchor=(0.0, 1000.0))
    got = spans.window_spans(w)
    assert {s.unit for s in got} == {root.id} and len(got) == 3
    assert spans.total(got, "zmo.phase2", "pair_rows") == 15
    # busy inside the phase2 spans: [100, 150] and [400, 450] of 200 us
    assert spans.busy_share(w, "zmo.phase2") == pytest.approx(0.5)
    assert spans.busy_share(w, "zmo.index") is None
    # last event starting in [50, 150] is k2, ending 180; in [350, 450]
    # the copy, ending 500
    assert spans.fetch_residuals_ms(w) == pytest.approx([0.030, 0.050])
    idle = spans.idle_by_span(w)
    # window idle 1000 - 180 = 820 us; phase2 idle 50 + 50; the pass's own
    # 600 - 180 - 100; outside 820 - 420
    assert idle["zmo.phase2"] == pytest.approx(100e-6)
    assert idle["zmo.pass"] == pytest.approx(320e-6)
    assert idle["outside spans"] == pytest.approx(400e-6)
    assert bench.metric_reader("zmo.phase2_busy_share").read(w) == \
        pytest.approx(0.5)
    assert bench.metric_reader("zmo.phase1_busy_share").read(w) is None
    w.trace = None
    assert bench.metric_reader("zmo.phase2_busy_share").read(w) is None


def test_readers_return_none_where_the_program_keeps_no_spans(monkeypatch):
    """The parent commit's program has no recorder: every new reader
    returns None there and raises nothing."""
    monkeypatch.delattr(timing, "RECORDER")
    for cell, names in NEW_READERS.items():
        unit = "Mbp" if cell.endswith("overlap") else "kbp"
        w = Window(work_unit=unit, work=1.0, units=1, t0=0.0, seconds=1.0,
                   trace=Trace([("k", "kernel", 0.0, 1.0)], 1.0),
                   anchor=(0.0, 0.0))
        for name in names:
            assert bench.metric_reader(name).read(w) is None, name
