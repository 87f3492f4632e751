"""A CPU rehearsal of the harness with tiny configurations kept here (not
cells): each mix's unit runs through the port on the CPU, the stage
parsers read the port's real log lines, the metric readers are found by
file name, run.py refuses to measure without a card, and a run with the
timed path broken underneath comes out not correct, once for each fault
the cells can have."""

import dataclasses
import json
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.harness import bench
from portbench.harness.stages import StageLog, cns_splits, overlap_stages
from portbench.harness.window import measure

RUN = runpy.run_path(str(ROOT / "portbench" / "run.py"),
                     run_name="portbench_run")


def _config(name, **kw):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as fh:
        cfg = json.load(fh)
    cfg.update(kw)
    return cfg


TINY_OVERLAP = dict(genome_bp=80_000, coverage=10, mean_len=3000,
                    filter_min_len=1000)
TINY_CNS = dict(unitig_bp=15_000, coverage=20, mean_len=2500,
                filter_min_len=1000)


def tiny_cell(name):
    """The cell `name` with its configuration cut to a CPU's size."""
    cell = bench.cell_of(bench.load_benchmark(), name)
    cfg = _config(cell.config["name"])
    if cell.mix["unit"] == "overlap":
        cfg.update(TINY_OVERLAP)
        cfg["zmo"] = dict(cfg["zmo"], batch_q=8)
        mix = dict(cell.mix, warmup_units=0)
    else:
        cfg.update(TINY_CNS)
        cfg["cns"] = dict(cfg["cns"], n_iter=3)
        mix = dict(cell.mix, warmup_units=0, tiles=1)
    return dataclasses.replace(cell, config=cfg, mix=mix)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_readers_found_by_name():
    b = bench.load_benchmark()
    for m in b["per_layer"]:
        assert callable(bench.metric_reader(m["name"]).read)
    for k in bench.roofline_kernels():
        mod = bench.roofline(k)
        assert mod.ENTRY and mod.KERNEL and callable(mod.bound_s)
    for t in {w["traffic"] for w in b["workloads"]}:
        with open(ROOT / "portbench" / "traffic" / f"{t}.json") as fh:
            assert hasattr(bench.unit_kind(json.load(fh)), "Unit")


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ecoli_pb.overlap",
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("name", ["ecoli_pb.overlap", "ecoli_pb.cns"])
def test_unit_stage_lines_and_readers(name):
    cell = tiny_cell(name)
    unit = bench.unit_kind(cell.mix).Unit(cell.config, cell.mix, 2**34 + 5,
                                          "cpu")
    log = StageLog(sys.stderr)
    sys.stderr = log
    try:
        w = measure(unit, 0.01, log, trace=False)
    finally:
        sys.stderr = log.through
    assert w.units == 1 and w.work > 0
    values = {m["name"]: bench.metric_reader(m["name"]).read(w)
              for m in cell.per_layer}
    if cell.mix["unit"] == "overlap":
        assert set(overlap_stages(w.lines)) >= {"index", "phase1", "phase2",
                                                "redispatch", "emission"}
        for k in ("index", "phase1", "phase2", "emission"):
            assert values[f"zmo.{k}_ms_per_mbp"] > 0
    else:
        s = cns_splits(w.lines)
        assert s["segdp"] > 0 and s["align"] >= s["segdp"]
        for k in ("seed", "segdp", "stitch", "dag"):
            assert values[f"cns.{k}_ms_per_kbp"] >= 0
    # no trace: the device readings stay out of the line
    assert all(v is None for k, v in values.items()
               if "roofline" in k or "idle" in k)


def _run(name, monkeypatch, fault=None):
    if fault is not None:
        fault(monkeypatch)
    return RUN["run_cell"](tiny_cell(name), 2**34 + 9, 0.01, False,
                           device="cpu")


def _half_records(monkeypatch):
    from smartdenovo_tpu_torch.pipeline import zmo

    real = zmo.overlap_dmo
    monkeypatch.setattr(zmo, "overlap_dmo",
                        lambda *a, **k: real(*a, **k)[::2])


def _altered_record(monkeypatch):
    from smartdenovo_tpu_torch.pipeline import zmo

    real = zmo.overlap_dmo

    def altered(*a, **k):
        out = real(*a, **k)
        out[0].score += 1
        return out

    monkeypatch.setattr(zmo, "overlap_dmo", altered)


def _one_late_batch_dropped(monkeypatch):
    from smartdenovo_tpu_torch.pipeline import zmo

    real = zmo.overlap_dmo

    def dropped(rb, params, **k):
        out = real(rb, params, **k)
        late = max(o.rid1 for o in out) // params.batch_q // 2
        return [o for o in out if o.rid1 // params.batch_q != late]

    monkeypatch.setattr(zmo, "overlap_dmo", dropped)


@pytest.mark.parametrize(
    "fault", [None, _half_records, _altered_record, _one_late_batch_dropped],
    ids=["sound", "half_left_out", "answer_altered", "one_batch_dropped"])
def test_overlap_faults(monkeypatch, fault):
    res = _run("ecoli_pb.overlap", monkeypatch, fault)
    assert res["correct"] is (fault is None)
    n = res["check"]["record_mismatches"]["value"]
    assert (n == 0) is (fault is None)


def _state_unchanged(monkeypatch):
    from smartdenovo_tpu_torch.pipeline import cns

    monkeypatch.setattr(cns, "consensus_unitig",
                        lambda unit, *a, **k: cns._gen_backbone(unit))


def _half_reads(monkeypatch):
    from smartdenovo_tpu_torch.pipeline import cns

    real = cns.consensus_unitig

    def half(unit, *a, **k):
        keep = [i for i, y in enumerate(unit.backbone) if y or i % 2 == 0]
        sub = cns.LayUnitig(unit.name, [unit.reads[i] for i in keep],
                            [unit.offs[i] for i in keep],
                            [unit.backbone[i] for i in keep])
        return real(sub, *a, **k)

    monkeypatch.setattr(cns, "consensus_unitig", half)


def _consensus_altered(monkeypatch):
    from smartdenovo_tpu_torch.pipeline import cns

    real = cns.consensus_unitig
    monkeypatch.setattr(
        cns, "consensus_unitig",
        lambda *a, **k: (3 - real(*a, **k)[::-1]).astype(np.uint8))


@pytest.fixture(scope="module")
def cns_sound():
    with pytest.MonkeyPatch.context() as mp:
        return _run("ecoli_pb.cns", mp)["check"]


@pytest.mark.parametrize(
    "fault", [_state_unchanged, _half_reads, _consensus_altered],
    ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_cns_faults(monkeypatch, fault, cns_sound):
    # the tiny tile's thin ends put its sound readings near the cell's
    # limits, so a fault must read above its sound reading as well
    res = _run("ecoli_pb.cns", monkeypatch, fault)
    c = res["check"]
    assert res["correct"] is False, c
    assert any(v["value"] > v["limit"] and v["value"] > cns_sound[n]["value"]
               for n, v in c.items()), (c, cns_sound)
