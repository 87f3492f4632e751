"""The port's overlapper, `asm` driver and CLI against the JAX package:
overlap records and the stage files (.ovl, .obt, .lay, .lay.utg) must be
equal, record for record and byte for byte, on a 30 kb / 10x simulation.
Also: the copied host helpers equal their sources, the port imports no
JAX, and what it does not run yet says so."""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smartdenovo_tpu.data.readbank import ReadBank, seq_to_codes
from smartdenovo_tpu.io.fasta import read_seqs_qual
from smartdenovo_tpu.pipeline import driver as jdriver
from smartdenovo_tpu.pipeline import zmo as jzmo
from smartdenovo_tpu.pipeline.pre import preprocess
from smartdenovo_tpu.utils.simulate import (random_genome, simulate_reads,
                                            write_sim_fasta)
from smartdenovo_tpu_torch import cli
from smartdenovo_tpu_torch.pipeline import cns as tcns
from smartdenovo_tpu_torch.pipeline import driver as tdriver
from smartdenovo_tpu_torch.pipeline import zmo as tzmo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = (".ovl", ".obt", ".lay", ".lay.utg")


def _sim():
    rng = np.random.default_rng(11)
    g = random_genome(rng, 30000)
    return simulate_reads(g, coverage=10, mean_len=5000, err=0.13, seed=12)


@pytest.fixture(scope="module")
def bank():
    return ReadBank(*_sim())


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module", params=["auto", "join"])
def assemblies(request, bank, tmp_path_factory):
    """(matcher, JAX result, port result, JAX prefix, port prefix)."""
    tmp = tmp_path_factory.mktemp("asm_" + request.param)
    kw = dict(batch_q=8, ncand=64, matcher=request.param)
    jres = jdriver.assemble_dmo(bank, jzmo.ZmoParams.dmo(**kw))
    jdriver.write_outputs(jres, str(tmp / "jax.dmo"))
    tres = tdriver.assemble_dmo(bank, tzmo.ZmoParams.dmo(**kw), device="cpu")
    tdriver.write_outputs(tres, str(tmp / "port.dmo"))
    return request.param, jres, tres, str(tmp / "jax.dmo"), str(tmp / "port.dmo")


def test_overlap_records_equal(assemblies):
    _m, jres, tres, _jp, _tp = assemblies
    assert len(tres.overlaps) > 50
    assert ([dataclasses.astuple(o) for o in tres.overlaps]
            == [dataclasses.astuple(o) for o in jres.overlaps])


def test_stage_files_byte_equal(assemblies):
    _m, _jres, tres, jp, tp = assemblies
    assert tres.graph.lays
    for ext in FILES:
        got = _read(tp + ext)
        assert got, ext
        assert got == _read(jp + ext), ext


def test_cli_asm_matches_jax_driver(tmp_path):
    """`asm` through the port's CLI (wtpre, then the dmo stages) writes
    the files the JAX package's driver writes for the same reads."""
    fa = str(tmp_path / "reads.fa")
    write_sim_fasta(fa, *_sim())
    rc = cli.main(["asm", fa, "-p", str(tmp_path / "port"), "-J", "1000",
                   "--batch-q", "8", "--device", "cpu"])
    assert rc == 0
    recs = list(preprocess(read_seqs_qual([fa]), min_len=1000))
    rb = ReadBank([r[0] for r in recs], [seq_to_codes(r[1]) for r in recs])
    jres = jdriver.assemble_dmo(rb, jzmo.ZmoParams.dmo(batch_q=8))
    jdriver.write_outputs(jres, str(tmp_path / "jax.dmo"))
    for ext in FILES:
        got = _read(str(tmp_path / "port.dmo") + ext)
        assert got, ext
        assert got == _read(str(tmp_path / "jax.dmo") + ext), ext


def test_cli_zmo_matches_jax(bank, tmp_path):
    fa = str(tmp_path / "reads.fa")
    write_sim_fasta(fa, *_sim())
    out = str(tmp_path / "port.ovl")
    assert cli.main(["zmo", "-i", fa, "-o", out, "-A", "64", "--batch-q", "8",
                     "--device", "cpu"]) == 0
    ovls = jzmo.overlap_dmo(bank, jzmo.ZmoParams.dmo(ncand=64, batch_q=8),
                            progress=False)
    jzmo.write_overlaps(str(tmp_path / "jax.ovl"), bank, ovls)
    got = _read(out)
    assert got and got == _read(str(tmp_path / "jax.ovl"))


def test_copied_host_helpers_equal_sources():
    for name in ("_nbest_of", "_emit_batch_dm", "_extract_candidates_dm",
                 "_replay_dm", "write_overlaps", "_pad_tier"):
        assert (inspect.getsource(getattr(tzmo, name))
                == inspect.getsource(getattr(jzmo, name))), name
    assert (inspect.getsource(tdriver.remap_overlaps)
            == inspect.getsource(jdriver.remap_overlaps))
    # every field the port keeps has the JAX package's default, also
    # under the dmo flags; the fields it drops select TPU strategies
    tf = {f.name: f for f in dataclasses.fields(tzmo.ZmoParams)}
    jf = {f.name: f for f in dataclasses.fields(jzmo.ZmoParams)}
    assert set(jf) - set(tf) == {"scan_chunk", "phase3", "segk"}
    assert set(tf) <= set(jf)
    tdmo, jdmo = tzmo.ZmoParams.dmo(), jzmo.ZmoParams.dmo()
    for name in tf:
        assert tf[name].default == jf[name].default, name
        assert getattr(tdmo, name) == getattr(jdmo, name), name
    assert ([(f.name, f.type, f.default) for f in dataclasses.fields(tzmo.Overlap)]
            == [(f.name, f.type, f.default) for f in dataclasses.fields(jzmo.Overlap)])
    assert ([f.name for f in dataclasses.fields(tdriver.AssemblyResult)]
            == [f.name for f in dataclasses.fields(jdriver.AssemblyResult)])
    vals = (3, 1, 10, 500, 4, 0, 20, 610, 480, 0.8765, 480, 0, 0, 0, 600)
    names, lens = [f"r{i}" for i in range(5)], [1000] * 5
    assert (tzmo.Overlap(*vals).to_tsv(names, lens)
            == jzmo.Overlap(*vals).to_tsv(names, lens))


def test_port_imports_no_jax():
    """Importing every module of the port, the JAX package's host modules
    it shares and chip_smoke.py leaves jax unimported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import smartdenovo_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "mods += ['chip_smoke', 'smartdenovo_tpu.pipeline.pre',\n"
        "         'smartdenovo_tpu.io.fasta', 'smartdenovo_tpu.utils.simulate',\n"
        "         'smartdenovo_tpu.utils.native']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'smartdenovo_tpu_torch.cli' in sys.modules\n"
        "assert 'jax' not in sys.modules, [m for m in sys.modules if 'jax' in m]\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15


def test_unported_paths_raise(bank, tmp_path):
    for kw in (dict(engine="sw"), dict(gparts=2), dict(matcher="vtab")):
        with pytest.raises(NotImplementedError):
            tzmo.overlap_dmo(bank, tzmo.ZmoParams.dmo(**kw), device="cpu")
    fa = str(tmp_path / "r.fa")
    write_sim_fasta(fa, bank.names[:3], [bank.get(i) for i in range(3)])
    for argv in (["asm", fa, "-e", "zmo"], ["cns", "-i", "x.lay", "-a", "x.aln"],
                 ["cns", "-i", "x.lay", "-V", "2.05"]):
        with pytest.raises(NotImplementedError):
            cli.main(argv + ["--device", "cpu"])
    # the whole-read consensus engine: f5q units and seg_engine=False
    reads = [bank.get(i) for i in range(4)]
    quals = [np.zeros((7, len(r)), np.uint8) for r in reads]
    for unit, p in ((tcns.LayUnitig("u", reads, [0] * 4, [True] * 4,
                                    quals=quals), tcns.CnsParams()),
                    (tcns.LayUnitig("u", reads, [0] * 4, [True] * 4),
                     tcns.CnsParams(seg_engine=False))):
        with pytest.raises(NotImplementedError, match="item 10"):
            tcns.consensus_unitig(unit, p, device="cpu")


def test_cuda_device_without_gpu_raises(bank):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tzmo.overlap_dmo(bank, tzmo.ZmoParams.dmo(batch_q=8, ncand=64),
                         progress=False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["zmo", "-i", "missing.fa", "-o", "x.ovl"])
