"""The port's overlapper, `asm` driver and CLI against the JAX package:
overlap records and the stage files (.ovl, .obt, .lay, .lay.utg) must be
equal, record for record and byte for byte, on a 30 kb / 10x simulation.
Also: the copied host helpers equal their sources, the port imports no
JAX, and what it does not run yet says so."""

import dataclasses
import inspect

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
    """Importing every module of the port and chip_smoke.py leaves jax
    unimported (the one import walk of test_torch_host_copies.py)."""
    from test_torch_host_copies import port_import_walk

    n, _bad, loaded = port_import_walk()
    assert "smartdenovo_tpu_torch.cli" in loaded
    assert "jax" not in loaded
    assert n >= 15


def test_unported_paths_raise(bank, tmp_path):
    """What the port does not run yet raises; the whole-read consensus
    engine, which it runs since it was ported, does not."""
    for kw in (dict(engine="sw"), dict(gparts=2), dict(matcher="vtab")):
        with pytest.raises(NotImplementedError):
            tzmo.overlap_dmo(bank, tzmo.ZmoParams.dmo(**kw), device="cpu")
    fa = str(tmp_path / "r.fa")
    write_sim_fasta(fa, bank.names[:3], [bank.get(i) for i in range(3)])
    with pytest.raises(NotImplementedError, match="item 9"):
        cli.main(["asm", fa, "-e", "zmo", "--device", "cpu"])
    # the whole-read consensus engine runs on the CPU: cns -a/-V, f5q units
    # and seg_engine=False (4 reads of 600 bp at offsets 0-300 of read 0)
    reads = [bank.get(0)[100 * k: 100 * k + 600] for k in range(4)]
    lay = tmp_path / "x.lay"
    lay.write_text(">u length=900 nodes=4\n" + "".join(
        f"Y\tr{k}\t+\t{100 * k}\t600\t{''.join('ACGT'[c] for c in r)}\n"
        for k, r in enumerate(reads)))
    aln = tmp_path / "x.aln"
    for opt in (["-a", str(aln)], ["-a", str(aln), "-V", "2.05"], ["-V", "2.05"]):
        assert cli.main(["cns", "-i", str(lay), "-o", str(tmp_path / "x.cns"),
                         "-n", "1", "--device", "cpu"] + opt) == 0
        if "-a" not in opt:   # -V alone writes nothing, as in the JAX CLI
            assert not aln.exists()
            continue
        text = aln.read_text()
        assert text.startswith("r0\t+\t600\t0\t600\tu\t")
        assert text.count("\nQ\t") == 4
        assert ("MATRIX" in text) == ("-V" in opt)
        aln.unlink()
    quals = [np.zeros((7, len(r)), np.uint8) for r in reads]
    offs = [0, 100, 200, 300]
    for unit, p in ((tcns.LayUnitig("u", reads, offs, [True] * 4, quals=quals),
                     tcns.CnsParams(n_iter=1)),
                    (tcns.LayUnitig("u", reads, offs, [True] * 4),
                     tcns.CnsParams(n_iter=1, seg_engine=False))):
        codes = tcns.consensus_unitig(unit, p, device="cpu")
        assert 800 <= len(codes) <= 1000


def test_cuda_device_without_gpu_raises(bank):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tzmo.overlap_dmo(bank, tzmo.ZmoParams.dmo(batch_q=8, ncand=64),
                         progress=False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["zmo", "-i", "missing.fa", "-o", "x.ovl"])
