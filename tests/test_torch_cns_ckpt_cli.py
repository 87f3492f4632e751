"""The port's consensus checkpoints and its `cns` subcommand against the
JAX package, on the CPU: a checkpoint the JAX package wrote after one
iteration resumes in the port to the JAX package's uninterrupted result,
the port resumes its own checkpoints to its straight result, column maps
of one length stay readable, and `cns -i` writes the JAX CLI's bytes;
`cns -a/-V` write their records (their bytes against the JAX CLI's are in
test_torch_cns_wholeread.py)."""

import numpy as np
import pytest
import torch

import smartdenovo_tpu.utils.cache as jcache
from smartdenovo_tpu import cli as jcli
from smartdenovo_tpu.data.readbank import codes_to_seq
from smartdenovo_tpu.pipeline import cns as jcns
from smartdenovo_tpu_torch import cli
from smartdenovo_tpu_torch.pipeline import cns as tcns
from test_torch_cns import small_unit

torch.set_num_threads(1)


def _same(j, t):
    """(codes, offsets) of the two packages are equal."""
    assert np.array_equal(np.asarray(j[0]), np.asarray(t[0]))
    assert list(j[1]) == list(t[1])


@pytest.fixture(scope="module")
def jax_straight():
    return jcns.consensus_unitig(small_unit(jcns), jcns.CnsParams(n_iter=3),
                                 return_offs=True)


def test_resume_jax_checkpoint(jax_straight, tmp_path):
    """The JAX package checkpoints after iteration 1; the port resumes it
    and finishes with the JAX package's uninterrupted result."""
    ck = str(tmp_path / "ck.npz")
    jcns.consensus_unitig(small_unit(jcns), jcns.CnsParams(n_iter=1), ckpt=ck)
    z = np.load(ck, allow_pickle=True)
    assert int(z["it"]) == 1 and z["colmap16"].ndim == 1
    t = tcns.consensus_unitig(small_unit(tcns), tcns.CnsParams(n_iter=3),
                              return_offs=True, ckpt=ck, device="cpu")
    _same(jax_straight, t)


def test_resume_own_checkpoint(jax_straight, tmp_path):
    ck = str(tmp_path / "ck.npz")
    tcns.consensus_unitig(small_unit(tcns), tcns.CnsParams(n_iter=1),
                          ckpt=ck, device="cpu")
    resumed = tcns.consensus_unitig(small_unit(tcns), tcns.CnsParams(n_iter=3),
                                    return_offs=True, ckpt=ck, device="cpu")
    straight = tcns.consensus_unitig(small_unit(tcns),
                                     tcns.CnsParams(n_iter=3),
                                     return_offs=True, device="cpu")
    _same(straight, resumed)
    _same(jax_straight, straight)


def test_checkpoint_colmaps_any_shape(tmp_path):
    """Column maps of one length stay a 1-D object array in the port's
    checkpoint; the reader also takes the JAX package's 2-D form."""
    st = tcns._SegState(small_unit(tcns))
    st.colmap16 = [np.arange(5, dtype=np.int64) * 16, None,
                   np.arange(5, dtype=np.int64)]
    ck = str(tmp_path / "ck.npz")
    tcns._save_cns_ckpt(ck, 1, np.zeros(4, np.uint8), [0, 1, 2], 0.9,
                        [0, 1, 2], None, st)
    cm = np.load(ck, allow_pickle=True)["colmap16"]
    assert cm.shape == (3,)
    got = tcns._load_colmaps(cm)
    assert got[1] is None
    assert np.array_equal(got[0], st.colmap16[0])
    two_d = np.array([np.arange(4), np.arange(4) + 7], dtype=object)
    assert two_d.ndim == 2
    got = tcns._load_colmaps(two_d)
    assert all(g.dtype == np.int64 for g in got)
    assert np.array_equal(got[1], np.arange(4) + 7)


def _write_lay(path, unit):
    """A reference-format .lay of one unit (README-tools.md:248-268)."""
    with open(path, "w") as fh:
        fh.write(f">{unit.name} length=0 nodes={len(unit.reads)}\n")
        for k, (r, off) in enumerate(zip(unit.reads, unit.offs)):
            fh.write(f"Y\tr{k}\t+\t{off}\t{len(r)}\t{codes_to_seq(r)}\n")


def test_cli_cns_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """`cns -i x.lay -o out -n 1` writes the JAX CLI's bytes; with no -o
    the records go to stdout."""
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a: None)
    lay = str(tmp_path / "x.lay")
    _write_lay(lay, small_unit(tcns))
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        assert main(["cns", "-i", lay, "-o", str(tmp_path / f"{tag}.cns"),
                     "-n", "1"] + extra) == 0
    got = (tmp_path / "port.cns").read_bytes()
    assert got.startswith(b">u len=") and got == (tmp_path / "jax.cns").read_bytes()
    capsys.readouterr()
    assert cli.main(["cns", "-i", lay, "-n", "1", "--device", "cpu"]) == 0
    head, *body = got.decode().splitlines()
    assert capsys.readouterr().out == f"{head}\n{''.join(body)}\n"


def test_cli_cns_aln_options_write_records(tmp_path):
    """`cns -a x.aln -V 2.05` writes a 16-column record, Q/T/M rows and a
    MATRIX row per aligned read."""
    lay = str(tmp_path / "x.lay")
    unit = small_unit(tcns)
    _write_lay(lay, unit)
    aln = tmp_path / "x.aln"
    assert cli.main(["cns", "-i", lay, "-o", str(tmp_path / "x.cns"), "-n",
                     "1", "-a", str(aln), "-V", "2.05", "--device", "cpu"]) == 0
    lines = aln.read_text().splitlines()
    recs = [x.split("\t") for x in lines
            if x and x[:2] not in ("Q\t", "T\t", "M\t")
            and not x.startswith("MATRIX")]
    assert len(recs) >= 0.8 * len(unit.reads)
    assert all(len(r) == 16 and r[5] == "u" for r in recs)
    assert sum(x.startswith("Q\t") for x in lines) == len(recs)
    assert sum(x.startswith("MATRIX\t") for x in lines) == len(recs)
