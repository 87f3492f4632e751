"""The port's whole-read consensus engine (pipeline/cns.py `_align_pass`, on
the CPU) against the JAX package: `seg_engine=False` and a unit with f5q
quality tracks give the JAX package's consensus codes and read offsets; a
JAX whole-read checkpoint resumes in the port to the JAX result; `run_cns`
with aln_path/vmsa and `cns -a -V` write the JAX package's bytes; f5q
reads keep the banded score as in the JAX package (its known fault);
`asm` on f5q reads with `-c 1` reaches the quality-aware refine."""

import numpy as np
import pytest
import torch

import smartdenovo_tpu.utils.cache as jcache
from smartdenovo_tpu import cli as jcli
from smartdenovo_tpu.pipeline import cns as jcns
from smartdenovo_tpu.utils.simulate import mutate_read, random_genome
from smartdenovo_tpu_torch import cli
from smartdenovo_tpu_torch.data.readbank import encode_f5q
from smartdenovo_tpu_torch.ops import refine5q as tq
from smartdenovo_tpu_torch.pipeline import cns as tcns
from test_f5q import _mk_tracks
from test_torch_cns import small_unit
from test_torch_cns_ckpt_cli import _write_lay

torch.set_num_threads(1)


def _same(j, t):
    """(codes, offsets) of the two packages are equal."""
    assert np.array_equal(np.asarray(j[0]), np.asarray(t[0]))
    assert list(j[1]) == list(t[1])


@pytest.fixture(scope="module")
def jax_wholeread():
    return jcns.consensus_unitig(small_unit(jcns),
                                 jcns.CnsParams(n_iter=2, seg_engine=False),
                                 return_offs=True)


def test_seg_engine_false_matches_jax(jax_wholeread):
    """The 3 kb unit of tests/test_cns.py:136-145, two iterations."""
    t = tcns.consensus_unitig(small_unit(tcns),
                              tcns.CnsParams(n_iter=2, seg_engine=False),
                              return_offs=True, device="cpu")
    _same(jax_wholeread, t)
    assert 2700 < len(t[0]) < 3300


def test_resume_jax_wholeread_checkpoint(jax_wholeread, tmp_path):
    """A JAX whole-read checkpoint (empty colmap16) after iteration 1
    resumes in the port to the JAX package's uninterrupted result."""
    ck = str(tmp_path / "ck.npz")
    jcns.consensus_unitig(small_unit(jcns),
                          jcns.CnsParams(n_iter=1, seg_engine=False), ckpt=ck)
    z = np.load(ck, allow_pickle=True)
    assert int(z["it"]) == 1 and z["colmap16"].size == 0
    t = tcns.consensus_unitig(small_unit(tcns),
                              tcns.CnsParams(n_iter=2, seg_engine=False),
                              return_offs=True, ckpt=ck, device="cpu")
    _same(jax_wholeread, t)


def f5q_unit(mod, span=5200, step=700, rlen=2600):
    """tests/test_f5q.py's quality-track unit: reads of 2.6 kb every 700
    bp of a 6 kb truth at 10% error, each with seeded 7-track qualities
    (N codes stay out: the DAG reads code 4 as a gap)."""
    rng = np.random.default_rng(14)
    truth = random_genome(rng, span + 800)
    reads, offs, quals = [], [], []
    for start in range(0, span, step):
        read = mutate_read(rng, truth[start: start + rlen], 0.1)
        reads.append(read)
        offs.append(start)
        quals.append(_mk_tracks(rng, len(read)))
    return mod.LayUnitig(name="u", reads=reads, offs=offs,
                         backbone=[True] * len(reads), quals=quals)


def test_f5q_unit_matches_jax():
    """Units with f5q tracks take the whole-read engine and the
    quality-aware refine: codes and offsets equal, two iterations."""
    j = jcns.consensus_unitig(f5q_unit(jcns),
                              jcns.CnsParams(n_iter=2, batch_reads=8),
                              return_offs=True)
    t = tcns.consensus_unitig(f5q_unit(tcns),
                              tcns.CnsParams(n_iter=2, batch_reads=8),
                              return_offs=True, device="cpu")
    _same(j, t)


def test_f5q_reads_keep_banded_score():
    """The JAX package's _align_pass leaves an f5q read's score at its
    banded score (cns.py:368-374; ROADMAP queue 3), so f5q reads enter
    the DAG in another order than the reference binary's.  The port
    copies this to stay equal: with the refine on, the scores are those of
    the banded pass alone, while the alignments change."""
    unit = f5q_unit(tcns, span=1600, step=800, rlen=900)
    cns = tcns._gen_backbone(unit)
    runs = []
    for refine in (True, False):
        p = tcns.CnsParams(refine=refine)
        runs.append(list(tcns._align_pass(unit, list(unit.offs), cns, p,
                                          p.gap, p.gap, device="cpu")))
    assert [r[:2] for r in runs[0]] == [r[:2] for r in runs[1]]
    assert any(not np.array_equal(x[4], y[4]) for x, y in zip(*runs))
    jp = jcns.CnsParams()
    jrun = list(jcns._align_pass(f5q_unit(jcns, span=1600, step=800,
                                          rlen=900), list(unit.offs), cns,
                                 jp, jp.gap, jp.gap))
    assert len(jrun) == len(runs[0])
    for x, y in zip(jrun, runs[0]):
        assert x[:4] == y[:4]
        assert np.array_equal(x[4], y[4]) and np.array_equal(x[5], y[5])


@pytest.fixture(scope="module")
def jax_cli_aln(tmp_path_factory):
    """The JAX CLI's `cns -n 1 -a x.aln -V 2.05` on the 3 kb unit."""
    d = tmp_path_factory.mktemp("wholeread_cli")
    lay = str(d / "x.lay")
    _write_lay(lay, small_unit(tcns))
    mp = pytest.MonkeyPatch()
    mp.setattr(jcache, "enable_compilation_cache", lambda *a: None)
    try:
        assert jcli.main(["cns", "-i", lay, "-o", str(d / "jax.cns"), "-n",
                          "1", "-a", str(d / "jax.aln"), "-V", "2.05"]) == 0
    finally:
        mp.undo()
    return lay, (d / "jax.cns").read_bytes(), (d / "jax.aln").read_bytes()


def test_run_cns_aln_vmsa_matches_jax(jax_cli_aln, tmp_path):
    lay, _, jaln = jax_cli_aln
    aln = str(tmp_path / "port.aln")
    res = tcns.run_cns(tcns.parse_lay_file(lay), tcns.CnsParams(n_iter=1),
                       aln_path=aln, vmsa=2.05, device="cpu")
    assert [n for n, _ in res] == ["u"]
    got = open(aln, "rb").read()
    assert got == jaln and b"\nMATRIX\tr" in got and b"\nQ\t" in got


def test_cli_cns_aln_vmsa_matches_jax_cli(jax_cli_aln, tmp_path):
    lay, jcns_bytes, jaln = jax_cli_aln
    assert cli.main(["cns", "-i", lay, "-o", str(tmp_path / "port.cns"), "-n",
                     "1", "-a", str(tmp_path / "port.aln"), "-V", "2.05",
                     "--device", "cpu"]) == 0
    assert (tmp_path / "port.cns").read_bytes() == jcns_bytes
    assert (tmp_path / "port.aln").read_bytes() == jaln


class _Reached(Exception):
    pass


def test_asm_f5q_c1_reaches_5q_refine(tmp_path, monkeypatch):
    """`asm reads.f5q -c 1`: the reads' tracks ride the layout into the
    consensus, whose whole-read engine calls the quality-aware refine (the
    run stops there; tests above hold that refine equal to the JAX
    package's)."""
    from smartdenovo_tpu_torch.utils.simulate import simulate_reads

    rng = np.random.default_rng(21)
    g = random_genome(rng, 12000)
    names, seqs = simulate_reads(g, coverage=10, mean_len=2500, err=0.13,
                                 seed=22)
    trng = np.random.default_rng(23)
    f5q = tmp_path / "reads.f5q"
    with open(f5q, "w") as fh:
        for n, s in zip(names, seqs):
            seq = "".join("ACGTN"[c] for c in s)
            fh.write(f"@{n}\n{seq}\n+\n{encode_f5q(_mk_tracks(trng, len(s)))}\n")
    seen = []

    def stop(*args, **kw):
        seen.append(args)
        raise _Reached

    monkeypatch.setattr(tq, "refine5q_banded", stop)
    with pytest.raises(_Reached):
        cli.main(["asm", str(f5q), "-p", str(tmp_path / "q"), "-J", "1000",
                  "--batch-q", "8", "-c", "1", "--device", "cpu"])
    a, _b, sq, iq, dq, st, dt = seen[0][:7]
    assert a.shape == sq.shape and int(sq.max()) >= 5 and int(st.max()) <= 3
