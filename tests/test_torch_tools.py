"""The side tools of the port against the JAX package on the CPU: every
subcommand that the port ran last (pre, clp, lay, fq2fa, n50, mer, idx,
pairaln, cyc, dif, dotplot, dbmidx, dbmget, haplo) through both CLIs with
the same inputs, output bytes equal; the batched SW and banded DPs of
pairaln, cyc and dif against the JAX package's one-pair calls; the plain
SW DP at bands wider than the zmo engine's; wtmer's histogram; wtidx's
snapshot; wtobt, the h5 converter, UPGMA and the dbm tools."""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from smartdenovo_tpu import cli as jcli
from smartdenovo_tpu.data.readbank import ReadBank, codes_to_seq, revcomp_codes
from smartdenovo_tpu.utils.simulate import (mutate_read, random_genome,
                                            simulate_reads, write_sim_fasta)
from smartdenovo_tpu_torch import cli as tcli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "goldens")


def _fa(path, recs):
    with open(path, "w") as fh:
        fh.write("".join(f">{n}\n{codes_to_seq(s)}\n" for n, s in recs))
    return str(path)


def pair_recs(rng):
    """Pairs for pairaln in one length tier and across tiers: b longer
    than a's LA (a of 200 bp pads to 256), noisy copies, and a pair with no
    matching base, which gives (0, 0, 0, 0)."""
    recs = []
    for k, (la, lb) in enumerate([(200, 400), (300, 280), (700, 650),
                                  (240, 1100), (900, 300)]):
        s = rng.integers(0, 4, max(la, lb)).astype(np.uint8)
        recs += [(f"a{k}", s[:la]), (f"b{k}", mutate_read(rng, s[:lb], 0.1))]
    recs += [("none_a", np.zeros(120, np.uint8)),
             ("none_b", np.full(90, 1, np.uint8))]
    return recs


def cyc_recs(rng):
    """wtcyc's cases: a palindrome folded at its centre, one folded off
    centre, an inverted repeat that scores but is no fold (its arms lie
    1,200 bp apart, too far for the DP to bridge, so the first DP's end
    and the second's begin come from the two mirror copies of the arm
    alignment and the fold tests reject them), a read with no palindrome,
    and a short one."""
    half = rng.integers(0, 4, 600).astype(np.uint8)
    arm = rng.integers(0, 4, 800).astype(np.uint8)
    x = rng.integers(0, 4, 250).astype(np.uint8)
    mid = rng.integers(0, 4, 1200).astype(np.uint8)
    tail = rng.integers(0, 4, 300).astype(np.uint8)
    return [("pal", np.concatenate([half, revcomp_codes(half)])),
            ("off", np.concatenate([arm, revcomp_codes(arm[500:])])),
            ("asym", np.concatenate([x, mid, revcomp_codes(x), tail])),
            ("norm", rng.integers(0, 4, 1200).astype(np.uint8)),
            ("short", rng.integers(0, 4, 150).astype(np.uint8))]


def dif_recs(rng):
    """A reference and reads against it: a substitution, an insertion, a
    deletion, all three, and a noisy read of another length tier."""
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    sub = ref.copy()
    sub[150] = (sub[150] + 1) % 4
    ins = np.insert(ref, 300, (ref[300] + 2) % 4)
    dele = np.delete(ref, 420)
    allv = np.delete(np.insert(sub, 300, (ref[300] + 2) % 4), 421)
    return [("ref", ref), ("sub", sub), ("ins", ins), ("del", dele),
            ("all", allv), ("noisy", mutate_read(rng, ref[:220], 0.08))]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tool_inputs")
    rng = np.random.default_rng(101)
    g = random_genome(rng, 6000)
    names, seqs = simulate_reads(g, coverage=4, mean_len=1500, err=0.1,
                                 seed=102)
    write_sim_fasta(str(d / "reads.fa"), names, seqs)
    # PacBio subread names: two subreads a hole, wtpre keeps the longest
    _fa(d / "sub.fa", [(f"mv/{k // 2}/{100 * k}_{100 * k + len(s)}", s)
                       for k, s in enumerate(seqs[:12])])
    with open(d / "r.fq", "w") as fh:
        for k, s in enumerate(seqs[:5]):
            fh.write(f"@q{k} desc{k}\n{codes_to_seq(s)}\n+\n{'I' * len(s)}\n")
    _fa(d / "pairs.fa", pair_recs(rng))
    _fa(d / "cyc.fa", cyc_recs(rng))
    _fa(d / "dif.fa", dif_recs(rng))
    s = rng.integers(0, 4, 2500).astype(np.uint8)
    _fa(d / "dot.fa", [("d0", mutate_read(rng, s[:1800], 0.05)),
                       ("d1", revcomp_codes(mutate_read(rng, s[700:], 0.05)))])
    with open(d / "msa.tsv", "w") as fh:
        fh.write("core\tACGT-ACGTAC\nr1\tACGT-ACGTAC\nr2\tACGT-ACGTAA\n"
                 "r3\tATGT-ACGTAC\nr4\tACGTTACCTAC\nr5\tACGT-ACGTAC\n")
    return str(d)


# subcommand: (argv with {i} the inputs, {o} the output directory; the
# output files; whether it runs device code)
CASES = {
    "pre": (["pre", "{i}/sub.fa", "-o", "{o}/pre.fa"], ["pre.fa"], False),
    "clp": (["clp", "-i", f"{GOLD}/smoke.ref.ovl", "-o", "{o}/x.clp"],
            ["x.clp"], False),
    "lay": (["lay", "-i", f"{GOLD}/smoke.fa", "-j", f"{GOLD}/smoke.ref.ovl",
             "-o", "{o}/x.lay"],
            ["x.lay", "x.lay.utg", "x.lay.dup", "x.lay.utg.dup"], False),
    "fq2fa": (["fq2fa", "{i}/r.fq", "-o", "{o}/r.fa"], ["r.fa"], False),
    "n50": (["n50", "{i}/reads.fa"], [], False),
    "mer": (["mer", "{i}/reads.fa"], [], True),
    "idx": (["idx", "{i}/reads.fa", "-o", "{o}/x.npz"], ["x.npz"], True),
    "pairaln": (["pairaln", "{i}/pairs.fa"], [], True),
    "cyc": (["cyc", "{i}/cyc.fa", "-o", "{o}/cyc.obt"], ["cyc.obt"], True),
    "dif": (["dif", "{i}/dif.fa"], [], True),
    "dotplot": (["dotplot", "{i}/dot.fa", "-o", "{o}/dp"],
                ["dp.fwd.txt", "dp.rev.txt"], True),
    "dbmidx": (["dbmidx", "{o}/reads.fa"], [], False),
}


def _in_process(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _npz_equal(a, b):
    x, y = np.load(a), np.load(b)
    assert sorted(x.files) == sorted(y.files)
    for k in x.files:
        assert x[k].dtype == y[k].dtype, k
        assert np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("cmd", list(CASES))
def test_cli_output_equals_jax(cmd, inputs, tmp_path):
    argv, files, on_device = CASES[cmd]
    outs = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        o = tmp_path / pkg
        o.mkdir()
        shutil.copy(os.path.join(inputs, "reads.fa"), o / "reads.fa")
        args = [a.format(i=inputs, o=o) for a in argv]
        if pkg == "port" and on_device:
            args += ["--device", "cpu"]
        outs[pkg] = (_in_process(main, args).replace(str(o), "OUT"), o)
    (jout, jdir), (tout, tdir) = outs["jax"], outs["port"]
    assert tout == jout
    for f in files:
        if f.endswith(".npz"):
            _npz_equal(jdir / f, tdir / f)
        else:
            assert (tdir / f).read_bytes() == (jdir / f).read_bytes(), f
    if cmd in ("n50", "mer", "pairaln", "dif"):
        assert tout.count("\n") >= 3
    if files:   # the first output holds records (.dup files may be empty)
        assert (tdir / files[0]).stat().st_size > 0


def _cli_proc(pkg, args, cwd):
    out = subprocess.run([sys.executable, "-m", pkg + ".cli", *args], cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout, out.stderr


@pytest.mark.parametrize("cmd", ["dbmget", "haplo"])
def test_cli_printing_tools_equal_jax(cmd, inputs, tmp_path):
    """dbmget and haplo print through a stream bound when their module is
    imported, so each CLI runs in a process of its own.  dbmget fetches
    from each package's own store (the dbm backend is the machine's):
    whole reads, strands, subranges and a missing name."""
    got = {}
    for pkg in ("smartdenovo_tpu", "smartdenovo_tpu_torch"):
        o = tmp_path / pkg
        o.mkdir()
        if cmd == "dbmget":
            fa = str(o / "reads.fa")
            shutil.copy(os.path.join(inputs, "reads.fa"), fa)
            _cli_proc(pkg, ["dbmidx", fa], o)
            rb = ReadBank.from_fasta([fa], sort=False)
            tags = [rb.names[0], rb.names[1] + "[-]",
                    rb.names[2] + "[+:20,90]", rb.names[3] + "[-:5,0]",
                    "missing"]
            got[pkg] = _cli_proc(pkg, ["dbmget", fa + ".dbm", *tags], o)
        else:
            got[pkg] = _cli_proc(pkg, ["haplo", "core",
                                       os.path.join(inputs, "msa.tsv")], o)
    assert got["smartdenovo_tpu_torch"][0] == got["smartdenovo_tpu"][0]
    assert got["smartdenovo_tpu_torch"][0].count("\n") >= 4
    if cmd == "dbmget":
        assert "'missing' was not found" in got["smartdenovo_tpu_torch"][1]


def test_cli_has_no_refusals():
    """Every subcommand of the JAX CLI is a subcommand of the port's, and
    the host-only ones take no --device."""
    assert not hasattr(tcli, "_NOT_PORTED")
    for argv in (["pre", "x"], ["clp", "-i", "x", "-o", "y"],
                 ["lay", "-i", "x", "-j", "y", "-o", "z"], ["n50", "x"],
                 ["fq2fa", "x"], ["dbmidx", "x"], ["dbmget", "x"],
                 ["haplo", "c", "m"]):
        with pytest.raises(SystemExit):
            tcli.main(argv + ["--device", "cpu"])


def test_pairaln_batch_equals_one_pair_calls():
    """align_local_batch over pairs of unequal lengths in one call per
    tier equals the JAX package's one-pair `_align_two`, among them b
    longer than a's LA and a pair with no positive cell."""
    from smartdenovo_tpu.pipeline.aln_tools import _align_two
    from smartdenovo_tpu_torch.ops.align import pow2_tier as _tier
    from smartdenovo_tpu_torch.pipeline.aln_tools import align_local_batch

    recs = pair_recs(np.random.default_rng(5))
    pairs = [(recs[k][1], recs[k + 1][1]) for k in range(0, len(recs), 2)]
    got = align_local_batch(pairs, device="cpu")
    exp = np.array([_align_two(a, b) for a, b in pairs])
    np.testing.assert_array_equal(got, exp)
    assert any(len(b) > _tier(len(a)) for a, b in pairs)
    assert (got == 0).all(1).any() and (got[:, 0] > 100).sum() >= 4
    assert len({_tier(len(a)) for a, _ in pairs}) >= 3


def test_cyc_folds(inputs, tmp_path):
    """The palindromes are cut at their folds (the centre and off centre),
    the inverted repeat that is no fold and the plain reads are kept
    whole."""
    out = tmp_path / "c.obt"
    assert tcli.main(["cyc", os.path.join(inputs, "cyc.fa"), "-o", str(out),
                      "--device", "cpu"]) == 0
    rows = {r.split("\t")[0]: [int(x) for x in r.split("\t")[1:]]
            for r in out.read_text().splitlines()}
    assert rows["pal"] == [0, 600, 1200]
    assert rows["off"][0] == 0 and 750 <= rows["off"][1] <= 850
    assert rows["asym"] == [0, 2000, 2000]
    assert rows["norm"] == [0, 1200, 1200]
    assert rows["short"] == [0, 150, 150]


def test_cyc_inverted_repeat_reaches_fold_tests():
    """The inverted repeat that is no fold scores over min_score, so the
    second DP runs, and its begin (from the far mirror copy) lies past the
    first DP's end: a negative span, which the identity test rejects."""
    from smartdenovo_tpu_torch.pipeline.aln_tools import align_local_batch

    x = dict(cyc_recs(np.random.default_rng(101)))["asym"]
    rc = revcomp_codes(x)
    first, second = align_local_batch(
        [(rc, x), (rc[::-1].copy(), x[::-1].copy())], W=1600, device="cpu")
    assert first[0] >= 400 and second[0] == first[0]
    qb, qe = len(x) - second[2], first[2]
    assert qb > qe


def test_cyc_calls_take_swwide_unit_path(inputs):
    """Every banded_local_dp call of `cyc` (both DPs: rc(read) against
    read, and the two reversed) bands every pair with slope 1 << 12 from
    (0, 0), so unit_steps flags every pair and csrc/swwide.cu keeps all
    their rows in registers: the test reads and lengths from 100 to 16,384
    over every length tier."""
    from smartdenovo_tpu_torch.data.readbank import \
        revcomp_codes as t_revcomp
    from smartdenovo_tpu_torch.ops.overlap_dp import unit_steps
    from smartdenovo_tpu_torch.pipeline.aln_tools import (local_chunks,
                                                          local_inputs)

    rng = np.random.default_rng(12)
    reads = [s for _, s in cyc_recs(rng)] + [
        rng.integers(0, 4, n).astype(np.uint8)
        for n in (100, 257, 1000, 2049, 3000, 8193, 16384)]
    rcs = [t_revcomp(s) for s in reads]
    for pairs in ([(rc, s) for rc, s in zip(rcs, reads)],
                  [(rc[::-1].copy(), s[::-1].copy())
                   for rc, s in zip(rcs, reads)]):
        tiers = 0
        for idx, LA in local_chunks(pairs):
            x = local_inputs([pairs[k] for k in idx], LA, "cpu")
            assert unit_steps(*x[2:], LA, 1600).all()
            tiers += 1
        assert tiers >= 6


def test_dif_variants(inputs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(["dif", os.path.join(inputs, "dif.fa"), "--device", "cpu"])
    rows = [r.split("\t") for r in buf.getvalue().splitlines()]
    by = {}
    for r in rows:
        by.setdefault(r[0], set()).add(r[2])
    assert by["sub"] == {"S"} and by["ins"] == {"I"} and by["del"] == {"D"}
    assert by["all"] == {"S", "I", "D"}
    assert ["sub", "150", "S"] == [r for r in rows if r[0] == "sub"][0][:3]


def _sw_inputs(kind, W, LA=384):
    from test_torch_cuda import sw_edge_pairs, sw_pairs, sw_tie_pairs

    rng = np.random.default_rng(W + len(kind))
    if kind == "ties":
        return sw_tie_pairs(rng, LA, W), LA
    if kind == "edge":
        return sw_edge_pairs(rng, 16, LA, W), LA
    return sw_pairs(rng, 12, LA), LA


@pytest.mark.parametrize("W,kind,gap", [
    (1600, "random", -3), (1600, "ties", -3), (1600, "edge", 1),
    (100, "random", -3), (100, "edge", -3), (100, "random", 1),
    (2048, "edge", -3), (2048, "ties", -3)])
def test_plain_sw_wide_bands_equal_jax(W, kind, gap):
    """banded_local_dp_plain, the wide kernel's plain version, against the
    JAX function at bands wider than the zmo engine's and at one that is no
    multiple of 32: random pairs, the edge cases, tied bests, a gap > 0."""
    import jax.numpy as jnp

    from smartdenovo_tpu.ops import overlap_dp as jdp
    from smartdenovo_tpu_torch.ops import overlap_dp as tdp

    x, LA = _sw_inputs(kind, W)
    got = tdp.banded_local_dp_plain(*(torch.from_numpy(v) for v in x),
                                    LA=LA, W=W, gap=gap)
    exp = jdp.banded_local_dp(*(jnp.asarray(v) for v in x), LA=LA, W=W,
                              gap=gap)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    if kind == "ties":
        assert (got[0].numpy() == 80).all()


def test_kmer_spectrum_equals_jax(inputs):
    from smartdenovo_tpu.pipeline.mer import kmer_spectrum as jspec
    from smartdenovo_tpu_torch.data.readbank import ReadBank as TBank
    from smartdenovo_tpu_torch.pipeline.mer import kmer_spectrum as tspec

    fa = [os.path.join(inputs, "reads.fa")]
    for k, hz in ((16, True), (11, False)):
        got = tspec(TBank.from_fasta(fa), k, hz, device="cpu")
        exp = jspec(ReadBank.from_fasta(fa), k, hz)
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
        assert got[1:].sum() > 1000


def test_idx_snapshot_equals_jax(inputs, tmp_path):
    """The port's index builds equal the JAX package's; its .npz holds the
    JAX file's keys, dtypes and arrays; each package loads the other's
    file; and load_indexes gives back the in-memory build."""
    from smartdenovo_tpu.ops.index import build_kmer_index as jk
    from smartdenovo_tpu.ops.index import build_zmer_index as jz
    from smartdenovo_tpu.pipeline import idx as jidx
    from smartdenovo_tpu_torch.data.readbank import ReadBank as TBank
    from smartdenovo_tpu_torch.ops.index import build_kmer_index as tk
    from smartdenovo_tpu_torch.ops.index import build_zmer_index as tz
    from smartdenovo_tpu_torch.pipeline import idx as tidx

    fa = [os.path.join(inputs, "reads.fa")]
    jrb, trb = ReadBank.from_fasta(fa), TBank.from_fasta(fa)
    jki, jzi = jk(jrb), jz(jrb)
    tki, tzi = tk(trb, device="cpu"), tz(trb, device="cpu")
    assert tki.max_freq == jki.max_freq and tki.n_postings > 1000
    assert tki.np_kmers.dtype == np.uint32
    np.testing.assert_array_equal(tki.np_kmers, np.asarray(jki.kmers))
    for f in ("post_rd", "post_dir"):
        t, j = getattr(tki, f).numpy(), np.asarray(getattr(jki, f))
        assert t.dtype == j.dtype, f
        np.testing.assert_array_equal(t, j)
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jidx.save_indexes(jp, jki, jzi)
    tidx.save_indexes(tp, tki, tzi)
    _npz_equal(jp, tp)
    for path in (jp, tp):
        k2, z2 = tidx.load_indexes(path, device="cpu")
        for a, b in ((k2, tki), (z2, tzi)):
            for f in ("kmers", "zmers", "post_rd", "post_dir", "post_off",
                      "post_span", "post_packed"):
                if hasattr(b, f):
                    x, y = getattr(a, f), getattr(b, f)
                    assert x.dtype == y.dtype and torch.equal(x, y), f
        assert (k2.max_freq, k2.ksize, k2.n_reads) == (tki.max_freq, tki.ksize,
                                                       tki.n_reads)
        assert (z2.zsize, z2.max_per_read) == (tzi.zsize, tzi.max_per_read)
        np.testing.assert_array_equal(z2.np_key, tzi.np_key)
        jk2, _ = jidx.load_indexes(path)
        np.testing.assert_array_equal(np.asarray(jk2.kmers), tki.np_kmers)


@pytest.mark.parametrize("case", ["covered", "trims", "spurred", "contained"])
def test_obt_equals_jax(case):
    """run_obt on tests/test_obt.py's cases."""
    from test_obt import _rec

    from smartdenovo_tpu.graph.obt import ObtParams as JP
    from smartdenovo_tpu.graph.obt import run_obt as jrun
    from smartdenovo_tpu_torch.graph.obt import ObtParams as TP
    from smartdenovo_tpu_torch.graph.obt import run_obt as trun

    recs = {
        "covered": [_rec("A", 0, 10000, 0, 5000, "B", 0, 8000, 3000, 8000),
                    _rec("A", 0, 10000, 3000, 9800, "C", 0, 9000, 0, 6800)],
        "trims": [_rec("A", 0, 10000, 2000, 9900, "B", 0, 9000, 0, 7900)],
        "spurred": [_rec("A", 0, 10000, 2000, 8000, "B", 0, 9000, 100, 6100)],
        "contained": [_rec("A", 0, 5000, 0, 5000, "B", 0, 12000, 3000, 8000),
                      _rec("B", 0, 12000, 0, 10000, "C", 0, 11000, 1000,
                           11000)],
    }[case]
    got = trun(recs, TP(min_cov=1))
    assert got == jrun(recs, JP(min_cov=1)) and got


def test_h5_converter_equals_jax(tmp_path):
    """convert_bas_h5 on tests/test_h5f5q.py's synthetic bas.h5."""
    pytest.importorskip("h5py")
    from test_h5f5q import _make_bas

    from smartdenovo_tpu.pipeline.h5f5q import convert_bas_h5 as jconv
    from smartdenovo_tpu_torch.pipeline.h5f5q import convert_bas_h5 as tconv

    p = str(tmp_path / "movie1.bas.h5")
    _make_bas(p)
    outs = []
    for conv in (jconv, tconv):
        buf = io.StringIO()
        assert conv(p, out=buf, min_len=100, min_rq=0.6) == 1
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[1].startswith("@movie1/7/50_400\n")


def test_upgma_and_cut_clusters_equal_jax():
    from smartdenovo_tpu.utils import upgma as ju
    from smartdenovo_tpu_torch.utils import upgma as tu

    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(0, 0.05, (5, 2)),
                          rng.normal(1, 0.05, (4, 2))])
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    merges = tu.upgma(d)
    assert merges == ju.upgma(d) and len(merges) == 8
    for h in (0.2, 0.5, 2.0):
        assert tu.cut_clusters(merges, 9, h) == ju.cut_clusters(merges, 9, h)
    labels = tu.cut_clusters(merges, 9, 0.5)
    assert len(set(labels.values())) == 2


def test_dbm_and_haplo_api_equal_jax(tmp_path):
    from smartdenovo_tpu.utils import dbmfa as jd
    from smartdenovo_tpu_torch.utils import dbmfa as td

    outs = []
    for k, mod in enumerate((jd, td)):
        fa = tmp_path / f"r{k}.fa"
        fa.write_text(">a desc\nACGTACGTAA\n>b\nGGGCCC\n")
        db = mod.dbm_index_fa(str(fa))
        buf = io.StringIO()
        mod.dbm_read_fa(db, ["a", "b[-]", "a[+:2,5]"], out=buf)
        rows = [("core", "ACGT-ACGT"), ("r1", "ACGT-ACGT"),
                ("r2", "ACGT-ACGT"), ("r3", "ATGT-ACGT"), ("r4", "ACGT-ACCT")]
        ref = mod.pbcluster_haplo("core", rows, out=buf)
        outs.append((buf.getvalue(), ref))
    assert outs[1] == outs[0] and outs[1][1] == "ACGT-ACGT"
