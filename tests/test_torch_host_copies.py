"""The port's copies of the JAX package's host code: importing the port
loads nothing of JAX or of `smartdenovo_tpu`; every copied module's
functions and classes equal their sources; the native engines build from
the port's own sources into its build directory; and the port's POA
engine, whose window order is a true topological order, runs
`asm -c 1 --cns-engine poa` on asm output (the JAX package's copy
segfaults there, ROADMAP queue 3)."""

import functools
import importlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))



def _writer_span(src):
    """The -a/-V record writer's block in write_final_alignments: the
    port times it as a `writer` span, the source runs it bare."""
    head, body = src.split('    with span("writer"):\n')
    return head + "".join(ln[4:] if ln.strip() else ln
                          for ln in body.splitlines(True))


# module, names whose source the copy changes on purpose or that the port
# adds to it; or module:function, the (port text, source text)
# replacements, or the functions of the port's text, that the copy makes
# on purpose
COPIES = [
    ("data.readbank", ()),
    ("io.fasta", ()),
    ("utils.log", ()),
    ("utils.native", ("build_and_load", "_ROOT", "_NATIVE", "Stitched",
                      "_stitch_lib", "_p64", "_p8", "stitch_round",
                      "_cig_check", "_cigars_lib", "_p32", "_i64", "Segments",
                      "cigar_segments", "cigar_band",
                      "cigar_rle", "cigar_strings", "_emitdm_lib", "_i32",
                      "EmitDm")),
    ("utils.simulate", ()),
    ("graph.clip", ()),
    ("graph.stringgraph", ()),
    ("pipeline.pre", ()),
    ("utils.stats", ()),
    ("utils.dbmfa", ()),
    ("utils.upgma", ()),
    ("graph.obt", ()),
    ("pipeline.h5f5q", ()),
    ("ops.seeds:np_canonical_kmers", ()),
    ("ops.seeds:extract_seeds_np", ()),
    ("ops.seeds:np_jenkins_u32", ()),
    ("ops.swdp:traceback_batch", ()),
    ("pipeline.zmo:read_pair_ledger", ()),
    ("pipeline.zmo:write_pair_ledger", ()),
    ("pipeline.corr", ("join_fragments_dag",)),
    ("pipeline.corr:join_fragments", ()),
    ("ops.banded:make_band_centers", ()),
    ("ops.refine:band_from_cigar", ()),
    ("ops.traceback:rle_moves", ()),
    ("ops.overlap_dp:chain_band_params", ()),
    ("ops.overlap_dp:reverse_batch", ()),
    ("ops.index:_length_batches", ()),
    ("ops.index:_pad_rids", ()),
    ("parallel.sharded:shard_bounds", ()),
    ("parallel.sharded:k16_freq_rule", ()),
    ("parallel.sharded:shard_tier", (
        ("Common flat tier across shards (one shape for every shard)",
         "Common posting tier across shards (one compile of the builder)"),)),
    ("graph.gbo", ("align_pairs_sw", "rescue_overlaps")),
    ("graph.gbo:rescue_overlaps", (
        ("params: GboParams | None = None,\n                    *, "
         'device="cuda"):', "params: GboParams | None = None):"),
        ('    """Run wtgbo-style rescue on `device`; returns the list of NEW '
         'Overlap\n    records."""', '    """Run wtgbo-style rescue; returns '
         'the list of NEW Overlap records."""'),
        ("Overlap, resolve_device\n", "Overlap\n"),
        ("    device = resolve_device(device)\n", ""),
        (", device=device)\n    closed", ")\n    closed"),
        ("p, device=device)", "p)"))),
    ("pipeline.ext", ("run_ext",)),
    ("pipeline.cns:_row_str", ()),
    ("pipeline.cns:write_final_alignments", (
        ('margin: int = 3, *,\n                           device="cuda"):',
         "margin: int = 3):"),
        ("gb,\n                                                  device=device):",
         "gb):"),
        _writer_span)),
]


@functools.cache
def port_import_walk():
    """Import every module of the port and chip_smoke.py in a fresh
    process.  Returns (modules imported, the loaded modules whose top
    package is jax, jaxlib or smartdenovo_tpu, every loaded module)."""
    code = (
        "import sys, pkgutil, importlib, json\n"
        "import smartdenovo_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "mods.append('chip_smoke')\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'smartdenovo_tpu')]\n"
        "print(json.dumps([len(mods), bad, sorted(sys.modules)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_port_imports_nothing_of_jax_package():
    n, bad, loaded = port_import_walk()
    assert not bad, bad
    assert n >= 25
    # the SW (zmo) slice's, the side tools' and the partitioned
    # overlapper's modules are among those walked, and none of them needs
    # h5py
    assert {"smartdenovo_tpu_torch." + m for m in (
        "ops.overlap_dp", "ops.zmo_sw", "ops.index", "graph.gbo",
        "pipeline.ext", "pipeline.aln_tools", "pipeline.corr",
        "pipeline.h5f5q", "pipeline.idx", "pipeline.mer", "graph.obt",
        "utils.dbmfa", "utils.stats", "utils.upgma", "parallel.gpass",
        "parallel.sharded", "parallel.multihost", "graft_entry")
    } <= set(loaded)
    assert "h5py" not in loaded


def _defs(mod):
    """Top-level functions and classes defined in mod, by name."""
    return {k: v for k, v in vars(mod).items()
            if (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


def _src(obj):
    """Source with the import lines written package-relative."""
    return inspect.getsource(obj).replace("from smartdenovo_tpu_torch.",
                                          "from ..").replace(
        "from smartdenovo_tpu.", "from ..")


@pytest.mark.parametrize("name,changed", COPIES, ids=[c[0] for c in COPIES])
def test_copy_equals_source(name, changed):
    if ":" in name:      # one function of a module the port rewrote
        name, fn = name.split(":")
        j = getattr(importlib.import_module("smartdenovo_tpu." + name), fn)
        src = _src(getattr(importlib.import_module(
            "smartdenovo_tpu_torch." + name), fn))
        for change in changed:
            if callable(change):
                src = change(src)
                continue
            port_text, source_text = change
            assert src.count(port_text) == 1, port_text
            src = src.replace(port_text, source_text)
        assert src == _src(j)
        return
    j = importlib.import_module("smartdenovo_tpu." + name)
    t = importlib.import_module("smartdenovo_tpu_torch." + name)
    jd, td = _defs(j), _defs(t)
    assert set(jd) <= set(td)
    assert set(td) - set(jd) <= set(changed)     # the port's own, named
    for k in jd:
        if k not in changed:
            assert _src(td[k]) == _src(jd[k]), k
    consts = [k for k, v in vars(j).items()
              if k.isupper() and k not in changed
              and isinstance(v, (int, float, str, bytes))]
    for k in consts:
        assert getattr(t, k) == getattr(j, k), k


def test_numpy_seed_twins_match_the_port(tmp_path):
    """The copied numpy twins agree with the port's own device code: the
    scan-loop oracle with `extract_seeds` on random reads, the numpy hash
    with `jenkins_hash_u32`; and the copied ledger helpers round-trip."""
    import torch

    from smartdenovo_tpu_torch.ops import seeds
    from smartdenovo_tpu_torch.pipeline.zmo import (read_pair_ledger,
                                                    write_pair_ledger)

    rng = np.random.default_rng(7)
    for trial, k in enumerate((10, 16, 5)):
        n = int(rng.integers(30, 300))
        seq = rng.integers(0, 4, n).astype(np.uint8)
        seq[n // 2: n // 2 + 4] = seq[n // 2]        # a homopolymer run
        for hz in (True, False):
            res = seeds.extract_seeds(torch.from_numpy(seq[None]),
                                      torch.tensor([n]), k, hz)
            v = res["valid"][0].numpy()
            got = list(zip(res["kmer"][0].numpy()[v].tolist(),
                           res["dir"][0].numpy()[v].astype(int).tolist(),
                           res["off"][0].numpy()[v].tolist(),
                           res["span"][0].numpy()[v].tolist()))
            assert got == seeds.extract_seeds_np(seq, k, hz), (trial, hz)
    keys = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
    assert np.array_equal(
        seeds.np_jenkins_u32(keys).astype(np.int64),
        seeds.jenkins_hash_u32(torch.from_numpy(keys.astype(np.int64))).numpy())
    pairs = [("pb1", "pb2"), ("pb3", "pb1")]
    write_pair_ledger(str(tmp_path / "a.pairs"), pairs)
    (tmp_path / "b.pairs").write_text("pb9\tpb8\textra\nlonely\n")
    assert read_pair_ledger(str(tmp_path / "a.pairs")) == pairs
    assert read_pair_ledger([str(tmp_path / "a.pairs"),
                             str(tmp_path / "b.pairs")]) == pairs + [("pb9", "pb8")]


def test_dagcns_source_equals_native():
    with open(os.path.join(ROOT, "native", "dagcns.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "smartdenovo_tpu_torch", "native",
                              "dagcns.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_dbgcorr_source_equals_native():
    with open(os.path.join(ROOT, "native", "dbgcorr.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "smartdenovo_tpu_torch", "native",
                              "dbgcorr.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_native_builds_into_port_build_dir():
    from smartdenovo_tpu_torch.utils import native

    for name in ("dagcns", "poa", "dbgcorr", "stitch"):
        so = native.build_and_load(name)._name
        assert os.path.dirname(so) == os.path.join(
            ROOT, "smartdenovo_tpu_torch", "_build"), so


def test_asm_poa_on_asm_output(tmp_path):
    """15 kb genome at 10x, seed 21: the run that segfaulted in the shared
    poa.cpp.  The CLI runs in a subprocess, so a crash fails this test
    and not the worker."""
    from smartdenovo_tpu_torch.pipeline.cns import _gen_backbone, parse_lay_file
    from smartdenovo_tpu_torch.utils.simulate import (random_genome,
                                                      simulate_reads,
                                                      write_sim_fasta)

    rng = np.random.default_rng(21)
    g = random_genome(rng, 15000)
    names, seqs = simulate_reads(g, coverage=10, mean_len=2500, err=0.13,
                                 seed=22)
    fa = str(tmp_path / "reads.fa")
    write_sim_fasta(fa, names, seqs)
    pfx = str(tmp_path / "poa")
    out = subprocess.run(
        [sys.executable, "-m", "smartdenovo_tpu_torch.cli", "asm", fa, "-p",
         pfx, "-J", "1000", "--batch-q", "8", "-c", "1", "--cns-engine",
         "poa", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    units = parse_lay_file(pfx + ".dmo.lay")
    assert len(units) == 1
    bb = len(_gen_backbone(units[0]))
    with open(pfx + ".dmo.cns") as fh:
        recs = fh.read().split(">")[1:]
    assert len(recs) == 1
    L = len("".join(recs[0].splitlines()[1:]))
    assert 0.9 * bb <= L <= 1.1 * bb, (L, bb)
