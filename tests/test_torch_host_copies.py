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

# module, names whose source the copy changes on purpose; or module:function,
# the (port text, source text) replacements that the copy makes on purpose
COPIES = [
    ("data.readbank", ()),
    ("io.fasta", ()),
    ("utils.log", ()),
    ("utils.native", ("build_and_load", "_ROOT", "_NATIVE")),
    ("utils.simulate", ()),
    ("graph.clip", ()),
    ("graph.stringgraph", ()),
    ("pipeline.pre", ()),
    ("ops.banded:make_band_centers", ()),
    ("ops.refine:band_from_cigar", ()),
    ("ops.traceback:rle_moves", ()),
    ("pipeline.cns:_row_str", ()),
    ("pipeline.cns:write_final_alignments", (
        ('margin: int = 3, *,\n                           device="cuda", '
         'split: dict | None = None):', "margin: int = 3):"),
        ("gb,\n                                                  device=device, "
         "split=split):", "gb):"),
        ("rb_))\n    t_writer = time.perf_counter()\n", "rb_))\n"),
        ('\n    if split is not None:\n        split["writer"] = split.get('
         '"writer", 0.0) + (time.perf_counter()\n'
         '                                                      - t_writer)\n',
         "\n"))),
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
    n, bad, _ = port_import_walk()
    assert not bad, bad
    assert n >= 25


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
        for port_text, source_text in changed:
            assert src.count(port_text) == 1, port_text
            src = src.replace(port_text, source_text)
        assert src == _src(j)
        return
    j = importlib.import_module("smartdenovo_tpu." + name)
    t = importlib.import_module("smartdenovo_tpu_torch." + name)
    jd, td = _defs(j), _defs(t)
    assert sorted(jd) == sorted(td)
    for k in jd:
        if k not in changed:
            assert _src(td[k]) == _src(jd[k]), k
    consts = [k for k, v in vars(j).items()
              if k.isupper() and k not in changed
              and isinstance(v, (int, float, str, bytes))]
    for k in consts:
        assert getattr(t, k) == getattr(j, k), k


def test_dagcns_source_equals_native():
    with open(os.path.join(ROOT, "native", "dagcns.cpp"), "rb") as a, \
            open(os.path.join(ROOT, "smartdenovo_tpu_torch", "native",
                              "dagcns.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_native_builds_into_port_build_dir():
    from smartdenovo_tpu_torch.utils import native

    for name in ("dagcns", "poa"):
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
