"""`asm -c 1` through the port's CLI (on the CPU) against the JAX package's
CLI on the same reads: the .cns file of the DAG engine (segment-engine
consensus) byte for byte, and the layout that feeds it.  The POA engine
(`--cns-engine poa`) is held equal on a unit in test_torch_cns.py: on asm
output the shared native/poa.cpp crashes in both packages (ROADMAP
queue 3).  Also: chip_smoke.py's consensus identity equals the difflib
identity of tests/test_goldens.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import smartdenovo_tpu.utils.cache as jcache
from smartdenovo_tpu import cli as jcli
from smartdenovo_tpu.utils.simulate import (random_genome, simulate_reads,
                                            write_sim_fasta)
from smartdenovo_tpu_torch import cli
from test_goldens import _identity

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    """A 12 kb genome at 10x, reads of 2.5 kb mean at 13% error: one
    unitig for the consensus stage."""
    rng = np.random.default_rng(21)
    g = random_genome(rng, 12000)
    names, seqs = simulate_reads(g, coverage=10, mean_len=2500, err=0.13,
                                 seed=22)
    fa = str(tmp_path_factory.mktemp("cns_asm") / "reads.fa")
    write_sim_fasta(fa, names, seqs)
    return fa


def test_cli_asm_c1_matches_jax_cli(reads_fa, tmp_path, monkeypatch):
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a: None)
    args = [reads_fa, "-J", "1000", "--batch-q", "8", "-c", "1"]
    assert cli.main(["asm", "-p", str(tmp_path / "port")] + args
                    + ["--device", "cpu"]) == 0
    assert jcli.main(["asm", "-p", str(tmp_path / "jax")] + args) == 0
    for ext in (".dmo.lay.utg", ".dmo.cns"):
        got = (tmp_path / ("port" + ext)).read_bytes()
        assert got.startswith(b">") and got == (tmp_path / ("jax" + ext)).read_bytes(), ext


def test_chip_smoke_identity_equals_difflib():
    """Mutated DNA (substitutions, insertions, deletions, repeats) and
    unrelated pairs, lengths 0 to 3 kb: the hashed recursion of
    chip_smoke.identity gives the difflib number exactly."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.default_rng(5)
    for k in range(120):
        n = int(rng.integers(0, 60 if k < 100 else 3000))
        alpha = np.frombuffer(b"ACGT", np.uint8)[: int(rng.integers(1, 5))]
        a = rng.choice(alpha, n)
        b = a.copy()
        for _ in range(int(rng.integers(0, 2 + n // 100))):
            i = int(rng.integers(0, len(b) + 1))
            op = int(rng.integers(0, 3))
            if op == 0 and i < len(b):
                b[i] = rng.choice(alpha)
            elif op == 1:
                b = np.insert(b, i, rng.choice(alpha))
            else:
                b = np.delete(b, min(i, len(b) - 1)) if len(b) else b
        if k % 7 == 0:
            b = rng.choice(alpha, int(rng.integers(0, 40)))
        sa, sb = a.tobytes().decode(), b.tobytes().decode()
        assert cs.identity(sa, sb) == _identity(sa, sb), (sa, sb)
