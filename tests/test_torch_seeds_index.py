"""The port's seeds, flat-array primitives and whole-bank index against
the JAX package (ops/seeds.py, ops/flatops.py, ops/flatseeds.py).

Inputs come from numpy seeds; every comparison is exact.  uint32 k-mer
codes are int64 in the port, so they are compared as values."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartdenovo_tpu.data.readbank import ReadBank
from smartdenovo_tpu.ops import flatops as jflatops
from smartdenovo_tpu.ops import flatseeds as jflat
from smartdenovo_tpu.ops import seeds as jseeds
from smartdenovo_tpu.pipeline import zmo as jzmo
from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
from smartdenovo_tpu_torch import convert
from smartdenovo_tpu_torch.ops import flatops, flatseeds, seeds
from smartdenovo_tpu_torch.pipeline import zmo as tzmo

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def _u32(rng, n):
    v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    v[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return v


def test_jenkins_hash_matches_jax():
    v = _u32(np.random.default_rng(1), 4096)
    got = seeds.jenkins_hash_u32(torch.from_numpy(v.astype(np.int64))).numpy()
    exp = np.asarray(jseeds.jenkins_hash_u32(jnp.asarray(v))).astype(np.int64)
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("ksize", [10, 16])
def test_revcomp_and_subsample_match_jax(ksize):
    rng = np.random.default_rng(ksize)
    v = (_u32(rng, 4096).astype(np.uint64) % (1 << (2 * ksize))).astype(np.uint32)
    tv = torch.from_numpy(v.astype(np.int64))
    got = seeds.revcomp_kmer_u32(tv, ksize).numpy()
    exp = np.asarray(jseeds.revcomp_kmer_u32(jnp.asarray(v), ksize))
    assert np.array_equal(got, exp.astype(np.int64))
    for ksave in (1, 4):
        got = seeds.subsample_mask(tv, ksave).numpy()
        exp = np.asarray(jseeds.subsample_mask(jnp.asarray(v), ksave))
        assert np.array_equal(got, exp)


def test_pad_pow2_matches_jax():
    for lo in (1 << 8, 1 << 12, 1 << 14):
        for n in list(range(0, 5000, 7)) + [1 << 20, (1 << 22) + 3, 25_000_001]:
            assert flatseeds.pad_pow2(n, lo=lo) == jflat.pad_pow2(n, lo=lo)


@pytest.mark.parametrize("budget", [64, 1000])
def test_expand_ranges_and_bisect_match_jax(budget):
    rng = np.random.default_rng(budget)
    cnt = rng.integers(0, 6, 200).astype(np.int32)
    cnt[rng.random(200) < 0.3] = 0
    got = flatops.expand_ranges(torch.from_numpy(cnt), budget)
    exp = jflatops.expand_ranges(jnp.asarray(cnt), budget)
    for g, e in zip(got, exp):
        assert np.array_equal(g.numpy(), np.asarray(e))
    vals = np.sort(rng.integers(0, 500, 300)).astype(np.int32)
    probes = rng.integers(-5, 505, 400).astype(np.int32)
    lo = rng.integers(0, 150, 400).astype(np.int32)
    hi = lo + rng.integers(0, 150, 400).astype(np.int32)
    got = flatops.bounded_bisect(torch.from_numpy(vals), torch.from_numpy(probes),
                                 torch.from_numpy(lo), torch.from_numpy(hi), 9)
    exp = jflatops.bounded_bisect(jnp.asarray(vals), jnp.asarray(probes),
                                  jnp.asarray(lo), jnp.asarray(hi), 9)
    assert np.array_equal(got.numpy(), np.asarray(exp))


def _sim_bank():
    rng = np.random.default_rng(3)
    g = random_genome(rng, 20000)
    names, seqs = simulate_reads(g, coverage=8, mean_len=4000, err=0.12, seed=4)
    return ReadBank(names, seqs)


def _smoke_bank():
    return ReadBank.from_fasta(os.path.join(GOLD, "smoke.fa"))


def _jax_state(rb):
    p = jzmo.ZmoParams.dmo()
    flat, offs, lens, _T, _Npad = jzmo._upload_bank(rb)
    return jflat.build_bank_indexes(
        flat, offs, lens, ksize=p.ksize, zsize=p.zsize, hz=p.hz,
        ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
        max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)


def _torch_state(rb):
    p = tzmo.ZmoParams.dmo()
    flat, offs, _lens, _T, _Npad = tzmo._upload_bank(rb, "cpu")
    return flatseeds.build_bank_indexes(
        flat, offs, ksize=p.ksize, zsize=p.zsize, hz=p.hz, ksave=p.ksave,
        max_kmer_freq=p.max_kmer_freq, max_zmer_freq=p.max_zmer_freq,
        zbits=2 * p.zsize)


@pytest.fixture(scope="module", params=["sim", "smoke"])
def both_states(request):
    rb = _sim_bank() if request.param == "sim" else _smoke_bank()
    return rb, _jax_state(rb), _torch_state(rb)


def test_index_fields_bit_equal(both_states):
    """Every FlatSeeds and DeviceIndexes field, the stats pack included,
    in the JAX package's dtypes."""
    _rb, jstate, tstate = both_states
    for jst, tst in zip(jstate, convert.state_to_numpy(*tstate)):
        for f in jst._fields:
            exp = np.asarray(getattr(jst, f))
            got = tst[f]
            assert got.dtype == exp.dtype, f
            assert np.array_equal(got, exp), f


def test_convert_round_trip(both_states):
    """JAX state -> the port's tensors equals the port's own build, and
    converts back to the JAX arrays."""
    _rb, jstate, tstate = both_states
    conv = convert.state_to_torch(*jstate, device="cpu")
    for cst, tst in zip(conv, tstate):
        for f in tst._fields:
            a, b = getattr(cst, f), getattr(tst, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
    for jst, back in zip(jstate, convert.state_to_numpy(*conv)):
        for f in jst._fields:
            assert np.array_equal(back[f], np.asarray(getattr(jst, f))), f


def test_gather_query_rows_matches_jax(both_states):
    rb, (jk16, _jz10, _jd), (tk16, _tz10, _td) = both_states
    rids = np.array([0, 3, len(rb) - 1, 1], np.int32)
    Lc = 1024
    exp = jflat.gather_query_rows(jk16, jnp.asarray(rids), Lc)
    got = flatseeds.gather_query_rows(tk16, torch.from_numpy(rids), Lc)
    for g, e in zip(got, exp):
        assert np.array_equal(g.numpy(), np.asarray(e).astype(g.numpy().dtype))
