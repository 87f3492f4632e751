"""The port's CUDA kernels and overlapper on the card, held against their
plain PyTorch versions on the CPU (which the other test_torch_* files hold
against the JAX package).  Every test needs an NVIDIA GPU and skips
without one.  This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from smartdenovo_tpu_torch.kernels import _build
from smartdenovo_tpu_torch.ops import jpost, pexpand, sseg

I32_MAX = (1 << 31) - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sseg_stream(rng, N):
    """Segments of 1 to ~100 entries, one longer than a block of 1024, and
    a dead tail (neutral lanes) over the last quarter."""
    seg_new = (rng.random(N) < 0.03).astype(np.int32)
    seg_new[0] = 1
    seg_new[N // 3: N // 3 + 3000] = 0
    v8 = rng.integers(-1000, 1 << 20, (8, N)).astype(np.int32)
    tail = N * 3 // 4
    seg_new[tail:] = 0
    v8[0, tail:] = 0
    v8[1:3, tail:] = I32_MAX
    v8[3:5, tail:] = 0
    v8[5:8, tail:] = I32_MAX
    return seg_new, v8


@pytest.mark.parametrize("ops", [
    ("sum", "min", "min", "max", "max", "first", "first", "first"),
    ("sum", "min", "min", "max", "max", "first", "sum", "first"),
    ("sum",) + ("first",) * 7])
@pytest.mark.parametrize("N", [1000, 1024, 300_001])
def test_sseg_cuda_matches_plain(cuda, ops, N):
    seg_new, v8 = _sseg_stream(np.random.default_rng(N), N)
    n_seg = int(seg_new.sum())
    for ob in (n_seg + 5, n_seg // 2):
        got, gcnt = sseg.seg_reduce_compact(_t(seg_new).to(cuda),
                                            _t(v8).to(cuda), ops=ops,
                                            out_budget=ob)
        exp, ecnt = sseg.seg_reduce_compact(_t(seg_new), _t(v8), ops=ops,
                                            out_budget=ob)
        assert int(gcnt) == int(ecnt) == n_seg
        n = min(n_seg, ob)
        assert torch.equal(got[:, :n].cpu(), exp[:, :n])


def _join_stream(rng, N):
    """Sorted join keys: runs of query entries (side 0) then candidate
    entries (side 1), some runs at or over max_per_read, dead tail."""
    keys = []
    g = 0
    while len(keys) < N * 4 // 5:
        g += int(rng.integers(1, 50))
        keys += [g << 1] * int(rng.integers(0, 20))
        keys += [(g << 1) | 1] * int(rng.integers(0, 6))
    key = np.full(N, I32_MAX, np.int32)
    key[:N * 4 // 5] = keys[:N * 4 // 5]
    pay = rng.integers(-(1 << 31), I32_MAX, N).astype(np.int32)
    aux = rng.integers(0, 1 << 20, N).astype(np.int32)
    return key, pay, aux


@pytest.mark.parametrize("N", [1024, 5000, 400_000])
def test_jpost_cuda_matches_plain(cuda, N):
    key, pay, aux = _join_stream(np.random.default_rng(N), N)
    for ob in (N, 17):
        got = jpost.join_emitters(*(_t(a).to(cuda) for a in (key, pay, aux)),
                                  max_per_read=16, out_budget=ob)
        exp = jpost.join_emitters(_t(key), _t(pay), _t(aux),
                                  max_per_read=16, out_budget=ob)
        assert (int(got[1]), int(got[2])) == (int(exp[1]), int(exp[2]))
        n = min(int(exp[1]), ob)
        assert n > 0
        assert torch.equal(got[0][:, :n].cpu(), exp[0][:, :n])


@pytest.mark.parametrize("NE", [1, 5000, 300_000])
def test_pexpand_cuda_matches_plain(cuda, NE):
    rng = np.random.default_rng(NE)
    cnt = rng.integers(0, 15, NE).astype(np.int32)
    cnt[NE // 2 + 1:] = 0
    args = [cnt] + [rng.integers(-(1 << 31), I32_MAX, NE).astype(np.int32)
                    for _ in range(3)]
    for pb in (int(cnt.sum()) + 100, int(cnt.sum()) // 2 + 1):
        got = pexpand.expand_emit(*(_t(a).to(cuda) for a in args),
                                  pair_budget=pb)
        exp = pexpand.expand_emit(*(_t(a) for a in args), pair_budget=pb)
        for g, e in zip(got, exp):
            assert torch.equal(g.cpu(), e)


@pytest.mark.parametrize("matcher", ["auto", "join"])
def test_overlap_dmo_cuda_matches_cpu(cuda, matcher):
    """The whole overlapper, record for record; the join run must have
    gone through all three kernels."""
    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    rng = np.random.default_rng(11)
    genome = random_genome(rng, 30_000)
    names, seqs = simulate_reads(genome, coverage=10, mean_len=5000,
                                 err=0.13, seed=12)
    rb = ReadBank(names, seqs)
    p = ZmoParams.dmo(batch_q=8, ncand=64, matcher=matcher)
    _build.reset_launches()
    got = overlap_dmo(rb, p, progress=False, device="cuda")
    launches = dict(_build.LAUNCHES)
    exp = overlap_dmo(rb, p, progress=False, device="cpu")
    assert got == exp and len(got) > 50
    assert launches["sseg"] > 0
    if matcher == "join":
        assert launches["jpost"] > 0 and launches["pexpand"] > 0
