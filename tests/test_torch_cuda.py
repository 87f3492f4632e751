"""The port's CUDA kernels, overlapper and consensus on the card, held
against their plain PyTorch versions on the CPU (which the other
test_torch_* files hold against the JAX package).  Every test needs an NVIDIA GPU and skips
without one.  This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from smartdenovo_tpu_torch.kernels import _build
from smartdenovo_tpu_torch.ops import jpost, pexpand, segdp, sseg

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


# ------------------------------------------------ consensus (segment engine)
# The input makers below are JAX-free; tests/test_torch_segdp.py and
# tests/test_torch_cns.py feed the same inputs to the JAX package.


def segments(rng, Bc, SEGR, LBW, W):
    """Read segments mutated (13% substitutions) from a random consensus,
    with band bases jittered so that they step up and down, alen from 0 to
    SEGR and windows shorter than LBW."""
    NB = SEGR // 16 + 2
    cns = rng.integers(0, 4, LBW + SEGR, dtype=np.uint8)
    a = np.full((Bc, SEGR), 4, np.uint8)
    b = np.full((Bc, LBW), 4, np.uint8)
    alen = np.zeros(Bc, np.int32)
    blen = np.zeros(Bc, np.int32)
    b16 = np.zeros((Bc, NB), np.int16)
    for k in range(Bc):
        off = int(rng.integers(0, LBW - SEGR + 1))
        ln = (SEGR, 0, int(rng.integers(1, SEGR + 1)))[k % 3]
        src = cns[off: off + ln].copy()
        err = rng.random(ln) < 0.13
        src[err] = rng.integers(0, 4, int(err.sum()))
        a[k, :ln] = src
        alen[k] = ln
        blen[k] = int(rng.integers(LBW * 3 // 4, LBW + 1))
        b[k, :blen[k]] = cns[:blen[k]]
        c = off + np.arange(NB) * 16 - W // 2 + rng.integers(-24, 25, NB)
        b16[k] = np.clip(c, 0, LBW - 1)
    return a, b, alen, blen, b16


def probe_tie_inputs(rng, B=6, L=1500, period=50):
    """Probe-anchoring inputs whose hits tie: every window repeats a random
    unit of `period` bases, and doff sits half a period off the true
    diagonal, so the two nearest hits are equally far from it."""
    a = np.full((B, 2048), 4, np.uint8)
    w = np.full((B, 2048), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    wlen = np.zeros(B, np.int32)
    doff = np.zeros(B, np.int32)
    for k in range(B):
        unit = rng.integers(0, 4, period, dtype=np.uint8)
        win = np.tile(unit, L // period + 4)[: L + 200]
        s0 = int(rng.integers(0, period))
        read = win[s0: s0 + L - 100 * (k % 2)]
        a[k, :len(read)] = read
        alen[k] = len(read)
        w[k, :len(win)] = win
        wlen[k] = len(win)
        doff[k] = s0 + period // 2
    return a, alen, w, wlen, doff


def unit_12kb(LayUnitig=None):
    """The 12 kb unit of tests/test_cns.py: 28 backbone reads of 3.5 kb at
    13% error every 400 bp, and 3 more that are not backbone."""
    from smartdenovo_tpu.utils.simulate import mutate_read, random_genome

    if LayUnitig is None:
        from smartdenovo_tpu_torch.pipeline.cns import LayUnitig
    rng = np.random.default_rng(55)
    truth = random_genome(rng, 12000)
    reads, offs, bb = [], [], []
    for start in list(range(0, 12000 - 1000, 400)) + [700, 4200, 8300]:
        reads.append(mutate_read(rng, truth[start: start + 3500], 0.13))
        offs.append(start)
        bb.append(len(reads) <= 28)
    return LayUnitig(name="utg0", reads=reads, offs=offs, backbone=bb)


@pytest.mark.parametrize("gaps", [(-3, -3), (-2, -3)])
@pytest.mark.parametrize("shape", [(8, 128, 256, 64, 512),
                                   (96, 2048, 3072, 256, 3072)])
def test_segdp_cuda_matches_plain(cuda, shape, gaps):
    Bc, SEGR, LBW, W, T = shape
    args = segments(np.random.default_rng(Bc + gaps[0]), Bc, SEGR, LBW, W)
    kw = dict(SEGR=SEGR, LBW=LBW, W=W, T=T, open_i=gaps[0], open_d=gaps[1])
    n0 = _build.LAUNCHES["segdp"]
    got = segdp.seg_align_tb(*(_t(x).to(cuda) for x in args), **kw)
    assert _build.LAUNCHES["segdp"] == n0 + 1
    exp = segdp.seg_align_tb(*(_t(x) for x in args), **kw)
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


def test_probe_anchor_ties_cuda_matches_cpu(cuda):
    from smartdenovo_tpu_torch.pipeline.cns import _probe_anchor_device

    args = [_t(x) for x in probe_tie_inputs(np.random.default_rng(5))]
    exp = _probe_anchor_device(*args)
    got = _probe_anchor_device(*(x.to(cuda) for x in args))
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


def test_consensus_unitig_cuda_matches_cpu(cuda):
    """The 12 kb unit of tests/test_cns.py, two iterations: codes and
    offsets bit-equal; the cuda run went through the segdp kernel."""
    from smartdenovo_tpu_torch.pipeline.cns import CnsParams, consensus_unitig

    unit = unit_12kb()
    p = CnsParams(n_iter=2)
    n0 = _build.LAUNCHES["segdp"]
    got = consensus_unitig(unit, p, return_offs=True, device="cuda")
    assert _build.LAUNCHES["segdp"] > n0
    exp = consensus_unitig(unit, p, return_offs=True, device="cpu")
    assert np.array_equal(got[0], exp[0]) and got[1] == exp[1]
