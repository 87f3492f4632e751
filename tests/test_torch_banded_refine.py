"""The whole-read DPs of the port (ops/banded.py, ops/refine.py,
ops/refine5q.py, ops/traceback.py, on the CPU, where each runs its plain
PyTorch version) against the JAX package's `jax.jit` functions: score,
end column, direction bytes (rows 0..alen of each read, the rows the CUDA
kernels write), move streams and final columns, with tolerance 0 (integer
outputs); the cases of tests/test_banded.py, test_refine.py and
test_refine5q.py run on the port; `align_strings` equals the JAX loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartdenovo_tpu.ops import banded as jb
from smartdenovo_tpu.ops import refine as jr
from smartdenovo_tpu.ops import refine5q as jq
from smartdenovo_tpu.ops import swdp as jswdp
from smartdenovo_tpu.ops import traceback as jt
from smartdenovo_tpu.utils.simulate import mutate_read
from smartdenovo_tpu_torch.ops import banded as tb
from smartdenovo_tpu_torch.ops import refine as tr
from smartdenovo_tpu_torch.ops import refine5q as tq
from test_refine import mutate, np_affine_global
from test_torch_cuda import (banded_inputs, quals_for, refine_inputs,
                             tracks_for)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows_equal(d_port, d_jax, alen):
    d_port, d_jax = np.asarray(d_port), np.asarray(d_jax)
    for k, ln in enumerate(alen):
        assert np.array_equal(d_port[k, :ln + 1], d_jax[k, :ln + 1]), k


# ---- banded ----------------------------------------------------------------


@pytest.mark.parametrize("semi", [True, False])
@pytest.mark.parametrize("gaps", [(-3, -3), (-2, -3)])
@pytest.mark.parametrize("W", [64, 128, 256])
def test_banded_plain_matches_jax(W, gaps, semi):
    """Reads of different alen (0 and LA among them), a window of length
    0, N codes, negative bases, a band step of W + 37 columns."""
    LA = 320
    args = banded_inputs(np.random.default_rng(W * 7 + gaps[0]), 8, LA, W)
    a, b, alen, blen, base = args
    assert (base < 0).any() and (alen == 0).any() and (blen == 0).any()
    assert (np.diff(base[3]) > W).any() and (a == 4).any()
    kw = dict(LA=LA, W=W, gap_a=gaps[0], gap_b=gaps[1], semiglobal_b=semi)
    js, je, jd = jb.banded_align(*map(jnp.asarray, args), **kw)
    jm, jj = jt.tb_banded_device(jd, jnp.asarray(base), jnp.asarray(alen), je,
                                 T=2 * (LA + 1) + W)
    s, e, d, m, j = (x.numpy() for x in tb.banded_align(*map(_t, args), **kw))
    assert np.array_equal(s, np.asarray(js))
    assert np.array_equal(e, np.asarray(je))
    _rows_equal(d, jd, alen)
    assert np.array_equal(m, np.asarray(jm))
    assert np.array_equal(j, np.asarray(jj))
    assert (s > jb.NEG_INF // 2).sum() >= 3
    cigs, bbeg = tb.traceback_banded(m, j)
    jcigs, jbbeg = jb.traceback_banded(jd, base, alen, je)
    assert cigs == jcigs and np.array_equal(bbeg, jbbeg)


def test_banded_rowmax_plain_matches_jax():
    """wtext's per-row best cell, plain only on the port."""
    LA, W = 200, 64
    args = banded_inputs(np.random.default_rng(9), 5, LA, W, jump=False)
    kw = dict(LA=LA, W=W, semiglobal_b=True, return_rowmax=True)
    jout = jb.banded_align(*map(jnp.asarray, args), **kw)
    out = tb.banded_align(*map(_t, args), **kw)
    # (score, end_col, ..., rmax, rcol) against JAX's (score, end_col,
    # dirs, rmax, rcol)
    for n, jn in ((0, 0), (1, 1), (5, 3), (6, 4)):
        assert np.array_equal(out[n].numpy(), np.asarray(jout[jn])), n


def _port_run(a_seqs, b_seqs, anchors=None, LA=None, W=64):
    """tests/test_banded.py's _run on the port."""
    B = len(a_seqs)
    LA = LA or max(len(s) for s in a_seqs)
    LB = max(len(s) for s in b_seqs)
    a = np.full((B, LA), 4, np.uint8)
    b = np.full((B, LB), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    for i, (x, y) in enumerate(zip(a_seqs, b_seqs)):
        a[i, : len(x)] = x
        alen[i] = len(x)
        b[i, : len(y)] = y
        blen[i] = len(y)
    anchors = anchors or [[] for _ in range(B)]
    base = tb.make_band_centers(anchors, alen, blen, LA, W)
    score, _e, _d, mvs, j = tb.banded_align(*map(_t, (a, b, alen, blen, base)),
                                            LA=LA, W=W)
    cigs, _ = tb.traceback_banded(mvs.numpy(), j.numpy())
    return score.numpy(), cigs, a, b, alen, blen


def test_banded_cases_identical_substitution_gap():
    """test_banded.py: identical sequences, one substitution, one gap."""
    rng = np.random.default_rng(1)
    s = rng.integers(0, 4, 100).astype(np.uint8)
    score, cigs, *_ = _port_run([s], [s])
    assert score[0] == 2 * 100 and cigs[0] == (["M"], [100])
    rng = np.random.default_rng(2)
    s = rng.integers(0, 4, 50).astype(np.uint8)
    t = s.copy()
    t[25] = (t[25] + 1) % 4
    assert _port_run([s], [t])[0][0] == 2 * 49 - 5
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, 60).astype(np.uint8)
    score, cigs, *_ = _port_run([s], [np.delete(s, 30)])
    assert score[0] == 2 * 59 - 3
    ops, counts = cigs[0]
    assert "".join(ops) in ("MIM", "IM", "MI")
    assert sum(c for o, c in zip(ops, counts) if o == "M") == 59


@pytest.mark.parametrize("case", ["strings", "drift"])
def test_banded_cases_strings_and_anchors(case):
    """test_banded.py: aligned strings reproduce both sequences, with and
    without anchors over a 3 kb indel-heavy read."""
    if case == "strings":
        rng = np.random.default_rng(4)
        s = rng.integers(0, 4, 300).astype(np.uint8)
        t = mutate_read(rng, s, 0.12)
        kw, bar = dict(W=128), 0.8
    else:
        rng = np.random.default_rng(5)
        s = rng.integers(0, 4, 3000).astype(np.uint8)
        t = mutate_read(rng, s, 0.13, ins_frac=0.8, del_frac=0.05,
                        sub_frac=0.15, hp_bias=0.2)
        anc = [(i, int(i * len(t) / len(s))) for i in range(250, 2800, 500)]
        kw, bar = dict(anchors=[anc], LA=3000, W=128), 0.75
    score, cigs, a, b, *_ = _port_run([s], [t], **kw)
    a0, a1 = tb.align_strings(a[0], b[0], *cigs[0])
    np.testing.assert_array_equal(a0[a0 != 4], s)
    np.testing.assert_array_equal(a1[a1 != 4], t)
    assert np.sum((a0 == a1) & (a0 != 4)) > bar * len(s)


def test_banded_case_batch_independence():
    rng = np.random.default_rng(6)
    seqs = [rng.integers(0, 4, 80).astype(np.uint8) for _ in range(4)]
    muts = [mutate_read(rng, s, 0.1) for s in seqs]
    score_b, cigs_b, *_ = _port_run(seqs, muts, W=64)
    for i in range(4):
        score_1, cigs_1, *_ = _port_run([seqs[i]], [muts[i]], W=64, LA=80)
        assert score_b[i] == score_1[0]
        assert cigs_b[i] == cigs_1[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_strings_matches_jax(seed):
    """Random CIGARs over codes with N, and the edge CIGARs: empty, all I,
    all D, zero-length runs."""
    rng = np.random.default_rng(seed)
    cases = [([], []), (["I"], [7]), (["D"], [5]), (["M", "I", "M"], [3, 0, 2])]
    for _ in range(20):
        n = int(rng.integers(1, 30))
        cases.append(([("M", "I", "D")[int(x)] for x in rng.integers(0, 3, n)],
                      rng.integers(1, 9, n).tolist()))
    for ops, counts in cases:
        na = sum(c for o, c in zip(ops, counts) if o != "D")
        nb = sum(c for o, c in zip(ops, counts) if o != "I")
        a = rng.integers(0, 5, na + 3).astype(np.uint8)
        b = rng.integers(0, 5, nb + 3).astype(np.uint8)
        got = tb.align_strings(a, b, ops, counts)
        exp = jswdp.align_strings(a, b, ops, counts)
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype == np.uint8 and np.array_equal(g, e)


# ---- refine ----------------------------------------------------------------


@pytest.mark.parametrize("W,indel,gaps", [(64, 0, (-3, -3)), (128, 0, (-2, -3)),
                                          (256, 0, (-2, -3)),
                                          (512, 200, (-3, -3))])
def test_refine_plain_matches_jax(W, indel, gaps):
    LA = 512 if indel else 256
    a, b, alen, blen, base, _ = refine_inputs(np.random.default_rng(W + 1), 6,
                                              LA, W, indel)
    args = (a, b, alen, blen, base)
    kw = dict(LA=LA, W=W, open_i=gaps[0], open_d=gaps[1])
    js, jd = jr.refine_banded_affine(*map(jnp.asarray, args), **kw)
    jm = jt.tb_refine_device(jd, jnp.asarray(base), jnp.asarray(alen),
                             jnp.asarray(blen), T=2 * (LA + 1) + W + 4)
    s, d, m = (x.numpy() for x in tr.refine_banded_affine(*map(_t, args), **kw))
    assert np.array_equal(s, np.asarray(js))
    _rows_equal(d, jd, alen)
    assert np.array_equal(m, np.asarray(jm))
    assert (s > tr.NEG).sum() >= 4
    assert tr.traceback_refine(m) == jr.traceback_refine(jd, base, alen, blen)


@pytest.mark.parametrize("indel,W", [(0, 64), (200, 512), (300, 1024)])
def test_refine_alignment_batch_matches_jax(indel, W):
    """The batch wrapper: band tier from the prior CIGARs' largest indel
    (W = 512 and 1024 for 200- and 300-base deletions), kernel, traceback
    and stats."""
    a, b, alen, blen, _, cigs = refine_inputs(np.random.default_rng(indel),
                                              5, 700, W, indel)
    keep = [k for k in range(5) if alen[k] and blen[k]]
    pairs = [(a[k, :alen[k]], b[k, :blen[k]]) for k in keep]
    cigs = [cigs[k] for k in keep]
    assert tr.band_tier(cigs, 64) == W
    got = tr.refine_alignment_batch(pairs, cigs, open_i=-2, device="cpu")
    exp = jr.refine_alignment_batch(pairs, cigs, open_i=-2)
    assert got == exp


@pytest.mark.parametrize("err", [0.05, 0.15])
def test_refine_full_matrix_oracle_on_port(err):
    """tests/test_refine.py's oracle: the port's refine equals the
    full-matrix affine DP."""
    rng = np.random.default_rng(41)
    pairs, cigars = [], []
    for _ in range(6):
        b = rng.integers(0, 4, 300).astype(np.uint8)
        a = mutate(rng, b, err)
        pairs.append((a, b))
        cigars.append((["M"], [max(len(a), len(b))]))
    res = tr.refine_alignment_batch(pairs, cigars, W_base=128, device="cpu")
    for (a, b), r in zip(pairs, res):
        assert r["score"] == np_affine_global(a, b)
        assert r["mat"] + r["mis"] + r["ins"] == len(a)
        assert r["mat"] + r["mis"] + r["dl"] == len(b)


# ---- refine5q --------------------------------------------------------------


@pytest.mark.parametrize("W", [64, 256])
def test_refine5q_plain_matches_jax(W):
    """Random tracks, N codes in reads, windows and tags."""
    LA = 256
    rng = np.random.default_rng(W + 2)
    a, b, alen, blen, base, _ = refine_inputs(rng, 6, LA, W)
    args = (a, b, *tracks_for(rng, a), alen, blen, base)
    js, jd = jq.refine5q_banded(*map(jnp.asarray, args), LA=LA, W=W)
    jm = jt.tb_refine_device(jd, jnp.asarray(base), jnp.asarray(alen),
                             jnp.asarray(blen), T=2 * (LA + 1) + W + 4)
    s, d, m = (x.numpy() for x in tq.refine5q_banded(*map(_t, args), LA=LA,
                                                       W=W))
    assert np.array_equal(s, np.asarray(js))
    _rows_equal(d, jd, alen)
    assert np.array_equal(m, np.asarray(jm))
    assert (s > tq.NEG).sum() >= 4


def _tracks(read, subqv=30, insqv=25, delqv=20):
    """tests/test_refine5q.py's uniform tracks (tags = read itself)."""
    q = np.zeros((7, len(read)), np.uint8)
    q[1], q[2], q[3] = subqv, insqv, delqv
    q[5] = read
    q[6] = read
    return q


def _5q_cases():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    yield "perfect", [(t.copy(), t)], [_tracks(t)], [(["M"], [300])], \
        dict(ops=["M"], mat=300, mis=0, score=0)
    rng = np.random.default_rng(4)
    t = rng.integers(0, 4, 200).astype(np.uint8)
    r = t.copy()
    r[100] = (t[100] + 1) % 4
    q = _tracks(r, subqv=7)
    q[5, 100] = t[100]
    yield "tagged_sub", [(r, t)], [q], [(["M"], [200])], \
        dict(mis=1, ins=0, dl=0, score=-7)
    yield "untagged_sub", [(r, t)], [_tracks(r, subqv=7)], [(["M"], [200])], \
        dict(score=-tq.QMIS)
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 200).astype(np.uint8)
    r = np.insert(t, 80, (t[80] + 2) % 4)
    yield "low_insqv", [(r, t)], [_tracks(r, insqv=3)], \
        [(["M", "I", "M"], [80, 1, 120])], dict(ins=1, dl=0, mat=200, score=-3)
    rng = np.random.default_rng(6)
    t = rng.integers(0, 4, 200).astype(np.uint8)
    r = np.delete(t, 90)
    q = _tracks(r, delqv=4)
    q[6, 90] = t[90]
    yield "tagged_del", [(r, t)], [q], [(["M", "D", "M"], [90, 1, 109])], \
        dict(dl=1, ins=0, score=-4)


@pytest.mark.parametrize("case", [c[0] for c in _5q_cases()])
def test_refine5q_cases_on_port(case):
    """tests/test_refine5q.py's cases: the port's batch equals the JAX
    package's and meets the same expectations."""
    _, pairs, quals, cigs, want = next(c for c in _5q_cases() if c[0] == case)
    got = tq.refine5q_alignment_batch(pairs, quals, cigs, device="cpu")
    assert got == jq.refine5q_alignment_batch(pairs, quals, cigs)
    for k, v in want.items():
        assert got[0][k] == v, k


def test_refine5q_alignment_batch_random_tracks_matches_jax():
    rng = np.random.default_rng(12)
    a, b, alen, blen, _, cigs = refine_inputs(rng, 6, 400, 64)
    keep = [k for k in range(6) if alen[k] and blen[k]]
    pairs = [(a[k, :alen[k]], b[k, :blen[k]]) for k in keep]
    cigs = [cigs[k] for k in keep]
    quals = quals_for(rng, pairs)
    got = tq.refine5q_alignment_batch(pairs, quals, cigs, device="cpu")
    assert got == jq.refine5q_alignment_batch(pairs, quals, cigs)


def test_constants_equal_jax():
    assert (tb.NEG_INF, tb.DIAG, tb.UP, tb.LEFT, tb.STOP) == (
        int(jb.NEG_INF), jb.DIAG, jb.UP, jb.LEFT, jb.STOP)
    assert tr.NEG == int(jr.NEG) and tq.NEG == int(jq.NEG)
    assert (tq.QCLP, tq.QMIS, tq.QDEL, tq.QEXT) == (jq.QCLP, jq.QMIS, jq.QDEL,
                                                    jq.QEXT)


def _jax_stats_loop(ac, bc, ops, counts):
    """The per-op stats loop of the JAX refine_alignment_batch."""
    x = y = mat = mis = ins = dl = 0
    for op, ln in zip(ops, counts):
        if op == "M":
            seg = int(np.sum(ac[x: x + ln] == bc[y: y + ln]))
            mat += seg
            mis += ln - seg
            x += ln
            y += ln
        elif op == "I":
            ins += ln
            x += ln
        else:
            dl += ln
            y += ln
    return dict(mat=mat, mis=mis, ins=ins, dl=dl, aln=mat + mis + ins + dl)


def test_cigar_stats_matches_jax_loop():
    """Random CIGARs over codes with N, empty, all-I and all-D ones."""
    rng = np.random.default_rng(17)
    cigs = [([], []), (["I"], [6]), (["D"], [4])]
    for _ in range(30):
        n = int(rng.integers(1, 40))
        cigs.append(([("M", "I", "D")[int(x)] for x in rng.integers(0, 3, n)],
                     rng.integers(1, 9, n).tolist()))
    pairs = []
    for ops, counts in cigs:
        na = sum(c for o, c in zip(ops, counts) if o != "D")
        nb = sum(c for o, c in zip(ops, counts) if o != "I")
        pairs.append((rng.integers(0, 5, na).astype(np.uint8),
                      rng.integers(0, 5, nb).astype(np.uint8)))
    got = tr.cigar_stats(pairs, cigs, np.arange(len(cigs)))
    for (ac, bc), (ops, counts), g in zip(pairs, cigs, got):
        want = _jax_stats_loop(ac, bc, ops, counts)
        assert {k: g[k] for k in want} == want
