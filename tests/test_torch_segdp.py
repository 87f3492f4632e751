"""The port's segment DP (ops/segdp.py, its plain PyTorch version) and the
probe anchoring of its consensus stage against the JAX package: score,
b_beg, b_end and the packed moves bit-equal to the JAX `seg_align_tb`,
also where the band base steps down (the floor division of a negative
numerator), at alen == SEGR, alen == 0, blen < LBW and at the main path's
constants; the scores equal the full-matrix oracle of tests/test_segdp.py;
(px, py, found) of `_probe_anchor_device` equal the JAX function's where
hits tie.  Exact comparisons throughout.  The CUDA kernel is held against
the plain version in test_torch_cuda.py, on the same input makers."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartdenovo_tpu.ops import segdp as jsegdp
from smartdenovo_tpu.pipeline import cns as jcns
from smartdenovo_tpu_torch.ops import segdp as tsegdp
from smartdenovo_tpu_torch.pipeline import cns as tcns
from test_segdp import _oracle_affine
from test_torch_cuda import probe_tie_inputs, segments

torch.set_num_threads(1)


def _both(args, **kw):
    """(JAX outputs, port outputs) as lists of numpy arrays."""
    j = jsegdp.seg_align_tb(*(jnp.asarray(x) for x in args), **kw)
    t = tsegdp.seg_align_tb(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in args), **kw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_equal(jo, to):
    for name, j, t in zip(("score", "b_beg", "b_end", "mvp"), jo, to):
        assert j.dtype == t.dtype and j.shape == t.shape, name
        assert np.array_equal(j, t), name


def _oracle_shapes(seed):
    """The inputs of tests/test_segdp.py:53 test_seg_align_matches_oracle
    for one seed (SEGR 128, LBW 256, W 64, T 512, four segments), with the
    read and window of each segment for the oracle."""
    rng = np.random.default_rng(seed)
    SEGR, LBW, W = 128, 256, 64
    Bc = 4
    NB = SEGR // 16 + 2
    reads = np.full(4096, 4, np.uint8)
    cns = np.full(LBW + 512, 4, np.uint8)
    base_seq = rng.integers(0, 4, 200, dtype=np.uint8)
    cns[: 200] = base_seq
    segs = []
    for k in range(Bc):
        off = int(rng.integers(0, 40))
        ln = int(rng.integers(80, SEGR))
        src = base_seq[off: off + ln].copy()
        nerr = max(1, ln // 10)
        pos = rng.integers(0, len(src), nerr)
        src[pos] = rng.integers(0, 4, nerr)
        aoff = k * 1024
        reads[aoff: aoff + len(src)] = src
        segs.append((aoff, len(src), 0, 200 + 56, off))
    b16 = np.zeros((Bc, NB), np.int16)
    for k, s in enumerate(segs):
        b16[k] = np.clip(s[4] + np.arange(NB) * 16 - W // 2, 0, LBW - 1)
    aoffs = np.array([s[0] for s in segs], np.int64)
    a = reads[np.minimum(aoffs[:, None] + np.arange(SEGR), len(reads) - 1)]
    b = cns[np.minimum(np.zeros(Bc, np.int64)[:, None] + np.arange(LBW),
                       len(cns) - 1)]
    args = (a, b, np.array([s[1] for s in segs], np.int32),
            np.array([s[3] for s in segs], np.int32), b16)
    pairs = [(reads[s[0]: s[0] + s[1]], cns[s[2]: s[2] + s[3]]) for s in segs]
    return args, pairs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_small_matches_jax_and_oracle(seed):
    args, pairs = _oracle_shapes(seed)
    jo, to = _both(args, SEGR=128, LBW=256, W=64, T=512, open_i=-2, open_d=-3)
    _assert_equal(jo, to)
    for k, (a, b) in enumerate(pairs):
        assert int(to[0][k]) == _oracle_affine(a, b)[0], k
    mv = tsegdp.unpack_moves(to[3][None])[0]
    for k, (a, _b) in enumerate(pairs):
        ops, counts = tsegdp.moves_to_cigar(mv[:, k])
        assert sum(c for o, c in zip(ops, counts) if o != "D") == len(a)


@pytest.mark.parametrize("gaps", [(-3, -3), (-2, -3)])
@pytest.mark.parametrize("seed", [4, 5])
def test_band_steps_down_matches_jax(seed, gaps):
    """Jittered band samples: the base steps down between samples, so
    (hi - lo) * kf is negative and must floor, not truncate."""
    rng = np.random.default_rng(seed)
    args = segments(rng, 9, 256, 384, 64)
    assert (np.diff(args[4].astype(np.int32), axis=1) < 0).any()
    jo, to = _both(args, SEGR=256, LBW=384, W=64, T=1024, open_i=gaps[0],
                   open_d=gaps[1])
    _assert_equal(jo, to)


def test_edge_lengths_match_jax():
    """alen == SEGR, alen == 0, blen < LBW, blen == 0 and an empty band."""
    rng = np.random.default_rng(6)
    a, b, alen, blen, b16 = segments(rng, 6, 128, 256, 64)
    alen[:3] = (128, 0, 128)
    blen[2] = 100
    blen[3] = 0
    b16[4] = 255
    jo, to = _both((a, b, alen, blen, b16), SEGR=128, LBW=256, W=64, T=512)
    _assert_equal(jo, to)
    assert (to[3][:, 1] == 0xFF).all()      # alen 0: no moves


@pytest.mark.parametrize("gaps", [(-3, -3), (-2, -3)])
def test_full_constants_match_jax(gaps):
    """SEGR 2048, LBW 3072, W 256, T 3072 (pipeline/cns.py:398-404), Bc 4."""
    args = segments(np.random.default_rng(7 - gaps[0]), 4, tcns.SEGR,
                    tcns.S_LBW, tcns.S_W)
    jo, to = _both(args, SEGR=tcns.SEGR, LBW=tcns.S_LBW, W=tcns.S_W,
                   T=tcns.S_T, open_i=gaps[0], open_d=gaps[1])
    _assert_equal(jo, to)


def test_move_helpers_equal_sources():
    for name in ("unpack_moves", "moves_to_cigar"):
        assert (inspect.getsource(getattr(tsegdp, name))
                == inspect.getsource(getattr(jsegdp, name))), name
    assert ((tsegdp.MV_M, tsegdp.MV_I, tsegdp.MV_D, tsegdp.MV_NONE)
            == (jsegdp.MV_M, jsegdp.MV_I, jsegdp.MV_D, jsegdp.MV_NONE))
    assert tsegdp.NEG == int(jsegdp.NEG)


def _probe_both(args):
    j = jcns._probe_anchor_device(*(jnp.asarray(x) for x in args))
    t = tcns._probe_anchor_device(*(torch.from_numpy(x) for x in args))
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def test_probe_anchor_ties_match_jax():
    args = probe_tie_inputs(np.random.default_rng(5))
    jo, to = _probe_both(args)
    for j, t in zip(jo, to):
        assert np.array_equal(j, t.astype(j.dtype))
    # the two hits nearest the diagonal tie: the first one (smaller
    # window position) wins, which is the true diagonal here
    px, py, found = to
    assert found.all()
    s0 = args[4] - 25
    assert (py - px == s0[:, None]).all()


def test_probe_anchor_reads_match_jax():
    """Mutated reads against their windows, some without any hit."""
    rng = np.random.default_rng(8)
    B, LA, LW = 5, 4096, 4096
    a = np.full((B, LA), 4, np.uint8)
    w = np.full((B, LW), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    wlen = np.zeros(B, np.int32)
    doff = np.zeros(B, np.int32)
    for k in range(B):
        win = rng.integers(0, 4, 3000, dtype=np.uint8)
        s0 = int(rng.integers(0, 600))
        read = win[s0: s0 + 2000].copy()
        err = rng.random(len(read)) < (0.13 if k < 4 else 0.9)
        read[err] = rng.integers(0, 4, int(err.sum()))
        a[k, :len(read)] = read
        w[k, :len(win)] = win
        alen[k], wlen[k] = len(read), len(win)
        doff[k] = s0 + int(rng.integers(-50, 50))
    jo, to = _probe_both((a, alen, w, wlen, doff))
    for j, t in zip(jo, to):
        assert np.array_equal(j, t.astype(j.dtype))
    assert to[2][:4].any(axis=1).all()
