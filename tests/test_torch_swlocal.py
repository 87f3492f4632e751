"""The SW engine's device ops against the JAX package, on the CPU: the
plain banded local DP (`banded_local_dp_plain`, the twin of
csrc/swlocal.cu) on its edge cases, `sw_align_batch` with tied chain
scores and dead rows, and the legacy seeds, z-mer index and matcher that
wtgbo's rescue uses.  Every integer array must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smartdenovo_tpu.data.readbank import ReadBank as JReadBank
from smartdenovo_tpu.ops import dotmatrix as jdm
from smartdenovo_tpu.ops import index as jindex
from smartdenovo_tpu.ops import overlap_dp as jodp
from smartdenovo_tpu.ops import seeds as jseeds
from smartdenovo_tpu.ops import zmo_sw as jsw
from smartdenovo_tpu_torch.data.readbank import ReadBank
from smartdenovo_tpu_torch.ops import dotmatrix as tdm
from smartdenovo_tpu_torch.ops import index as tindex
from smartdenovo_tpu_torch.ops import overlap_dp as todp
from smartdenovo_tpu_torch.ops import seeds as tseeds
from smartdenovo_tpu_torch.ops import zmo_sw as tsw
from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads
from test_torch_cuda import sw_bank, sw_edge_pairs, sw_live_pairs, sw_pairs

torch.set_num_threads(1)
I32_MAX = (1 << 31) - 1


def _eq(j, t):
    assert np.array_equal(np.asarray(j), t.cpu().numpy())


@pytest.mark.parametrize("W", [64, 256])
@pytest.mark.parametrize("kind", ["edge", "random"])
def test_banded_local_dp_plain_matches_jax(W, kind):
    """B 16, LA 2048: random pairs at 13% error, or the edge cases of
    sw_edge_pairs (alen / blen 0, blen < W, slopes 1 and 4 << 12, negative
    tb and qb, a dead row with tb INT32_MAX, N codes, homopolymer and
    dinucleotide ties)."""
    rng = np.random.default_rng(3 * W + (kind == "edge"))
    x = (sw_edge_pairs(rng, 16, 2048, W) if kind == "edge"
         else sw_pairs(rng, 16, 2048))
    exp = jodp.banded_local_dp(*(jnp.asarray(v) for v in x), LA=2048, W=W)
    got = todp.banded_local_dp(*(torch.from_numpy(v) for v in x), LA=2048,
                               W=W)
    for j, t in zip(exp, got):
        _eq(j, t)
    assert int(got[0].max()) > 200


def test_chain_band_params_and_reverse_batch():
    rng = np.random.default_rng(4)
    tb, te, qb, qe = (rng.integers(-500, 5000, 64) for _ in range(4))
    for j, t in zip(jodp.chain_band_params(tb, te, qb, qe),
                    todp.chain_band_params(tb, te, qb, qe)):
        assert np.array_equal(j, t)
    x = rng.integers(0, 4, (8, 100)).astype(np.uint8)
    lens = rng.integers(0, 101, 8)
    assert np.array_equal(jodp.reverse_batch(x, lens),
                          todp.reverse_batch(x, lens))


def _wrap32(x):
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(
        np.int32)


def _trim_check(x, LA, W, gap=-3):
    """Each pair cut to its live rows [i0, i1] (`a[i0-1:i1]`, tb - (i0-1),
    alen i1 - i0 + 1; alen 0 where it has none) through the JAX function
    gives its outputs on the whole pair, end_a offset by i0 - 1 where the
    best is positive.  Returns (the whole pairs' outputs, rows kept)."""
    a, b, alen, blen, tb, qb, sl = x
    i0, i1 = (v.numpy() for v in todp.live_rows(
        *(torch.from_numpy(v) for v in x[2:]), LA, W, gap=gap))
    n = np.maximum(i1 - i0 + 1, 0).astype(np.int32)
    at = np.full_like(a, 4)
    for k in range(a.shape[0]):
        at[k, :n[k]] = a[k, max(i0[k] - 1, 0):max(i0[k] - 1, 0) + n[k]]
    tbt = _wrap32(tb.astype(np.int64) - np.maximum(i0 - 1, 0))
    full = jodp.banded_local_dp(*(jnp.asarray(v) for v in x), LA=LA, W=W,
                                gap=gap)
    cut = jodp.banded_local_dp(*(jnp.asarray(v) for v in (
        at, b, n, blen, tbt, qb, sl)), LA=LA, W=W, gap=gap)
    full, cut = ([np.asarray(v) for v in r] for r in (full, cut))
    for f in (0, 1, 3):
        assert np.array_equal(full[f], cut[f])
    pos = full[0] > 0
    assert np.array_equal(full[2], np.where(pos, cut[2] + i0 - 1, 0))
    return full, n


@pytest.mark.parametrize("W", [32, 96, 256])
@pytest.mark.parametrize("kind", ["live", "random"])
def test_live_rows_trim_matches_jax(W, kind):
    """The rows that the CUDA kernel skips change nothing (_trim_check).
    B 32, LA 1024: random pairs, or sw_live_pairs' slope-0, negative,
    wrapping, pinned and dead cases."""
    rng = np.random.default_rng(7 * W + (kind == "live"))
    LA = 1024
    x = (sw_live_pairs(rng, 32, LA, W) if kind == "live"
         else sw_pairs(rng, 32, LA))
    full, n = _trim_check(x, LA, W)
    assert (n < np.minimum(x[2], LA)).sum() >= 8   # rows were cut
    assert int(full[0].max()) > 200
    if kind == "live":   # tb beyond alen, blen 0, the dead row: no rows
        assert n[8] == n[10] == n[18] == 0
        assert full[0][[8, 10, 18]].max() == 0


@pytest.mark.parametrize("gap", [0, 1])
def test_live_rows_trim_matches_jax_gap(gap):
    """_trim_check at a gap of 0, where a pinned tail row only ties the
    best and the tail is still cut, and +1, where it raises the best and
    the tail stays: sw_live_pairs at W 96, whose pairs 2, 14, 15 and 21
    end pinned at blen."""
    LA, W = 1024, 96
    x = sw_live_pairs(np.random.default_rng(90 + gap), 32, LA, W)
    _, n = _trim_check(x, LA, W, gap=gap)
    _, n3 = (v.numpy() for v in todp.live_rows(
        *(torch.from_numpy(v) for v in x[2:]), LA, W))
    tails = [2, 14, 15, 21]
    R = np.minimum(x[2], LA)
    assert (n3[tails] < R[tails]).all()   # gap -3 cuts these tails
    if gap > 0:
        _, i1 = todp.live_rows(*(torch.from_numpy(v) for v in x[2:]), LA, W,
                               gap=gap)
        assert (i1.numpy()[tails] == R[tails]).all()


@pytest.mark.parametrize("scores", [dict(gap=1), dict(match=(1 << 28) + 1),
                                    dict(mismatch=(1 << 28) + 1)])
def test_live_rows_keep_the_tail_when_it_can_rise(scores):
    """A positive gap, or a match or mismatch that lifts the NEG_INF
    diagonal of a pinned row above 0, keeps every row after the head; the
    engine's scores cut the tail."""
    LA, W = 1000, 256
    alen = np.full(3, 900, np.int32)
    blen = np.array([300, 500, 2000], np.int32)
    tb, qb = np.zeros(3, np.int32), np.full(3, 128, np.int32)
    sl = np.full(3, 4096, np.int32)
    args = [torch.from_numpy(v) for v in (alen, blen, tb, qb, sl)]
    i0, i1 = todp.live_rows(*args, LA, W)
    # row i starts at column i: row blen is the last that can raise the best
    assert i1.tolist() == [300, 500, 900]
    j0, j1 = todp.live_rows(*args, LA, W, **scores)
    assert j0.tolist() == i0.tolist() and j1.tolist() == [900] * 3


def test_live_rows_whole_range_outside_the_monotone_case():
    """A negative slope, or a band start whose int32 steps wrap somewhere in
    rows 0 .. min(alen, LA), gets rows 1 .. min(alen, LA); so does a
    monotone band whose every row is live."""
    LA, W = 1000, 256
    alen = np.array([900, 900, 900, 900, 900, 1500, 900], np.int32)
    blen = np.full(7, 2000, np.int32)
    tb = np.array([0, 1 << 30, -(1 << 30), 0, 0, 0, 0], np.int32)
    qb = np.array([500, 0, 0, I32_MAX - 200, -(1 << 31) + 10, 128, 128],
                  np.int32)
    sl = np.array([-4096, 64 << 12, 4 << 12, 1 << 12, -1, 4096, 4096],
                  np.int32)
    i0, i1 = todp.live_rows(*(torch.from_numpy(v) for v in
                              (alen, blen, tb, qb, sl)), LA, W)
    assert i0.tolist() == [1] * 7
    assert i1.tolist() == [900, 900, 900, 900, 900, 1000, 900]
    assert i0.dtype == i1.dtype == torch.int32


def _odd_head_pairs(rng, W, LA=256):
    """sw_pairs whose band start sits at -(W-2) (only column 1 in the band)
    in every row (slope 0) or from some row on (slope 1 << 12), with a and
    b of one code so that column 1 scores, beside pairs one column further
    left (every row dead) and random pairs."""
    x = sw_pairs(rng, 12, LA)
    a, b, alen, blen, tb, qb, sl = x
    edge = 2 - W + W // 2   # qb whose row starts at -(W-2) at slope 0
    for k, (t, q, s) in enumerate([(0, edge, 0), (0, edge - 1, 0),
                                   (LA // 4, edge - 1, 1 << 12),
                                   (LA // 3, edge - 5, 1 << 12)]):
        a[k], b[k], alen[k], blen[k] = 1, 1, LA, LA
        tb[k], qb[k], sl[k] = t, q, s
    return x


@pytest.mark.parametrize("W", [1, 33, 1599])
def test_live_rows_head_at_odd_widths(W):
    """At an odd W the first live row is the first whose band start is
    -(W-2) or more (W // 2 is not W / 2 there): _trim_check on bands that
    reach column 1 alone, which scores 2 from row 1 where the band holds
    its diagonal (W > 1)."""
    LA = 256
    x = _odd_head_pairs(np.random.default_rng(W), W, LA)
    full, n = _trim_check(x, LA, W)
    assert n[0] == LA and n[1] == 0 and 0 < n[2] < LA
    assert full[0][0] == (2 if W > 1 else 0) and full[0][1] == 0


def _band_steps_ok(x, LA, W):
    """Per pair: every live row's band start (band_bases) moves 0 or 1
    column from the row before."""
    t = [torch.from_numpy(v) for v in x[2:]]
    i0, i1 = (v.numpy() for v in todp.live_rows(*t, LA, W))
    steps = np.diff(todp.band_bases(*t, LA, W).numpy().astype(np.int64), axis=1)
    return np.array([i0[k] > i1[k] or bool(np.isin(
        steps[k, i0[k] - 1:i1[k]], [0, 1]).all()) for k in range(len(i0))])


@pytest.mark.parametrize("W", [96, 1600, 1601])
def test_unit_steps_flag_matches_band_steps(W):
    """The pairs unit_steps flags (csrc/swwide.cu's register path) move 0
    or 1 column every live row: sw_live_pairs' cases (slope 0 inside the
    columns and pinned at either end, 1 << 12 with dead heads and tails
    pinned at blen, negative slopes, wrapping bands) and random slopes
    around 1 << 12; the monotone slopes from 0 to 1 << 12 are flagged and
    the others are not."""
    LA = 1024
    rng = np.random.default_rng(W)
    x = sw_live_pairs(rng, 40, LA, W)
    x[6][24:32] = [0, 1, 4095, 4096, 4097, 8192, -1, 1 << 20]
    unit = todp.unit_steps(*(torch.from_numpy(v) for v in x[2:]), LA,
                           W).numpy()
    assert _band_steps_ok(x, LA, W)[unit].all()
    assert unit[[0, 1, 2, 8, 9, 12, 15, 22, 23, 24, 25, 26, 27]].all()
    assert not unit[[3, 4, 5, 6, 7, 13, 14, 16, 18, 20, 21, 28, 29, 30,
                     31]].any()


def test_swwide_shape_covers_every_width():
    """swwide_shape's block holds every W from 1 to SWWIDE_MAX_W with no
    lane missing and no warp wholly dead, in at most SWWIDE_MAX_WARPS warps
    (fewer where the kernel's launch bounds say so) of at most SWWIDE_MAX_P
    lanes a thread."""
    shapes = {}
    for W in range(1, todp.SWWIDE_MAX_W + 1):
        P, warps = todp.swwide_shape(W)
        assert 1 <= P <= todp.SWWIDE_MAX_P
        assert 1 <= warps <= todp.SWWIDE_WARP_CAPS.get(
            P, todp.SWWIDE_MAX_WARPS)
        assert 32 * P * (warps - 1) < W <= 32 * P * warps
        shapes[W] = (P, warps)
    assert shapes[1600] == (10, 5)     # wtcyc: 5 x 32 x 10, none dead
    assert shapes[4096] == (8, 16) and shapes[1] == (1, 1)
    # never more dead lanes than a block of 256 threads of ceil(W / 256)
    # lanes each, and under a third of them on average
    dead = np.array([32 * P * w - W for W, (P, w) in shapes.items()])
    old = np.array([-W % 256 for W in shapes])
    assert (dead <= old).all() and dead.mean() < old.mean() / 3


def test_longest_first_is_a_stable_permutation():
    rng = np.random.default_rng(11)
    i0 = torch.from_numpy(rng.integers(0, 40, 500).astype(np.int32))
    i1 = torch.from_numpy(rng.integers(-1, 60, 500).astype(np.int32))
    order = todp.longest_first(i0, i1)
    assert order.dtype == torch.int32
    o = order.numpy()
    assert np.array_equal(np.sort(o), np.arange(500))
    n = np.maximum(i1.numpy() - i0.numpy() + 1, 0)[o]
    assert (np.diff(n) <= 0).all() and (n == 0).sum() > 50
    same = np.diff(n) == 0
    assert (np.diff(o)[same] > 0).all()   # ties in pair order


def _bank(n_reads=24, seed=21):
    rng = np.random.default_rng(seed)
    g = random_genome(rng, 6000)
    names, seqs = simulate_reads(g, coverage=5, mean_len=1000, err=0.13,
                                 seed=seed + 1, min_len=400)
    seqs = [s[:1800] for s in seqs[:n_reads]]
    return names[:n_reads], seqs


def _dm_rows(rng, Q, A, n, rb):
    """Synthetic dot_matrix_align rows: unique live pair ids over half the
    (q, slot, dir) grid, chain scores in 0..4 (ties across slots and
    across the two strands, zeros), coordinates inside the reads, and a
    dead tail (pair id BIGP, tb INT32_MAX as dotmatrix's min fill)."""
    NP2 = Q * A * 2
    live = rng.permutation(NP2)[: NP2 // 2]
    PD = live.size + 40
    pid = np.full(PD, NP2, np.int32)
    pid[: live.size] = live
    score = np.zeros(PD, np.int32)
    score[: live.size] = rng.integers(0, 5, live.size) * 100
    tb = np.full(PD, I32_MAX, np.int32)
    te, qb, qe = (np.zeros(PD, np.int32) for _ in range(3))
    tb[: live.size] = rng.integers(0, 300, live.size)
    te[: live.size] = tb[: live.size] + rng.integers(300, 900, live.size)
    qb[: live.size] = rng.integers(-50, 300, live.size)
    qe[: live.size] = qb[: live.size] + rng.integers(-20, 900, live.size)
    csorted = np.sort(rng.integers(0, n, (Q, A)), axis=1).astype(np.int32)
    csorted[:, -3:] = I32_MAX
    return pid, score, tb, te, qb, qe, csorted


def test_sw_align_batch_matches_jax():
    """Top C of A per query with tied chain scores (the lower slot first),
    strand ties (strand 0), dead slots and dead rows."""
    names, seqs = _bank()
    rb = ReadBank(names, seqs)
    rng = np.random.default_rng(9)
    Q, A, C, L = 4, 12, 5, 2048
    rids = np.array([0, 3, 5, 7], np.int32)
    qbatch, qlens = rb.batch(rids, pad_to=L)
    rows = _dm_rows(rng, Q, A, len(rb), rb)
    bank = (rb.bases, rb.offsets.astype(np.int32), rb.lengths.astype(np.int32))
    args = (*rows, qbatch, qlens.astype(np.int32), *bank)
    kw = dict(Q=Q, A=A, C=C, Ltier=L, W=64)
    exp = jsw.sw_align_batch(*(jnp.asarray(v) for v in args), **kw)
    got = tsw.sw_align_batch(*(torch.from_numpy(v) for v in args), **kw)
    for f in jsw.SwBatchResult._fields:
        _eq(getattr(exp, f), getattr(got, f))
    assert int((got.cand >= 0).sum()) > Q and int(got.score.max()) > 0
    with pytest.raises(AssertionError, match="duplicate"):
        dup = list(args)
        dup[0] = dup[0].copy()
        dup[0][1] = dup[0][0]
        tsw.sw_align_batch(*(torch.from_numpy(v) for v in dup), **kw)


@pytest.mark.parametrize("hz,ksize", [(True, 10), (True, 16), (False, 12)])
def test_extract_seeds_matches_jax(hz, ksize):
    names, seqs = _bank(8)
    rb = ReadBank(names, seqs)
    batch, lens = rb.batch(np.arange(8), pad_to=2048)
    lens[3] = 0
    exp = jseeds.extract_seeds(jnp.asarray(batch), jnp.asarray(lens), ksize, hz)
    got = tseeds.extract_seeds(torch.from_numpy(batch), torch.from_numpy(lens),
                               ksize, hz)
    assert sorted(exp) == sorted(got)
    for k in exp:
        _eq(np.asarray(exp[k]).astype(np.int64), got[k].to(torch.int64))
    rids = np.arange(8, dtype=np.int32) + 100
    for ksave, with_pos in ((0, True), (4, False), (0, False)):
        e = jseeds.compact_seed_batch(jnp.asarray(batch), jnp.asarray(lens),
                                      jnp.asarray(rids), ksize, hz, ksave,
                                      with_pos=with_pos)
        g = tseeds.compact_seed_batch(torch.from_numpy(batch),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(rids), ksize, hz, ksave,
                                      with_pos=with_pos)
        assert len(e) == len(g)
        for x, y in zip(e, g):
            _eq(np.asarray(x).astype(np.int64), y.to(torch.int64))


@pytest.fixture(scope="module")
def zindex():
    names, seqs = sw_bank()
    jrb, trb = JReadBank(names, seqs), ReadBank(names, seqs)
    # small batches so that several length tiers and padded batches occur
    kw = dict(zsize=10, hz=True, max_per_read=4, batch_elems=1 << 14)
    return (jrb, trb, jindex.build_zmer_index(jrb, **kw),
            tindex.build_zmer_index(trb, **kw, device="cpu"))


def test_build_zmer_index_matches_jax(zindex):
    _jrb, _trb, j, t = zindex
    for f in ("zmers", "post_rd", "post_dir", "post_off", "post_span",
              "post_packed", "rm_zsd", "rm_pk", "rm_start"):
        _eq(np.asarray(getattr(j, f)).astype(np.int64),
            getattr(t, f).to(torch.int64))
    for f in ("np_zmers", "np_key", "np_top_z"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    assert (j.zsize, j.max_per_read, j.max_read_z) == (
        t.zsize, t.max_per_read, t.max_read_z)
    assert t.zmers.numel() > 1000


@pytest.mark.parametrize("pair_budget", [1 << 14, 512])
def test_extract_zmer_pairs_matches_jax(zindex, pair_budget):
    """The legacy matcher on 8 queries against candidate sets (with pads),
    at a budget that holds every match and at one that cuts them."""
    jrb, trb, j, t = zindex
    Q, A = 8, 6
    rng = np.random.default_rng(2)
    rids = np.arange(Q, dtype=np.int32) * 2
    batch, lens = trb.batch(rids, pad_to=2048)
    cands = np.full((Q, A), I32_MAX, np.int32)
    for q in range(Q):
        c = np.sort(rng.choice(len(trb), int(rng.integers(1, A + 1)),
                               replace=False))
        cands[q, : c.size] = c
    js = jseeds.extract_seeds(jnp.asarray(batch), jnp.asarray(lens), 10, True)
    ts = tseeds.extract_seeds(torch.from_numpy(batch), torch.from_numpy(lens),
                              10, True)
    kw = dict(expand_budget=1 << 15, pair_budget=pair_budget, kvar=2)
    keys = ("kmer", "dir", "off", "span", "valid")
    exp = jdm.extract_zmer_pairs(
        *(js[k] for k in keys), jnp.asarray(rids), jnp.asarray(cands),
        j.zmers, j.post_rd, j.post_packed,
        jnp.asarray(jrb.lengths.astype(np.int32)), **kw)
    got = tdm.extract_zmer_pairs(
        *(ts[k] for k in keys), torch.from_numpy(rids),
        torch.from_numpy(cands), t.zmers, t.post_rd, t.post_packed,
        torch.from_numpy(trb.lengths.astype(np.int32)), **kw)
    for f in tdm.PairBatch._fields:
        _eq(getattr(exp, f), getattr(got, f))
    assert int(got.total) > 200
    assert (int(got.total) > pair_budget) == (pair_budget == 512)
