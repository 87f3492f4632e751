"""Phase 1 (candidate scan) and phase 2 (z-mer matchers, dot-matrix
aligner) of the port against the JAX package on its CPU `fill` paths.

Both sides read the identical index: the JAX package builds it and
convert.py carries it across.  Budgets follow pipeline/zmo.py overlap_dmo
for the batch at hand.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartdenovo_tpu.data.readbank import ReadBank
from smartdenovo_tpu.ops import dotmatrix as jdm
from smartdenovo_tpu.ops import flatseeds as jflat
from smartdenovo_tpu.pipeline import zmo as jzmo
from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
from smartdenovo_tpu_torch import convert
from smartdenovo_tpu_torch.ops import dotmatrix as tdm
from smartdenovo_tpu_torch.ops import flatseeds as tflat
from smartdenovo_tpu_torch.pipeline import zmo as tzmo

torch.set_num_threads(1)

Q, A = 8, 64
P = jzmo.ZmoParams.dmo(batch_q=Q, ncand=A)
ZB = 2 * P.zsize


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    g = random_genome(rng, 30000)
    names, seqs = simulate_reads(g, coverage=10, mean_len=5000, err=0.13,
                                 seed=12)
    rb = ReadBank(names, seqs)
    n = len(rb)
    flat, offs, lens, _T, Npad = jzmo._upload_bank(rb)
    jstate = jflat.build_bank_indexes(
        flat, offs, lens, ksize=P.ksize, zsize=P.zsize, hz=P.hz,
        ksave=P.ksave, max_kmer_freq=P.max_kmer_freq,
        max_zmer_freq=P.max_zmer_freq, zbits=ZB)
    tstate = convert.state_to_torch(*jstate, device="cpu")
    stats = np.asarray(jstate[2].stats).astype(np.int64)
    return dict(rb=rb, n=n, Npad=Npad, jstate=jstate, tstate=tstate,
                stats=stats, read_lens=rb.lengths.astype(np.int32))


def _batch(s, first):
    """Batch inputs as overlap_dmo makes them; the last batch is padded
    with its last read and the padding rows skipped."""
    rids_np = np.arange(first, min(first + Q, s["n"]))
    rids = np.concatenate([rids_np, np.full(Q - len(rids_np), rids_np[-1])]
                          ).astype(np.int32)
    qskip = np.zeros(Q, bool)
    qskip[len(rids_np):] = True
    return rids, s["rb"].lengths[rids].astype(np.int32), qskip


def _cand_static(s):
    Npad, n = s["Npad"], s["n"]
    kneed = s["stats"][Npad: 2 * Npad][:n]
    kprobes = s["stats"][2 * Npad: 3 * Npad][:n]
    batches = [np.arange(i, min(i + Q, n)) for i in range(0, n, Q)]
    return dict(
        Q=Q, Lc=tflat.pad_pow2(int(s["stats"][5 * Npad]), lo=1 << 10), A=A,
        Adm=A,
        cbud=min(tflat.pad_pow2(max(int(kneed[b].sum()) for b in batches)
                                + 1024, lo=1 << 14), P.expand_budget_cap),
        kq=tflat.pad_pow2(max(int(kprobes[b].sum()) for b in batches) + Q,
                          lo=1 << 12),
        ksave=P.ksave, kovl=P.kovl, len_ratio=P.len_ratio)


def _phase1(s, first):
    rids, qlens, qskip = _batch(s, first)
    st = _cand_static(s)
    jk16, _jz10, jd = s["jstate"]
    tk16, _tz10, td = s["tstate"]
    jout = jzmo._cand_core(jnp.asarray(rids), jnp.asarray(qlens),
                           jnp.asarray(qskip), jk16, jd,
                           jnp.asarray(s["read_lens"]), **st)
    tout = tzmo._cand_core(torch.from_numpy(rids), torch.from_numpy(qlens),
                           torch.from_numpy(qskip), tk16, td,
                           torch.from_numpy(s["read_lens"]), **st)
    return rids, qlens, st, jout, tout


@pytest.fixture(scope="module", params=["first", "last"])
def phase1(setup, request):
    last = (setup["n"] - 1) // Q * Q
    return _phase1(setup, 0 if request.param == "first" else last)


def test_cand_core_bit_equal(phase1):
    _rids, _qlens, _st, jout, tout = phase1
    for name, j, t in zip(("csorted", "osorted", "sizes"), jout, tout):
        assert np.array_equal(t.numpy(), np.asarray(j)), name
    assert int(np.asarray(jout[2])[3]) > 0


def _sweep_budgets(s, rids):
    Npad, n = s["Npad"], s["n"]
    zcnt = s["stats"][:Npad][:n]
    cross = s["stats"][4 * Npad: 5 * Npad][:n]
    mb = tflat.pad_pow2(int(zcnt[rids].sum()) + Q, lo=1 << 12)
    cx = tflat.pad_pow2(int(cross[rids].sum()) + 1024, lo=1 << 14)
    return mb, cx, max(cx // 4, 1 << 14)


def _join_budgets(zneed, s, rids):
    mb = tflat.pad_pow2(int(zneed) + 1024, lo=1 << 14)
    pb = min(tflat.pad_pow2(int(zneed) * 3 // 4 + 1024, lo=1 << 14), mb)
    Npad = s["Npad"]
    comp_len = s["stats"][3 * Npad: 4 * Npad][: s["n"]]
    qkb = tflat.pad_pow2(int(comp_len[rids].sum()) + Q, lo=1 << 13)
    return mb, pb, qkb


def _pairs(setup, phase1, matcher):
    s = setup
    rids, _qlens, st, jout, tout = phase1
    jk16, jz10, jd = s["jstate"]
    tk16, tz10, td = s["tstate"]
    rl = s["read_lens"]
    if matcher == "sweep":
        mb, cx, pb = _sweep_budgets(s, rids)
        kw = dict(cross_budget=cx, occ_budget=mb, kvar=P.kvar, zbits=ZB,
                  pair_budget=pb)
        jp = jdm.extract_zmer_pairs_sweep(
            jnp.asarray(rids), jnp.zeros(Q, bool), jout[0], jd.rm_zsd,
            jd.rm_pk, jd.rm_rd, jd.rm_start, jnp.asarray(rl), jd.rm_cnt, **kw)
        tp = tdm.extract_zmer_pairs_sweep(
            torch.from_numpy(rids), torch.zeros(Q, dtype=torch.bool), tout[0],
            td.rm_zsd, td.rm_pk, td.rm_rd, td.rm_start, torch.from_numpy(rl),
            td.rm_cnt, **kw)
    else:
        mb, pb, qkb = _join_budgets(int(np.asarray(jout[2])[0]), s, rids)
        kw = dict(expand_budget=mb, pair_budget=pb, kvar=P.kvar, zbits=ZB,
                  max_per_read=P.max_zmer_freq, qprobe_budget=qkb)
        jz = jflat.gather_query_rows(jz10, jnp.asarray(rids), st["Lc"])
        jp = jdm.extract_zmer_pairs_join(
            jz[0], jz[3], jz[1], jz[2], jz[4], jout[0], jd.rm_zsd, jd.rm_pk,
            jd.rm_start, jnp.asarray(rl), phase3="fill", **kw)
        tz = tflat.gather_query_rows(tz10, torch.from_numpy(rids), st["Lc"])
        tp = tdm.extract_zmer_pairs_join(
            tz[0], tz[3], tz[1], tz[2], tz[4], tout[0], td.rm_zsd, td.rm_pk,
            td.rm_start, torch.from_numpy(rl), **kw)
    return jp, tp


@pytest.mark.parametrize("matcher", ["sweep", "join"])
def test_pair_batch_bit_equal(setup, phase1, matcher):
    """Every live entry and every count.  Dead join slots (pair_id BIGP)
    carry don't-care coordinates: the JAX fill branch forward-fills a few
    slots past the total, the kernel contract writes zeros there."""
    jp, tp = _pairs(setup, phase1, matcher)
    pid = np.asarray(jp.pair_id)
    live = pid < Q * A * 2
    assert live.sum() > 100
    assert np.array_equal(tp.pair_id.numpy(), pid)
    for f in ("o1l1", "o2l2"):
        got, exp = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        if matcher == "sweep":
            assert np.array_equal(got, exp), f
        else:
            assert np.array_equal(got[live], exp[live]), f
    for f in ("total", "expand_total", "match_cnt"):
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f


@pytest.mark.parametrize("matcher", ["sweep", "join"])
def test_dot_matrix_result_bit_equal(setup, phase1, matcher):
    """The aligner on the identical PairBatch (the JAX one, carried
    across): blocks, merge, windows, the dense table and the chain DP."""
    s = setup
    rids, qlens, _st, jout, _tout = phase1
    jp, _tp = _pairs(setup, phase1, matcher)
    tp = tdm.PairBatch(*(torch.from_numpy(np.array(x)) for x in jp))
    n = s["n"]
    cs = np.asarray(jout[0])
    clen = np.repeat(np.where(cs < n, s["read_lens"][np.clip(cs, 0, n - 1)], 0)
                     .astype(np.int32).reshape(-1), 2)
    qlen = np.repeat(qlens, A * 2)
    pb = jp.pair_id.shape[0]
    kw = dict(n_pairs=Q * A * 2, nb=P.nb, xvar=P.xvar, yvar=P.yvar,
              min_block_len=P.min_block_len, max_overhang=P.max_overhang,
              deviation_penalty=P.deviation_penalty,
              gap_penalty=P.gap_penalty, nbk=max(pb // 4, 1 << 14),
              pd=tflat.pad_pow2(2 * int(np.asarray(jout[2])[3]) + 64,
                                lo=1 << 12),
              max_len=16384)
    jr = jdm.dot_matrix_align(jp, jnp.asarray(qlen), jnp.asarray(clen),
                              segk="fill", **kw)
    tr = tdm.dot_matrix_align(tp, torch.from_numpy(qlen),
                              torch.from_numpy(clen), **kw)
    assert int(tr.row_total) > 0
    for f in jr._fields:
        assert np.array_equal(getattr(tr, f).numpy(),
                              np.asarray(getattr(jr, f))), f
