"""The vtab z-mer matcher (direct-addressed (query, zmer) table) of the
port against the JAX package on the CPU: `extract_zmer_pairs_vtab` on the
identical index (every PairBatch field and both totals, with budgets that
fit and budgets that cut), `overlap_dmo(matcher="vtab")` records for the
dm and the sw engine and on a tandem-repeat bank whose batches overflow
their pair budgets and are redispatched, and the 2^25 index-width limit,
which raises in both packages.  Every comparison is exact."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartdenovo_tpu.data.readbank import ReadBank as JReadBank
from smartdenovo_tpu.ops import dotmatrix as jdm
from smartdenovo_tpu.pipeline import zmo as jzmo
from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
from smartdenovo_tpu_torch.data.readbank import ReadBank
from smartdenovo_tpu_torch.ops import dotmatrix as tdm
from smartdenovo_tpu_torch.ops import flatseeds as tflat
from smartdenovo_tpu_torch.pipeline import zmo as tzmo
from test_torch_candidates_dotmatrix import A, P, Q, ZB, phase1, setup  # noqa: F401
from test_torch_cuda import sw_bank

torch.set_num_threads(1)


def _vtab_budgets(s, rids, zneed, cut):
    """overlap_dmo's vtab budgets for this batch (pair_budgets and qkb_z);
    `cut` shrinks the expansion and pair budgets below the batch's need."""
    Npad, n = s["Npad"], s["n"]
    zcnt = s["stats"][:Npad][:n]
    qkb = tflat.pad_pow2(int(zcnt[rids].sum()) + Q, lo=1 << 13)
    mb = tflat.pad_pow2(int(zneed) + 1024, lo=1 << 14)
    pb = min(tflat.pad_pow2(int(zneed) * 3 // 4 + 1024, lo=1 << 14), mb)
    if cut:
        mb, pb = 1 << 11, 1 << 8
    return dict(expand_budget=mb, pair_budget=pb, qm_budget=qkb, kvar=P.kvar,
                zbits=ZB, max_per_read=P.max_zmer_freq)


@pytest.mark.parametrize("cut", [False, True], ids=["fit", "cut"])
def test_vtab_pair_batch_equals_jax(setup, phase1, cut):  # noqa: F811
    s = setup
    rids, _qlens, _st, jout, tout = phase1
    _jk16, _jz10, jd = s["jstate"]
    _tk16, _tz10, td = s["tstate"]
    rl = s["read_lens"]
    kw = _vtab_budgets(s, rids, int(np.asarray(jout[2])[0]), cut)
    jp = jdm.extract_zmer_pairs_vtab(
        jnp.asarray(rids), jout[0], jd.rm_zsd, jd.rm_pk, jd.rm_start,
        jnp.asarray(rl), jd.rm_cnt, **kw)
    tp = tdm.extract_zmer_pairs_vtab(
        torch.from_numpy(rids), tout[0], td.rm_zsd, td.rm_pk, td.rm_start,
        torch.from_numpy(rl), td.rm_cnt, **kw)
    live = np.asarray(jp.pair_id) < Q * A * 2
    assert live.sum() > (100 if not cut else 10)
    for f in jp._fields:
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f
    total, etotal = int(tp.total), int(tp.expand_total)
    if cut:
        assert total > kw["pair_budget"] and etotal > kw["expand_budget"]
    else:
        assert total <= kw["pair_budget"] and etotal <= kw["expand_budget"]


def test_vtab_index_width_raises():
    """An index of 2^25 postings does not fit the vt start packing: both
    packages refuse it (the JAX function while it traces)."""
    R, Qn, An = 4, 2, 3
    kw = dict(expand_budget=1 << 14, pair_budget=1 << 14, qm_budget=1 << 13)
    big = 1 << 25
    with pytest.raises(AssertionError, match="2\\^25"):
        tdm.extract_zmer_pairs_vtab(
            torch.zeros(Qn, dtype=torch.int32),
            torch.zeros((Qn, An), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32).expand(big),
            torch.zeros(1, dtype=torch.int32).expand(big),
            torch.zeros(R + 1, dtype=torch.int32),
            torch.zeros(R, dtype=torch.int32),
            torch.zeros(R, dtype=torch.int32), **kw)
    sds = jax.ShapeDtypeStruct
    i32 = jnp.int32
    with pytest.raises(AssertionError, match="2\\^25"):
        jax.eval_shape(functools.partial(jdm.extract_zmer_pairs_vtab, **kw),
                       sds((Qn,), i32), sds((Qn, An), i32), sds((big,), i32),
                       sds((big,), i32), sds((R + 1,), i32), sds((R,), i32),
                       sds((R,), i32))
    # one posting less fits the packing
    tdm.extract_zmer_pairs_vtab(
        torch.zeros(Qn, dtype=torch.int32),
        torch.full((Qn, An), 0x7FFFFFFF, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32).expand(big - 1),
        torch.zeros(1, dtype=torch.int32).expand(big - 1),
        torch.zeros(R + 1, dtype=torch.int32),
        torch.zeros(R, dtype=torch.int32),
        torch.zeros(R, dtype=torch.int32), zbits=8, **kw)


def _bank30k():
    rng = np.random.default_rng(11)
    g = random_genome(rng, 30000)
    return simulate_reads(g, coverage=10, mean_len=5000, err=0.13, seed=12)


def repeat_bank():
    """A 12 kb tandem array of a 400 bp unit (3% divergence between
    copies) between two 3 kb unique flanks, at 8x, reads of ~3 kb: each
    query zmer occurs in several copies, so a batch's matches outgrow the
    pair budget (0.75x its expansion)."""
    rng = np.random.default_rng(31)
    unit = random_genome(rng, 400)
    copies = []
    for _ in range(30):
        u = unit.copy()
        m = rng.random(400) < 0.03
        u[m] = rng.integers(0, 4, int(m.sum()))
        copies.append(u)
    g = np.concatenate([random_genome(rng, 3000), *copies,
                        random_genome(rng, 3000)])
    return simulate_reads(g, coverage=8, mean_len=3000, err=0.13, seed=32)


CASES = {
    "dm": (_bank30k, dict(batch_q=8, ncand=64), "dmo"),
    "sw": (sw_bank, dict(max_zmer_freq=16, min_id=0.1, ncand=16, batch_q=4),
           "zmo"),
    "redispatch": (repeat_bank, dict(batch_q=8, ncand=64), "dmo"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_overlap_vtab_records_equal_jax(case, monkeypatch):
    make, kw, flags = CASES[case]
    names, seqs = make()
    logs = {"jax": [], "port": []}
    monkeypatch.setattr(jzmo, "log", lambda m, *a: logs["jax"].append(m % a))
    monkeypatch.setattr(tzmo, "log", lambda m, *a: logs["port"].append(m % a))
    jrec = jzmo.overlap_dmo(
        JReadBank(names, seqs),
        getattr(jzmo.ZmoParams, flags)(matcher="vtab", **kw), progress=False)
    trec = tzmo.overlap_dmo(
        ReadBank(names, seqs),
        getattr(tzmo.ZmoParams, flags)(matcher="vtab", **kw), progress=False,
        device="cpu")
    assert len(trec) > 30
    assert ([dataclasses.astuple(o) for o in trec]
            == [dataclasses.astuple(o) for o in jrec])
    over = {k: [m for m in v if "budget overflow" in m]
            for k, v in logs.items()}
    assert over["port"] == over["jax"]
    if case == "redispatch":
        assert len(over["port"]) >= 2
        assert any("pair" in m for m in over["port"])
    if case == "sw":
        assert all(o.cigar != f"{o.aln}M" for o in trec)


def test_vtab_pairs_agree_with_auto():
    """tests/test_overlap_dmo.py's bar on the port alone: the vtab pair set
    is the production (auto) one, Jaccard >= 0.99."""
    rb = ReadBank(*_bank30k())

    def ps(m):
        recs = tzmo.overlap_dmo(rb, tzmo.ZmoParams.dmo(batch_q=8, ncand=64,
                                                       matcher=m),
                                progress=False, device="cpu")
        return {(min(o.rid1, o.rid2), max(o.rid1, o.rid2)) for o in recs}

    base, mine = ps("auto"), ps("vtab")
    assert len(base) > 100
    assert len(base & mine) / len(base | mine) >= 0.99
