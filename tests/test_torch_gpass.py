"""The port's -G overlapper (parallel/gpass.py) against the JAX package:
the row form of the sweep matcher bit for bit, and `overlap_gparts`
record for record on a bank where no budget overflows (so the JAX package
drops nothing); -e sw and the pair ledgers are refused under -G."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartdenovo_tpu.data.readbank import ReadBank
from smartdenovo_tpu.ops import dotmatrix as jdm
from smartdenovo_tpu.ops import flatseeds as jflat
from smartdenovo_tpu.ops.seeds import extract_seeds as jextract
from smartdenovo_tpu.pipeline import zmo as jzmo
from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
from smartdenovo_tpu_torch import convert
from smartdenovo_tpu_torch.data.readbank import ReadBank as TReadBank
from smartdenovo_tpu_torch.ops import dotmatrix as tdm
from smartdenovo_tpu_torch.ops.align import pad_tier
from smartdenovo_tpu_torch.ops.flatseeds import pad_pow2
from smartdenovo_tpu_torch.ops.seeds import extract_seeds as textract
from smartdenovo_tpu_torch.parallel import gpass
from smartdenovo_tpu_torch.pipeline import zmo as tzmo

torch.set_num_threads(1)

Q, A = 8, 64
P = jzmo.ZmoParams.dmo(batch_q=Q, ncand=A)
ZB = 2 * P.zsize


def _sim():
    rng = np.random.default_rng(11)
    g = random_genome(rng, 30000)
    return simulate_reads(g, coverage=10, mean_len=5000, err=0.13, seed=12)


@pytest.fixture(scope="module")
def banks():
    names, seqs = _sim()
    return ReadBank(names, seqs), TReadBank(names, seqs)


@pytest.fixture(scope="module")
def padded_batch(banks):
    """A batch of the bank's 5 longest reads (padded with the fifth, the
    padding rows skipped), its top-A candidates and z-mer seed rows, both
    packages."""
    rb = banks[0]
    n = len(rb)
    flat, offs, lens, _T, Npad = jzmo._upload_bank(rb)
    jstate = jflat.build_bank_indexes(
        flat, offs, lens, ksize=P.ksize, zsize=P.zsize, hz=P.hz,
        ksave=P.ksave, max_kmer_freq=P.max_kmer_freq,
        max_zmer_freq=P.max_zmer_freq, zbits=ZB)
    stats = np.asarray(jstate[2].stats).astype(np.int64)
    live = np.arange(5)
    rids = np.concatenate([live, np.full(Q - len(live), live[-1])]
                          ).astype(np.int32)
    qskip = np.arange(Q) >= len(live)
    qlens = rb.lengths[rids].astype(np.int32)
    cs, _os, _sz = jzmo._cand_core(
        jnp.asarray(rids), jnp.asarray(qlens), jnp.asarray(qskip), jstate[0],
        jstate[2], jnp.asarray(rb.lengths.astype(np.int32)), Q=Q,
        Lc=pad_pow2(int(stats[5 * Npad]), lo=1 << 10), A=A, Adm=A,
        cbud=1 << 16, kq=1 << 14, ksave=P.ksave, kovl=P.kovl,
        len_ratio=P.len_ratio)
    batch, blens = rb.batch(rids, pad_to=pad_tier(int(rb.lengths[0])))
    jz = jextract(jnp.asarray(batch), jnp.asarray(blens), P.zsize, P.hz)
    tz = textract(torch.from_numpy(batch), torch.from_numpy(blens), P.zsize,
                  P.hz)
    occ = pad_pow2(int(stats[:n][rids[~qskip]].sum()) + Q, lo=1 << 12)
    cross = pad_pow2(int(stats[4 * Npad: 5 * Npad][rids].sum()) + 1024,
                     lo=1 << 14)
    return dict(rb=rb, rids=rids, qskip=qskip, csorted=np.asarray(cs),
                jz=jz, tz=tz, jd=jstate[2],
                td=convert.state_to_torch(*jstate, device="cpu")[2],
                occ=occ, cross=cross)


def _occ_tables(s, max_per_read):
    jz, tz, qskip = s["jz"], s["tz"], s["qskip"]
    jo = jdm.build_query_occ_rows(
        jz["kmer"], ((jz["off"] << 9) | (jnp.minimum(jz["span"], 255) << 1)
                     | jz["dir"].astype(jnp.int32)),
        jz["valid"] & ~jnp.asarray(qskip)[:, None], occ_budget=s["occ"],
        zbits=ZB, max_per_read=max_per_read)
    to = tdm.build_query_occ_rows(
        tz["kmer"], ((tz["off"] << 9) | (tz["span"].clamp(max=255) << 1)
                     | tz["dir"].to(torch.int32)),
        tz["valid"] & ~torch.from_numpy(qskip)[:, None], occ_budget=s["occ"],
        zbits=ZB, max_per_read=max_per_read)
    return jo, to


@pytest.mark.parametrize("max_per_read", [P.max_zmer_freq, 2])
def test_row_sweep_equals_jax(padded_batch, max_per_read):
    """build_query_occ_rows and extract_zmer_pairs_sweep_rows bit-equal to
    the JAX functions on a padded batch; at max_per_read 2 the per-(q,
    zmer) cap drops occurrences."""
    s = padded_batch
    jo, to = _occ_tables(s, max_per_read)
    for name, j, t in zip(("bq_cnt", "bq_start", "occ_q", "occ_pk",
                           "qtotal"), jo, to):
        assert np.array_equal(t.numpy(), np.asarray(j)), name
    valid = int((s["tz"]["valid"] & ~torch.from_numpy(s["qskip"])[:, None])
                .sum())
    qtotal = int(to[4])
    assert 0 < qtotal <= s["occ"]
    assert (qtotal < valid) == (max_per_read == 2)
    # padded rows (skipped queries) carry no occurrences
    assert int((to[2] < Q).sum()) == qtotal
    assert not np.isin(to[2].numpy(), np.nonzero(s["qskip"])[0]).any()
    jd, td = s["jd"], s["td"]
    rl = s["rb"].lengths.astype(np.int32)
    jp = jdm.extract_zmer_pairs_sweep_rows(
        jnp.asarray(s["rids"]), jnp.asarray(s["csorted"]), jo, jd.rm_zsd,
        jd.rm_pk, jd.rm_rd, jd.rm_start, jnp.asarray(rl),
        cross_budget=s["cross"], kvar=P.kvar, zbits=ZB)
    tp = tdm.extract_zmer_pairs_sweep_rows(
        torch.from_numpy(s["rids"]), torch.from_numpy(s["csorted"]), to,
        td.rm_zsd, td.rm_pk, td.rm_rd, td.rm_start, torch.from_numpy(rl),
        cross_budget=s["cross"], kvar=P.kvar, zbits=ZB)
    assert int((tp.pair_id < Q * A * 2).sum()) > 100
    for f in jp._fields:
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f


def _records(ovls):
    return [dataclasses.astuple(o) for o in ovls]


def gparts_records(rb, trb, monkeypatch, **kw):
    """(JAX records, port records, the port's gpass log lines) of one -G
    run; tests/test_torch_gpass_*.py share it."""
    msgs = []
    monkeypatch.setattr(gpass, "log", lambda m, *a: msgs.append(m % a))
    jrec = _records(jzmo.overlap_dmo(rb, jzmo.ZmoParams.dmo(**kw),
                                     progress=False))
    trec = _records(tzmo.overlap_dmo(trb, tzmo.ZmoParams.dmo(**kw),
                                     progress=True, device="cpu"))
    return jrec, trec, msgs


def test_gparts_records_equal_jax(banks, monkeypatch):
    """-G 2 at batch_q 8: no budget of the port overflows (so the JAX
    package truncated nothing), and the records are equal (-G 3:
    tests/test_torch_gpass_g3.py)."""
    jrec, trec, msgs = gparts_records(*banks, monkeypatch, batch_q=Q,
                                      ncand=A, gparts=2)
    assert not [m for m in msgs if "budget overflow" in m]
    assert "gpass: 0 redispatches" in msgs
    assert len(trec) > 300
    assert trec == jrec


def test_gparts_refusals(banks):
    """The JAX package's -G path runs the dm engine for -e sw and drops
    the pair ledgers; the port refuses both."""
    rb = banks[1]
    with pytest.raises(NotImplementedError, match="dot-matrix"):
        tzmo.overlap_dmo(rb, tzmo.ZmoParams.dmo(gparts=2, engine="sw"),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="ledgers"):
        tzmo.overlap_dmo(rb, tzmo.ZmoParams.dmo(gparts=2), device="cpu",
                         preattempted=[])
    with pytest.raises(NotImplementedError, match="ledgers"):
        tzmo.overlap_dmo(rb, tzmo.ZmoParams.dmo(gparts=2), device="cpu",
                         attempted_out=[])
