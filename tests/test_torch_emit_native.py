"""The dm engine's native emission (native/emitdm.cpp through
pipeline/zmo.py _emit_dm) against _emit_batch_dm, the Python copy of the
JAX package's emission: after every batch, the records and their order,
the coverage array, the emitted-pair set and the attempted pairs (their
names and order) are the same.  On the CPU dm pass of the 30 kb / 10x
simulation of tests/test_torch_overlap_asm.py, with and without the pair
ledgers, and on synthetic batches built to reach the edges; two broken
builds of the native source (the emitted-pair dedup dropped, the min_id
gate rounded) must be told apart."""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

from smartdenovo_tpu_torch.data.readbank import ReadBank
from smartdenovo_tpu_torch.pipeline import zmo
from smartdenovo_tpu_torch.utils import native
from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads
from smartdenovo_tpu_torch.utils.timing import RECORDER

torch.set_num_threads(1)

BIGP = 0x7FFFFFFF
REAL_EMIT_DM = zmo._emit_dm


def _pre_pairs(rb, preattempted):
    """_dm_pass's id pairs of a -L ledger."""
    out = set()
    for n1, n2 in preattempted or ():
        i1, i2 = rb.name2id.get(n1), rb.name2id.get(n2)
        if i1 is not None and i2 is not None:
            out.add((min(i1, i2), max(i1, i2)))
    return out


class Checked:
    """In the place of _emit_dm: runs _emit_batch_dm on state of its own
    beside each native batch and notes, after every batch, what differs
    (`faults`), the returned counts against the Python extraction's rows
    included.  `passed_nbest` counts the queries that gained more counted
    overlaps in a batch than they lacked of nbest at its start,
    `fewer_candidates` the batches with fewer candidate rows than
    attempted rows."""

    def __init__(self, rb, p, pre_pairs=()):
        self.rb, self.p = rb, p
        self.rdcovs = np.zeros(len(rb), np.int64)
        self.emitted: set = set()
        self.pre = set(pre_pairs)
        self.batches = self.records = self.passed_nbest = 0
        self.fewer_candidates = 0
        self.faults: list = []

    def __call__(self, em, rb, rids, row, csorted, Q, A, rdcovs, overlaps,
                 attempted_out, pd=None):
        start = self.rdcovs.copy()
        want, want_att = [], None if attempted_out is None else []
        zmo._emit_batch_dm(rb, self.p, rids, row, csorted, Q, A, self.rdcovs,
                           np.zeros(len(rb), bool), want, self.emitted,
                           self.pre, want_att, rb.avg_len(), pd=pd)
        n0 = len(overlaps)
        a0 = 0 if attempted_out is None else len(attempted_out)
        counts = REAL_EMIT_DM(em, rb, rids, row, csorted, Q, A, rdcovs,
                              overlaps, attempted_out, pd=pd)
        bi = self.batches
        cand_arr, att_arr = zmo._extract_candidates_dm(
            rb, self.p, rids, row, csorted, Q, A, rb.avg_len(), pd=pd)
        if counts != (len(cand_arr), len(att_arr)):
            self.faults.append((bi, "counts"))
        self.fewer_candidates += len(cand_arr) < len(att_arr)
        if ([dataclasses.astuple(o) for o in overlaps[n0:]]
                != [dataclasses.astuple(o) for o in want]):
            self.faults.append((bi, "records"))
        if not np.array_equal(rdcovs, self.rdcovs):
            self.faults.append((bi, "rdcovs"))
        if set(map(tuple, em.pairs().tolist())) != self.emitted:
            self.faults.append((bi, "emitted"))
        if attempted_out is not None and attempted_out[a0:] != want_att:
            self.faults.append((bi, "attempted"))
        gained: dict = {}
        for o in want:
            x = (min(o.beg1, o.beg2) + min(rb.lengths[o.rid1] - o.end1,
                                           rb.lengths[o.rid2] - o.end2))
            if x <= self.p.max_unalign_dovetail:
                gained[o.rid1] = gained.get(o.rid1, 0) + 1
        self.passed_nbest += sum(
            g > zmo._nbest_of(self.p, rb.lengths[r], rb.avg_len()) - start[r]
            for r, g in gained.items())
        self.batches += 1
        self.records += len(want)
        return counts


# --------------------------------------------------- the CPU dm pass


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(11)
    g = random_genome(rng, 30000)
    return ReadBank(*simulate_reads(g, coverage=10, mean_len=5000, err=0.13,
                                    seed=12))


@pytest.mark.parametrize("ledgers", [False, True])
def test_dm_pass_equals_the_python_copy(bank, ledgers, monkeypatch):
    p = zmo.ZmoParams.dmo(batch_q=8, ncand=64)
    plain = zmo.overlap_dmo(bank, p, progress=False, device="cpu")
    pre = None
    if ledgers:
        # every third emitted pair goes to the -L ledger
        pre = [(bank.names[o.rid1], bank.names[o.rid2]) for o in plain[::3]]
    chk = Checked(bank, p, _pre_pairs(bank, pre))
    monkeypatch.setattr(zmo, "_emit_dm", chk)
    att = [] if ledgers else None
    got = zmo.overlap_dmo(bank, p, progress=False, preattempted=pre,
                          attempted_out=att, device="cpu")
    assert chk.faults == []
    assert chk.batches == -(-len(bank) // 8) and chk.records == len(got)
    if ledgers:
        assert len(att) > len(got) > 50 and len(got) < len(plain)
    else:
        assert len(got) > 50
        assert ([dataclasses.astuple(o) for o in got]
                == [dataclasses.astuple(o) for o in plain])


def test_emission_span_counts(bank):
    p = zmo.ZmoParams.dmo(batch_q=8, ncand=64)
    out = zmo.overlap_dmo(bank, p, progress=False, device="cpu")
    em = next(s for s in reversed(RECORDER.spans) if s.name == "zmo.emission")
    B = -(-len(bank) // 8)
    assert em.counts["native"] == B
    assert em.counts["records"] == len(out) > 50
    assert em.counts["attempted"] >= em.counts["candidates"] >= len(out)
    kids = [s for s in RECORDER.spans if s.parent == em.id]
    assert [s.name for s in kids] == ["emit_native", "records"] * B
    assert sum(s.seconds for s in kids) <= em.seconds


# --------------------------------------------------- synthetic batches


def _synth_batch(rb, rng, rids, Q, A, pd, plant):
    """The packed row and csorted of queries `rids` (padded to Q with the
    last one): half to all slots live, 70% of their strands with a row,
    scores from a small set (ties), a fifth of the rows dovetails, match
    counts around the ztot gate (30).  pd None: the positional layout.
    `plant`: (q, slot, cand, score, tb, te, qb, qe) put on strand 0, the
    slot's strand 1 without a row and its matches past the gate."""
    n = len(rb)
    rids = np.concatenate([rids, np.full(Q - len(rids), rids[-1])]).astype(
        np.int32)
    NP = Q * A * 2
    csorted = np.full((Q, A), BIGP, np.int32)
    planted = {(q, s): r for q, s, *r in plant}
    for q in range(Q):
        # a planted candidate in no other slot of its query
        free = np.setdiff1d(np.arange(n), [r[0] for (q2, _s), r in
                                           planted.items() if q2 == q])
        k = int(rng.integers(A // 2, A + 1))
        csorted[q, :k] = np.sort(rng.choice(free, k, replace=False))
    for (q, s), r in planted.items():
        csorted[q, s] = r[0]
    rows = []
    for q in range(Q):
        qlen = int(rb.lengths[rids[q]])
        for s in range(A):
            c = int(csorted[q, s])
            if c >= n:
                continue
            if (q, s) in planted:
                rows.append(((q * A + s) * 2, *planted[(q, s)][1:]))
                continue
            clen = int(rb.lengths[c])
            for d in (0, 1):
                if rng.random() < 0.3:
                    continue
                a0 = int(rng.integers(0, qlen // 2))
                a1 = int(rng.integers(a0, qlen + 1))
                b0 = int(rng.integers(0, clen // 2))
                b1 = int(rng.integers(b0, clen + 1))
                if rng.random() < 0.2:
                    a1, b0 = qlen, 0
                sc = int(rng.choice([0, 150, 300, 300, 450, 900, 2000]))
                rows.append(((q * A + s) * 2 + d, sc, a0, a1, b0, b1))
    rows = [rows[i] for i in rng.permutation(len(rows))]
    W = NP if pd is None else pd
    cols = np.zeros((6, W), np.int64)
    cols[0] = BIGP
    for j, r in enumerate(rows):
        cols[:, r[0] if pd is None else j] = r
    match = rng.integers(0, 40, NP)
    for q, s, *_r in plant:
        match[(q * A + s) * 2: (q * A + s) * 2 + 2] = 20
    row = np.concatenate([cols.reshape(-1), match, np.zeros(4, np.int64)])
    return rids, row.astype(np.int32), csorted


def _synth_pass(seed, nbest, layout):
    """Eight batches of 8 queries (A 48) on a bank of 120 reads of 2-12 kb;
    returns the Checked state and the records and attempted pairs."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2000, 12000, 120)
    rb = ReadBank([f"r{i:03d}" for i in range(120)],
                  [np.zeros(k, np.uint8) for k in lens], sort=False)
    Q, A = 8, 48
    p = zmo.ZmoParams.dmo(batch_q=Q, ncand=A, ztot=300, min_score=100,
                          nbest=nbest, max_unalign_dovetail=500)
    pre = {(3, 40), (0, 1), (17, 60), (5, 9), (90, 100)}
    chk = Checked(rb, p, pre)
    em = zmo._dm_emission(rb, p, rb.avg_len(), pre)
    rdcovs = np.zeros(len(rb), np.int64)
    overlaps, att = [], []
    batches = [np.arange(i, i + Q) for i in range(0, 64, Q)]
    # (3, 17) from both sides within batch 1, (40, 90) across batches 1
    # and 4 (its last batch is short: padded with its last query)
    batches[1] = np.array([17, 3, 40, 8, 9, 10, 11, 12])
    batches[4] = np.array([90, 41, 42, 43, 44, 45])
    for bi, rids in enumerate(batches):
        ids = [int(r) for r in rids]
        # each query its own candidate in slot 0
        plant = [(q, 0, r, 2000, 10, 1500, 10, 1500) for q, r in
                 enumerate(ids)]
        for a, b in ((3, 17), (17, 3), (40, 90), (90, 40), (3, 40)):
            if a in ids:
                plant.append((ids.index(a), 1, b, 900, 0, 1000, 0, 1000))
        # w == int(min_id * ol): 0.1 * 1237 = 123.7, truncated to 123
        plant.append((len(ids) - 1, 2, 119 - bi, 123, 0, 1237, 5, 1000))
        # equal scores in one query: slot order holds
        plant += [(2, 3 + j, 100 + j, 450, 7, 2007, 9, 1800)
                  for j in range(4)]
        # the pair-row width: the positional layout, or a dense width
        # that batch 3 grew in a redispatch
        pd = None if layout == "positional" else (2048 if bi == 3 else 1024)
        r32, row, cs = _synth_batch(rb, rng, rids, Q, A, pd, plant)
        chk(em, rb, r32, row, cs, Q, A, rdcovs, overlaps, att, pd=pd)
    return chk, overlaps, att


@pytest.mark.parametrize("seed,nbest,layout", [
    (1, 2, "dense"), (2, 100, "dense"), (3, 2, "positional"),
    (4, 100, "positional")])
def test_synthetic_batches_equal_the_python_copy(seed, nbest, layout):
    chk, overlaps, att = _synth_pass(seed, nbest, layout)
    assert chk.faults == []
    assert chk.batches == 8 and len(overlaps) == chk.records > 100
    assert chk.fewer_candidates == 8
    assert len(att) > len(overlaps)
    recs = {(o.rid1, o.rid2): o for o in overlaps}
    assert not any(o.rid1 == o.rid2 for o in overlaps)
    assert (3, 40) not in recs and (40, 3) not in recs
    if nbest == 100:
        # the exact min_id case, one a batch (no random row scores 123);
        # one side of (3, 17) and of (40, 90)
        assert sum(o.score == 123 for o in overlaps) == 8
        assert ((3, 17) in recs) + ((17, 3) in recs) == 1
        assert ((40, 90) in recs) + ((90, 40) in recs) == 1
    else:
        assert chk.passed_nbest > 0


def _broken_lib(tmp_path, old, new):
    with open(f"{native._NATIVE}/emitdm.cpp") as fh:
        src = fh.read()
    assert src.count(old) == 1
    path = tmp_path / "emitdm_broken.cpp"
    path.write_text("#include <cmath>\n" + src.replace(old, new))
    so = tmp_path / "libemitdm_broken.so"
    subprocess.run(["g++", *native._FLAGS, "-o", str(so), str(path)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("old,new", [
    ("if (e.emitted.contains(key)) continue;", ""),
    ("(int64_t)(e.min_id * (double)ol)",
     "(int64_t)std::llround(e.min_id * (double)ol)")])
def test_broken_builds_are_told_apart(tmp_path, monkeypatch, old, new):
    monkeypatch.setitem(native._CACHE, "emitdm",
                        _broken_lib(tmp_path, old, new))
    chk, _overlaps, _att = _synth_pass(2, 100, "dense")
    assert any(f == "records" for _bi, f in chk.faults)


def test_refusals():
    rb = ReadBank(["a", "b"], [np.zeros(100, np.uint8)] * 2, sort=False)
    p = zmo.ZmoParams.dmo(batch_q=1, ncand=2)
    with pytest.raises(IndexError):
        zmo._dm_emission(rb, p, rb.avg_len(), {(0, 2)})
    em = zmo._dm_emission(rb, p, rb.avg_len())
    row = np.zeros(6 * 4 + 4, np.int32)
    cs = np.array([[1, BIGP]], np.int32)
    with pytest.raises(ValueError):        # coverage of another dtype
        em.batch(np.array([0], np.int32), row, cs, 1, 2,
                 np.zeros(2, np.int32))
    with pytest.raises(IndexError):        # a query outside the bank
        em.batch(np.array([2], np.int32), row, cs, 1, 2,
                 np.zeros(2, np.int64))
    assert em.pairs().shape == (0, 2)
