"""The SW (zmo) engine's CIGAR stage in native/cigars.cpp against the plain
helpers it replaced on the main path, which stay the reference: the
run-length encoding (`cigar_rle`) against ops/banded.py traceback_banded,
the counts and CIGAR text (`cigar_strings`) against pipeline/zmo.py
`_cigar_stats` over align_strings, the segments against ReadBank slices,
the padded inputs and bands (`cigar_band`) against make_band_centers, and
`_attach_cigars` on the SW tests' tiny bank against the plain stage, with
refine off and on."""

import dataclasses

import numpy as np
import pytest
import torch

from smartdenovo_tpu_torch.data.readbank import ReadBank, revcomp_codes
from smartdenovo_tpu_torch.ops import align
from smartdenovo_tpu_torch.ops.banded import (banded_align, make_band_centers,
                                              traceback_banded)
from smartdenovo_tpu_torch.pipeline import zmo as tzmo
from smartdenovo_tpu_torch.utils import native, timing
from smartdenovo_tpu_torch.utils.timing import child_seconds
from test_torch_cuda import sw_bank

# (LA, W) of two length tiers; T = 2 (LA + 1) + W, as banded_align's
TIERS = [(2048, 64), (8192, 256)]
CLI_PARAMS = dict(max_zmer_freq=16, min_id=0.1, ncand=16, batch_q=4)


def _moves(rng, LA, W, n):
    """A group's moves [T, n] as banded_align gives them: per overlap a
    stream of runs of 1 (M), 2 (I), 3 (D), then no-ops (0); one empty
    stream, one all-M, and a few no-ops inside a stream besides."""
    T = 2 * (LA + 1) + W
    mvs = np.zeros((T, n), np.int8)
    for k in range(n):
        if k == 1:
            continue                      # an empty traceback
        L = int(rng.integers(1, T + 1)) if k != 2 else T
        if k == 3:
            mvs[:L, k] = 1
            continue
        runs = rng.choice(np.array([1, 1, 1, 2, 3], np.int8), L)
        lens = rng.geometric(0.3, L)
        mvs[:L, k] = np.repeat(runs, lens)[:L]
    holes = rng.random(mvs.shape) < 0.002
    mvs[holes] = 0
    return mvs


def _plain_runs(mvs, j_final):
    cigs, b_beg = traceback_banded(mvs, j_final)
    return [(list(o), list(c)) for o, c in cigs], b_beg


def _native_runs(mvs, j_final):
    ops, counts, offs, b_beg = native.cigar_rle(np.ascontiguousarray(mvs.T),
                                                j_final)
    return [(["MID"[o] for o in ops[offs[k]:offs[k + 1]].tolist()],
             counts[offs[k]:offs[k + 1]].tolist())
            for k in range(len(offs) - 1)], b_beg


@pytest.mark.parametrize("LA,W", TIERS)
@pytest.mark.parametrize("n", [1, 13, 40])
def test_rle_equals_traceback_banded(LA, W, n):
    rng = np.random.default_rng(LA + n)
    mvs = _moves(rng, LA, W, n)
    j_final = rng.integers(-3 * W, LA, n).astype(np.int32)
    j_final[0] = -1
    want, want_b = _plain_runs(mvs, j_final)
    got, got_b = _native_runs(mvs, j_final)
    assert got == want
    assert got_b.tolist() == want_b.tolist()
    assert (want_b >= 0).all() and min(j_final) < 0
    if n > 3:
        assert got[1] == ([], []) and got[3] == (["M"], [int(
            (mvs[:, 3] != 0).sum())])


def test_rle_of_odd_shapes_and_a_bad_code():
    rng = np.random.default_rng(5)
    for T, n in ((1, 1), (7, 3), (9, 9), (31, 17)):
        mvs = rng.integers(0, 4, (T, n)).astype(np.int8)
        j_final = rng.integers(-5, 5, n)
        (got, got_b), (want, want_b) = (_native_runs(mvs, j_final),
                                        _plain_runs(mvs, j_final))
        assert got == want and got_b.tolist() == want_b.tolist()
    mvs[4, 2] = 5
    with pytest.raises(ValueError):
        native.cigar_rle(np.ascontiguousarray(mvs.T), j_final)


def _segments(rng, n, tier):
    """n (query, candidate) code pairs up to `tier` long, every other one
    with N (4) in both (the native counts take another path without)."""
    out = []
    for k in range(n):
        top = 5 if k % 2 else 4
        a = rng.integers(0, top, int(rng.integers(0, tier))).astype(np.uint8)
        b = rng.integers(0, top, int(rng.integers(0, tier))).astype(np.uint8)
        out.append((a, b))
    return out


def _cigar_for(rng, na, nb):
    """Runs that consume at most na query and nb candidate codes."""
    ops, counts, x, y = [], [], 0, 0
    while True:
        op = "MID"[int(rng.integers(0, 3))]
        c = int(rng.geometric(0.25))
        if (op != "D" and x + c > na) or (op != "I" and y + c > nb):
            break
        if ops and ops[-1] == op:
            counts[-1] += c
        else:
            ops.append(op)
            counts.append(c)
        x += c * (op != "D")
        y += c * (op != "I")
    return ops, counts


def _blank(n):
    return [tzmo.Overlap(rid1=0, dir1=0, beg1=0, end1=1, rid2=1, dir2=0,
                         beg2=0, end2=1, score=1, identity=0.5, mat=1, mis=0,
                         ins=0, dl=0, aln=1, cigar="1M") for _ in range(n)]


def _flat(pairs):
    """The pairs as native.Segments (without the slack)."""
    parts = []
    for side in zip(*pairs):
        lens = np.array([len(x) for x in side], np.int64)
        parts += [np.concatenate(side).astype(np.uint8),
                  np.concatenate([[0], np.cumsum(lens)]), lens]
    return native.Segments(*parts)


def _native_stats(pairs, cigs, b_beg, ovls):
    """cigar_strings over runs laid out in reverse order, as the stage
    lays out the groups' runs (not in overlap order), into ovls."""
    segs = _flat(pairs)
    n = len(pairs)
    run_beg, run_end = np.zeros(n, np.int64), np.zeros(n, np.int64)
    ops, counts, r = [], [], 0
    for i in reversed(range(n)):
        o, c = cigs[i]
        run_beg[i], run_end[i] = r, r + len(o)
        r += len(o)
        ops += ["MID".index(x) for x in o]
        counts += c
    stats, offs, text = native.cigar_strings(segs, b_beg, run_beg, run_end,
                                             ops, counts)
    text = text.tobytes().decode("ascii")
    for i in np.flatnonzero(run_end > run_beg):
        m, x, ins, dl, aln = stats[i].tolist()
        ov = ovls[i]
        ov.mat, ov.mis, ov.ins, ov.dl, ov.aln = m, x, ins, dl, aln
        ov.identity = m / max(1, aln)
        ov.cigar = text[offs[i]:offs[i + 1]]
    return int((run_end > run_beg).sum())


@pytest.mark.parametrize("tier", [300, 3000])
def test_strings_equal_cigar_stats(tier):
    rng = np.random.default_rng(tier)
    pairs = _segments(rng, 48, tier)
    b_beg = np.array([int(rng.integers(0, len(b) + 1)) for _, b in pairs])
    b_beg[:3] = [0, len(pairs[1][1]), len(pairs[2][1]) + 5]
    cigs = []
    for k, ((a, b), bb) in enumerate(zip(pairs, b_beg)):
        cigs.append(([], []) if k % 7 == 0 else
                    _cigar_for(rng, len(a), max(0, len(b) - int(bb))))
    # N in both at M columns, and all-N runs of I and D
    cigs[5] = (["M", "I", "D"], [4, 2, 2])
    pairs[5] = (np.array([4, 0, 4, 1, 4, 4], np.uint8),
                np.array([4, 4, 0, 2, 4, 3], np.uint8))
    b_beg[5] = 0
    want, got = _blank(len(pairs)), _blank(len(pairs))
    given = tzmo._cigar_stats(pairs, cigs, b_beg, want)
    assert _native_stats(pairs, cigs, b_beg, got) == given
    assert [dataclasses.astuple(o) for o in got] == [
        dataclasses.astuple(o) for o in want]
    assert want[0].cigar == "1M" and want[5].cigar == "4M2I2D"
    assert (want[5].mat, want[5].mis, want[5].ins, want[5].dl) == (0, 1, 1, 2)
    assert sum(o.cigar == "1M" for o in want) == len(pairs) - given


def test_strings_raise_past_a_segment_end():
    pairs = [(np.zeros(3, np.uint8), np.zeros(5, np.uint8))]
    for cig, bb in (((["M"], [4]), 0), ((["D"], [3]), 3), ((["I"], [4]), 0),
                    ((["M"], [1]), 6)):
        with pytest.raises(IndexError):
            tzmo._cigar_stats(pairs, [cig], np.array([bb]), _blank(1))
        with pytest.raises(IndexError):
            _native_stats(pairs, [cig], np.array([bb]), _blank(1))


def test_segments_equal_readbank_slices():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 5, int(rng.integers(1, 400))).astype(np.uint8)
            for _ in range(12)]
    rb = ReadBank([f"r{k}" for k in range(12)], seqs)
    fields, want = [], []
    for k in range(60):
        r1, r2 = (int(x) for x in rng.integers(0, 12, 2))
        L1, L2 = len(rb.get(r1)), len(rb.get(r2))
        b1, e1 = sorted(int(x) for x in rng.integers(0, L1 + 1, 2))
        b2, e2 = sorted(int(x) for x in rng.integers(0, L2 + 1, 2))
        if k == 0:
            b2, e2 = 0, L2                    # a whole read
        d2 = k % 2
        fields.append((r1, b1, e1, r2, d2, b2, e2))
        cb = rb.get(r2)
        want.append((rb.get(r1)[b1:e1],
                     (revcomp_codes(cb) if d2 else cb)[b2:e2]))
    segs = native.cigar_segments(rb.bases, rb.offsets, fields)
    for i, (qa, cb) in enumerate(want):
        assert segs.query(i).tolist() == qa.tolist()
        assert segs.cand(i).tolist() == cb.tolist()
    assert segs.alen.tolist() == [len(q) for q, _ in want]
    # an N of a reverse-complemented candidate is 3 - 4 in uint8, as there
    assert 255 in segs.c and 4 in segs.c
    # a read id outside the bank, a span past its read's end or before
    # its start, one that ends before it begins
    L0 = len(rb.get(0))
    for bad in ((12, 0, 1, 0, 0, 0, 1), (0, 0, 1, -1, 1, 0, 1),
                (0, 0, 1, 0, 1, 1, L0 + 1), (0, -1, 1, 0, 0, 0, 1),
                (0, 2, 1, 0, 0, 0, 1)):
        with pytest.raises(IndexError):
            native.cigar_segments(rb.bases, rb.offsets, [fields[1], bad])


@pytest.mark.parametrize("W", [1, 64, 255, 256])
def test_band_equals_make_band_centers(W):
    LA = 2048
    rng = np.random.default_rng(W)
    alen = [0, 0, 5, 2048, 2048, 1000, 1, 1999, 700, 1500]
    blen = [0, 300, W // 2 - 1 if W > 2 else 0, 1, 2048, 3000, 7, 1999,
            W // 2, 1200]
    alen += [int(x) for x in rng.integers(0, LA + 1, 30)]
    blen += [int(x) for x in rng.integers(0, 2 * LA, 30)]
    pairs = [(rng.integers(0, 5, a).astype(np.uint8),
              rng.integers(0, 5, b).astype(np.uint8))
             for a, b in zip(alen, blen)]
    segs = _flat(pairs)
    idx = np.arange(len(pairs))[::-1].copy()
    a, b, base = native.cigar_band(segs, idx, LA, W)
    al, bl = np.array(alen)[idx], np.array(blen)[idx]
    want = make_band_centers([[(0, 0), (x, y)] for x, y in zip(al, bl)],
                             al, bl, LA, W)
    assert base.dtype == want.dtype and np.array_equal(base, want)
    assert b.shape == (len(pairs), max(bl.max(), 1))
    for k, i in enumerate(idx):
        qa, cb = pairs[i]
        assert np.array_equal(a[k], np.concatenate(
            [qa, np.full(LA - len(qa), 4, np.uint8)]))
        assert np.array_equal(b[k], np.concatenate(
            [cb, np.full(b.shape[1] - len(cb), 4, np.uint8)]))
    # a group whose candidates are all empty still gets a column
    _a, b1, _b = native.cigar_band(segs, np.array([0]), LA, W)
    assert b1.shape == (1, 1) and b1[0, 0] == 4


def _plain_cigar_calls(rb, p, ovls, dev):
    """The CIGAR stage as it ran before native/cigars.cpp: per overlap
    segments, make_band_centers, traceback_banded and `_cigar_stats`."""
    from smartdenovo_tpu_torch.ops.refine import refine_alignment_batch

    segs = []
    for ov in ovls:
        qa = rb.get(ov.rid1)[ov.beg1:ov.end1]
        cb = rb.get(ov.rid2)
        if ov.dir2:
            cb = revcomp_codes(cb)
        segs.append((qa, cb[ov.beg2:ov.end2]))
    B = len(segs)
    alen = np.array([len(x) for x, _ in segs], np.int32)
    blen = np.array([len(y) for _, y in segs], np.int32)
    W = p.band_w
    cigs, b_begs = [None] * B, np.zeros(B, np.int64)
    end_col = np.zeros(B, np.int64)
    for idx, LA in align.tier_chunks(alen, align.plane_fits(W)):
        n = len(idx)
        a = np.full((n, LA), 4, np.uint8)
        b = np.full((n, max(int(blen[idx].max()), 1)), 4, np.uint8)
        anchors = []
        for k, i in enumerate(idx):
            qa, cb = segs[i]
            a[k, : len(qa)] = qa
            b[k, : len(cb)] = cb
            anchors.append([(0, 0), (len(qa), len(cb))])
        base = make_band_centers(anchors, alen[idx], blen[idx], LA, W)
        _score, ecol, _dirs, mvs, j_final = banded_align(
            *(torch.from_numpy(x).to(dev)
              for x in (a, b, alen[idx], blen[idx], base)),
            LA=LA, W=W, match=p.sw_match, mismatch=p.sw_mismatch,
            gap=p.sw_gap, semiglobal_b=True)
        mvs, j_final, ecol = (t.cpu().numpy() for t in (mvs, j_final, ecol))
        cg, bb = traceback_banded(mvs, j_final)
        for k, i in enumerate(idx):
            cigs[i] = cg[k]
        b_begs[idx] = bb
        end_col[idx] = ecol
    if p.refine:
        rpairs, rcigs, rmap = [], [], []
        for i in range(B):
            ops, counts = cigs[i]
            seg_b = segs[i][1][int(b_begs[i]): int(end_col[i])]
            if not ops or seg_b.size == 0 or int(alen[i]) == 0:
                continue
            rpairs.append((segs[i][0], seg_b))
            rcigs.append((ops, counts))
            rmap.append(i)
        for i, r in zip(rmap, refine_alignment_batch(
                rpairs, rcigs, W_base=64, match=p.sw_match,
                mismatch=p.sw_mismatch, open_i=p.sw_gap, open_d=p.sw_gap,
                ext=-1, device=dev)):
            cigs[i] = (r["ops"], r["counts"])
    return tzmo._cigar_stats(segs, cigs, b_begs, ovls)


@pytest.fixture(scope="module")
def sw_overlaps():
    """The SW overlaps of the tiny bank as the emission gives them, before
    their CIGARs."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rb = ReadBank(*sw_bank())
        p = tzmo.ZmoParams.zmo(emit_cigar=False, **CLI_PARAMS)
        return rb, tzmo.overlap_reads(rb, p, progress=False, device="cpu")
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("refine", [False, True])
def test_attach_cigars_equals_the_plain_stage(sw_overlaps, refine):
    rb, ovls = sw_overlaps
    assert len(ovls) > 30 and all(o.cigar == f"{o.aln}M" for o in ovls)
    p = tzmo.ZmoParams.zmo(refine=refine, **CLI_PARAMS)
    # an overlap whose query segment is empty: its traceback is empty and
    # it keeps its record
    ovls = ovls[:24] + [dataclasses.replace(ovls[0], end1=ovls[0].beg1)]
    want = [dataclasses.replace(o) for o in ovls]
    got = [dataclasses.replace(o) for o in ovls]
    given = _plain_cigar_calls(rb, p, want, torch.device("cpu"))
    sp = tzmo._attach_cigars(rb, p, got, device="cpu")
    split = child_seconds([sp])
    assert sp.counts["overlaps"] == given == len(ovls) - 1
    assert [dataclasses.astuple(o) for o in got] == [
        dataclasses.astuple(o) for o in want]
    assert got[-1] == ovls[-1] and got[0].cigar != ovls[0].cigar
    assert {"segs", "centers", "banded", "banded_rle", "strings"} <= set(split)
    assert ("refine" in split) == refine


def _stage_pairs(rng):
    """Query and target pairs for the batched stage: targets are their
    query mutated (10% substitutions, insertions and deletions) between
    random flanks, one query past the 2,048 tier, one of them empty."""
    pairs = []
    for al in (700, 0, 350, 2300, 520, 90, 610, 430):
        a = rng.integers(0, 4, al).astype(np.uint8)
        core = []
        for x in a.tolist():
            r = rng.random()
            if r < 0.04:
                core.append(int(rng.integers(0, 4)))
            elif r < 0.07:
                continue
            elif r < 0.10:
                core += [x, int(rng.integers(0, 4))]
            else:
                core.append(x)
        flank = [rng.integers(0, 4, int(rng.integers(0, 60))) for _ in "lr"]
        b = np.concatenate([flank[0], core, flank[1]]).astype(np.uint8)
        pairs.append((a, b, len(flank[0])))
    return pairs


@pytest.mark.parametrize("case", ["anchors", "no_anchors", "small_cap"])
def test_stage_equals_the_plain_per_row_path(case, monkeypatch):
    """ops/align.py banded_runs against each pair alone through
    make_band_centers, banded_align and traceback_banded at the pair's own
    tier: the same runs, start and end columns and scores; with a cap
    small enough to take two pairs a call, more calls in one tier."""
    rng = np.random.default_rng(21)
    W = 64
    trip = _stage_pairs(rng)
    pairs = [(a, b) for a, b, _ in trip]
    anchors = None
    if case == "anchors":
        anchors = [[(x, x + f) for x in range(0, len(a), 150)]
                   for a, _b, f in trip]
        anchors[2] = []
    if case == "small_cap":
        monkeypatch.setattr(align, "DIRS_CAP", 2 * (2048 + 1) * W)
    segs = native.Segments.from_pairs(pairs)
    assert segs.alen.tolist() == [len(a) for a, _ in pairs]
    assert all(np.array_equal(segs.cand(i), b)
               for i, (_a, b) in enumerate(pairs))
    with timing.span("outer") as outer:
        r = align.banded_runs(segs, W, anchors=anchors, device="cpu")
    got = align.run_lists(r.ops, r.counts, r.run_beg, r.run_end)
    for i, (a, b) in enumerate(pairs):
        LA = align.pad_tier(len(a))
        ap = np.full((1, LA), 4, np.uint8)
        ap[0, :len(a)] = a
        al = np.array([len(a)], np.int32)
        bl = np.array([len(b)], np.int32)
        anc = anchors[i] if anchors else [(0, 0), (len(a), len(b))]
        base = make_band_centers([anc], al, bl, LA, W)
        sc, ecol, _d, mvs, j_final = banded_align(
            *(torch.from_numpy(x) for x in (ap, b[None], al, bl, base)),
            LA=LA, W=W, semiglobal_b=True)
        (cig,), b_beg = traceback_banded(mvs.numpy(), j_final.numpy())
        assert got[i] == (list(cig[0]), list(cig[1])), i
        assert (r.b_beg[i], r.end_col[i], r.score[i]) == (
            b_beg[0], ecol[0], sc[0]), i
    assert got[1] == ([], []) and all(got[k][0] for k in (0, 2, 3))
    kids = [s for s in timing.RECORDER.spans if s.parent == outer.id]
    assert [s.name for s in kids] == ["centers", "banded",
                                      "banded_rle"] * r.calls
    assert sum(s.counts["overlaps"] for s in kids
               if s.name == "banded_rle") == len(pairs)
    assert r.calls == (5 if case == "small_cap" else 2)


def test_refine_decode_equals_traceback_refine():
    """The refine DPs' moves (0 M, 1 I, 2 D, 3 no-op), mapped onto
    banded_align's codes and run-length encoded by cigar_rle, equal
    traceback_refine; and refine_alignment_batch, which decodes so, equals
    each pair refined alone and decoded by traceback_refine, in input
    order."""
    from smartdenovo_tpu_torch.ops import refine

    rng = np.random.default_rng(8)
    T, n = 400, 9
    mvs = np.full((T, n), 3, np.int8)
    for k in range(1, n):
        L = int(rng.integers(1, T + 1))
        mvs[:L, k] = np.repeat(rng.integers(0, 3, L),
                               rng.geometric(0.3, L))[:L]
    mvs[rng.random(mvs.shape) < 0.01] = 3
    ops, counts, offs, b_beg = native.cigar_rle(refine.BANDED_MOVES[mvs.T],
                                                np.zeros(n, np.int64))
    got = align.run_lists(ops, counts, offs[:-1], offs[1:])
    assert got == [(list(o), list(c)) for o, c in refine.traceback_refine(mvs)]
    assert got[0] == ([], []) and not b_beg.any()

    trip = _stage_pairs(rng)[:6]
    pairs = [(a, b[f:f + len(a)]) for a, b, f in trip]
    cigars = [(["M"], [max(len(a), len(b), 1)]) for a, b in pairs]
    res = refine.refine_alignment_batch(pairs, cigars, device="cpu")
    W = refine.band_tier(cigars, 64)
    for k, (a, b) in enumerate(pairs):
        LA = align.pow2_tier(len(a))
        ap = np.full((1, LA), 4, np.uint8)
        ap[0, :len(a)] = a
        bp = np.full((1, len(b) + 1), 4, np.uint8)
        bp[0, :len(b)] = b
        al = np.array([len(a)], np.int32)
        bl = np.array([len(b)], np.int32)
        base = refine.band_from_cigar([cigars[k]], al, bl, LA, W)
        sc, _d, mv = refine.refine_banded_affine(
            *(torch.from_numpy(x) for x in (ap, bp, al, bl, base)),
            LA=LA, W=W)
        (want,) = refine.cigar_stats([(a, b)], refine.traceback_refine(
            mv.numpy()), sc.numpy())
        assert res[k] == want, k
