"""The consensus's native segment stitcher (native/stitch.cpp through
pipeline/cns.py `_stitch_native`) against the plain `_stitch_reads`, on
the CPU: every yielded read (rid, score, beg, end, ra, rb), the column
maps left in the segment state and the fallback line are equal, on the
two rounds of the 12 kb unit of tests/test_cns.py (the segment DP's
plain version in the loop) and on hand-made move streams that reach each
branch of the stitcher."""

import copy

import numpy as np
import pytest
import torch

from smartdenovo_tpu_torch.pipeline import cns
from smartdenovo_tpu_torch.utils import native
from test_torch_cuda import unit_12kb

P = cns.CnsParams()


# ------------------------------------------------------------ the harness


def _run(stitch, case, monkeypatch):
    """(yields, column maps, log lines) of one stitcher on a copy of the
    case's segment state."""
    st = copy.copy(case["st"])
    st.colmap16 = list(case["st"].colmap16)
    lines = []
    monkeypatch.setattr(cns, "log", lambda m, *a: lines.append(m % a))
    out = list(stitch(case["unit"], st, case["spans"], case["arr"],
                      case["b_beg"], case["mv_all"], case["cns_pad"],
                      case["Lc"], P, case["open_i"], case["open_d"]))
    return out, st.colmap16, lines


def _same(got, exp):
    gy, gc, gl = got
    ey, ec, el = exp
    assert [y[:4] for y in gy] == [y[:4] for y in ey]
    for g, e in zip(gy, ey):
        assert [type(v) for v in g[:4]] == [type(v) for v in e[:4]]
        for a, b in zip(g[4:], e[4:]):
            assert a.dtype == b.dtype == np.uint8
            assert np.array_equal(a, b)
    assert len(gc) == len(ec)
    for a, b in zip(gc, ec):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype == np.int64
            assert np.array_equal(a, b)
    assert gl == el


# ----------------------------------------------- the 12 kb unit's rounds


@pytest.fixture(scope="module")
def rounds_12kb():
    """The stitcher's inputs in both rounds of the 12 kb unit at n_iter 2,
    each with the column maps as they were before it ran."""
    got = []
    real = cns._stitch_native

    def record(unit, st, spans, arr, b_beg, mv_all, cns_pad, Lc, p, oi, od,
               counts=None):
        before = copy.copy(st)
        before.colmap16 = list(st.colmap16)
        got.append(dict(unit=unit, st=before, spans=spans, arr=arr,
                        b_beg=b_beg, mv_all=mv_all, cns_pad=cns_pad, Lc=Lc,
                        open_i=oi, open_d=od))
        return real(unit, st, spans, arr, b_beg, mv_all, cns_pad, Lc, p,
                    oi, od, counts)

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(cns, "_stitch_native", record)
    try:
        cns.consensus_unitig(unit_12kb(), cns.CnsParams(n_iter=2),
                             device="cpu")
    finally:
        mp.undo()
        torch.set_num_threads(n)
    assert len(got) == 2
    return got


# ------------------------------------------------ hand-made move streams
#
# A round of reads of `SEG`-row segments overlapping as the program's do
# (stride SEG - 2 * OVL), each cut from one forward path of the whole read
# against the consensus, so adjacent segments share their columns unless
# a case moves or breaks one.

SEG, OVL, T, LC = 256, 64, 509, 4000
M, I, D = 0, 1, 2


def _path(rng, rows, p_ins=0.08, p_del=0.08):
    """A forward move path with `rows` row moves, random I and D."""
    mv = []
    for _ in range(rows):
        while rng.random() < p_del:
            mv.append(D)
        mv.append(I if rng.random() < p_ins else M)
    return np.array(mv, np.int8)


def _cut_rows(mv, rows):
    """Length of the prefix of mv that holds `rows` row moves."""
    seen = 0
    for k, m in enumerate(mv):
        seen += m != D
        if seen == rows:
            return k + 1
    raise ValueError("too few rows")


def _periodic(rows):
    """M D M I repeated up to `rows` row moves: any four column moves
    hold an M and a D."""
    mv = [M, D, M, I] * rows
    return np.array(mv[: _cut_rows(mv, rows)], np.int8)


def _segments(rl):
    if rl < 64:
        return []
    S = 1 if rl <= SEG else int(np.ceil((rl - SEG) / (SEG - 2 * OVL))) + 1
    return [(r0, min(SEG, rl - r0)) for r0 in
            (min(s * (SEG - 2 * OVL), max(0, rl - SEG)) for s in range(S))]


def _round(reads):
    """The stitcher's inputs for `reads`: dicts of rl, c0 (consensus column
    of the first row) and optionally path, segs [(r0, alen)], shift {s:
    columns added to segment s's start}, drop_row {s} (a row move taken
    out of segment s), split_row {s: k} (segment s's row k passes another
    column)."""
    rng = np.random.default_rng(7)
    codes, spans, arr, b_beg, streams = [], [], [], [], []
    for rid, r in enumerate(reads):
        rl = r["rl"]
        codes.append(rng.integers(0, 5, rl).astype(np.uint8))
        path = r.get("path")
        if path is None:
            path = _path(rng, rl)
        rmi = np.nonzero(path != D)[0]
        colb = r["c0"] + np.cumsum(path != I) - (path != I)
        segs = r.get("segs", _segments(rl))
        spans.append((len(arr), len(segs), [r0 for r0, _ in segs]))
        for s, (r0, alen) in enumerate(segs):
            lo = rmi[r0]
            hi = rmi[r0 + alen] if r0 + alen < rl else len(path)
            mv = path[lo:hi]
            if s in r.get("drop_row", ()):
                mv = np.delete(mv, np.nonzero(mv != D)[0][alen // 2])
            if s in r.get("split_row", {}):
                # the row's M as D then I: the same rows and columns on
                # either side, another column at the row
                k = np.nonzero(mv != D)[0][r["split_row"][s]]
                assert mv[k] == M
                mv = np.concatenate([mv[:k], [D, I], mv[k + 1:]]).astype(
                    np.int8)
            start = int(colb[lo]) + r.get("shift", {}).get(s, 0)
            w0 = max(0, start - 100)
            arr.append((rid, r0, alen, w0, 3 * SEG))
            b_beg.append(start - w0)
            stream = np.full(T, 3, np.uint8)
            stream[: len(mv)] = mv[::-1]
            streams.append(stream)
    unit = cns.LayUnitig(name="syn", reads=codes, offs=[r["c0"]
                                                        for r in reads],
                         backbone=[True] * len(reads))
    st = cns._SegState(unit)
    for rid, r in enumerate(reads):
        st.reset_colmap(rid, r["c0"])
    cns_pad = np.full(LC + 512, 4, np.uint8)
    cns_pad[:LC] = rng.integers(0, 4, LC)
    return dict(unit=unit, st=st, spans=spans,
                arr=np.asarray(arr, np.int64).reshape(-1, 5),
                b_beg=np.asarray(b_beg, np.int32),
                mv_all=np.asarray(streams, np.uint8).reshape(-1, T),
                cns_pad=cns_pad, Lc=LC, open_i=P.gap_ins, open_d=P.gap_del)


CLEAN = [dict(rl=700, c0=100), dict(rl=420, c0=900)]
# each case: its reads (two clean ones first), the plain stitcher's status
# of each read (S stitched, R reseeded, K skipped) and its fallbacks
CASES = {
    # the second segment starts 5 columns late: no shared column, the
    # gap bridged with deletions
    "fallback_bridges": ([*CLEAN, dict(rl=300, c0=1500, shift={1: 5})],
                         "SSS", 1),
    # it starts 4 columns early: the next piece sheds 4 column moves,
    # M -> I and D dropped
    "head_fix_sheds": ([*CLEAN, dict(rl=300, c0=2000, path=_periodic(300),
                                     shift={1: -4})], "SSS", 1),
    # no shared column at the zone's middle row (64 of 128), but one row
    # to either side: the first of the two
    "junction_tie": ([*CLEAN, dict(rl=384, c0=1500,
                                   path=np.zeros(384, np.int8),
                                   split_row={1: 64})], "SSS", 0),
    # far too early: the last piece is shorter than what it must shed
    "head_fix_too_long": ([*CLEAN, dict(rl=600, c0=2500,
                                        shift={3: -3000})], "SSR", 1),
    "rows_differ": ([*CLEAN, dict(rl=600, c0=1500, drop_row={1})], "SSR",
                    0),
    # the second segment starts where the first ends: no junction zone
    "empty_zone": ([*CLEAN, dict(rl=400, c0=1500,
                                 segs=[(0, 200), (200, 200)])], "SSR", 0),
    "overrun": ([*CLEAN, dict(rl=600, c0=LC - 300)], "SSR", 0),
    # the first column before the consensus: its codes clipped to column 0
    "starts_before_consensus": ([*CLEAN, dict(rl=400, c0=-6)], "SSS", 0),
    "short_read": ([*CLEAN, dict(rl=50, c0=1500)], "SSK", 0),
    "single_segment": ([dict(rl=256, c0=100), dict(rl=64, c0=600),
                        dict(rl=200, c0=900)], "SSS", 0),
}


def _case(name):
    reads, status, fallbacks = CASES[name]
    return _round(reads), status, fallbacks


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("name", ["round_1", "round_2", *CASES])
def test_native_stitcher_equals_plain(name, rounds_12kb, monkeypatch):
    if name.startswith("round_"):
        case = rounds_12kb[int(name[-1]) - 1]
    else:
        case, status, fallbacks = _case(name)
    exp = _run(cns._stitch_reads, case, monkeypatch)
    got = _run(cns._stitch_native, case, monkeypatch)
    _same(got, exp)
    if name.startswith("round_"):
        # the segment DP's layout: a segment a column
        assert case["mv_all"].strides == (1, case["mv_all"].shape[0])
        assert len(exp[0]) > 20
        return
    # the same streams a segment a column, as the segment DP lays them out
    case["mv_all"] = np.asfortranarray(case["mv_all"])
    _same(_run(cns._stitch_native, case, monkeypatch), exp)
    # the case reaches the branch it is named for
    yielded = {y[0] for y in exp[0]}
    before = case["st"].colmap16
    for rid, s in enumerate(status):
        assert (rid in yielded) == (s == "S"), (rid, s)
        assert (exp[1][rid] is None) == (s == "R"), (rid, s)
        if s == "K":
            assert exp[1][rid] is before[rid]
    assert exp[2] == ([f"cns syn: {fallbacks} stitch fallbacks (no shared "
                       "column in overlap)"] if fallbacks else [])


def test_stitch_round_raises_on_an_index_out_of_range():
    """Spans past the segment arrays raise, as the plain stitcher's
    numpy indexing does, and bad shapes are refused."""
    case, _, _ = _case("single_segment")
    st = case["st"]
    args = dict(r0=case["arr"][:, 1], mv_all=case["mv_all"],
                arr=case["arr"], b_beg=case["b_beg"], flat=st.flat,
                flat_offs=st.flat_offs, lens=st.lens,
                cns_pad=case["cns_pad"], Lc=LC, match=P.match,
                mismatch=P.mismatch, open_i=-2, open_d=-3, ext=-1)
    n = len(case["spans"])
    ok = native.stitch_round(np.arange(n), np.ones(n), **args)
    assert list(ok.status) == [native.STITCHED] * n
    with pytest.raises(IndexError):
        native.stitch_round(np.arange(n) + 1, np.ones(n), **args)
    with pytest.raises(ValueError):
        native.stitch_round(np.arange(n), np.ones(n),
                            **dict(args, b_beg=case["b_beg"][:-1]))
    with pytest.raises(ValueError):
        native.stitch_round(np.arange(n), np.ones(n), **dict(args, Lc=0))
