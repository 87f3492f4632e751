"""Consensus stage (port of smartdenovo_tpu/pipeline/cns.py, the
equivalent of the reference `wtcns`, DAGCon-style).

Per unitig: backbone = offset-concatenation of the layout's Y reads; then
`n_iter` rounds of
  1. align every read to the current consensus, with one of two engines:
     - the segment engine (the default): probe-anchor every read lacking
       a column map (`_probe_anchor_device`, plain torch ops on the
       device), cut every read into SEGR-row segments, align them all
       against their consensus windows, Bc segments per call of
       `ops.segdp.seg_align_tb` (csrc/segdp.cu on the card), and stitch
       each read's segment alignments on the host;
     - the whole-read engine (units with f5q quality tracks, or
       `seg_engine=False`): probe-anchor batches of whole reads, align
       each batch along its anchor band with `ops.banded.banded_align`
       (csrc/banded.cu), then refine around that alignment with the
       affine `ops.refine` or, for reads with f5q tracks, the
       quality-aware `ops.refine5q` DP (both csrc/refine.cu);
  2. insert the accepted alignments best-score-first into the native DAG
     (the port's copy of native/dagcns.cpp, through utils/native.py),
     merge nodes, take the consensus and remap read offsets.
`run_cns(aln_path=..., vmsa=...)` (cns -a/-V) then aligns every read to
the final consensus with the whole-read engine and writes the records.

The host parts (layout parsing, segmenting, stitching, the DAG loop, the
-a/-V writer) are copies of the JAX package's, held equal to their
sources by tests/test_torch_cns.py and tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..data.readbank import codes_to_seq, revcomp_codes
from ..utils.log import log
from ..utils.native import DagCns

from ..ops.banded import (align_strings, banded_align, make_band_centers,
                          traceback_banded)
from ..ops.refine import refine_alignment_batch
from ..ops.refine5q import refine5q_alignment_batch
from ..ops.segdp import seg_align_tb, unpack_moves
from ..utils.timing import span, timed

# base letter byte -> 2-bit code (4 = other), reference base_bit_table
_BASE_BIT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_BIT[_c] = _i
    _BASE_BIT[_c + 32] = _i


@dataclasses.dataclass
class CnsParams:
    seg_engine: bool = True    # segment-parallel align pass (ops/segdp.py);
                               # falls back to the whole-read path for
                               # units carrying f5q quality tracks.
                               # Validated vs the whole-read path: same
                               # accepted reads, same per-read m/coords,
                               # equal truth-identity on sims
    n_iter: int = 6            # -n (reference default 6, wtcns.c)
    zsize: int = 10            # -z
    hz: bool = False           # -H (off by default in wtcns)
    kvar: int = 2              # -l
    min_id: float = 0.5        # -m
    ref_penalty: float = 0.5   # -Y
    alt_penalty: float = 0.2   # -N
    match: int = 2
    mismatch: int = -5
    gap: int = -3          # -O, first round
    gap_ins: int = -2      # -I, later rounds (insertion in read)
    gap_del: int = -3      # -D, later rounds (deletion vs consensus)
    band: int = 256            # band width for the guided DP
    win_margin: int = 600      # cns window margin around expected span
    batch_reads: int = 64      # per-dispatch reads: the row scan's cost is
                               # ~constant in B (step-latency bound), so
                               # bigger batches amortize it; the dirs
                               # plane ([B, LA, W] u8) bounds B — 128 at
                               # LA=32768 crashed the TPU worker (HBM
                               # pressure), 64 is safe to LA 32768
    max_zmer_per_read: int = 64
    xvar: int = 128
    yvar: int = 64
    min_block_len: int = 64
    max_overhang: int = 512
    # affine refine pass around the banded alignment's CIGAR before DAG
    # insertion (reference kswx_refine_alignment, wtcns.c:372-381) —
    # canonical affine gap placement is what lets the DAG votes stack
    refine: bool = True
    refine_w: int = 64         # refine band base (reference -r is 8 with
                               # local indel widening, kswx.h:526-601)
    refine_open_i: int = -2    # reference wtcns -I
    refine_open_d: int = -3    # reference wtcns -D
    refine_ext: int = -1       # reference -E
    use_qv: bool = True        # quality-aware refine when the .lay has
                               # f5q tracks (reference -F disables)


@dataclasses.dataclass
class LayUnitig:
    """One unitig layout: oriented read sequences + backbone offsets."""

    name: str
    reads: list[np.ndarray]   # oriented 2-bit codes (direct-use, like .lay rows)
    offs: list[int]
    backbone: list[bool]      # Y/N flag
    rnames: list[str] | None = None   # read names (for -a output)
    quals: list[np.ndarray] | None = None  # [len,7] f5q tracks or None per read


def units_from_graph(graph) -> list[LayUnitig]:
    """Extract consensus jobs from an in-memory StringGraph (post layout).

    Contained reads are recruited around their containers exactly as the
    .lay file path does (wtlay.c:2468-2497) — they carry most of the
    coverage, and consensus without them runs at tiling depth (~2-3x)
    instead of read depth.
    """
    units = []
    for i, lay in enumerate(graph.lays):
        if len(lay) < 4:
            continue
        lay = list(lay)
        if not any(e[5] for e in lay):  # not already recruited (output_layout)
            graph._recurit_contained(lay)
        reads, offs, bflags, rnames, quals = [], [], [], [], []
        any_q = False
        for nid, dir, fwd, bwd, off, cont in lay:
            codes = graph.rb.get(nid)
            q = graph.rb.quals[nid] if getattr(graph.rb, "quals", None) else None
            if dir:
                codes = revcomp_codes(codes)
                if q is not None:
                    from ..data.readbank import revcomp_f5q

                    q = revcomp_f5q(q)
            reads.append(np.ascontiguousarray(codes))
            offs.append(int(off))
            bflags.append(not cont)
            rnames.append(graph.rb.names[nid])
            quals.append(q)
            any_q = any_q or q is not None
        units.append(LayUnitig(name=f"utg{i}", reads=reads, offs=offs,
                               backbone=bflags, rnames=rnames,
                               quals=quals if any_q else None))
    return units


def parse_lay_file(path: str) -> list[LayUnitig]:
    """Parse a reference-format .lay file (README-tools.md:248-268)."""
    from ..data.readbank import seq_to_codes

    units = []
    cur = None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                cur = LayUnitig(name=name, reads=[], offs=[], backbone=[],
                                rnames=[], quals=[])
                units.append(cur)
                continue
            cols = line.split("\t")
            if len(cols) < 6 or cur is None:
                continue
            cur.backbone.append(cols[0] == "Y")
            cur.rnames.append(cols[1])
            cur.offs.append(int(cols[3]))
            cur.reads.append(seq_to_codes(cols[5]))
            # optional f5q 7-track qualities (wtcns.c:938: col7 len == 7*len;
            # push5q_wtcns: tracks 0-4 phred chars -33, tracks 5-6 base codes)
            if len(cols) > 6 and len(cols[6]) == 7 * len(cols[5]):
                raw = np.frombuffer(cols[6].encode(), np.uint8).reshape(7, -1)
                qv = np.empty_like(raw)
                qv[:5] = raw[:5] - 33
                qv[5:] = _BASE_BIT[raw[5:]]
                cur.quals.append(qv)
            else:
                cur.quals.append(None)
    return [u for u in units if u.reads]


def _gen_backbone(unit: LayUnitig) -> np.ndarray:
    """Offset-concatenation of Y reads (cf. gen_backbone_wtcns wtcns.c:246-284)."""
    ln = 0
    for r, off, bb in zip(unit.reads, unit.offs, unit.backbone):
        if bb:
            ln = max(ln, off + len(r))
    ctg = np.zeros(ln, np.uint8)
    built = 0
    for r, off, bb in zip(unit.reads, unit.offs, unit.backbone):
        if not bb or off + len(r) <= built:
            continue
        ctg[off : off + len(r)] = r
        built = off + len(r)
    return ctg[:built]


def _pad_tier(n: int, tiers=(1024, 2048, 4096, 8192, 16384, 32768, 65536)) -> int:
    for t in tiers:
        if n <= t:
            return t
    return ((n + 65535) // 65536) * 65536


def _probe_anchor_device(a, alen, w, wlen, doff, *, K=14, D=1024, S=96):
    """Sampled k-mer probe anchoring of read i against window i.

    The layout already places every read near its window position (doff),
    so anchoring only needs a few (read_pos, window_pos) points to center
    the banded DP: S evenly spaced raw K-mers per read are matched
    against the window within +-D of the expected diagonal.  Plain torch
    ops on the tensors' device (gathers, a compare, an argmax); the hit
    nearest the diagonal wins, the first one on a tie (torch.argmax takes
    the first maximum, as jnp.argmax does).

    a [B, LA] u8, alen [B] i32, w [B, LW] u8, wlen [B] i32, doff [B] i32.
    Returns (px [B,S] read pos, py [B,S] window pos, found [B,S])."""
    B, LA = a.shape
    LW = w.shape[1]
    dev = a.device
    i32 = torch.int32

    def roll_kmers(x):
        # K 2-bit codes fit in 28 bits: int32 holds them exactly
        km = torch.zeros(x.shape, dtype=i32, device=dev)
        bad = torch.zeros(x.shape, dtype=i32, device=dev)
        for t in range(K):
            sh = torch.cat([x[:, t:], torch.full((x.shape[0], t), 4,
                                                 dtype=x.dtype, device=dev)],
                           dim=1)
            km = (km << 2) | (sh & 3).to(i32)
            bad = bad + (sh >= 4).to(i32)
        return km, bad == 0

    ka, va = roll_kmers(a)
    kw, vw = roll_kmers(w)
    alen = alen.to(i32)
    s = torch.arange(S, dtype=i32, device=dev)
    px = torch.div(torch.clamp(alen[:, None] - K, min=1) * s, S,
                   rounding_mode="floor")                     # [B, S]
    pxc = px.clamp(0, LA - 1).long()
    pk = torch.gather(ka, 1, pxc)
    pv = torch.gather(va, 1, pxc) & (px <= alen[:, None] - K)
    j = torch.arange(2 * D, dtype=i32, device=dev)
    wy = px[:, :, None] + doff.to(i32)[:, None, None] - D + j[None, None, :]
    wyc = wy.clamp(0, LW - 1).long().reshape(B, -1)
    hit = (
        pv[:, :, None]
        & (torch.gather(kw, 1, wyc).reshape(wy.shape) == pk[:, :, None])
        & torch.gather(vw, 1, wyc).reshape(wy.shape)
        & (wy >= 0)
        & (wy <= wlen.to(i32)[:, None, None] - K)
    )
    pref = torch.where(hit, -(j - D).abs()[None, None, :],
                       torch.tensor(-2 * D - 1, dtype=i32, device=dev))
    bestj = torch.argmax(pref, dim=2).to(i32)
    found = pref.amax(dim=2) > -2 * D - 1
    py = px + doff.to(i32)[:, None] - D + bestj
    return px, py, found


def _anchor_reads(reads, windows, p: CnsParams, doffs, device):
    """Anchor each read i to window i (device probes + median-diag filter).

    Returns per read: list of (a_pos, b_pos) anchors or []."""
    B = len(reads)
    LA = _pad_tier(max(len(r) for r in reads))
    LW = _pad_tier(max(len(w) for w in windows))
    a = np.full((B, LA), 4, np.uint8)
    w = np.full((B, LW), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    wlen = np.zeros(B, np.int32)
    for i, (r, win) in enumerate(zip(reads, windows)):
        a[i, : len(r)] = r
        w[i, : len(win)] = win
        alen[i] = len(r)
        wlen[i] = len(win)
    px, py, found = (t.cpu().numpy() for t in _probe_anchor_device(
        *(torch.from_numpy(x).to(device)
          for x in (a, alen, w, wlen, np.asarray(doffs, np.int32)))))
    anchors = []
    for i in range(B):
        xs = px[i][found[i]]
        ys = py[i][found[i]]
        if xs.size == 0:
            anchors.append([])
            continue
        d = ys.astype(np.int64) - xs
        med = np.median(d)
        keep = np.abs(d - med) <= 512      # repeat-hit outlier filter
        anchors.append(sorted(zip(xs[keep].tolist(), ys[keep].tolist())))
    return anchors


def _split_str(split: dict) -> str:
    """The align split as logged: `part seconds` pairs by part name."""
    return " ".join(f"{k} {v:.3f}s" for k, v in sorted(split.items()))


def _align_pass(unit: LayUnitig, offs, cns, p: CnsParams, ga: int, gb: int,
                *, device, split: dict | None = None):
    """Align every layout read to the current consensus, batch_reads whole
    reads per call of the banded DP on `device`.

    Yields (rid, score, beg, end, ra, rb) per read that aligned, where
    beg/end are cns coordinates and ra/rb the aligned code rows (4 = gap),
    ra = read, rb = consensus.  Applies the affine refine pass when
    p.refine (reference kswx_refine_alignment, wtcns.c:372-381); reads
    with f5q tracks get the quality-aware refine (wtcns.c:380).  The JAX
    package's pass, with the traceback inside the DP's call; split: a dict
    the host seconds of each part are added to (utils/timing.py).
    """
    nreads = len(unit.reads)
    for b0 in range(0, nreads, p.batch_reads):
        ridx = list(range(b0, min(nreads, b0 + p.batch_reads)))
        reads = [unit.reads[i] for i in ridx]
        wstarts = []
        windows = []
        for i in ridx:
            ws = max(0, offs[i] - p.win_margin)
            we = min(len(cns), offs[i] + len(unit.reads[i]) + p.win_margin)
            if we <= ws:
                ws, we = 0, min(len(cns), len(unit.reads[i]) + 2 * p.win_margin)
            wstarts.append(ws)
            windows.append(cns[ws:we])
        doffs = [offs[i] - ws for i, ws in zip(ridx, wstarts)]
        with timed(split, "probe"):
            anchors = _anchor_reads(reads, windows, p, doffs, device)
        LA = _pad_tier(max(len(r) for r in reads))
        LBm = max(len(w) for w in windows)
        B = len(reads)
        a = np.full((B, LA), 4, np.uint8)
        b = np.full((B, LBm), 4, np.uint8)
        alen = np.zeros(B, np.int32)
        blen = np.zeros(B, np.int32)
        for i, (r, w) in enumerate(zip(reads, windows)):
            a[i, : len(r)] = r
            alen[i] = len(r)
            b[i, : len(w)] = w
            blen[i] = len(w)
        with timed(split, "band"):
            base = make_band_centers(anchors, alen, blen, LA, p.band)
        with timed(split, "banded"):
            score, end_col, _dirs, mvs, j_final = banded_align(
                *(torch.from_numpy(x).to(device)
                  for x in (a, b, alen, blen, base)),
                LA=LA, W=p.band, match=p.match, mismatch=p.mismatch,
                gap=p.gap, gap_a=ga, gap_b=gb, semiglobal_b=True)
            del _dirs
            score = score.cpu().numpy().copy()  # writable: refine overwrites
            end_col = end_col.cpu().numpy()
            mvs = mvs.cpu().numpy()
            j_final = j_final.cpu().numpy()
        with timed(split, "rle"):
            cigs, b_begs = traceback_banded(mvs, j_final)
        if p.refine:
            # affine re-alignment around the prior CIGAR (reference
            # kswx_refine_alignment, wtcns.c:372-381): canonical gap
            # placement so DAG votes stack on the same columns; reads
            # with f5q tracks get the quality-aware variant (wtcns.c:380)
            groups: dict = {"plain": ([], [], []), "qv": ([], [], [])}
            quals = unit.quals if (p.use_qv and unit.quals) else None
            for i in range(B):
                ops, counts = cigs[i]
                if not ops:
                    continue
                seg_b = b[i][int(b_begs[i]): int(end_col[i])]
                if int(alen[i]) == 0 or seg_b.size == 0:
                    continue
                qv = quals[ridx[i]] if quals is not None else None
                g = groups["qv" if qv is not None else "plain"]
                g[0].append((a[i][: int(alen[i])], seg_b))
                g[1].append((ops, counts) if qv is None else
                            ((ops, counts), qv))
                g[2].append(i)
            rpairs, rcigs, rmap = groups["plain"]
            # iteration-dependent refine opens (reference wtcns.c:381:
            # iter? I : O for both the main align and the refine)
            refined = refine_alignment_batch(
                rpairs, rcigs, W_base=p.refine_w, match=p.match,
                mismatch=p.mismatch, open_i=ga,
                open_d=gb, ext=p.refine_ext, device=device, split=split)
            for i, r in zip(rmap, refined):
                cigs[i] = (r["ops"], r["counts"])
                # the reference sorts DAG insertion by the REFINED affine
                # score (wtcns.c:381 sets kswx from the refine result and
                # :551 sorts by it) — report it, not the banded score
                score[i] = r["score"]
            qpairs, qmeta, qmap = groups["qv"]
            if qpairs:
                # the JAX package keeps the banded score of f5q reads (its
                # known fault, ROADMAP queue 3); copied, to stay equal
                refined = refine5q_alignment_batch(
                    qpairs, [m[1] for m in qmeta], [m[0] for m in qmeta],
                    W_base=p.refine_w, device=device, split=split)
                for i, r in zip(qmap, refined):
                    cigs[i] = (r["ops"], r["counts"])
        for i in range(B):
            ops, counts = cigs[i]
            if not ops:
                continue
            # build alignment strings: row a = read, row b = window
            with timed(split, "strings"):
                ra, rb_ = align_strings(a[i], b[i][int(b_begs[i]):], ops,
                                        counts)
            if ra.shape[0] == 0:
                continue
            beg = wstarts[i] + int(b_begs[i])
            end = wstarts[i] + int(end_col[i])
            yield ridx[i], int(score[i]), beg, end, ra, rb_


# ---- segment-parallel align pass (ops/segdp.py) --------------------------
#
# Replaces the whole-read banded pass for consensus iterations: reads are
# cut into SEGR-row segments overlapping by OVL, all segments form one
# [C, Bc] grid, and ONE kernel dispatch per iteration runs the affine
# banded DP + traceback for every segment (reference analogue: the
# zmer-window piecewise alignment of aln_read_wtcns, wtcns.c:286-434).
# The host stitches segment alignments at a row where adjacent segments
# pass through the same consensus column.

SEGR = 2048       # rows (read bases) per segment
S_OVL = 256       # stitch overlap rows between adjacent segments
S_STRIDE = SEGR - 2 * S_OVL
S_LBW = 3072      # consensus window length per segment
S_W = 256         # band width
S_T = 3072        # traceback budget (moves per segment)
S_WMARG = (S_LBW - SEGR) // 2   # window slack each side


class _SegState:
    """Per-unit device bank + per-read consensus column maps."""

    def __init__(self, unit: LayUnitig):
        lens = np.array([len(r) for r in unit.reads], np.int64)
        offs = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        from .zmo import pad_pow2 as _pp2

        flat = np.full(_pp2(int(offs[-1]) + SEGR + 8), 4, np.uint8)
        for i, r in enumerate(unit.reads):
            flat[offs[i]: offs[i] + len(r)] = r
        self.lens = lens
        self.flat_offs = offs
        self.flat = flat
        # colmap16[i]: int32 cns column at read rows 0,16,32,... (absolute)
        self.colmap16: list = [None] * len(lens)

    def remap(self, mp: np.ndarray):
        for i, c in enumerate(self.colmap16):
            if c is not None:
                self.colmap16[i] = mp[np.clip(c, 0, len(mp) - 1)].astype(np.int64)

    def reset_colmap(self, rid: int, off: int):
        n16 = int(self.lens[rid]) // 16 + 2
        self.colmap16[rid] = off + np.arange(n16, dtype=np.int64) * 16


def _seed_colmaps(unit, st: _SegState, offs, cns, p: CnsParams,
                  batch: int = 512, *, device):
    """Probe-anchor reads lacking a column map (iteration 0 / failures)."""
    need = [i for i, c in enumerate(st.colmap16) if c is None]
    for b0 in range(0, len(need), batch):
        ridx = need[b0: b0 + batch]
        reads = [unit.reads[i] for i in ridx]
        wstarts, windows, doffs = [], [], []
        for i in ridx:
            ws = max(0, offs[i] - p.win_margin)
            we = min(len(cns), offs[i] + len(unit.reads[i]) + p.win_margin)
            if we <= ws:
                ws, we = 0, min(len(cns), len(unit.reads[i]) + 2 * p.win_margin)
            wstarts.append(ws)
            windows.append(cns[ws:we])
            doffs.append(offs[i] - ws)
        anchors = _anchor_reads(reads, windows, p, doffs, device)
        for i, ws, anc in zip(ridx, wstarts, anchors):
            rl = int(st.lens[i])
            rows16 = np.arange(rl // 16 + 2, dtype=np.int64) * 16
            if not anc:
                st.reset_colmap(i, offs[i])
                continue
            xs = np.array([a for a, _ in anc], np.int64)
            ys = np.array([b for _, b in anc], np.int64) + ws
            xs, ui = np.unique(xs, return_index=True)
            ys = ys[ui]
            c = np.interp(rows16, xs, ys)
            # extrapolate the chain diagonal past the terminal anchors
            lo, hi = rows16 < xs[0], rows16 > xs[-1]
            c[lo] = ys[0] - (xs[0] - rows16[lo])
            c[hi] = ys[-1] + (rows16[hi] - xs[-1])
            st.colmap16[i] = c.astype(np.int64)


def _build_segments(st: _SegState, nreads: int, Lc: int):
    """Segment every read; returns packed numpy arrays + per-read spans."""
    NB = SEGR // 16 + 2
    rows = []   # (rid, r0, alen, w0, blen)
    b16s = []
    spans = []  # per read: (first_seg_idx, n_segs, [r0 list])
    for i in range(nreads):
        rl = int(st.lens[i])
        if rl < 64:
            spans.append((len(rows), 0, []))
            continue
        c16 = st.colmap16[i]
        grid = np.arange(len(c16), dtype=np.int64) * 16
        S = 1 if rl <= SEGR else int(np.ceil((rl - SEGR) / S_STRIDE)) + 1
        first = len(rows)
        r0s = []
        for s in range(S):
            r0 = min(s * S_STRIDE, max(0, rl - SEGR))
            alen = min(SEGR, rl - r0)
            segrows = r0 + np.arange(NB, dtype=np.int64) * 16
            center = np.interp(segrows, grid, c16)
            w0 = int(np.clip(center[0] - S_WMARG, 0, max(0, Lc - 1)))
            blen = int(np.clip(Lc - w0, 0, S_LBW))
            b16 = np.clip(center - w0 - S_W // 2, 0, S_LBW - 1)
            rows.append((i, r0, alen, w0, blen))
            b16s.append(b16.astype(np.int16))
            r0s.append(r0)
        spans.append((first, S, r0s))
    return rows, b16s, spans


def _cigar_pieces(mv, bbeg):
    """Per-move row/col cursors for one segment's forward move array."""
    is_row = mv != 2          # M/I consume a read row
    is_col = mv != 1          # M/D consume a consensus column
    rowb = np.cumsum(is_row) - is_row         # rows before each move
    colb = bbeg + np.cumsum(is_col) - is_col  # cols before each move
    rowmove_idx = np.nonzero(is_row)[0]
    return rowb, colb, rowmove_idx


def _seg_align_pass(unit: LayUnitig, st: _SegState, offs, cns,
                    p: CnsParams, ga: int, gb: int, *, device):
    """Alignment of every read against the current consensus, Bc segments
    per `seg_align_tb` call on `device`.

    Yields (rid, score, beg, end, ra, rb) per stitched read: beg/end are
    cns coordinates, ra/rb the aligned code rows (4 = gap), ra = read."""
    nreads = len(unit.reads)
    Lc = len(cns)
    with span("cns.segplan"):
        _seed_colmaps(unit, st, offs, cns, p, device=device)
        rows, b16s, spans = _build_segments(st, nreads, Lc)
        if not rows:
            return
        # Bc = 1024 segments per call bounds the kernel's direction scratch
        # ([Bc, SEGR, W] u8, 537 MB) and fills the card's 132 SMs; small
        # unitigs use narrower pow2 tiers
        Nseg = len(rows)
        Bc = 1 << max(8, min(10, (Nseg - 1).bit_length()))
        n_disp = (Nseg + Bc - 1) // Bc
        Np = n_disp * Bc
        NB = SEGR // 16 + 2
        arr = np.zeros((Np, 5), np.int64)
        arr[:Nseg] = np.asarray(rows, np.int64)
        b16 = np.zeros((Np, NB), np.int16)
        b16[:Nseg] = np.stack(b16s)
        seg_aoff = (st.flat_offs[arr[:, 0]] + arr[:, 1]).astype(np.int64)
        seg_alen = arr[:, 2].astype(np.int32)
        seg_alen[Nseg:] = 0
        seg_w0 = arr[:, 3].astype(np.int64)
        seg_bl = arr[:, 4].astype(np.int32)
        from .zmo import pad_pow2 as _pp2

        cns_pad = np.full(_pp2(Lc + S_LBW + 8), 4, np.uint8)
        cns_pad[:Lc] = cns
        open_i, open_d = ga, gb
        rowsA = np.arange(SEGR, dtype=np.int64)[None, :]
        rowsB = np.arange(S_LBW, dtype=np.int64)[None, :]
    with span("cns.segdp", segments=Nseg, dispatches=n_disp, Bc=Bc) as sp:
        outs = []
        for d0 in range(n_disp):
            sl = slice(d0 * Bc, (d0 + 1) * Bc)
            a_dense = st.flat[np.minimum(seg_aoff[sl, None] + rowsA,
                                         len(st.flat) - 1)]
            b_dense = cns_pad[np.minimum(seg_w0[sl, None] + rowsB,
                                         len(cns_pad) - 1)]
            outs.append(seg_align_tb(
                *(torch.from_numpy(x).to(device) for x in (
                    a_dense, b_dense, seg_alen[sl], seg_bl[sl], b16[sl])),
                SEGR=SEGR, LBW=S_LBW, W=S_W, T=S_T,
                match=p.match, mismatch=p.mismatch,
                open_i=open_i, open_d=open_d, ext=p.refine_ext))
        b_beg = np.concatenate([o[1].cpu().numpy() for o in outs])
        mv_all = np.concatenate([
            unpack_moves(o[3].cpu().numpy()[None]).transpose(0, 2, 1).reshape(
                Bc, -1) for o in outs])   # [seg, T] backward streams
    log("cns %s: %d segments in %d dispatches of %d, %.3fs", unit.name, Nseg,
        n_disp, Bc, sp.seconds)
    # stitched to a list, so that the span holds the stitcher alone and
    # not the caller's work on each read
    with span("cns.stitch"):
        stitched = list(_stitch_reads(unit, st, spans, arr, b_beg, mv_all,
                                      cns_pad, Lc, p, open_i, open_d))
    yield from stitched


def _stitch_reads(unit: LayUnitig, st: _SegState, spans, arr, b_beg, mv_all,
                  cns_pad, Lc, p: CnsParams, open_i, open_d):
    """Stitch each read's segment alignments at a row where adjacent
    segments pass through the same consensus column; yields the reads
    whose stitched alignment consumed every row."""
    nreads = len(unit.reads)
    fallbacks = 0
    for rid in range(nreads):
        first, S, r0s = spans[rid]
        if S == 0:
            continue
        rl = int(st.lens[rid])
        segs = []
        ok = True
        for s in range(S):
            gi = first + s
            mv = mv_all[gi]
            mv = mv[mv != 3][::-1].astype(np.int8)
            nrow = int(np.sum(mv != 2))
            if nrow != int(arr[gi, 2]):
                ok = False
                break
            rowb, colb, rmi = _cigar_pieces(mv, int(arr[gi, 3] + b_beg[gi]))
            segs.append((mv, rowb, colb, rmi, r0s[s]))
        if not ok or not segs:
            st.colmap16[rid] = None   # reseed next iteration
            continue
        pieces = []
        cut_prev = 0       # global read row where the kept span starts
        head_fix = 0       # columns the next piece must shed (cutc2 < cutc)
        for s in range(S):
            mv, rowb, colb, rmi, r0 = segs[s]
            if s + 1 < S:
                mv2, rowb2, colb2, rmi2, r02 = segs[s + 1]
                zlo, zhi = r02, r0 + int(arr[first + s, 2])
                zl = np.arange(max(zlo, cut_prev + 1), zhi, dtype=np.int64)
                if zl.size == 0:
                    ok = False
                    break
                cl = colb[rmi[zl - r0]]
                cr = colb2[rmi2[zl - r02]]
                eq = np.nonzero(cl == cr)[0]
                mid = zl.size // 2
                if eq.size:
                    pick = eq[np.argmin(np.abs(eq - mid))]
                    cut, cutc, cutc2 = int(zl[pick]), int(cl[pick]), int(cl[pick])
                else:
                    fallbacks += 1
                    pick = int(np.argmin(np.abs(cl - cr) + np.abs(
                        np.arange(zl.size) - mid) // 8))
                    cut, cutc, cutc2 = int(zl[pick]), int(cl[pick]), int(cr[pick])
            else:
                cut, cutc, cutc2 = rl, None, None
            lo = rmi[cut_prev - r0] if cut_prev - r0 < len(rmi) else len(mv)
            hi = rmi[cut - r0] if cut - r0 < len(rmi) else len(mv)
            piece = mv[lo:hi]
            if head_fix > 0:
                # previous junction left the right side behind by head_fix
                # columns: shed that many col-consuming moves from this
                # piece's head (M -> I keeps the row count intact)
                piece = piece.copy()
                shed = 0
                for t in range(len(piece)):
                    if shed >= head_fix:
                        break
                    if piece[t] == 0:
                        piece[t] = 1
                        shed += 1
                    elif piece[t] == 2:
                        piece[t] = -1   # mark dropped
                        shed += 1
                piece = piece[piece >= 0]
                head_fix -= shed
                if head_fix > 0:      # piece too short to reconcile
                    ok = False
                    break
            pieces.append(piece)
            if s + 1 < S and cutc2 != cutc:
                if cutc2 > cutc:      # bridge the gap with deletions
                    pieces.append(np.full(cutc2 - cutc, 2, np.int8))
                else:
                    head_fix = cutc - cutc2
            cut_prev = cut
        if not ok:
            st.colmap16[rid] = None
            continue
        mvf = np.concatenate(pieces) if len(pieces) > 1 else pieces[0]
        beg = int(arr[first, 3] + b_beg[first])
        is_row = mvf != 2
        is_col = mvf != 1
        nrow = int(is_row.sum())
        if nrow != rl:
            st.colmap16[rid] = None
            continue
        end = beg + int(is_col.sum())
        if end > Lc:        # clip pathological overrun
            st.colmap16[rid] = None
            continue
        rcodes = st.flat[st.flat_offs[rid]: st.flat_offs[rid] + rl]
        rowi = np.cumsum(is_row) - 1
        coli = beg + np.cumsum(is_col) - 1
        ra = np.where(is_row, rcodes[np.clip(rowi, 0, rl - 1)], 4).astype(np.uint8)
        rb_ = np.where(is_col, cns_pad[np.clip(coli, 0, Lc - 1)], 4).astype(np.uint8)
        ra[~is_row] = 4
        rb_[~is_col] = 4
        # affine score of the stitched alignment (kswx conventions)
        msk = mvf == 0
        sc = int(np.sum(np.where(ra[msk] == rb_[msk], p.match, p.mismatch)))
        run_start = np.empty(len(mvf), bool)
        run_start[0] = True
        np.not_equal(mvf[1:], mvf[:-1], out=run_start[1:])
        n_i = int(np.sum(mvf == 1))
        n_d = int(np.sum(mvf == 2))
        o_i = int(np.sum(run_start & (mvf == 1)))
        o_d = int(np.sum(run_start & (mvf == 2)))
        sc += o_i * open_i + n_i * p.refine_ext
        sc += o_d * open_d + n_d * p.refine_ext
        # refresh the column map from this alignment (rows stride 16):
        # col BEFORE each row move (M consumed its col: coli; I did not:
        # coli points at the previous consumed col, so +1)
        rowmove_cols = coli[is_row] + (mvf[is_row] == 1)
        c16 = rowmove_cols[::16]
        st.colmap16[rid] = np.concatenate(
            [c16, [end, end + 16]]).astype(np.int64)
        yield rid, sc, beg, end, ra, rb_
    if fallbacks:
        log("cns %s: %d stitch fallbacks (no shared column in overlap)",
            unit.name, fallbacks)


def _save_cns_ckpt(ckpt, it, cns, offs, prev_agree, prev_offs, prev_cns, st):
    """The JAX package's checkpoint fields; colmap16 is always a 1-D object
    array (the JAX package's np.array(cm, dtype=object) turns 2-D when
    every column map has the same length)."""
    import os

    cm = ([c if c is not None else np.zeros(0, np.int64)
           for c in st.colmap16] if st is not None else [])
    cm_arr = np.empty(len(cm), dtype=object)
    for k, c in enumerate(cm):
        cm_arr[k] = c
    np.savez(ckpt + ".tmp.npz", it=it, cns=cns,
             offs=np.asarray(offs, np.int64),
             prev_agree=prev_agree,
             prev_offs=np.asarray(prev_offs, np.int64),
             prev_cns=(prev_cns if prev_cns is not None
                       else np.zeros(0, np.uint8)),
             colmap16=cm_arr)
    os.replace(ckpt + ".tmp.npz", ckpt)


def _load_colmaps(cm) -> list:
    """Checkpointed column maps, from a 1-D object array of int arrays or
    the 2-D object array the JAX package writes when all have one length;
    empty maps become None."""
    return [np.asarray(c, np.int64) if c is not None and getattr(c, "size", 0)
            else None for c in cm]


def consensus_unitig(unit: LayUnitig, p: CnsParams | None = None,
                     return_offs: bool = False, ckpt: str | None = None, *,
                     device="cuda"):
    """Iterative DAG consensus for one unitig; returns consensus codes
    (and the final read offsets when return_offs).

    ckpt: optional npz path saved after every iteration so a killed run
    resumes at the next iteration instead of restarting — genome-scale
    failure recovery (SURVEY §5.3).
    It takes the JAX package's checkpoints as well.  device: where the
    probe anchoring and the DPs run.
    """
    with span("cns.unitig", rounds=0) as sp_unit:
        return _unitig_rounds(unit, p or CnsParams(), return_offs, ckpt,
                              device, sp_unit)


def _unitig_rounds(unit: LayUnitig, p: CnsParams, return_offs, ckpt,
                   device, sp_unit):
    """consensus_unitig inside its `cns.unitig` span `sp_unit`; each round
    is a `cns.round` span of seed, align and dag spans."""
    import os

    cns = _gen_backbone(unit)
    nreads = len(unit.reads)
    offs = list(unit.offs)
    if len(cns) == 0:
        return (cns, offs) if return_offs else cns
    # engine: segment-parallel unless the unit carries f5q quality tracks
    # (the quality-aware refine runs on the whole-read path)
    use_seg = p.seg_engine and not (p.use_qv and unit.quals
                                    and any(q is not None for q in unit.quals))
    st = _SegState(unit) if use_seg else None
    # convergence guard: agreement = total read bases matching the current
    # backbone, a penalty-independent quality metric.  If an iteration's
    # backbone agrees with the reads less than the previous one did, the
    # DAG update diverged (insertion bloat) — return the previous backbone.
    prev_cns = None
    prev_agree = -1
    prev_offs = list(offs)
    start_it = 0
    if ckpt and os.path.exists(ckpt):
        z = np.load(ckpt, allow_pickle=True)
        start_it = int(z["it"])
        cns = z["cns"]
        offs = [int(v) for v in z["offs"]]
        prev_agree = float(z["prev_agree"])
        prev_offs = [int(v) for v in z["prev_offs"]]
        prev_cns = z["prev_cns"] if z["prev_cns"].size else None
        if st is not None:
            st.colmap16 = _load_colmaps(z["colmap16"])
        log("cns %s: resumed at iteration %d from %s", unit.name,
            start_it + 1, ckpt)
    for it in range(start_it, p.n_iter):
        with span("cns.round") as sp_round:
            with span("cns.seed") as sp_seed:
                dag = DagCns(p.ref_penalty, p.alt_penalty)
                dag.set_backbone(cns)
                agree = 0
                abase = 0
                pending = []  # (score, beg, end, a0, a1)
                # reference wtcns: -O in round 1, asymmetric -I/-D afterwards
                ga = p.gap if it == 0 else p.gap_ins
                gb = p.gap if it == 0 else p.gap_del
                if use_seg:
                    # seed (idempotent) BEFORE the align pass so the column
                    # maps can be checkpointed separately
                    _seed_colmaps(unit, st, offs, cns, p, device=device)
                    if ckpt:
                        _save_cns_ckpt(ckpt, it, cns, offs, prev_agree,
                                       prev_offs, prev_cns, st)
            with span("cns.align") as sp_align:
                split: dict = {}
                itr = (_seg_align_pass(unit, st, offs, cns, p, ga, gb,
                                       device=device)
                       if use_seg else
                       _align_pass(unit, offs, cns, p, ga, gb, device=device,
                                   split=split))
                aligned = 0
                for rid, sc, beg, end, ra, rb_ in itr:
                    aligned += 1
                    m = int(np.sum((ra == rb_) & (ra != 4)))
                    # reference acceptance (wtcns.c:347-357): mat >= min_id
                    # * aln AND mat >= min_id * projected read overlap — the
                    # aln-columns test is what rejects junk alignments whose
                    # semiglobal span shrank (mat/span alone lets them
                    # pollute the DAG)
                    if (m < p.min_id * ra.shape[0]
                            or m < p.min_id * len(unit.reads[rid])):
                        continue
                    pending.append((sc, beg, end, rb_, ra, rid))
                    agree += m
                    abase += len(unit.reads[rid])
                    offs[rid] = beg
                sp_round.counts.update(reads_aligned=aligned,
                                       reads_accepted=len(pending))
                # divergence guard on the PER-BASE agreement rate: insertion
                # bloat collapses the rate; reads dropping out at layout
                # edges (window drift) lower the absolute sum but not the
                # rate and must not abort the polish
                rate = agree / max(1, abase)
                if rate < 0.98 * prev_agree:
                    log("cns %s iter %d: agreement rate %.4f << %.4f, "
                        "keeping previous", unit.name, it + 1, rate,
                        prev_agree)
                    return (prev_cns, prev_offs) if return_offs else prev_cns
                if rate >= prev_agree:
                    prev_cns, prev_agree, prev_offs = cns, rate, list(offs)
            with span("cns.dag") as sp_dag:
                pending.sort(key=lambda t: -t[0])
                for sc, beg, end, a0, a1, _ in pending:
                    dag.add_alignment(beg, end, a0, a1)
                dag.merge_nodes()
                new_cns, mp, dag_score = dag.consensus()
                # remap offsets old->new
                if mp is not None and len(mp):
                    for i in range(nreads):
                        o = min(max(0, offs[i]), len(mp) - 1)
                        offs[i] = int(mp[o])
                    if st is not None:
                        st.remap(np.asarray(mp))
                log("cns %s iter %d: %d reads aligned, len %d -> %d, score "
                    "%.1f", unit.name, it + 1, len(pending), len(cns),
                    len(new_cns), dag_score)
            sp_unit.counts["rounds"] += 1
        log("cns %s iter %d time: seed %.3fs align %.3fs dag %.3fs", unit.name,
            it + 1, sp_seed.seconds, sp_align.seconds, sp_dag.seconds)
        if not use_seg:
            log("cns %s iter %d align split: %s", unit.name, it + 1,
                _split_str(split))
        cns = new_cns
        if ckpt:
            _save_cns_ckpt(ckpt, it + 1, cns, offs, prev_agree, prev_offs,
                           prev_cns, st)
        if len(cns) == 0:
            break
    return (cns, offs) if return_offs else cns


def run_cns(units: list[LayUnitig], params: CnsParams | None = None,
            aln_path: str | None = None, vmsa: float | None = None, *,
            device="cuda"):
    """Consensus for all unitigs on `device`; returns list of (name, codes).

    aln_path: write final read-vs-consensus alignments there (reference
    wtcns -a, wtcns.c:586-722).  vmsa: also emit the variant MATRIX rows
    (reference -V <cnt.freq>, e.g. 2.05 = min count 2, min freq 0.05).
    """
    p = params or CnsParams()
    out = []
    alnfh = open(aln_path, "w") if aln_path else None
    try:
        for unit in units:
            cns, offs = consensus_unitig(unit, p, return_offs=True,
                                         device=device)
            if not len(cns):
                continue
            out.append((unit.name, cns))
            if alnfh is not None:
                split: dict = {}
                write_final_alignments(alnfh, unit, offs, cns, p, vmsa=vmsa,
                                       device=device, split=split)
                log("cns %s -a/-V split: %s", unit.name, _split_str(split))
    finally:
        if alnfh is not None:
            alnfh.close()
    return out


_GAP_CHR = np.frombuffer(b"ACGT-", np.uint8)


def _row_str(codes: np.ndarray) -> str:
    return _GAP_CHR[np.clip(codes, 0, 4)].tobytes().decode()


def write_final_alignments(fh, unit: LayUnitig, offs, cns, p: CnsParams,
                           vmsa: float | None = None, margin: int = 3, *,
                           device="cuda", split: dict | None = None):
    """Reference wtcns -a output: per read, a 16-col record + Q/T/M rows;
    with vmsa, per-column base tallies over interior match-run bases and
    MATRIX rows at variant columns (wtcns.c:586-722).

    vmsa encodes min_cnt.min_freq like the reference -V flag: 2.05 means
    min_allele_count 2, min_allele_freq 0.05.
    """
    names = unit.rnames or [f"rd{i}" for i in range(len(unit.reads))]
    cnsid = unit.name.split()[0]
    ga, gb = p.gap_ins, p.gap_del
    rows = []
    for rid, sc, beg, end, ra, rb_ in _align_pass(unit, offs, cns, p, ga, gb,
                                                  device=device, split=split):
        rows.append((rid, sc, beg, end, ra, rb_))
    t_writer = time.perf_counter()
    if vmsa is not None:
        min_cnt = int(vmsa)
        min_freq = vmsa - min_cnt
        bases = np.zeros((4, len(cns)), np.int32)
    counted_rows = {}
    for rid, sc, beg, end, ra, rb_ in rows:
        m_col = (ra != 4) & (rb_ != 4)
        mat = int(np.sum(m_col & (ra == rb_)))
        mis = int(np.sum(m_col & (ra != rb_)))
        ins = int(np.sum((ra != 4) & (rb_ == 4)))
        dl = int(np.sum((ra == 4) & (rb_ != 4)))
        aln = ra.shape[0]
        qlen = len(unit.reads[rid])
        fh.write(f"{names[rid]}\t+\t{qlen}\t0\t{qlen}\t{cnsid}\t+\t{len(cns)}"
                 f"\t{beg}\t{end}\t{sc}\t{mat / (aln + 1):.3f}"
                 f"\t{mat}\t{mis}\t{ins}\t{dl}\n")
        fh.write(f"Q\t{_row_str(ra)}\n")
        fh.write(f"T\t{_row_str(rb_)}\n")
        mline = np.full(aln, ord(" "), np.uint8)
        mline[(ra == 4) | (rb_ == 4)] = ord("-")
        mline[m_col & (ra != rb_)] = ord("*")
        fh.write("M\t" + mline.tobytes().decode() + "\n\n")
        if vmsa is not None:
            # interior of each match run: >margin columns from the nearest
            # indel/alignment end on both sides (wtcns.c:627-668 lc logic)
            runs = m_col.astype(np.int32)
            left = np.zeros(aln, np.int32)
            acc = 0
            for j in range(aln):          # run-distance from run start
                acc = acc + 1 if runs[j] else 0
                left[j] = acc
            right = np.zeros(aln, np.int32)
            acc = 0
            for j in range(aln - 1, -1, -1):
                acc = acc + 1 if runs[j] else 0
                right[j] = acc
            counted = m_col & (left > margin) & (right > margin)
            cpos = np.cumsum(rb_ != 4) - 1 + beg   # cns position per column
            sel = counted & (ra < 4)
            np.add.at(bases, (ra[sel], cpos[sel]), 1)
            counted_rows[rid] = (counted, cpos)
    if vmsa is not None and rows:
        order = np.argsort(bases, axis=0)
        a_ = order[3]
        b_ = order[2]
        cnt_a = bases[a_, np.arange(len(cns))]
        cnt_b = bases[b_, np.arange(len(cns))]
        keys = (a_ != b_) & (cnt_b >= min_cnt) & (cnt_b >= min_freq * cnt_a)
        key_idx = np.nonzero(keys)[0]
        rank = np.cumsum(keys) - keys                 # rank before position
        for rid, sc, beg, end, ra, rb_ in sorted(rows, key=lambda r: r[2]):
            counted, cpos = counted_rows[rid]
            line = ["-"] * len(key_idx)
            in_t = rb_ != 4
            kmask = np.isin(cpos, key_idx) & in_t
            for j in np.nonzero(kmask)[0]:
                ki = int(rank[cpos[j]])
                if not counted[j]:
                    line[ki] = "-"
                elif ra[j] == rb_[j]:
                    line[ki] = "."
                else:
                    line[ki] = "ACGT-"[min(int(ra[j]), 4)]
            fh.write(f"MATRIX\t{names[rid]}\t" + "".join(line) + "\n")
    if split is not None:
        split["writer"] = split.get("writer", 0.0) + (time.perf_counter()
                                                      - t_writer)


def write_cns(path: str, results):
    from ..io.fasta import write_fasta

    with open(path, "w") as fh:
        for name, codes in results:
            write_fasta(fh, f"{name} len={len(codes)}", codes_to_seq(codes), width=100)
