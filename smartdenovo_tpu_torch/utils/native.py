"""Compile on demand and load with ctypes the native (C++) host engines.

The DAG consensus engine (native/dagcns.cpp) and wtmsa's POA engine
(native/poa.cpp) are plain C++ called through ctypes; this package keeps
its own copies of their sources in ``smartdenovo_tpu_torch/native/``,
beside its own segment stitcher (native/stitch.cpp), the SW engine's
CIGAR stage (native/cigars.cpp) and the dm engine's emission
(native/emitdm.cpp).
Each is compiled with g++ at first use into ``smartdenovo_tpu_torch/_build/``
(listed in .gitignore), under a name keyed by a hash of the source and the
flags, so an edited source rebuilds and nothing is written beside the
sources.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_PKG, "native")
_BUILD = os.path.join(_PKG, "_build")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_CACHE: dict[str, ctypes.CDLL] = {}


def build_and_load(name: str) -> ctypes.CDLL:
    if name in _CACHE:
        return _CACHE[name]
    src = os.path.join(_NATIVE, f"{name}.cpp")
    with open(src, "rb") as fh:
        h = hashlib.sha256(" ".join(_FLAGS).encode() + fh.read())
    so = os.path.join(_BUILD, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_FLAGS, "-o", tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _CACHE[name] = lib
    return lib


class DagCns:
    """ctypes wrapper over native/dagcns.cpp."""

    def __init__(self, ref_penalty: float = 0.5, alt_penalty: float = 0.2):
        lib = build_and_load("dagcns")
        lib.dagcns_new.restype = ctypes.c_void_p
        lib.dagcns_new.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.dagcns_free.argtypes = [ctypes.c_void_p]
        lib.dagcns_set_backbone.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.dagcns_add_alignment.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.dagcns_merge_nodes.argtypes = [ctypes.c_void_p]
        lib.dagcns_consensus.restype = ctypes.c_int
        lib.dagcns_consensus.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
        lib.dagcns_get_cns.restype = ctypes.c_int
        lib.dagcns_get_cns.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.dagcns_score.restype = ctypes.c_double
        lib.dagcns_score.argtypes = [ctypes.c_void_p]
        lib.dagcns_call_snv.restype = ctypes.c_int
        lib.dagcns_call_snv.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        self._lib = lib
        self._h = lib.dagcns_new(ref_penalty, alt_penalty)
        self.backbone_size = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dagcns_free(self._h)
            self._h = None

    @staticmethod
    def _u8ptr(arr: np.ndarray):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def set_backbone(self, codes: np.ndarray):
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        self.backbone_size = len(codes)
        self._lib.dagcns_set_backbone(self._h, self._u8ptr(codes), len(codes))

    def add_alignment(self, beg: int, end: int, aln_backbone: np.ndarray, aln_read: np.ndarray):
        a0 = np.ascontiguousarray(aln_backbone, dtype=np.uint8)
        a1 = np.ascontiguousarray(aln_read, dtype=np.uint8)
        assert len(a0) == len(a1)
        self._lib.dagcns_add_alignment(
            self._h, beg, end, self._u8ptr(a0), self._u8ptr(a1), len(a0))

    def merge_nodes(self):
        self._lib.dagcns_merge_nodes(self._h)

    def consensus(self, with_map: bool = True):
        if with_map:
            mp = np.zeros(self.backbone_size + 2, np.uint32)
            mpp = mp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
            mcap = len(mp)
        else:
            mp, mpp, mcap = None, None, 0
        n = self._lib.dagcns_consensus(self._h, mpp, mcap)
        out = np.zeros(max(1, n), np.uint8)
        self._lib.dagcns_get_cns(self._h, self._u8ptr(out), len(out))
        score = self._lib.dagcns_score(self._h)
        return out[:n], (mp if with_map else None), score

    def call_snv(self, min_cnt: int = 2, min_freq: float = 0.05, cap: int = 65536):
        """SNV records along the consensus path (wtcns -V equivalent).

        Returns array [n, 5]: pos, cns_base, alt_base, cns_cnt, alt_cnt."""
        buf = np.zeros(cap * 5, np.int32)
        n = self._lib.dagcns_call_snv(
            self._h, min_cnt, min_freq,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        return buf[: n * 5].reshape(-1, 5).copy()


class PoaCns:
    """ctypes wrapper over native/poa.cpp (wtmsa's POA consensus engine)."""

    def __init__(self, match=2, mismatch=-5, gap=-3, band=100):
        lib = build_and_load("poa")
        lib.poa_new.restype = ctypes.c_void_p
        lib.poa_new.argtypes = [ctypes.c_int] * 4
        lib.poa_free.argtypes = [ctypes.c_void_p]
        lib.poa_init_backbone.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.poa_align_and_add.restype = ctypes.c_int
        lib.poa_align_and_add.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.poa_consensus.restype = ctypes.c_int
        lib.poa_consensus.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        self._lib = lib
        self._h = lib.poa_new(match, mismatch, gap, band)
        self.backbone_size = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.poa_free(self._h)
            self._h = None

    @staticmethod
    def _u8(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def init_backbone(self, codes: np.ndarray):
        codes = np.ascontiguousarray(codes, np.uint8)
        self.backbone_size = len(codes)
        self._lib.poa_init_backbone(self._h, self._u8(codes), len(codes))

    def align_and_add(self, read: np.ndarray, wlo: int, whi: int) -> int:
        read = np.ascontiguousarray(read, np.uint8)
        return self._lib.poa_align_and_add(self._h, self._u8(read), len(read),
                                           int(wlo), int(whi))

    def consensus(self) -> np.ndarray:
        cap = max(64, self.backbone_size * 2 + 64)
        out = np.zeros(cap, np.uint8)
        n = self._lib.poa_consensus(self._h, self._u8(out), cap)
        return out[:n].copy()


STITCHED, RESEED, SKIPPED = 0, 1, 2


def _stitch_lib() -> ctypes.CDLL:
    lib = build_and_load("stitch")
    i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    p8 = ctypes.POINTER(ctypes.c_uint8)
    lib.stitch_run.restype = ctypes.c_void_p
    lib.stitch_run.argtypes = [
        i64, p64, p64, p64, p8, i64, i64, i64, i64, p64, p64, p8, i64, p64,
        p64, p8, *[i64] * 6, *[p64] * 6]
    lib.stitch_fetch.argtypes = [ctypes.c_void_p, p64, p8, p8, p64]
    lib.stitch_free.argtypes = [ctypes.c_void_p]
    return lib


@dataclasses.dataclass
class Stitched:
    """A round's stitched reads: per read a status (STITCHED, RESEED: its
    column map is to be seeded again, SKIPPED: no segments) and, for a
    stitched one, its score, consensus span [beg, end), aligned rows
    ra[aln_offs[i]:aln_offs[i + 1]] (read) and rb (consensus), 4 = gap,
    and column map cm[cm_offs[i]:cm_offs[i + 1]]; `fallbacks` counts the
    junctions cut where the two segments share no column."""

    status: np.ndarray
    sc: np.ndarray
    beg: np.ndarray
    end: np.ndarray
    aln_offs: np.ndarray
    ra: np.ndarray
    rb: np.ndarray
    cm_offs: np.ndarray
    cm: np.ndarray
    fallbacks: int


def _p64(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p8(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def stitch_round(first, nseg, r0, mv_all, arr, b_beg, flat, flat_offs, lens,
                 cns_pad, Lc: int, match: int, mismatch: int, open_i: int,
                 open_d: int, ext: int) -> Stitched:
    """native/stitch.cpp over one round of the segment engine.

    Read i's segments are rows first[i] .. first[i] + nseg[i] - 1 of r0
    [Np] (first read row), mv_all [Np, T] u8 (backward 2-bit move streams,
    3 = padding), arr [Np, 5] (rid, r0, alen, w0, blen) and b_beg [Np];
    flat / flat_offs / lens hold the reads' codes, cns_pad the consensus
    (Lc bases, then padding).  Raises IndexError where the plain stitcher
    would index out of an array."""
    first, nseg, r0, arr, b_beg, flat_offs, lens = (
        np.ascontiguousarray(x, np.int64)
        for x in (first, nseg, r0, arr, b_beg, flat_offs, lens))
    flat = np.ascontiguousarray(flat, np.uint8)
    cns_pad = np.ascontiguousarray(cns_pad, np.uint8)
    if mv_all.dtype != np.uint8 or mv_all.ndim != 2:
        raise ValueError("stitch_round: mv_all must be a 2-D uint8 array")
    n, (Np, T) = len(first), mv_all.shape
    if (len(nseg) != n or len(lens) < n or len(flat_offs) < n
            or r0.shape != (Np,) or arr.shape != (Np, 5)
            or b_beg.shape != (Np,)):
        raise ValueError("stitch_round: array shapes do not agree")
    if not 0 < Lc <= len(cns_pad):
        raise ValueError(f"stitch_round: Lc {Lc} outside the consensus buffer")
    status, sc, beg, end = (np.zeros(n, np.int64) for _ in range(4))
    aln_offs, cm_offs = np.zeros(n + 1, np.int64), np.zeros(n + 1, np.int64)
    counts = np.zeros(1, np.int64)
    lib = _stitch_lib()
    h = lib.stitch_run(
        n, _p64(first), _p64(nseg), _p64(r0), _p8(mv_all), Np, T,
        mv_all.strides[0], mv_all.strides[1], _p64(arr), _p64(b_beg),
        _p8(flat), len(flat), _p64(flat_offs), _p64(lens), _p8(cns_pad), Lc,
        match, mismatch, open_i, open_d, ext, _p64(status), _p64(beg),
        _p64(end), _p64(aln_offs), _p64(cm_offs), _p64(counts))
    if not h:
        raise IndexError("stitch_round: an index runs out of its array")
    try:
        ra = np.empty(int(aln_offs[-1]), np.uint8)
        rb = np.empty(int(aln_offs[-1]), np.uint8)
        cm = np.empty(int(cm_offs[-1]), np.int64)
        lib.stitch_fetch(h, _p64(sc), _p8(ra), _p8(rb), _p64(cm))
    finally:
        lib.stitch_free(h)
    return Stitched(status, sc, beg, end, aln_offs, ra, rb, cm_offs, cm,
                    int(counts[0]))


# ---------------------------------------------------------------------------
# native/cigars.cpp: the SW (zmo) engine's CIGAR stage, a batch at a time
# ---------------------------------------------------------------------------

_CIG_ERRORS = {1: (IndexError, "an index runs out of its array"),
               2: (ValueError, "a move or op code out of range"),
               3: (ValueError, "a count out of range")}


def _cig_check(name: str, err: int):
    if err:
        kind, what = _CIG_ERRORS[err]
        raise kind(f"{name}: {what}")


def _cigars_lib() -> ctypes.CDLL:
    lib = build_and_load("cigars")
    i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    p8, p32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.cig_segs.restype = ctypes.c_int
    lib.cig_segs.argtypes = [i64, p8, i64, p64, i64, *[p64] * 9, p8, p8]
    lib.cig_band.restype = ctypes.c_int
    lib.cig_band.argtypes = [i64, p64, p8, p64, p64, p8, p64, p64, i64, i64,
                             i64, p8, p8, p32]
    lib.cig_rle_run.restype = ctypes.c_void_p
    lib.cig_rle_run.argtypes = [p8, i64, i64, p64, p64, p64,
                                ctypes.POINTER(ctypes.c_int)]
    lib.cig_rle_fetch.argtypes = [ctypes.c_void_p, p8, p32]
    lib.cig_rle_free.argtypes = [ctypes.c_void_p]
    lib.cig_text_len.restype = ctypes.c_int
    lib.cig_text_len.argtypes = [i64, p64, p64, p32, p64]
    lib.cig_strings.restype = ctypes.c_int
    lib.cig_strings.argtypes = [i64, p8, p64, p64, p8, p64, p64, p64, p64,
                                p64, p8, p32, p64, p64, ctypes.c_char_p]
    return lib


def _p32(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int64)


@dataclasses.dataclass
class Segments:
    """A batch's overlap segments, flat: overlap i's query codes
    q[q_offs[i]:q_offs[i + 1]] (alen[i] of them) and its candidate's
    c[c_offs[i]:c_offs[i + 1]] (blen[i])."""

    q: np.ndarray
    q_offs: np.ndarray
    alen: np.ndarray
    c: np.ndarray
    c_offs: np.ndarray
    blen: np.ndarray

    def __post_init__(self):
        self.q, self.c = (np.ascontiguousarray(x, np.uint8)
                          for x in (self.q, self.c))
        self.q_offs, self.alen, self.c_offs, self.blen = (
            _i64(x) for x in (self.q_offs, self.alen, self.c_offs, self.blen))
        for codes, offs, lens in ((self.q, self.q_offs, self.alen),
                                  (self.c, self.c_offs, self.blen)):
            if (offs.shape != (len(lens) + 1,) or offs[0] != 0
                    or not np.array_equal(np.diff(offs), lens)
                    or (lens < 0).any() or offs[-1] > len(codes)):
                raise ValueError("Segments: offsets and lengths disagree")

    @classmethod
    def from_pairs(cls, pairs) -> "Segments":
        """The segments of (query codes, target codes) pairs, copied flat
        with the slack of `padded`."""
        parts = []
        for side in (0, 1):
            segs = [np.asarray(p[side], np.uint8) for p in pairs]
            lens = np.array([len(s) for s in segs], np.int64)
            parts += [np.concatenate(segs + [np.zeros(16, np.uint8)]),
                      np.concatenate([[0], np.cumsum(lens)]), lens]
        return cls(*parts)

    def padded(self) -> tuple[np.ndarray, np.ndarray]:
        """q and c with 16 bytes past their last segment, which
        native/cigars.cpp reads 16 at a time."""
        return tuple(x if len(x) >= offs[-1] + 16 else
                     np.concatenate([x[:offs[-1]], np.zeros(16, np.uint8)])
                     for x, offs in ((self.q, self.q_offs),
                                     (self.c, self.c_offs)))

    def query(self, i: int) -> np.ndarray:
        return self.q[self.q_offs[i]:self.q_offs[i + 1]]

    def cand(self, i: int) -> np.ndarray:
        return self.c[self.c_offs[i]:self.c_offs[i + 1]]


def cigar_segments(bases, read_offs, fields) -> Segments:
    """The segments of overlaps fields [n, 7] (rid1, beg1, end1, rid2,
    dir2, beg2, end2): rb.get(rid1)[beg1:end1] and, reverse-complemented
    where dir2 (readbank.revcomp_codes), rb.get(rid2)[beg2:end2], in one
    call of native/cigars.cpp.  Raises IndexError for a read id or a span
    outside its read."""
    f = _i64(fields).reshape(-1, 7)
    read_offs, bases = _i64(read_offs), np.ascontiguousarray(bases, np.uint8)
    alen, blen = f[:, 2] - f[:, 1], f[:, 6] - f[:, 5]
    if (alen < 0).any() or (blen < 0).any():
        raise IndexError("cigar_segments: a span ends before it begins")
    q_offs = np.zeros(len(f) + 1, np.int64)
    c_offs = np.zeros(len(f) + 1, np.int64)
    np.cumsum(alen, out=q_offs[1:])
    np.cumsum(blen, out=c_offs[1:])
    # slack past the last segment (Segments.padded)
    q = np.zeros(int(q_offs[-1]) + 16, np.uint8)
    c = np.zeros(int(c_offs[-1]) + 16, np.uint8)
    rid1, qb, rid2, rev, cb = (_i64(f[:, k]) for k in (0, 1, 3, 4, 5))
    alen, blen = _i64(alen), _i64(blen)
    _cig_check("cigar_segments", _cigars_lib().cig_segs(
        len(f), _p8(bases), len(bases), _p64(read_offs), len(read_offs) - 1,
        _p64(rid1), _p64(qb), _p64(alen), _p64(rid2), _p64(cb), _p64(blen),
        _p64(rev), _p64(q_offs), _p64(c_offs), _p8(q), _p8(c)))
    return Segments(q, q_offs, alen, c, c_offs, blen)


def cigar_band(segs: Segments, idx, LA: int, W: int):
    """One `banded_align` group of overlaps idx: a [n, LA] and b [n, LB]
    u8, the segments padded with 4 (LB = the group's longest candidate
    segment, 1 at least), and base [n, LA + 1] i32, which is
    make_band_centers with the anchors (0, 0) and (alen, blen)."""
    idx = _i64(idx)
    n = len(idx)
    LB = max(int(segs.blen[idx].max()), 1)
    a = np.empty((n, LA), np.uint8)
    b = np.empty((n, LB), np.uint8)
    base = np.empty((n, LA + 1), np.int32)
    _cig_check("cigar_band", _cigars_lib().cig_band(
        n, _p64(idx), _p8(segs.q), _p64(segs.q_offs), _p64(segs.alen),
        _p8(segs.c), _p64(segs.c_offs), _p64(segs.blen), LA, LB, W, _p8(a),
        _p8(b), _p32(base)))
    return a, b, base


def cigar_rle(mvs, j_final):
    """traceback_banded over one group's moves, given transposed: mvs
    [n, T] i8 (row k is column k of `banded_align`'s [T, n] moves) and
    j_final [n], in one call.  Returns (ops u8, counts i32, offs [n + 1],
    b_beg [n]): overlap k's runs are ops/counts[offs[k]:offs[k + 1]], op
    0 = M, 1 = I, 2 = D."""
    if mvs.dtype != np.int8 or mvs.ndim != 2:
        raise ValueError("cigar_rle: mvs must be a 2-D int8 array")
    mvs = np.ascontiguousarray(mvs)
    n, T = mvs.shape
    j_final = _i64(j_final)
    if j_final.shape != (n,):
        raise ValueError("cigar_rle: j_final does not match mvs")
    b_beg, nruns = np.zeros(n, np.int64), np.zeros(n, np.int64)
    err = ctypes.c_int(0)
    lib = _cigars_lib()
    h = lib.cig_rle_run(mvs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        n, T, _p64(j_final), _p64(b_beg), _p64(nruns),
                        ctypes.byref(err))
    if not h:
        _cig_check("cigar_rle", err.value)
    try:
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(nruns, out=offs[1:])
        ops = np.empty(int(offs[-1]), np.uint8)
        counts = np.empty(int(offs[-1]), np.int32)
        lib.cig_rle_fetch(h, _p8(ops), _p32(counts))
    finally:
        lib.cig_rle_free(h)
    return ops, counts, offs, b_beg


def cigar_strings(segs: Segments, b_beg, run_beg, run_end, ops, counts):
    """Per overlap i, its runs ops/counts[run_beg[i]:run_end[i]] over its
    query segment and its candidate segment from column b_beg[i], in one
    call: (stats [n, 5] i64: mat, mis, ins, dl, aln, as _cigar_stats
    counts them over align_strings; text_offs [n + 1]; text u8, overlap
    i's CIGAR at text[text_offs[i]:text_offs[i + 1]]).  Raises IndexError
    where the runs consume past a segment's end, as align_strings would."""
    b_beg, run_beg, run_end = (_i64(x) for x in (b_beg, run_beg, run_end))
    ops = np.ascontiguousarray(ops, np.uint8)
    counts = np.ascontiguousarray(counts, np.int32)
    n = len(segs.alen)
    if not (b_beg.shape == run_beg.shape == run_end.shape == (n,)):
        raise ValueError("cigar_strings: array shapes do not agree")
    if n and ((run_beg < 0) | (run_end < run_beg)
              | (run_end > len(ops))).any() or len(ops) != len(counts):
        raise IndexError("cigar_strings: runs outside the run arrays")
    q, c = segs.padded()
    lib = _cigars_lib()
    text_offs = np.zeros(n + 1, np.int64)
    _cig_check("cigar_strings", lib.cig_text_len(
        n, _p64(run_beg), _p64(run_end), _p32(counts), _p64(text_offs)))
    text = np.empty(int(text_offs[-1]) + 8, np.uint8)
    stats = np.zeros((n, 5), np.int64)
    _cig_check("cigar_strings", lib.cig_strings(
        n, _p8(q), _p64(segs.q_offs), _p64(segs.alen), _p8(c),
        _p64(segs.c_offs), _p64(segs.blen), _p64(b_beg), _p64(run_beg),
        _p64(run_end), _p8(ops), _p32(counts), _p64(text_offs),
        _p64(stats), text.ctypes.data_as(ctypes.c_char_p)))
    return stats, text_offs, text[:-8]


# ---------------------------------------------------------------------------
# native/emitdm.cpp: the dm engine's emission, a query batch at a time
# ---------------------------------------------------------------------------


def _emitdm_lib() -> ctypes.CDLL:
    lib = build_and_load("emitdm")
    i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.emitdm_new.restype = ctypes.c_void_p
    lib.emitdm_new.argtypes = [i64, p64, i64, i64, i64, ctypes.c_double, i64,
                               i64, i64, i64, p64]
    lib.emitdm_free.argtypes = [ctypes.c_void_p]
    lib.emitdm_batch.restype = ctypes.c_int
    lib.emitdm_batch.argtypes = [ctypes.c_void_p, i64, i64, p32, p32, p32,
                                 i64, p64, p64]
    lib.emitdm_fetch.restype = i64
    lib.emitdm_fetch.argtypes = [ctypes.c_void_p, p64, p64]
    lib.emitdm_npairs.restype = i64
    lib.emitdm_npairs.argtypes = [ctypes.c_void_p]
    lib.emitdm_pairs.argtypes = [ctypes.c_void_p, p64]
    return lib


def _i32(x) -> np.ndarray:
    """x as a contiguous int32 array; a value that int32 cannot hold
    raises."""
    x = np.asarray(x)
    if x.dtype == np.int32:
        return np.ascontiguousarray(x)
    y = np.ascontiguousarray(x, np.int32)
    if not np.array_equal(y, x):
        raise ValueError("a value outside int32")
    return y


class EmitDm:
    """native/emitdm.cpp: the dm engine's emission over one pass, the
    state (pre-attempted and emitted pairs) held natively from batch to
    batch.  `lengths` are the bank's read lengths, `pre_pairs` read-id
    pairs that are not to be emitted (the -L ledger); the gates are the
    overlapper's parameters."""

    def __init__(self, lengths, *, zsize: int, ztot: int, min_score: int,
                 min_id: float, nbest: int, avg_len: int,
                 max_unalign_dovetail: int, pre_pairs=()):
        self._lib = _emitdm_lib()
        self._h = None
        lens = _i64(lengths)
        pre = np.array(list(pre_pairs), np.int64).reshape(-1, 2)
        self.n = len(lens)
        self._h = self._lib.emitdm_new(
            self.n, _p64(lens), zsize, ztot, min_score, float(min_id), nbest,
            avg_len, max_unalign_dovetail, len(pre), _p64(pre))
        if not self._h:
            raise IndexError("EmitDm: a pre-attempted pair names a read "
                             "outside the bank")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.emitdm_free(self._h)
            self._h = None

    def batch(self, rids, row, csorted, Q: int, A: int, rdcovs, pd=None,
              attempted: bool = False):
        """_emit_batch_dm's work on one batch: rids [Q], csorted [Q, A],
        the packed row at pair-row width pd (None: the positional Q*A*2
        layout), the coverage rdcovs [n] int64, updated in place.  Returns
        (recs [k, 9] i64: rid1, beg1, end1, rid2, dir2, beg2, end2, score,
        aln, in emission order; att [m, 2] i64, the attempted pairs in the
        order they were first inserted, None unless `attempted`;
        (candidate rows replayed, attempted rows))."""
        NP = Q * A * 2
        W = NP if pd is None else int(pd)
        rids, row, csorted = _i32(rids), _i32(row), _i32(csorted)
        if (rdcovs.dtype != np.int64 or not rdcovs.flags.c_contiguous
                or rdcovs.shape != (self.n,)):
            raise ValueError("EmitDm.batch: rdcovs must be a contiguous "
                             "int64 array of one entry a read")
        if (rids.shape != (Q,) or csorted.size != Q * A
                or row.ndim != 1 or len(row) < 6 * W + NP):
            raise ValueError("EmitDm.batch: array shapes do not agree")
        counts = np.zeros(3, np.int64)
        err = self._lib.emitdm_batch(self._h, Q, A, _p32(rids), _p32(csorted),
                                     _p32(row), W, _p64(rdcovs),
                                     _p64(counts))
        if err:
            raise IndexError("EmitDm.batch: a read or pair id outside the "
                             "bank or the row map")
        recs = np.empty((int(counts[0]), 9), np.int64)
        att = np.empty((Q * A, 2), np.int64) if attempted else None
        m = self._lib.emitdm_fetch(self._h, _p64(recs),
                                   None if att is None else _p64(att))
        return (recs, None if att is None else att[:m],
                (int(counts[1]), int(counts[2])))

    def pairs(self) -> np.ndarray:
        """The pass's emitted pairs [k, 2] (smaller id, larger id), in no
        particular order."""
        out = np.empty((self._lib.emitdm_npairs(self._h), 2), np.int64)
        self._lib.emitdm_pairs(self._h, _p64(out))
        return out
