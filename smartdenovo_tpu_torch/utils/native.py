"""Compile on demand and load with ctypes the native (C++) host engines.

The DAG consensus engine (native/dagcns.cpp) and wtmsa's POA engine
(native/poa.cpp) are plain C++ called through ctypes; this package keeps
its own copies of their sources in ``smartdenovo_tpu_torch/native/``,
beside its own segment stitcher (native/stitch.cpp).
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
