"""Compile on demand and load with ctypes the native (C++) host engines.

The DAG consensus engine (native/dagcns.cpp) and wtmsa's POA engine
(native/poa.cpp) are plain C++ called through ctypes; this package keeps
its own copies of their sources in ``smartdenovo_tpu_torch/native/``.
Each is compiled with g++ at first use into ``smartdenovo_tpu_torch/_build/``
(listed in .gitignore), under a name keyed by a hash of the source and the
flags, so an edited source rebuilds and nothing is written beside the
sources.
"""

from __future__ import annotations

import ctypes
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
