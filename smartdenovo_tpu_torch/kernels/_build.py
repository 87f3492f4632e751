"""Build the CUDA kernels of ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/*.cu`` file compiles to an object of its own, all of them at
once (one nvcc process per source), and the objects link into one shared
library with a plain C interface, for Hopper (``sm_90a``).  The library
is built at the first CUDA launch into ``smartdenovo_tpu_torch/_build/``
(listed in .gitignore), under a name keyed by a hash of the sources and
flags, so a fresh checkout builds it once and an edited source rebuilds
it.

Each C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0.  ``LAUNCHES`` counts kernel launches
per wrapper: a wrapper adds one where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

LAUNCHES = {"sseg": 0, "jpost": 0, "pexpand": 0, "segdp": 0, "banded": 0,
            "refine": 0, "refine5q": 0, "swlocal": 0, "swwide": 0,
            "nwglobal": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C signatures: (name, argtypes); the entry points that launch return an
# int (cudaError_t), the others a size or a flag
_SIGNATURES = {
    # seg_new, v8, N, ops, out_budget, out, count, scratch, stream
    "sseg_reduce_compact": [_P, _P, _I64, _I32, _I32, _P, _P, _P, _P],
    # N -> ints of scratch that sseg_reduce_compact needs
    "sseg_scratch_ints": [_I64],
    # -> entries a tile
    "sseg_tile": [],
    # ops -> 1 when that lane-op set is compiled with its ops known
    "sseg_specialized": [_I32],
    # key, pay, aux, N, max_per_read, out_budget, out, totals, scratch, stream
    "jpost_join_emitters": [_P, _P, _P, _I64, _I32, _I32, _P, _P, _P, _P],
    # N -> ints of scratch that jpost_join_emitters needs
    "jpost_scratch_ints": [_I64],
    # -> entries a tile
    "jpost_tile": [],
    # cnt, pay, aux, base, NE, pair_budget, out, scratch, stream
    "pexpand_expand_emit": [_P, _P, _P, _P, _I64, _I64, _P, _P, _P],
    # NE, pair_budget -> ints of scratch that pexpand_expand_emit needs
    "pexpand_scratch_ints": [_I64, _I64],
    # a, b, alen, blen, b16, Bc, SEGR, LBW, NB, W, T, match, mismatch,
    # open_i, open_d, ext, dirs, score, b_beg, b_end, mvp, stream
    "segdp_align_tb": [_P, _P, _P, _P, _P] + [_I32] * 11 + [_P] * 6,
    # SEGR, LBW, W, segments a block, blocks an SM
    "segdp_occupancy": [_I32, _I32, _I32, _P, _P],
    # a, b, alen, blen, base, B, LA, LB, W, T, match, mismatch, gap_a,
    # gap_b, semiglobal_b, dirs, score, end_col, mvs, j_final, rmax, rcol
    # (both null: no row maxima), stream
    "banded_align_tb": [_P] * 5 + [_I32] * 10 + [_P] * 8,
    # a, b, alen, blen, base, subqv, insqv, delqv, subtag, deltag (0 for
    # the affine costs), B, LA, LB, W, T, q5, five costs (match, mismatch,
    # open_i, open_d, ext or qclp, qmis, qdel, qext, 0), dirs, score, mvs,
    # stream
    "refine_align_tb": [_P] * 10 + [_I32] * 11 + [_P] * 4,
    # a, b, blen, tb, qb, slope, i0, i1, order, counter, B, LA, LB, W,
    # match, mismatch, gap, out, stream
    "swlocal_dp": [_P] * 10 + [_I32] * 7 + [_P] * 2,
    # the same for any W up to 4096 (csrc/swwide.cu), with unit [B] u8
    # after i1 (the pairs whose band moves 0 or 1 column a row) and the
    # block shape P, warps after W
    "swwide_dp": [_P] * 11 + [_I32] * 9 + [_P] * 2,
    # a, b, alen, blen, B, L, match, mismatch, gap, P (0: the wide
    # instance), warps, pairs, in_smem, scratch, score, dirs, stream
    "nwglobal_align": [_P] * 4 + [_I32] * 9 + [_P] * 4,
}
_RESTYPES = {"sseg_scratch_ints": _I64, "jpost_scratch_ints": _I64,
             "pexpand_scratch_ints": _I64}   # the others return an int


def _nvcc() -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsdtpu_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet.  Returns (path,
    seconds spent compiling; 0.0 when it was already there)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}.tmp"
    tmp = so.with_name(so.name + tag)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / (s.stem + tag + ".o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for s, o in zip(srcs, objs)]
    errs = []
    for s, pr in zip(srcs, procs):
        _out, err = pr.communicate()
        if pr.returncode != 0:
            errs.append(f"{s.name} ({pr.returncode}):\n{err}")
    if not errs:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            errs.append(f"link ({res.returncode}):\n{res.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    if errs:
        raise RuntimeError("nvcc failed: " + "\n".join(errs))
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    so, _ = build()
    cdll = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, _I32)
    return cdll


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
