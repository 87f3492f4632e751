#!/usr/bin/env python3
"""Split the whole-read DP kernels (banded, refine, refine5q) of a checkout
into their DP rows and their traceback walk, on one GPU.

    python3 kernel_split.py [ROOT ...] [--B 64] [--LA 32768]

For each ROOT (default: this checkout) the script copies its
csrc/banded.cu, csrc/refine.cu and csrc/warpdp.cuh into a temporary
directory, adds clock64 reads around each read's row loop and its walk
(the checkout's kernels stay as they are), builds the copies with nvcc for
sm_90a and runs them on chip_smoke.py phase 3's inputs (`_wr_inputs`: W 256
for banded, 128 for the refines, seeds 31-33).  For each kernel it prints
the call's time (median of 5 CUDA-event times) and, for the read whose
row loop and walk took longest, the cycles a row and a walk step; then the
card's name, power limit and SM clock.  It also prints `-Xptxas -v` for
every kernel instance of the checkout's unmodified sources.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]
PROBE = ('\n__device__ long long split_clk[65536][2];\n'
         'extern "C" int split_get(void* h, int n) {\n'
         '  return (int)cudaMemcpyFromSymbol(h, split_clk, 16 * (size_t)n);\n}\n')
KINDS = (("banded", 256, 31), ("refine", 128, 32), ("refine5q", 128, 33))


def probed(src: str, name: str) -> str:
    """The source with clock64 reads around the row loop (from the warp's
    start to the score) and the walk (from the traceback to the end)."""
    src = src.replace('#include "warpdp.cuh"', '#include "warpdp.cuh"' + PROBE, 1)
    start = next(a for a in ("if (r >= B) return;  // the whole warp: nothing "
                             "below syncs the block", "const int r = blockIdx.x;")
                 if a in src)
    score = ("  // ---- score and end column" if name == "banded"
             else "  // ---- score: H at")
    walk = "  // ---- traceback"
    end = ("  if (lane == 0) {\n    score_[r] = best;" if name == "banded"
           else "  if (lane == 0) score_[r] = best;")
    for anchor in (start, score, walk, end):
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}.cu: anchor {anchor!r} not found once")
    src = src.replace(start, start + "\n  const long long split_t0 = clock64();", 1)
    src = src.replace(score, "  const long long split_t1 = clock64();\n" + score, 1)
    src = src.replace(walk, "  const long long split_t2 = clock64();\n" + walk, 1)
    return src.replace(end, "  if (lane == 0) {\n    split_clk[r][0] = split_t1 - split_t0;\n"
                            "    split_clk[r][1] = clock64() - split_t2;\n  }\n" + end, 1)


def build(root: str, tmp: str):
    """(libs by kernel source, ptxas text of the unmodified sources)."""
    csrc = os.path.join(root, "smartdenovo_tpu_torch", "csrc")
    procs = {}
    for name in ("banded", "refine"):
        shutil.copy(os.path.join(csrc, "warpdp.cuh"), tmp)
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            src = f.read()
        fn = os.path.join(tmp, f"{name}_split.cu")
        with open(fn, "w") as f:
            f.write(probed(src, name))
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, "-shared", "-o", fn[:-3] + ".so", fn],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name + " ptxas"] = subprocess.Popen(
            [NVCC, *FLAGS, "-Xptxas", "-v", "-cubin", "-o",
             os.path.join(tmp, f"{name}.cubin"), os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, []
    for key, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{out}")
        if key.endswith("ptxas"):
            fn = None
            for ln in out.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", ln)
                if m:
                    fn = re.sub(r".*?([a-z]+_warpILi\d+E(?:Lb\dE)*).*", r"\1", m.group(1))
                elif "Used" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln):
                    ptxas.append(f"ptxas {fn}: {ln.split('info    : ')[-1].strip()}")
            continue
        lib = ctypes.CDLL(os.path.join(tmp, f"{key}_split.so"))
        lib.split_get.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[key] = lib
    return libs, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", default=[HERE])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--LA", type=int, default=32768)
    args = ap.parse_args()
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    B, LA = args.B, args.LA
    inputs = {kind: [torch.from_numpy(x).to(dev)
                     for x in cs._wr_inputs(kind, B, LA, W, seed)]
              for kind, W, seed in KINDS}
    P, I = ctypes.c_void_p, ctypes.c_int
    for root in map(os.path.abspath, args.roots):
        with tempfile.TemporaryDirectory() as tmp:
            libs, ptxas = build(root, tmp)
            for ln in ptxas:
                print(f"{root}: {ln}")
            for kind, W, _ in KINDS:
                t = inputs[kind]
                a, b, alen, blen, base = t[0], t[1], t[-3], t[-2], t[-1]
                LB = b.shape[1]
                T = 2 * (LA + 1) + W + (0 if kind == "banded" else 4)
                dirs = torch.empty((B, LA + 1, W), dtype=torch.uint8, device=dev)
                i32 = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
                mvs = torch.empty((T, B), dtype=torch.int8, device=dev)
                st = torch.cuda.current_stream().cuda_stream
                lib = libs["banded" if kind == "banded" else "refine"]
                if kind == "banded":
                    fn = lib.banded_align_tb
                    rowmax = "int* rmax" in open(os.path.join(
                        root, "smartdenovo_tpu_torch", "csrc", "banded.cu")).read()
                    fn.argtypes = [P] * 5 + [I] * 10 + [P] * (8 if rowmax else 6)
                    extra = [None, None] if rowmax else []
                    call = lambda: fn(a.data_ptr(), b.data_ptr(), alen.data_ptr(),
                                      blen.data_ptr(), base.data_ptr(), B, LA, LB,
                                      W, T, 2, -5, -2, -3, 1, dirs.data_ptr(),
                                      i32[0].data_ptr(), i32[1].data_ptr(),
                                      mvs.data_ptr(), i32[2].data_ptr(), *extra, st)
                    noop = 0
                else:
                    fn = lib.refine_align_tb
                    fn.argtypes = [P] * 10 + [I] * 11 + [P] * 4
                    q5 = kind == "refine5q"
                    tp = [x.data_ptr() for x in t[2:7]] if q5 else [0] * 5
                    c = [251, 236, 241, 251, 0] if q5 else [2, -5, -2, -3, -1]
                    call = lambda: fn(a.data_ptr(), b.data_ptr(), alen.data_ptr(),
                                      blen.data_ptr(), base.data_ptr(), *tp, B, LA,
                                      LB, W, T, int(q5), *c, dirs.data_ptr(),
                                      i32[0].data_ptr(), mvs.data_ptr(), st)
                    noop = 3
                if call() != 0:
                    raise RuntimeError(f"{kind}: the launch failed")
                ms = cs.cuda_ms(call, reps=5)
                call()
                torch.cuda.synchronize()
                clk = np.zeros((B, 2), np.int64)
                assert lib.split_get(clk.ctypes.data, B) == 0
                steps = (mvs != noop).sum(0).cpu().numpy()
                al = alen.cpu().numpy()
                k = int(np.argmax(clk[:, 0] + clk[:, 1]))
                print(f"{root}: {kind} B={B} LA={LA} W={W}: {ms:.3f} ms; read {k} "
                      f"(alen {al[k]}, {steps[k]} walk steps): rows "
                      f"{clk[k, 0] / max(al[k], 1):.1f} cycles a row, walk "
                      f"{clk[k, 1] / max(steps[k], 1):.1f} cycles a step", flush=True)
                del dirs, mvs
                torch.cuda.empty_cache()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
