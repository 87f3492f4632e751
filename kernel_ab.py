#!/usr/bin/env python3
"""Time DP kernels of two checkouts of this repository on one GPU, in
turns: other, this, this, other.

    python3 kernel_ab.py OTHER_ROOT [--kernels banded refine refine5q swlocal
                                               swwide nwglobal zmo]
                                               [--B 64 528] [--LA 32768]

OTHER_ROOT is another checkout (for example `git archive` of an earlier
commit unpacked into a directory that .gitignore lists).  The inputs are
chip_smoke.py phase 3's, made once here and saved: for the whole-read DPs
(the default kernels) `_wr_inputs` at each B and LA (W 256 for banded, 128
for the refines, seeds 31-33); for swlocal (the SW local DP) one batch of
the E. coli zmo path, `_sw_batch(77)` (2,048 pairs, W 256; --B and --LA do
not apply); for swwide (the wide-band SW local DP) phase 3's call of `cyc`
on the E. coli reads, `cyc_chunk` (2,048 reads against their reverse
complements, LA 16,384, W 1600; timed over 5 calls each); for nwglobal
(the global NW DP, `batch_global_align`) its two callers' shapes, phase
3's batch `_nw_batch(91)` (2,048 pairs, L 512) and the DAG loop's first
call `nw_dag_inputs()` (24 reads, L 2,048).  `zmo` is not
one kernel but chip_smoke.py phase 8 (a), the end-to-end run that holds
swlocal: `asm -e zmo` through the CLI on the E. coli reads
(`ecoli_reads`), whose `phase2` stage, wall and overlap count it reports.  Each turn is a process of its own with its checkout's root
first on sys.path, which builds that checkout's kernels and times each
call alone through that checkout's wrappers (`chip_smoke.cuda_ms`, median
of 10 CUDA-event times).  Prints a line per turn and kernel, the card's
name and power limit, and a JSON line with both checkouts' times per
kernel and shape.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
KINDS = (("banded", 256, 31), ("refine", 128, 32), ("refine5q", 128, 33))
WR_KINDS = tuple(k for k, _, _ in KINDS)
SW_W = 256
CYC_W = 1600


def one_turn(root, inputs, kernels, Bs, LA):
    """Time every kernel (and B) with the checkout at root."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from smartdenovo_tpu_torch.kernels import _build

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    _build.build()
    dev = torch.device("cuda", 0)
    z = np.load(inputs)
    out = {}
    if "zmo" in kernels:
        import re

        prefix = os.path.join(os.path.dirname(inputs), "ecoli")
        log, wall = cs._run_cli(["asm", prefix + "_reads.fa", "-p", prefix,
                                 "-e", "zmo", "--batch-q", "16", "--device",
                                 "cuda"])
        stages = dict(re.findall(r"stage (\w+): ([0-9.]+)s", log))
        with open(prefix + ".zmo.ovl") as fh:
            out["zmo overlaps"] = sum(1 for _ in fh)
        out["zmo phase2 s"] = float(stages["phase2"])
        out["zmo wall s"] = wall
    if "swlocal" in kernels:
        from smartdenovo_tpu_torch.ops import overlap_dp

        args = [torch.from_numpy(z[f"swlocal_{t}"]).to(dev) for t in range(7)]
        LAs = int(z["swlocal_LA"])
        ms = cs.cuda_ms(lambda: overlap_dp.banded_local_dp(*args, LA=LAs,
                                                           W=SW_W))
        out[f"swlocal B={args[0].shape[0]} LA={LAs}"] = ms
        del args
        torch.cuda.empty_cache()
    if "nwglobal" in kernels:
        from smartdenovo_tpu_torch.ops import swdp

        for tag, name in (("nw3", "phase-3 batch"), ("nwdag", "DAG loop")):
            args = [torch.from_numpy(z[f"{tag}_{t}"]).to(dev)
                    for t in range(4)]
            B, L = args[0].shape
            ms = cs.cuda_ms(lambda: swdp.batch_global_align(*args,
                                                            max_len=L))
            out[f"nwglobal {name} B={B} L={L}"] = ms
            del args
            torch.cuda.empty_cache()
    if "swwide" in kernels:
        from smartdenovo_tpu_torch.ops import overlap_dp

        args = [torch.from_numpy(z[f"swwide_{t}"]).to(dev) for t in range(7)]
        LAc = int(z["swwide_LA"])
        ms = cs.cuda_ms(lambda: overlap_dp.banded_local_dp(*args, LA=LAc,
                                                           W=CYC_W), reps=5)
        out[f"swwide B={args[0].shape[0]} LA={LAc}"] = ms
        del args
        torch.cuda.empty_cache()
    for B in Bs:
        for kind, W, _ in KINDS:
            if kind not in kernels:
                continue
            n = sum(1 for k in z.files if k.startswith(f"{kind}_{B}_"))
            args = [torch.from_numpy(z[f"{kind}_{B}_{t}"]).to(dev)
                    for t in range(n)]
            ms = cs.cuda_ms(lambda: cs._call_wr(kind, args, LA, W))
            out[f"{kind} B={B} LA={LA}"] = ms
            del args
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--kernels", nargs="+", default=list(WR_KINDS),
                    choices=list(WR_KINDS) + ["swlocal", "swwide",
                                              "nwglobal", "zmo"])
    ap.add_argument("--B", type=int, nargs="+", default=[64, 528])
    ap.add_argument("--LA", type=int, default=32768)
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        one_turn(os.path.abspath(args.turn), args.inputs, args.kernels,
                 args.B, args.LA)
        return 0
    import numpy as np

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    other = os.path.abspath(args.other)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        arrays = {}
        if "zmo" in args.kernels or "swwide" in args.kernels:
            cs.ecoli_reads(os.path.join(tmp, "ecoli_reads.fa"))
        if "swwide" in args.kernels:
            x, LAc = cs.cyc_chunk(os.path.join(tmp, "ecoli_reads.fa"), "cpu")
            arrays.update({f"swwide_{t}": v.numpy() for t, v in enumerate(x)})
            arrays["swwide_LA"] = np.int64(LAc)
        if "nwglobal" in args.kernels:
            for tag, x in (("nw3", cs._nw_batch(91)),
                           ("nwdag", cs.nw_dag_inputs()[0])):
                arrays.update({f"{tag}_{t}": v for t, v in enumerate(x)})
        if "swlocal" in args.kernels:
            x, LAs = cs._sw_batch(77, W=SW_W)
            arrays.update({f"swlocal_{t}": v for t, v in enumerate(x)})
            arrays["swlocal_LA"] = np.int64(LAs)
        for B in args.B:
            for kind, W, seed in KINDS:
                if kind not in args.kernels:
                    continue
                for t, x in enumerate(cs._wr_inputs(kind, B, args.LA, W, seed)):
                    arrays[f"{kind}_{B}_{t}"] = x
        np.savez(inputs, **arrays)
        del arrays
        runs = {"other": [], "this": []}
        for who, root in (("other", other), ("this", HERE), ("this", HERE),
                          ("other", other)):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), other, "--turn",
                 root, "--inputs", inputs, "--LA", str(args.LA),
                 "--B", *map(str, args.B), "--kernels", *args.kernels],
                capture_output=True, text=True, timeout=1200)
            if res.returncode:
                print(res.stdout, res.stderr, file=sys.stderr)
                return res.returncode
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[who].append(times)
            for k, v in times.items():
                unit = "" if k.startswith("zmo ") else " ms"
                print(f"kernel_ab {who} {k}: {v:.3f}{unit}", flush=True)
    print(cs.gpu_line())
    print(json.dumps({k: {who: [r[k] for r in runs[who]] for who in runs}
                      for k in runs["this"][0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
