#!/usr/bin/env python3
"""Time the whole-read DP kernels (banded, refine, refine5q) of two checkouts
of this repository on one GPU, in turns: other, this, this, other.

    python3 kernel_ab.py OTHER_ROOT [--B 64 528] [--LA 32768]

OTHER_ROOT is another checkout (for example `git archive` of an earlier
commit unpacked into a directory that .gitignore lists).  The inputs are
chip_smoke.py phase 3's (`_wr_inputs`: W 256 for banded, 128 for the
refines, seeds 31-33), made once here and saved; each turn is a process of
its own with its checkout's root first on sys.path, which builds that
checkout's kernels and times each call alone through that checkout's
wrappers (`chip_smoke.cuda_ms`, median of 10 CUDA-event times).  Prints a
line per turn and kernel, the card's name and power limit, and a JSON line
with both checkouts' times per kernel and B.
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


def one_turn(root, inputs, Bs, LA):
    """Time every kernel and B with the checkout at root."""
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
    for B in Bs:
        for kind, W, _ in KINDS:
            n = sum(1 for k in z.files if k.startswith(f"{kind}_{B}_"))
            args = [torch.from_numpy(z[f"{kind}_{B}_{t}"]).to(dev)
                    for t in range(n)]
            ms = cs.cuda_ms(lambda: cs._call_wr(kind, args, LA, W))
            out[f"{kind} B={B}"] = ms
            del args
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--B", type=int, nargs="+", default=[64, 528])
    ap.add_argument("--LA", type=int, default=32768)
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        one_turn(os.path.abspath(args.turn), args.inputs, args.B, args.LA)
        return 0
    import numpy as np

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    other = os.path.abspath(args.other)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        arrays = {}
        for B in args.B:
            for kind, W, seed in KINDS:
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
                 "--B", *map(str, args.B)],
                capture_output=True, text=True, timeout=1200)
            if res.returncode:
                print(res.stdout, res.stderr, file=sys.stderr)
                return res.returncode
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[who].append(times)
            for k, v in times.items():
                print(f"kernel_ab {who} {k} LA={args.LA}: {v:.3f} ms",
                      flush=True)
    print(cs.gpu_line())
    print(json.dumps({k: {who: [r[k] for r in runs[who]] for who in runs}
                      for k in runs["this"][0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
