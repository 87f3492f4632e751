#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (smartdenovo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--workdir DIR]

Phases, each printing its lines; any failure raises and the script exits
non-zero:

1. device   the card's name and power limit (nvidia-smi); no CUDA -> exit 2
2. build    nvcc builds csrc/*.cu for sm_90a into smartdenovo_tpu_torch/_build
3. kernels  K1 (sseg), K2 (jpost), K3 (pexpand) and the consensus segment DP
            (segdp) on seeded inputs at the widths the main path gives them,
            each held equal to its plain PyTorch version on the same inputs
            (integer outputs: the tolerance is 0), with median CUDA-event
            times of both
4. join     the overlapper with the sort-join matcher on a deep 25 kb
            simulation, on cuda and on cpu: the overlap lists must be
            equal record for record, and K2 and K3 must have launched
5. asm      the main path, `asm` through the port's CLI, on simulated
            E. coli reads (4.6 Mb genome, 18x; scripts/sim_ecoli.py's
            seeds): stage times, the matcher picked per chunk, overlap
            and unitig counts, and the launches of K1-K3, which must all
            be > 0; the assembly must pass the contiguity bars of
            tests/test_assembly_e2e.py
6. cns      the consensus stage through the port's CLI on cuda:
            (a) `cns -n 6` on tests/goldens/smoke.ref.lay, every unitig's
                identity against the reference binary's smoke.ref.cns
                printed, utg0's held to the slow golden test's bar (0.9985);
                then `asm smoke.fa -c 1`, whose layout must equal `-c 0`'s
            (b) one golden unitig, two iterations, on cuda and on cpu: the
                consensus codes and read offsets must be equal
            (c) `cns -n 6` on phase 5's E. coli layout cut to the reads at
                offsets below CNS_CUT: stage time, segments, dispatches,
                segdp launches (> 0), consensus length within 0.9-1.1x the
                cut's backbone, >= 90% of its reads accepted in the last
                iteration

The last lines are one JSON object of kernel results, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_LEN = 4_600_000      # scripts/sim_ecoli.py
COVERAGE = 18
CNS_CUT = 2_000_000         # bp of the E. coli layout that phase 6 (c) polishes
GOLD = os.path.join(ROOT, "tests", "goldens")
I32_MAX = (1 << 31) - 1


def say(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10):
    """Median device time of fn() in ms (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs(a, b):
    import torch

    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _block_stream(gen, N, dev):
    """A match stream shaped like dot_matrix_align's block phase: sorted,
    blocks of a few to a few hundred entries, and a dead tail of 40%."""
    import torch

    live_n = N * 6 // 10
    live = torch.arange(N, device=dev) < live_n
    starts = (torch.rand(N, generator=gen, device=dev) < 0.15) & live
    starts[0] = True
    bid = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32)
    r = lambda hi: torch.randint(0, hi, (N,), generator=gen, device=dev,  # noqa: E731
                                 dtype=torch.int32)
    o1 = r(1 << 17)
    o2 = r(1 << 17)
    l1 = r(256)
    l2 = r(256)
    bigp = 64 * 1000 * 2
    pid = torch.where(live, bid // 7, bigp).to(torch.int32)
    z = torch.zeros(N, dtype=torch.int32, device=dev)
    v8 = torch.stack([
        torch.where(live, l1, z),
        torch.where(live, o1, I32_MAX),
        torch.where(live, o2, I32_MAX),
        torch.where(live, o1 + l1, z),
        torch.where(live, o2 + l2, z),
        pid, live.to(torch.int32), z]).contiguous()
    ops = ("sum", "min", "min", "max", "max", "first", "sum", "first")
    return starts.to(torch.int32), v8, ops, N // 8


def _cand_stream(gen, N, dev):
    """An event stream shaped like scan_candidates' group reduce: sorted
    (q, cand, dir) keys in runs, a dead tail of INT32_MAX keys."""
    import torch

    live_n = N * 7 // 10
    kq = torch.sort(torch.randint(0, N // 16, (N,), generator=gen,
                                  device=dev, dtype=torch.int32)).values
    kq = torch.where(torch.arange(N, device=dev) < live_n, kq, I32_MAX)
    seg_new = torch.ones(N, dtype=torch.int32, device=dev)
    seg_new[1:] = (kq[1:] != kq[:-1]).to(torch.int32)
    contrib = torch.where(kq != I32_MAX,
                          torch.randint(0, 64, (N,), generator=gen, device=dev,
                                        dtype=torch.int32), 0)
    z = torch.zeros(N, dtype=torch.int32, device=dev)
    v8 = torch.stack([contrib, kq, z, z, z, z, z, z]).contiguous()
    ops = ("sum",) + ("first",) * 7
    return seg_new, v8, ops, N // 4


def _join_stream(gen, N, dev):
    """A sorted join stream (key, pay, aux): 64 queries, query z-mer
    entries (side 0) with repeats, candidate entries (side 1) that mostly
    hit a query z-mer, and a dead tail of INT32_MAX keys."""
    import torch

    Q, zb = 64, 20
    nq = N // 8
    nc = N * 3 // 4
    r = lambda n, hi: torch.randint(0, hi, (n,), generator=gen,  # noqa: E731
                                    device=dev, dtype=torch.int64)
    pool = r(Q * 16384, 1 << zb).reshape(Q, 16384)
    qq = r(nq, Q)
    qz = pool[qq, r(nq, 16384)]
    cq = r(nc, Q)
    cz = torch.where(r(nc, 4) > 0, pool[cq, r(nc, 16384)], r(nc, 1 << zb))
    key = torch.cat([(qq << (zb + 1)) | (qz << 1),
                     (cq << (zb + 1)) | (cz << 1) | 1,
                     torch.full((N - nq - nc,), I32_MAX, device=dev,
                                dtype=torch.int64)]).to(torch.int32)
    pay = torch.randint(-(1 << 31), I32_MAX, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    aux = torch.cat([torch.zeros(nq, dtype=torch.int32, device=dev),
                     r(N - nq, Q * 1000).to(torch.int32)])
    perm = torch.sort(key, stable=True).indices
    return key[perm].contiguous(), pay[perm].contiguous(), aux[perm].contiguous()


def phase_kernels(dev):
    import torch

    from smartdenovo_tpu_torch.ops import jpost, pexpand, sseg

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = {}

    # K1: the candidate scan at 2^22, the block phase at 2^24
    errs, t = [], None
    for N, make in ((1 << 22, _cand_stream), (1 << 24, _block_stream)):
        seg_new, v8, ops, ob = make(gen, N, dev)
        out, cnt = sseg.seg_reduce_compact(seg_new, v8, ops=ops, out_budget=ob)
        pout, pcnt = sseg.seg_reduce_compact_plain(seg_new, v8, ops=ops,
                                                   out_budget=ob)
        torch.cuda.synchronize()
        n = min(int(pcnt), ob)
        if int(cnt) != int(pcnt) or not torch.equal(out[:, :n], pout[:, :n]):
            raise AssertionError(f"K1 sseg differs from its plain version at "
                                 f"N={N}: count {int(cnt)} vs {int(pcnt)}")
        errs.append(max_abs(out[:, :n], pout[:, :n]))
        ms = cuda_ms(lambda: sseg.seg_reduce_compact(seg_new, v8, ops=ops,
                                                     out_budget=ob))
        pms = cuda_ms(lambda: sseg.seg_reduce_compact_plain(
            seg_new, v8, ops=ops, out_budget=ob))
        say(f"kernel sseg N={N} segments={int(cnt)}: {ms:.3f} ms, "
            f"plain {pms:.3f} ms, equal")
        t = (ms, pms)
        del seg_new, v8, out, pout
    results["sseg"] = dict(max_abs_err=max(errs), ms=t[0], plain_ms=t[1])

    # K2 on a join stream of 2^23, out budget 2^23 (EB = pair_budget)
    N = 1 << 23
    EB = 1 << 23
    key, pay, aux = _join_stream(gen, N, dev)
    eout, nem, tot = jpost.join_emitters(key, pay, aux, max_per_read=16,
                                         out_budget=EB)
    pout, pnem, ptot = jpost.join_emitters_plain(key, pay, aux,
                                                 max_per_read=16,
                                                 out_budget=EB)
    torch.cuda.synchronize()
    n = min(int(pnem), EB)
    if (int(nem), int(tot)) != (int(pnem), int(ptot)) or not torch.equal(
            eout[:, :n], pout[:, :n]):
        raise AssertionError(f"K2 jpost differs from its plain version: "
                             f"emitters {int(nem)} vs {int(pnem)}, slots "
                             f"{int(tot)} vs {int(ptot)}")
    err = max_abs(eout[:, :n], pout[:, :n])
    ms = cuda_ms(lambda: jpost.join_emitters(key, pay, aux, max_per_read=16,
                                             out_budget=EB))
    pms = cuda_ms(lambda: jpost.join_emitters_plain(
        key, pay, aux, max_per_read=16, out_budget=EB))
    say(f"kernel jpost N={N} emitters={int(nem)} slots={int(tot)}: "
        f"{ms:.3f} ms, plain {pms:.3f} ms, equal")
    results["jpost"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

    # K3 on K2's emitters, pair budget 2^23
    PB = 1 << 23
    cnt_c = torch.where(torch.arange(EB, device=dev) < pnem, pout[0], 0)
    args = (cnt_c, pout[1].contiguous(), pout[2].contiguous(),
            pout[3].contiguous())
    got = pexpand.expand_emit(*args, pair_budget=PB)
    ref = pexpand.expand_emit_plain(*args, pair_budget=PB)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError("K3 pexpand differs from its plain version")
    err = max(max_abs(a, b) for a, b in zip(got, ref))
    ms = cuda_ms(lambda: pexpand.expand_emit(*args, pair_budget=PB))
    pms = cuda_ms(lambda: pexpand.expand_emit_plain(*args, pair_budget=PB))
    say(f"kernel pexpand PB={PB} slots={int(cnt_c.sum())}: {ms:.3f} ms, "
        f"plain {pms:.3f} ms, equal")
    results["pexpand"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    del key, pay, aux, eout, pout, cnt_c, args, got, ref
    results["segdp"] = phase_segdp(dev)
    return results


def _segments(rng, Bc, SEGR, LBW, W):
    """Bc read segments cut from a random consensus with 13% of their bases
    redrawn, a third each of alen SEGR, 0 and random; windows of 3/4 LBW
    to LBW; band bases every 16 rows jittered by up to 24 columns, so that
    they step up and down."""
    import numpy as np

    NB = SEGR // 16 + 2
    cns = rng.integers(0, 4, LBW + SEGR, dtype=np.uint8)
    off = rng.integers(0, LBW - SEGR + 1, Bc)
    k3 = np.arange(Bc) % 3
    alen = np.where(k3 == 0, SEGR, np.where(k3 == 1, 0, rng.integers(
        1, SEGR + 1, Bc))).astype(np.int32)
    rows = np.arange(SEGR)[None, :]
    a = cns[off[:, None] + rows]
    a = np.where(rng.random(a.shape) < 0.13,
                 rng.integers(0, 4, a.shape, dtype=np.uint8), a)
    a = np.where(rows < alen[:, None], a, 4).astype(np.uint8)
    blen = rng.integers(LBW * 3 // 4, LBW + 1, Bc).astype(np.int32)
    b = np.where(np.arange(LBW)[None, :] < blen[:, None], cns[None, :LBW],
                 4).astype(np.uint8)
    c = (off[:, None] + np.arange(NB)[None, :] * 16 - W // 2
         + rng.integers(-24, 25, (Bc, NB)))
    return a, b, alen, blen, np.clip(c, 0, LBW - 1).astype(np.int16)


def phase_segdp(dev):
    """segdp at the consensus stage's full width (pipeline/cns.py: SEGR 2048,
    window 3072, band 256, traceback 3072 moves, 1024 segments a call),
    with the first iteration's gap opens and the later ones'."""
    import numpy as np
    import torch

    from smartdenovo_tpu_torch.ops import segdp
    from smartdenovo_tpu_torch.pipeline import cns

    Bc = 1024
    shape = dict(SEGR=cns.SEGR, LBW=cns.S_LBW, W=cns.S_W, T=cns.S_T)
    args = [torch.from_numpy(x).to(dev) for x in _segments(
        np.random.default_rng(2024), Bc, cns.SEGR, cns.S_LBW, cns.S_W)]
    live = int((args[2] > 0).sum())
    errs, t = [], None
    for oi, od in ((-3, -3), (-2, -3)):
        kw = dict(shape, open_i=oi, open_d=od)
        got = segdp.seg_align_tb(*args, **kw)
        ref = segdp.seg_align_tb_plain(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"segdp differs from its plain version at "
                                 f"open_i={oi} open_d={od}")
        errs.append(max(max_abs(g, r) for g, r in zip(got, ref)))
        ms = cuda_ms(lambda: segdp.seg_align_tb(*args, **kw))
        pms = cuda_ms(lambda: segdp.seg_align_tb_plain(*args, **kw), reps=3)
        say(f"kernel segdp Bc={Bc} ({live} segments with rows) open_i={oi} "
            f"open_d={od}: {ms:.3f} ms, plain {pms:.3f} ms, equal "
            f"(score, b_beg, b_end, moves)")
        t = (ms, pms)
    return dict(max_abs_err=max(errs), ms=t[0], plain_ms=t[1])


# ---------------------------------------------------------------------------
# phase 4: the join path, cuda against cpu
# ---------------------------------------------------------------------------


def phase_join():
    import numpy as np
    import torch

    from smartdenovo_tpu.data.readbank import ReadBank
    from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    rng = np.random.default_rng(79)
    genome = random_genome(rng, 25_000)
    names, seqs = simulate_reads(genome, coverage=12, mean_len=3000,
                                 err=0.12, seed=80)
    rb = ReadBank(names, seqs)
    p = ZmoParams.dmo(ncand=64, batch_q=8, matcher="join")
    _build.reset_launches()
    t0 = time.perf_counter()
    gpu = overlap_dmo(rb, p, progress=False, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    cpu = overlap_dmo(rb, p, progress=False, device="cpu")
    t2 = time.perf_counter()
    if gpu != cpu or not gpu:
        raise AssertionError(f"join path: cuda gave {len(gpu)} overlaps, cpu "
                             f"{len(cpu)}, or they differ")
    if launches["jpost"] == 0 or launches["pexpand"] == 0:
        raise AssertionError(f"join path did not launch K2/K3: {launches}")
    say(f"join path: {len(rb)} reads, {len(gpu)} overlaps equal on cuda and "
        f"cpu; cuda {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s; launches {launches}")


# ---------------------------------------------------------------------------
# phase 5: asm on simulated E. coli
# ---------------------------------------------------------------------------


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def phase_asm(tmp):
    import numpy as np
    import torch

    from smartdenovo_tpu.utils.simulate import (random_genome, simulate_reads,
                                                write_sim_fasta)
    from smartdenovo_tpu_torch import cli
    from smartdenovo_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    rng = np.random.default_rng(46_000_000)
    genome = random_genome(rng, GENOME_LEN)
    names, seqs = simulate_reads(genome, coverage=COVERAGE, mean_len=9500,
                                 err=0.13, seed=18_460, circular=True)
    fa = os.path.join(tmp, "ecoli_reads.fa")
    write_sim_fasta(fa, names, seqs)
    say(f"asm input: {len(seqs)} reads, {sum(len(s) for s in seqs)} bases "
        f"from a {GENOME_LEN} bp genome at {COVERAGE}x, simulated in "
        f"{time.perf_counter() - t0:.1f} s")
    del names, seqs

    prefix = os.path.join(tmp, "ecoli")
    buf = io.StringIO()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        rc = cli.main(["asm", fa, "-p", prefix, "--batch-q", "64"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"asm exited {rc}")
    log = buf.getvalue()
    stages = {m[0]: float(m[1])
              for m in re.findall(r"stage (\w+): ([0-9.]+)s", log)}
    picks = re.findall(r"chunk (\d+): matcher=(\w+)", log)
    with open(prefix + ".dmo.ovl") as fh:
        n_ovl = sum(1 for _ in fh)
    with open(prefix + ".dmo.lay.utg") as fh:
        lens = sorted((int(m) for m in re.findall(r"^>\S+ length=(\d+)",
                                                  fh.read(), re.M)),
                      reverse=True)
    say(f"asm stages (s): {json.dumps(stages)}; wall {wall:.1f} s")
    say(f"asm matcher per chunk: {' '.join(f'{c}:{m}' for c, m in picks)}")
    say(f"asm overlaps: {n_ovl} (JAX package on the raw reads, through zmo: "
        f"131763 pairs, PARITY_r05.json)")
    say(f"asm unitigs: {len(lens)}, total {sum(lens)} bp, largest "
        f"{lens[0] if lens else 0} bp (JAX package, PARITY_r05.json: 1 "
        f"unitig of 4788949 bp)")
    say(f"asm launches: {json.dumps(launches)}; peak device memory "
        f"{peak} bytes")
    if n_ovl == 0 or not lens:
        raise AssertionError("asm produced no overlaps or no unitigs")
    # contiguity bars of tests/test_assembly_e2e.py
    if not (0.8 * GENOME_LEN < lens[0] < 1.4 * GENOME_LEN
            and sum(lens) < 2.0 * GENOME_LEN):
        raise AssertionError(f"asm contiguity: unitigs {lens[:5]}")
    missing = [k for k in ("sseg", "jpost", "pexpand") if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    return launches


# ---------------------------------------------------------------------------
# phase 6: consensus
# ---------------------------------------------------------------------------


def read_fasta(path):
    seqs, name = {}, None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            elif name is not None:
                seqs[name].append(line)
    return {k: "".join(v) for k, v in seqs.items()}


_HB = 0x9E3779B97F4A7C15


def _first_common(a, b, L, pw, M):
    """(i, j) of the first window of length L common to a and b, least i
    and then least j, or None.  Windows are hashed as polynomials mod 2^64
    (uint64 wraps) scaled to one power; every hit is verified."""
    import numpy as np

    def hashes(x):
        s = np.zeros(len(x) + 1, np.uint64)
        np.cumsum(x.astype(np.uint64) * pw[:len(x)], out=s[1:])
        n = len(x) - L + 1
        return (s[L:L + n] - s[:n]) * pw[M - np.arange(n)]

    ha, hb = hashes(a), hashes(b)
    order = np.argsort(hb, kind="stable")
    sb = hb[order]
    lo = np.searchsorted(sb, ha, "left")
    hi = np.searchsorted(sb, ha, "right")
    for i in np.nonzero(hi > lo)[0]:
        for j in order[lo[i]:hi[i]]:
            if np.array_equal(a[i:i + L], b[j:j + L]):
                return int(i), int(j)
    return None


def identity(a: str, b: str) -> float:
    """The consensus identity of tests/test_goldens.py `_identity`: bases in
    the matching blocks of difflib.SequenceMatcher(None, a, b,
    autojunk=False) over the longer length.  Same recursion (the longest
    common block, least i then least j, then both sides of it), but each
    longest block is found by a binary search over hashed windows: seconds
    for a 75 kb unitig where difflib takes minutes.
    tests/test_torch_cns_asm.py holds it equal to difflib."""
    import numpy as np

    x = np.frombuffer(a.encode(), np.uint8)
    y = np.frombuffer(b.encode(), np.uint8)
    M = max(len(x), len(y)) + 1
    pw = np.ones(M + 1, np.uint64)
    np.cumprod(np.full(M, _HB, np.uint64), out=pw[1:])
    matched = 0
    queue = [(0, len(x), 0, len(y))]
    while queue:
        alo, ahi, blo, bhi = queue.pop()
        sa, sb = x[alo:ahi], y[blo:bhi]
        k, hi, best = 0, min(len(sa), len(sb)), None
        while k < hi:
            mid = (k + hi + 1) // 2
            hit = _first_common(sa, sb, mid, pw, M)
            if hit is None:
                hi = mid - 1
            else:
                k, best = mid, hit
        if not k:
            continue
        i, j = alo + best[0], blo + best[1]
        matched += k
        if alo < i and blo < j:
            queue.append((alo, i, blo, j))
        if i + k < ahi and j + k < bhi:
            queue.append((i + k, ahi, j + k, bhi))
    return matched / max(len(a), len(b), 1)


def _run_cli(argv):
    """cli.main(argv) with its log captured; returns (log, wall s)."""
    import torch

    from smartdenovo_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"{' '.join(argv[:1])} exited {rc}")
    return buf.getvalue(), time.perf_counter() - t0


def _cut_lay(src, dst, max_off):
    """Write the largest unitig of the .lay `src` with only its rows at
    offsets below max_off; returns (rows kept, rows)."""
    units = []
    with open(src) as fh:
        for line in fh:
            if line.startswith(">"):
                units.append((line, []))
            elif units and len(line.split("\t")) >= 6:
                units[-1][1].append(line)
    head, rows = max(units, key=lambda u: len(u[1]))
    keep = [r for r in rows if int(r.split("\t")[3]) < max_off]
    with open(dst, "w") as fh:
        fh.write(head)
        fh.writelines(keep)
    return len(keep), len(rows)


def phase_cns(tmp, cut):
    import numpy as np

    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline import cns

    # (a) the golden layout, six iterations, against the reference binary
    out = os.path.join(tmp, "smoke.cns")
    _build.reset_launches()
    log, wall = _run_cli(["cns", "-i", os.path.join(GOLD, "smoke.ref.lay"),
                          "-o", out, "-n", "6"])
    n_a = _build.LAUNCHES["segdp"]
    ours, ref = read_fasta(out), read_fasta(os.path.join(GOLD, "smoke.ref.cns"))
    if set(ours) != set(ref):
        raise AssertionError(f"golden cns unitigs {sorted(ours)} vs {sorted(ref)}")
    idents = {k: identity(ours[k], ref[k]) for k in sorted(ref)}
    say(f"cns golden smoke.ref.lay -n 6: {wall:.1f} s, segdp launches {n_a}; "
        f"identity vs smoke.ref.cns: " + ", ".join(
            f"{k} {v:.5f} ({len(ours[k])} vs {len(ref[k])} bp)"
            for k, v in idents.items()))
    if n_a == 0 or idents["utg0"] < 0.9985:
        raise AssertionError(f"golden cns: utg0 identity {idents['utg0']:.5f} "
                             f"< 0.9985 or no segdp launch ({n_a})")
    smk = os.path.join(GOLD, "smoke.fa")
    _, w0 = _run_cli(["asm", smk, "-p", os.path.join(tmp, "smk0"), "-c", "0"])
    log, w1 = _run_cli(["asm", smk, "-p", os.path.join(tmp, "smk1"), "-c", "1"])
    with open(os.path.join(tmp, "smk0.dmo.lay.utg"), "rb") as f0, \
            open(os.path.join(tmp, "smk1.dmo.lay.utg"), "rb") as f1:
        same = f0.read() == f1.read()
    got = read_fasta(os.path.join(tmp, "smk1.dmo.cns"))
    stage = re.findall(r"stage cns: ([0-9.]+)s", log)
    say(f"asm smoke.fa -c 1: {w1:.1f} s (cns stage {stage[-1]} s, -c 0 run "
        f"{w0:.1f} s); {len(got)} consensus records, "
        f"{sum(map(len, got.values()))} bp; .lay.utg equal to -c 0's: {same}")
    if not got or not all(got.values()) or not same:
        raise AssertionError("asm -c 1 wrote no consensus or another layout")

    # (b) one golden unitig on cuda and on cpu
    unit = [u for u in cns.parse_lay_file(os.path.join(GOLD, "smoke.ref.lay"))
            if u.name == "utg1"][0]
    p = cns.CnsParams(n_iter=2)
    t0 = time.perf_counter()
    g = cns.consensus_unitig(unit, p, return_offs=True, device="cuda")
    t1 = time.perf_counter()
    c = cns.consensus_unitig(unit, p, return_offs=True, device="cpu")
    t2 = time.perf_counter()
    if not (np.array_equal(g[0], c[0]) and g[1] == c[1]):
        raise AssertionError("golden utg1: cuda and cpu consensus differ")
    say(f"cns utg1 ({len(unit.reads)} reads) -n 2: cuda {t1 - t0:.1f} s, cpu "
        f"{t2 - t1:.1f} s; {len(g[0])} bp and read offsets equal")

    # (c) the E. coli layout of phase 5, cut to offsets below `cut`
    lay = os.path.join(tmp, "ecoli_cut.lay")
    kept, total = _cut_lay(os.path.join(tmp, "ecoli.dmo.lay"), lay, cut)
    unit = cns.parse_lay_file(lay)[0]
    bb = len(cns._gen_backbone(unit))
    _build.reset_launches()
    log, wall = _run_cli(["cns", "-i", lay, "-o", lay + ".cns", "-n", "6"])
    launches = _build.LAUNCHES["segdp"]
    segs = re.findall(r": (\d+) segments in (\d+) dispatches of (\d+), "
                      r"([0-9.]+)s", log)
    iters = re.findall(r"iter (\d+): (\d+) reads aligned, len (\d+) -> (\d+)",
                       log)
    split = re.findall(r"iter \d+ time: seed ([0-9.]+)s align ([0-9.]+)s "
                       r"dag ([0-9.]+)s", log)
    stage = float(re.findall(r"stage cns: ([0-9.]+)s", log)[-1])
    res = read_fasta(lay + ".cns")
    L = len(next(iter(res.values()))) if res else 0
    aligned = int(iters[-1][1]) if iters else 0
    say(f"cns E. coli cut (offsets < {cut}): {kept} of {total} reads, "
        f"backbone {bb} bp -> consensus {L} bp; stage {stage:.1f} s, wall "
        f"{wall:.1f} s; segments/dispatches per iteration "
        f"{[(int(s), int(d)) for s, d, _, _ in segs]}; segment DP incl. "
        f"transfers {[float(x[3]) for x in segs]} s; seed/align/dag s "
        f"{[tuple(map(float, x)) for x in split]}; reads accepted per "
        f"iteration {[int(x[1]) for x in iters]}; segdp launches {launches}")
    if launches == 0 or not 0.9 * bb <= L <= 1.1 * bb or aligned < 0.9 * kept:
        raise AssertionError(f"E. coli cut cns: launches {launches}, length "
                             f"{L} vs backbone {bb}, {aligned} of {kept} "
                             f"reads accepted")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="keep the work files (E. coli reads and stage files) "
                         "here instead of a temporary directory")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "smartdenovo_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    line = gpu_line()
    say(f"device: {line}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    from smartdenovo_tpu_torch.kernels import _build

    so, secs = _build.build()
    _build.lib()
    say(f"build: {so.name} in {secs:.1f} s (nvcc, sm_90a)")

    kres = phase_kernels(dev)
    phase_join()
    with contextlib.ExitStack() as stack:
        tmp = args.workdir or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(tmp, exist_ok=True)
        launches = phase_asm(tmp)
        launches["segdp"] = phase_cns(tmp, CNS_CUT)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    src = {"sseg": ("smartdenovo_tpu_torch/csrc/sseg.cu",
                    "smartdenovo_tpu/ops/sseg.py:307"),
           "jpost": ("smartdenovo_tpu_torch/csrc/jpost.cu",
                     "smartdenovo_tpu/ops/jpost.py:256"),
           "pexpand": ("smartdenovo_tpu_torch/csrc/pexpand.cu",
                       "smartdenovo_tpu/ops/pexpand.py:131"),
           "segdp": ("smartdenovo_tpu_torch/csrc/segdp.cu",
                     "smartdenovo_tpu/ops/segdp.py:47 (jax.jit lax.scan, "
                     "not Pallas)")}
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k], **kres[k])
               for k in ("sseg", "jpost", "pexpand", "segdp")]
    say(json.dumps({"kernels": kernels}))
    say(gpu_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
