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
            (integer outputs: the tolerance is 0), with the median
            CUDA-event times of both (each call timed alone; for K1-K3 also
            the mean of 10 calls in a row, which hides the host's launch
            overhead), each kernel's bound (bytes over HBM or int32
            operations over the int32 rate; K2 counts its key stream and pay, aux and the
            record of its emitters only, K3 the counts, the payloads of the
            emitters that own a slot and the three output rows) and its
            share of it, and for K3 the time of torch.repeat_interleave;
            segdp must run Bc = 1024 segments in one wave; the whole-read
            DPs (banded, refine, refine5q) are timed and held equal to their
            plain versions at 64 reads of LA 32768, a batch shape that
            phase 7's E. coli align pass gives them, and at 528 reads of
            the same length (four on each SM sub-partition)
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
                iteration; the probe anchoring (_probe_anchor_device, torch
                ops) is timed alone on the largest batch it was given there
7. whole-read  the whole-read consensus engine on cuda:
            (a) `run_cns` on smoke.ref.lay, seg_engine=False, 6 iterations,
                with -a/-V: each unitig's identity against smoke.ref.cns
                beside the segment engine's of 6 (a), held above its raw
                backbone's; the .aln records checked as tests/test_cns.py
                does
            (b) the golden unitig with fewest reads, one iteration and its
                -a/-V records, on cuda and on cpu: codes, offsets and .aln
                bytes equal
            (c) `cns -n 1 -a -V 2.05` through the CLI on phase 5's E. coli
                layout cut to offsets below WR_CUT: records for >= 90% of
                its reads, each consistent with its Q row
            (d) the same cut with seeded synthetic f5q tracks in column 7,
                `cns -n 2`: refine5q launched, length within 0.9-1.1x the
                backbone, >= 90% of the reads accepted in the last iteration
            (c) and (d) print the align pass's time split (probe anchoring,
            each kernel with its fetch, band construction, run-length
            encoding, align_strings, the -a/-V writer)

The last lines are one JSON object of kernel results (all seven kernels,
each launched on the main path: K1-K3 in phase 5, segdp in 6 (c), the
whole-read DPs in 7 (c) and (d)), the card's name and power limit, and
{"ok": true, "device": {...}}.
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
WR_CUT = 1_000_000          # bp of it that phase 7 (c) and (d) align whole
GOLD = os.path.join(ROOT, "tests", "goldens")
I32_MAX = (1 << 31) - 1
# H100 SXM peaks for a kernel's bound: HBM3 at 3.35 TB/s (NVIDIA's data
# sheet); int32 at 132 SMs x 64 int32 lanes x 1.98 GHz boost.  A bound is
# the larger of bytes / HBM and operations / int32 rate, with every input
# read once and every output written once.
HBM_BPS = 3.35e12
INT32_OPS = 132 * 64 * 1.98e9
SEGDP_OPS_PER_CELL = 12   # int32 operations of one DP cell, at the least
# the same for the whole-read DPs: banded (two candidates, their max and
# compare, the gap scan's max, its compare) and the affine refines (three
# lanes; 5q adds its cost selects)
OPS_PER_CELL = {"banded": 10, "refine": 12, "refine5q": 14}


def say(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, in_a_row=False):
    """Median device time of fn() in ms (CUDA events, after a warm-up), each
    call timed alone; with in_a_row, the mean of `reps` calls issued back to
    back, so that the host's launch overhead hides under the device's work
    (median of 3 such runs)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3 if in_a_row else reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps if in_a_row else 1):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (reps if in_a_row else 1))
    return statistics.median(times)


def bound(nbytes, ops=0):
    """(bound_ms, bound_by) of work that moves nbytes and does ops int32
    operations."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / INT32_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def timing(ms, plain_ms, nbytes, ops=0, library_ms=None):
    bms, by = bound(nbytes, ops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                share=bms / ms, library_ms=library_ms)


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

    from smartdenovo_tpu_torch.ops import sseg

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
    return starts.to(torch.int32), v8, sseg.BLOCK_OPS, N // 8


def _cand_stream(gen, N, dev):
    """An event stream shaped like scan_candidates' group reduce: sorted
    (q, cand, dir) keys in runs, a dead tail of INT32_MAX keys."""
    import torch

    from smartdenovo_tpu_torch.ops import sseg

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
    return seg_new, v8, sseg.CAND_OPS, N // 4


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

    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.ops import jpost, pexpand, sseg

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = {}

    # every lane-op set of the main path runs a specialised K1
    for ops in sseg.MAIN_PATH_OPS:
        if not _build.lib().sseg_specialized(sseg.opcode(ops)):
            raise AssertionError(f"K1 has no specialised build for {ops}")

    # K1: the candidate scan at 2^22, the block phase at 2^24 (reported)
    errs, shapes = [], []
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
        call = lambda: sseg.seg_reduce_compact(seg_new, v8, ops=ops,  # noqa: E731
                                               out_budget=ob)
        ms, rms = cuda_ms(call), cuda_ms(call, in_a_row=True)
        pms = cuda_ms(lambda: sseg.seg_reduce_compact_plain(
            seg_new, v8, ops=ops, out_budget=ob))
        t = timing(ms, pms, 36 * N + 32 * n + 4)
        say(f"kernel sseg N={N} segments={int(cnt)}: {ms:.3f} ms ({rms:.3f} "
            f"in a row), plain {pms:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), share {t['share']:.3f}, equal")
        shapes.append(dict(t, N=N, ms_in_a_row=rms))
        del seg_new, v8, out, pout
    results["sseg"] = dict(shapes[-1], max_abs_err=max(errs), shapes=shapes)

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
    call = lambda: jpost.join_emitters(key, pay, aux, max_per_read=16,  # noqa: E731
                                       out_budget=EB)
    ms, rms = cuda_ms(call), cuda_ms(call, in_a_row=True)
    pms = cuda_ms(lambda: jpost.join_emitters_plain(
        key, pay, aux, max_per_read=16, out_budget=EB))
    # the key stream once; pay, aux and the record of each emitter; the
    # two totals
    t = timing(ms, pms, 4 * N + 24 * n + 8)
    say(f"kernel jpost N={N} emitters={int(nem)} slots={int(tot)}: "
        f"{ms:.3f} ms ({rms:.3f} in a row), plain {pms:.3f} ms, bound "
        f"{t['bound_ms']:.3f} ms ({t['bound_by']}), share "
        f"{t['share']:.3f}, equal")
    results["jpost"] = dict(t, max_abs_err=err, ms_in_a_row=rms)

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
    call = lambda: pexpand.expand_emit(*args, pair_budget=PB)  # noqa: E731
    ms, rms = cuda_ms(call), cuda_ms(call, in_a_row=True)
    pms = cuda_ms(lambda: pexpand.expand_emit_plain(*args, pair_budget=PB))
    # the one PyTorch call of the same function (without the padding to
    # PB), timed here only: the port never calls it
    slots = int(cnt_c.sum())
    pay3 = torch.stack(args[1:])
    lib = torch.repeat_interleave(pay3, cnt_c, dim=1, output_size=slots)
    if not all(torch.equal(g[:slots], r) for g, r in zip(got, lib)):
        raise AssertionError("repeat_interleave differs from K3")
    lms = cuda_ms(lambda: torch.repeat_interleave(pay3, cnt_c, dim=1,
                                                  output_size=slots))
    # the counts are read over all EB emitters (their cumsum), the three
    # payloads only for the emitters that own a slot, and the three outputs
    # written over PB
    owners = int((cnt_c > 0).sum())
    t = timing(ms, pms, 4 * EB + 12 * owners + 12 * PB, library_ms=lms)
    say(f"kernel pexpand PB={PB} slots={slots} owners={owners}: {ms:.3f} ms "
        f"({rms:.3f} in a row), plain {pms:.3f} ms, repeat_interleave "
        f"{lms:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}), "
        f"share {t['share']:.3f}, equal")
    results["pexpand"] = dict(t, max_abs_err=err, ms_in_a_row=rms)
    del pay3, lib
    del key, pay, aux, eout, pout, cnt_c, args, got, ref
    results["segdp"] = phase_segdp(dev)
    results.update(phase_wholeread_kernels(dev))
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
    NB = args[4].shape[1]
    cells = int(args[2].sum()) * cns.S_W
    nbytes = Bc * (cns.SEGR + cns.S_LBW + 2 * NB + 8) + Bc * (12 + cns.S_T // 4)
    wpb, per_sm = segdp.launch_shape(cns.SEGR, cns.S_LBW, cns.S_W)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = -(-Bc // (wpb * per_sm * sms))
    say(f"kernel segdp launch: {wpb} segments a block, {per_sm} block(s) an "
        f"SM, {sms} SMs: {waves} wave(s) at Bc={Bc}; {cells} cells")
    if waves != 1:
        raise AssertionError(f"segdp at Bc={Bc} takes {waves} waves")
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
        t = timing(ms, pms, nbytes, SEGDP_OPS_PER_CELL * cells)
        say(f"kernel segdp Bc={Bc} ({live} segments with rows) open_i={oi} "
            f"open_d={od}: {ms:.3f} ms, plain {pms:.3f} ms, bound "
            f"{t['bound_ms']:.3f} ms ({t['bound_by']}), share "
            f"{t['share']:.3f}, equal (score, b_beg, b_end, moves)")
    return dict(t, max_abs_err=max(errs))


def _wr_reads(rng, B, LA, W, err=0.13):
    """B reads against their consensus windows, as the whole-read align
    pass gives them: read k is its window from an offset below W with err
    of its bases deleted, inserted and substituted (a third each), every
    fourth read LA long and the others LA/2 to LA.  Returns (a, b, alen,
    blen, src): src[k][x] is the window column read base x came from."""
    import numpy as np

    LB = LA + LA // 8 + 2 * W
    a = np.full((B, LA), 4, np.uint8)
    b = np.full((B, LB), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    srcs = []
    for k in range(B):
        win = rng.integers(0, 4, LB, dtype=np.uint8)
        src = np.arange(int(rng.integers(0, W)), LB)
        src = src[rng.random(src.size) >= err / 3]
        src = np.repeat(src, 1 + (rng.random(src.size) < err / 3))
        read = win[src]
        ins = np.zeros(src.size, bool)
        ins[1:] = src[1:] == src[:-1]
        read[ins] = rng.integers(0, 4, int(ins.sum()))
        sub = rng.random(read.size) < err / 3
        read[sub] = (read[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        n = min(LA if k % 4 == 0 else int(rng.integers(LA // 2, LA + 1)),
                read.size)
        a[k, :n] = read[:n]
        alen[k] = n
        blen[k] = min(LB, int(src[n - 1]) + 1 + int(rng.integers(0, W)))
        b[k, :blen[k]] = win[:blen[k]]
        srcs.append(src[:n])
    return a, b, alen, blen, srcs


def _wr_inputs(kind, B, LA, W, seed):
    """Inputs of one whole-read kernel: banded (semiglobal, band from
    anchors every 100 rows), refine (global from the read's first window
    column to its last, band along the true path, as band_from_cigar of
    the true CIGAR gives it) or refine5q (the same with five seeded
    tracks)."""
    import numpy as np

    from smartdenovo_tpu_torch.ops.banded import make_band_centers

    rng = np.random.default_rng(seed)
    a, b, alen, blen, srcs = _wr_reads(rng, B, LA, W)
    if kind == "banded":
        anchors = [list(zip(range(0, len(s), 100), s[::100].tolist()))
                   for s in srcs]
        return a, b, alen, blen, make_band_centers(anchors, alen, blen, LA, W)
    base = np.zeros((B, LA + 1), np.int32)
    b2 = np.full_like(b, 4)
    for k, s in enumerate(srcs):
        off = int(s[0])
        blen[k] = int(s[-1]) + 1 - off
        b2[k, :blen[k]] = b[k, off:off + blen[k]]
        c = np.concatenate([[0], s - off + 1, np.full(LA - len(s), blen[k])])
        base[k] = np.maximum.accumulate(np.clip(c - W // 2, 0, blen[k]))
    out = (a, b2, alen, blen, base)
    if kind == "refine5q":
        q = [rng.integers(3, 41, (B, LA)).astype(np.int32) for _ in range(3)]
        q += [rng.integers(0, 4, (B, LA)).astype(np.int32) for _ in range(2)]
        out = (a, b2, *q, alen, blen, base)
    return out


def _call_wr(kind, args, LA, W):
    from smartdenovo_tpu_torch.ops import banded, refine, refine5q

    if kind == "banded":
        return banded.banded_align(*args, LA=LA, W=W, gap_a=-2, gap_b=-3,
                                   semiglobal_b=True)
    if kind == "refine":
        return refine.refine_banded_affine(*args, LA=LA, W=W, open_i=-2,
                                           open_d=-3)
    return refine5q.refine5q_banded(*args, LA=LA, W=W)


def _wr_equal(kind, got, exp, alen):
    """(equal, max_abs_err) of a whole-read kernel against its plain
    version: every output, dirs on the rows 0..alen it writes."""
    ndirs = 2 if kind == "banded" else 1
    err = 0
    for n, (g, e) in enumerate(zip(got, exp)):
        if n == ndirs:
            for k, ln in enumerate(alen.tolist()):
                err = max(err, max_abs(g[k, :ln + 1], e[k, :ln + 1]))
        else:
            err = max(err, max_abs(g, e))
    return err == 0, err


def phase_wholeread_kernels(dev):
    """banded, refine and refine5q at a shape the whole-read align pass
    gives them on the E. coli reads of 7 (c) and (d) (its _pad_tier and
    refine's power-of-two LA pad a batch of 64 to 16,384 or 32,768 rows):
    B = 64 reads, LA = 32,768, W = 256 (refine W = 128, 5q with its
    tracks); and the same at B = 528 reads, four on each SM sub-partition
    of the card's 132 SMs.  Each is timed there, each call alone (median
    of 10), and held equal to its plain version on the same inputs, whose
    one call is timed too (its cost is a Python loop over rows and
    traceback steps, so about a minute a kernel and B).  The bound counts
    the cells of this run's reads (sum of alen x W) at OPS_PER_CELL int32
    operations, against the bytes of the inputs, the direction plane's
    rows 0..alen and the moves.  The kernel line reports B = 64 (the
    batch the consensus driver gives them) with both B in `shapes`."""
    import torch

    res = {}
    LA = 32768
    for kind, W, seed in (("banded", 256, 31), ("refine", 128, 32),
                          ("refine5q", 128, 33)):
        shapes = []
        for B in (64, 528):
            args = [torch.from_numpy(x).to(dev)
                    for x in _wr_inputs(kind, B, LA, W, seed)]
            alen = args[-3]
            got = _call_wr(kind, args, LA, W)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: _call_wr(kind, args, LA, W))
            cells = int(alen.sum()) * W
            T = 2 * (LA + 1) + W + (0 if kind == "banded" else 4)
            nbytes = (sum(t.numel() * t.element_size() for t in args)
                      + int((alen + 1).sum()) * W + T * B + 12 * B)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            exp = _plain_wr(kind, args, LA, W)
            ev[1].record()
            ev[1].synchronize()
            pms = ev[0].elapsed_time(ev[1])
            ok, err = _wr_equal(kind, got, exp, alen)
            if not ok:
                raise AssertionError(f"{kind} differs from its plain version "
                                     f"at B {B}, LA {LA} (max abs err {err})")
            del args, got, exp
            torch.cuda.empty_cache()
            t = timing(ms, pms, nbytes, OPS_PER_CELL[kind] * cells)
            say(f"kernel {kind} B={B} LA={LA} W={W} ({cells} cells): "
                f"{t['ms']:.3f} ms, plain {pms:.1f} ms, bound "
                f"{t['bound_ms']:.3f} ms ({t['bound_by']}), share "
                f"{t['share']:.4f}, equal (max abs err {err})")
            shapes.append(dict(t, max_abs_err=err,
                               shape=f"B {B}, LA {LA}, W {W}"))
        res[kind] = dict(shapes[0], max_abs_err=max(x["max_abs_err"]
                                                    for x in shapes),
                         shapes=shapes)
    return res


def _plain_wr(kind, args, LA, W):
    """The plain version of a whole-read kernel on the same device
    tensors (the wrappers take it only for CPU tensors)."""
    from smartdenovo_tpu_torch.ops import banded, refine, refine5q, traceback

    if kind == "banded":
        a, b, alen, blen, base = args
        s, e, d = banded.banded_align_plain(
            *args, LA=LA, W=W, match=2, mismatch=-5, gap_a=-2, gap_b=-3,
            semiglobal_b=True)
        return (s, e, d) + traceback.tb_banded(d, base, alen, e,
                                               T=2 * (LA + 1) + W)
    if kind == "refine":
        s, d = refine.refine_banded_affine_plain(
            *args, LA=LA, W=W, match=2, mismatch=-5, open_i=-2, open_d=-3,
            ext=-1)
    else:
        s, d = refine5q.refine5q_banded_plain(
            *args, LA=LA, W=W, qclp=refine5q.QCLP, qmis=refine5q.QMIS,
            qdel=refine5q.QDEL, qext=refine5q.QEXT)
    alen, blen, base = args[-3:]
    return s, d, traceback.tb_refine(d, base, alen, blen,
                                     T=2 * (LA + 1) + W + 4)


# ---------------------------------------------------------------------------
# phase 4: the join path, cuda against cpu
# ---------------------------------------------------------------------------


def phase_join():
    import numpy as np
    import torch

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads
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

    from smartdenovo_tpu_torch.utils.simulate import (random_genome, simulate_reads,
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
    probe, seen = cns._probe_anchor_device, {"calls": 0, "args": None}

    def probe_seen(*a, **kw):  # counts the calls, keeps the largest batch
        seen["calls"] += 1
        if seen["args"] is None or a[0].shape[0] > seen["args"][0].shape[0]:
            seen["args"] = a
        return probe(*a, **kw)

    cns._probe_anchor_device = probe_seen
    try:
        log, wall = _run_cli(["cns", "-i", lay, "-o", lay + ".cns", "-n", "6"])
    finally:
        cns._probe_anchor_device = probe
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
    time_probe(seen["args"], seen["calls"])
    return launches, idents


def time_probe(args, calls):
    """CUDA-event time of the probe anchoring on one batch of phase 6 (c).
    Its bound: the reads and windows (bytes) read once and px, py, found
    written; or the operations of the least work: a rolling k-mer code of
    every window base (3 int32 operations) and, per probe and diagonal
    offset, a compare, two range tests, a select and a max (5)."""
    from smartdenovo_tpu_torch.pipeline import cns

    a, alen, w, wlen, doff = args
    B, LA = a.shape
    LW = w.shape[1]
    S, D = 96, 1024     # _probe_anchor_device's defaults, as cns calls it
    ms = cuda_ms(lambda: cns._probe_anchor_device(*args), reps=2)
    t = timing(ms, None, B * (LA + LW) + 12 * B + 9 * B * S,
               3 * B * LW + 5 * B * S * 2 * D)
    say(f"probe anchoring (torch ops) B={B} LA={LA} LW={LW}: {ms:.3f} ms, "
        f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}), share "
        f"{t['share']:.4f}; {calls} calls in the cut's cns")


def _check_aln(path):
    """The -a records of one unitig, checked as tests/test_cns.py:90-105
    does; returns (records, MATRIX rows, columns of the aligned rows,
    records whose mat + mis + ins + dl is not their Q row's length)."""
    with open(path) as fh:
        text = fh.read().splitlines()
    recs = [ln for ln in text if ln and ln[0] not in "QTM" and "\t" in ln
            and not ln.startswith("MATRIX")]
    qrows = [ln for ln in text if ln.startswith("Q\t")]
    trows = [ln for ln in text if ln.startswith("T\t")]
    mrows = [ln for ln in text if ln.startswith("M\t")]
    mats = [ln for ln in text if ln.startswith("MATRIX\t")]
    if not len(recs) == len(qrows) == len(trows) == len(mrows):
        raise AssertionError(f"{path}: {len(recs)} records, {len(qrows)} Q, "
                             f"{len(trows)} T, {len(mrows)} M rows")
    bad = 0
    for r, q, t, m in zip(recs, qrows, trows, mrows):
        cols = r.split("\t")
        mat, mis, ins, dl = (int(c) for c in cols[12:16])
        if (len(cols) != 16 or len(q) != len(t) or len(q) != len(m)
                or mat + mis + ins + dl != len(q) - 2
                or mat + mis + ins != int(cols[4]) - int(cols[3])
                or mat + mis + dl != int(cols[9]) - int(cols[8])):
            bad += 1
    return recs, mats, bad


def phase_wholeread(tmp, cut, seg_idents, dev="cuda"):
    """The whole-read consensus engine on `dev` (seg_engine=False, cns
    -a/-V, f5q units); returns the launches of banded, refine and refine5q in (c)
    and (d), read with the counts set to 0 just before (c)."""
    import numpy as np
    import torch

    from smartdenovo_tpu_torch.data.readbank import encode_f5q
    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline import cns

    # (a) the golden layout, six iterations, with -a/-V
    lay = os.path.join(GOLD, "smoke.ref.lay")
    units = cns.parse_lay_file(lay)
    aln = os.path.join(tmp, "wr_smoke.aln")
    p = cns.CnsParams(n_iter=6, seg_engine=False)
    _build.reset_launches()
    t0 = time.perf_counter()
    res = dict(cns.run_cns(units, p, aln_path=aln, vmsa=2.05, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la = {k: _build.LAUNCHES[k] for k in ("banded", "refine", "refine5q")}
    ref = read_fasta(os.path.join(GOLD, "smoke.ref.cns"))
    rows = []
    for u in units:
        got = cns.codes_to_seq(res[u.name])
        ib = identity(cns.codes_to_seq(cns._gen_backbone(u)), ref[u.name])
        iw = identity(got, ref[u.name])
        rows.append(f"{u.name} {iw:.5f} (segment engine {seg_idents[u.name]:.5f}"
                    f", backbone {ib:.5f}; {len(got)} bp)")
        if iw <= ib:
            raise AssertionError(f"whole-read {u.name}: identity {iw:.5f} not "
                                 f"above its backbone's {ib:.5f}")
    recs, mats, bad = _check_aln(aln)
    nreads = sum(len(u.reads) for u in units)
    say(f"whole-read golden -n 6 -a -V 2.05: {wall:.1f} s, launches {la}; "
        f"identity vs smoke.ref.cns: " + ", ".join(rows))
    say(f"whole-read golden .aln: {len(recs)} records of {nreads} reads, "
        f"{len(mats)} MATRIX rows, {bad} inconsistent")
    on_card = dev != "cpu"     # the kernels launch only for cuda tensors
    if bad or len(recs) < 0.8 * nreads or len(mats) != len(recs) or (
            on_card and not (la["banded"] and la["refine"])):
        raise AssertionError("whole-read golden .aln records or launches")

    # (b) one golden unitig, one iteration, cuda against cpu
    unit = min(units, key=lambda u: len(u.reads))
    p1 = cns.CnsParams(n_iter=1, seg_engine=False)
    outs, walls = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        c, offs = cns.consensus_unitig(unit, p1, return_offs=True, device=d)
        buf = io.StringIO()
        cns.write_final_alignments(buf, unit, offs, c, p1, vmsa=2.05,
                                   device=d)
        outs[d] = (c, offs, buf.getvalue())
        walls[d] = time.perf_counter() - t0
    g, c = outs[dev], outs["cpu"]
    if not (np.array_equal(g[0], c[0]) and g[1] == c[1] and g[2] == c[2]):
        raise AssertionError(f"whole-read {unit.name}: cuda and cpu differ")
    say(f"whole-read {unit.name} ({len(unit.reads)} reads) -n 1 + -a -V: {dev} "
        f"{walls[dev]:.1f} s, cpu {walls['cpu']:.1f} s; {len(g[0])} bp, "
        f"offsets and {len(g[2])} bytes of .aln equal")

    # (c) cns -n 1 -a -V on the E. coli layout cut at `cut`
    lay = os.path.join(tmp, "ecoli_wr.lay")
    kept, total = _cut_lay(os.path.join(tmp, "ecoli.dmo.lay"), lay, cut)
    unit = cns.parse_lay_file(lay)[0]
    bb = len(cns._gen_backbone(unit))
    aln = lay + ".aln"
    _build.reset_launches()
    log, wall = _run_cli(["cns", "-i", lay, "-o", lay + ".cns", "-n", "1",
                          "-a", aln, "-V", "2.05", "--device", dev])
    recs, mats, bad = _check_aln(aln)
    iters = re.findall(r"iter (\d+): (\d+) reads aligned, len (\d+) -> (\d+)",
                       log)
    say(f"whole-read E. coli cut (offsets < {cut}) cns -n 1 -a -V 2.05: "
        f"{kept} of {total} reads, backbone {bb} bp -> "
        f"{iters[-1][3] if iters else 0} bp; wall {wall:.1f} s; "
        f"{len(recs)} records, {len(mats)} MATRIX rows, {bad} inconsistent; "
        f"launches banded {_build.LAUNCHES['banded']} refine "
        f"{_build.LAUNCHES['refine']}")
    _say_split("(c)", log)
    if bad or len(recs) < 0.9 * kept:
        raise AssertionError(f"whole-read cut: {len(recs)} records of {kept} "
                             f"reads, {bad} inconsistent")

    # (d) the same cut with seeded synthetic f5q tracks in column 7
    rng = np.random.default_rng(5)
    qlay = os.path.join(tmp, "ecoli_wr_f5q.lay")
    with open(lay) as src, open(qlay, "w") as dst:
        for line in src:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 6 and not line.startswith(">"):
                L = len(cols[5])
                q = np.zeros((7, L), np.uint8)
                q[0] = rng.integers(10, 40, L)
                q[1:4] = rng.integers(5, 30, (3, L))
                q[4] = rng.integers(10, 40, L)
                q[5:7] = rng.integers(0, 4, (2, L))
                line = "\t".join(cols[:6] + [encode_f5q(q)]) + "\n"
            dst.write(line)
    log, wall = _run_cli(["cns", "-i", qlay, "-o", qlay + ".cns", "-n", "2",
                          "--device", dev])
    launches = dict(_build.LAUNCHES)
    iters = re.findall(r"iter (\d+): (\d+) reads aligned, len (\d+) -> (\d+)",
                       log)
    res = read_fasta(qlay + ".cns")
    L = len(next(iter(res.values()))) if res else 0
    aligned = int(iters[-1][1]) if iters else 0
    say(f"whole-read E. coli cut with f5q tracks cns -n 2: wall {wall:.1f} s; "
        f"backbone {bb} bp -> {L} bp; reads accepted per iteration "
        f"{[int(x[1]) for x in iters]} of {kept}; launches {launches}")
    _say_split("(d)", log)
    if (on_card and not launches["refine5q"]) or not 0.9 * bb <= L <= 1.1 * bb \
            or aligned < 0.9 * kept:
        raise AssertionError(f"whole-read f5q cut: refine5q launches "
                             f"{launches['refine5q']}, length {L} vs {bb}, "
                             f"{aligned} of {kept} accepted")
    return {k: launches[k] for k in ("banded", "refine", "refine5q")}


def _say_split(tag, log):
    """The align pass's time split (host clock; each kernel with the fetch
    of its outputs) as the consensus driver logs it: per iteration, for
    the -a/-V pass (whose "writer" is the record writer after its align
    pass), and summed over all of them."""
    lines = re.findall(r"cns \S+ (iter \d+ align|-a/-V) split: (.*)", log)
    total: dict = {}
    for what, ln in lines:
        say(f"whole-read {tag} {what} split: {ln}")
        for k, v in re.findall(r"(\w+) ([0-9.]+)s", ln):
            total[k] = total.get(k, 0.0) + float(v)
    parts = {k: round(v, 3) for k, v in sorted(total.items())}
    say(f"whole-read {tag} align split in all (s): {json.dumps(parts)}")


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
        launches["segdp"], idents = phase_cns(tmp, CNS_CUT)
        launches.update(phase_wholeread(tmp, WR_CUT, idents))
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
                     "not Pallas)"),
           "banded": ("smartdenovo_tpu_torch/csrc/banded.cu",
                      "smartdenovo_tpu/ops/banded.py:33 and "
                      "smartdenovo_tpu/ops/traceback.py:29 (jax.jit lax.scan, "
                      "not Pallas)"),
           "refine": ("smartdenovo_tpu_torch/csrc/refine.cu",
                      "smartdenovo_tpu/ops/refine.py:49 and "
                      "smartdenovo_tpu/ops/traceback.py:58 (jax.jit lax.scan, "
                      "not Pallas)"),
           "refine5q": ("smartdenovo_tpu_torch/csrc/refine.cu",
                        "smartdenovo_tpu/ops/refine5q.py:47 and "
                        "smartdenovo_tpu/ops/traceback.py:58 (jax.jit "
                        "lax.scan, not Pallas)")}
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k], **kres[k])
               for k in src]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"the main path did not launch {idle}")
    say(json.dumps({"kernels": kernels}))
    say(gpu_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
