#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (smartdenovo_tpu_torch) on one GPU.

    python3 chip_smoke.py [--workdir DIR]
    python3 chip_smoke.py --only swlocal     # device, build, phase 3's swlocal
    python3 chip_smoke.py --only swwide      # device, build, phase 3's swwide
    python3 chip_smoke.py --only nwglobal    # device, build, phase 3's nwglobal rows
    python3 chip_smoke.py --only partitioned # device, build, phase 10
    python3 chip_smoke.py --only vtab        # device, build, phase 11

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
            phase 7's E. coli align pass gives them, and timed at 528 reads
            of the same length (four on each SM sub-partition); the SW local
            DP (swlocal) on one batch of the E. coli zmo path (16 queries x
            64 chains, both passes in one call, W 256), timed and held
            equal to its plain version; its bound counts the batch's live
            rows, counted on the host (the bound of all rows is printed
            beside it); the wide-band SW local DP (swwide) on the call
            with the most rows that `cyc` makes on phase 5's E. coli reads
            (2,048 reads against their reverse complements at LA 16,384,
            W 1600; the reads are simulated before phase 3: every pair on
            its register path of unit band steps), timed and held equal
            to its plain version, its bound over the live cells, and a
            small batch of wide band steps at W 1600 (its shared-memory
            path) held equal too; its block shape and the time of each
            call and of the live-row plan are printed; the global NW DP
            (nwglobal) at its two callers' shapes, 2,048 pairs of 384-512
            bp windows at 13% divergence, L 512, and phase 11 (c)'s first
            DAG-loop call, 24 reads at L 2,048: each timed and held equal
            to its plain version on the card (scores and every byte of the
            direction plane), its bound the larger of the plane's bytes
            and the live cells' operations, and the instance and shape
            swdp.nw_plan picked printed
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
8. zmo      the SW (zmo) engine on cuda:
            (a) `asm -e zmo -c 0` through the CLI on phase 5's E. coli reads
                (batch_q 16; band 256, 500 candidates, 64 chains a query):
                stage times (index, phase1, phase2, redispatch, emission,
                cigars, gbo, clp, lay), overlaps, wtgbo's candidates and
                new overlaps per round, unitigs, peak device memory and
                launches; swlocal, banded and K1 must have launched
            (b) tests/test_zmo_goldens.py's protocol: the first 60 reads of
                smoke.fa with ZmoParams.zmo() and GboParams(), held to its
                bars against smoke.zmo.ref.ovl / .gbo (pair recall >= 0.95,
                precision >= 0.85, gbo coverage >= 0.5); the whole 179-read
                set's recall and precision printed beside them
            (c) `zmo -e sw -n` records, wtgbo's rescue and wtext on a small
                simulation, on cuda and on cpu: equal, with swlocal, refine
                and the banded row-max instance launched

9. tools     the side tools on cuda:
            (a) `cyc` through the CLI on phase 5's E. coli reads with 16 of
                them replaced by seeded palindromes folded at known points
                (some off centre): every planted read cut at its fold as the
                JAX package's rule gives, every other read kept whole,
                swwide launched; wall time and launches, and the summed
                CUDA-event time of swwide's launches beside the wall
            (b) on cuda and on cpu, the same bytes: cyc on a 24-read cut of
                (a) with 4 palindromes, pairaln on 64 consecutive pairs of
                overlapping E. coli reads, dif on 32 reads of a 12 kb locus,
                dotplot on two overlapping reads, mer on 500 reads, and
                join_fragments_dag on tests/test_corr.py's gap fill; swwide,
                swlocal, banded and segdp launched
            (c) `mer` through the CLI on the E. coli reads and `idx` on the
                first IDX_READS of them (a depth cut: idx is host sorts and
                zlib, ~135 s on all 8,354 reads), their times; load_indexes
                of the snapshot equal to the build

10. partitioned  the read-block-partitioned overlapper on cuda:
            (a) `zmo -G 2` and `-G 1` through the CLI (default dmo flags,
                --batch-q 64) on phase 5's E. coli reads, where -G 2 must
                raise at the expansion cap (its sweep needs far more than
                the cap per batch and part), then on the depth cut (the
                E. coli simulation's settings on a 250 kb genome): wall,
                stage times, redispatches, K1 launches (> 0), peak device
                memory of each, the pair-set Jaccard of -G 2 against -G 1
                (>= 0.97)
            (b) `-G 2` on the 30 kb test bank, on cuda and on cpu: equal
            (c) whether gloo takes CUDA tensors; the sharded driver on the
                60 kb dry-run sim as two gloo ranks sharing the card,
                equal to the same world on the cpu, and as a world of one
                over nccl, equal to overlap_dmo on the card
            (d) graft_entry.entry()'s forward on cuda and on cpu: its 8
                outputs equal

11. vtab     the vtab z-mer matcher and the global NW DP on cuda:
            (a) overlap_dmo(matcher="vtab") through the API at the dmo
                defaults and --batch-q 64 on phase 5's E. coli reads, which
                must raise at the 2^25 z-mer index width as the JAX
                package does, then on the longest prefix of the reads
                whose index stays under it (a depth cut), beside
                matcher="auto": wall, stage split, the cut's reads, bases
                and index width, K1 launches (> 0), peak device memory,
                and the pair-set Jaccard against auto (>= 0.99)
            (b) the vtab on cuda and on cpu, dm engine on the 30 kb test
                bank and sw engine on the SW tests' 8 kb bank: equal
            (c) tests/test_dagcns.py's consensus loop through
                batch_global_align at L 2,048 (a 2,000 bp truth, 24 reads
                at 10% error, three iterations): the first iteration equal
                to the plain version on the same device tensors, the
                consensus identity above 0.97 and above the backbone's

The last lines are one JSON object of kernel results (all ten kernels,
each launched on the main path: K1-K3 in phase 5, segdp in 6 (c), the
whole-read DPs in 7 (c) and (d), swlocal in 8 (a), swwide in 9 (a),
nwglobal in 11 (c)), the card's name and power limit, and
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
CNS_CUT = 1_500_000         # bp of the E. coli layout that phase 6 (c) polishes
WR_CUT = 500_000            # bp of it that phase 7 (c) and (d) align whole
IDX_READS = 2_100           # E. coli reads that phase 9 (c) indexes (host sorts)
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
# the SW local DP's cell (csrc/swlocal.cu): two candidate adds, the
# substitution select, the diagonal/up compare and its select, the restart
# compare and select, the mask select, the gap add, compare and select, and
# the row best's compare
SW_OPS_PER_CELL = 12


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


def phase_kernels(dev, fa):
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
    results["swlocal"] = phase_swlocal(dev)
    results["swwide"] = phase_swwide(dev, fa)
    results["nwglobal"] = phase_nwglobal(dev)
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
    of 10); at B = 64 it is held equal to its plain version on the same
    inputs, whose one call is timed too (its cost is a Python loop over
    rows and traceback steps, so about a minute a kernel, about the same
    at B = 528, where the script's time limit leaves no room for it;
    test_whole_read_cuda_many_reads holds each kernel at 528 reads of up to
    2,048 rows).  The bound counts
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
            pms, err, check = None, None, "not checked here"
            if B == 64:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                exp = _plain_wr(kind, args, LA, W)
                ev[1].record()
                ev[1].synchronize()
                pms = ev[0].elapsed_time(ev[1])
                ok, err = _wr_equal(kind, got, exp, alen)
                if not ok:
                    raise AssertionError(f"{kind} differs from its plain "
                                         f"version at B {B}, LA {LA} (max "
                                         f"abs err {err})")
                check = f"equal (max abs err {err})"
                del exp
            del args, got
            torch.cuda.empty_cache()
            t = timing(ms, pms, nbytes, OPS_PER_CELL[kind] * cells)
            say(f"kernel {kind} B={B} LA={LA} W={W} ({cells} cells): "
                f"{t['ms']:.3f} ms, plain "
                f"{'not run' if pms is None else f'{pms:.1f} ms'}, bound "
                f"{t['bound_ms']:.3f} ms ({t['bound_by']}), share "
                f"{t['share']:.4f}, {check}")
            shapes.append(dict(t, max_abs_err=err,
                               shape=f"B {B}, LA {LA}, W {W}"))
        res[kind] = dict(shapes[0], shapes=shapes)
    return res


def _sw_batch(seed, Q=16, C=64, W=256):
    """Both passes of one batch of the E. coli zmo path: Q queries with C
    chains each, read lengths drawn as scripts/sim_ecoli.py's simulation
    draws them (gamma(4, 9500 / 4), at least 1,000 bp), 13% error, every
    candidate overlapping its query by 1,000 bp or more on the forward
    strand, and the band of each chain from its extents as sw_align_batch
    computes it.  LA is pad_tier of the longest of the ~8,700 reads of
    that simulation, as the engine pads every batch.  Returns the seven
    numpy inputs of banded_local_dp over 2 Q C pairs (forward, then
    reversed) and LA."""
    import numpy as np

    from smartdenovo_tpu_torch.ops.align import pad_tier
    from smartdenovo_tpu_torch.utils.simulate import mutate_read, random_genome

    rng = np.random.default_rng(seed)
    n_reads = GENOME_LEN * COVERAGE // 9500
    lens = np.maximum(1000, rng.gamma(4.0, 9500 / 4.0, n_reads).astype(np.int64))
    LA = pad_tier(int(lens.max()))
    G = random_genome(rng, 600_000)
    fwd, rev = [], []
    for _ in range(Q):
        Lq = int(rng.choice(lens))
        sq = int(rng.integers(60_000, len(G) - 60_000 - Lq))
        a = mutate_read(rng, G[sq:sq + Lq], 0.13)[:LA]
        fa = len(a) / Lq
        for _ in range(C):
            Lc = int(rng.choice(lens))
            s0 = int(rng.integers(sq - Lc + 1000, sq + Lq - 1000))
            b = mutate_read(rng, G[s0:s0 + Lc], 0.13)[:LA]
            fb = len(b) / Lc
            o0, o1 = max(sq, s0), min(sq + Lq, s0 + Lc)
            tb, te = int((o0 - sq) * fa), int((o1 - sq) * fa)
            qb, qe = int((o0 - s0) * fb), int((o1 - s0) * fb)
            sl = min(max(((qe - qb) << 12) // max(1, te - tb), 1), 4 << 12)
            fwd.append((a, b, tb, qb, sl))
            rev.append((a[::-1], b[::-1], len(a) - te, len(b) - qe, sl))
    B = 2 * Q * C
    A = np.full((B, LA), 4, np.uint8)
    Bm = np.full((B, LA), 4, np.uint8)
    alen, blen, tbv, qbv, slv = (np.zeros(B, np.int32) for _ in range(5))
    for k, (a, b, tb, qb, sl) in enumerate(fwd + rev):
        A[k, :len(a)] = a
        Bm[k, :len(b)] = b
        alen[k], blen[k], tbv[k], qbv[k], slv[k] = len(a), len(b), tb, qb, sl
    return [A, Bm, alen, blen, tbv, qbv, slv], LA


def _wrap32(x):
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def sw_live_rows_host(x, LA, W):
    """Per pair, the rows of the SW DP that can change its outputs, counted
    on the host from every row's band start (numpy, the JAX function's int32
    formula), independent of the port's live_rows: where the band start is
    non-decreasing over rows 0 .. min(alen, LA), the rows before the band
    reaches column 1 and those after two rows in a row start at blen are
    dead (the latter at the engine's scores, gap -3); any other pair counts
    all its rows.  [B] int64."""
    import numpy as np

    _, _, alen, blen, tb, qb, sl = (np.asarray(v, np.int64) for v in x)
    n = np.zeros(alen.size, np.int64)
    for p in range(alen.size):
        R = min(int(alen[p]), LA)
        if R <= 0 or blen[p] <= 0:
            continue
        i = np.arange(R + 1, dtype=np.int64)
        c = _wrap32(qb[p] + (_wrap32(_wrap32(i - tb[p]) * sl[p]) >> 12))
        bs = np.clip(_wrap32(c - W // 2), -(W - 1), blen[p])
        if (np.diff(bs) < 0).any():
            n[p] = R
            continue
        live = np.flatnonzero(bs[1:] > -(W - 1))
        pinned = np.flatnonzero((bs[1:] == blen[p]) & (bs[:-1] == blen[p]))
        i0 = live[0] + 1 if live.size else R + 1
        i1 = pinned[0] if pinned.size else R
        n[p] = max(0, i1 - i0 + 1)
    return n


def phase_swlocal(dev):
    """swlocal (csrc/swlocal.cu) on one batch of the E. coli zmo path
    (_sw_batch: 16 queries x 64 chains, both passes in one call, W 256),
    timed (median of 10 calls, each alone, and the mean of 10 in a row)
    and held equal to its plain version on the same inputs, whose one call
    is timed too; the live-row plan that each call makes (live_rows and
    longest_first) is timed alone.  The bound counts the live cells of this
    batch (sw_live_rows_host x W) at SW_OPS_PER_CELL int32 operations,
    against the inputs' bytes; the bound of all rows, sum of min(alen, LA)
    x W cells, is printed beside it."""
    import torch

    from smartdenovo_tpu_torch.ops import overlap_dp

    x, LA = _sw_batch(77)
    W = 256
    live = sw_live_rows_host(x, LA, W)
    t = [torch.from_numpy(v).to(dev) for v in x]
    kw = dict(LA=LA, W=W)
    got = overlap_dp.banded_local_dp(*t, **kw)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: overlap_dp.banded_local_dp(*t, **kw))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    exp = overlap_dp.banded_local_dp_plain(*t, **kw)
    ev[1].record()
    ev[1].synchronize()
    pms = ev[0].elapsed_time(ev[1])
    err = max(max_abs(g, e) for g, e in zip(got, exp))
    if err:
        raise AssertionError(f"swlocal differs from its plain version (max "
                             f"abs err {err})")
    ms_row = cuda_ms(lambda: overlap_dp.banded_local_dp(*t, **kw),
                     in_a_row=True)
    plan_ms = cuda_ms(lambda: overlap_dp.longest_first(
        *overlap_dp.live_rows(*t[2:], LA, W)))
    alen = t[2].clamp(max=LA)
    rows = int(alen.sum())
    nbytes = int(alen.sum() + t[3].sum()) + 5 * 4 * t[2].numel() + 16 * t[2].numel()
    tm = timing(ms, pms, nbytes, SW_OPS_PER_CELL * int(live.sum()) * W)
    all_rows, _ = bound(nbytes, SW_OPS_PER_CELL * rows * W)
    B = t[2].numel()
    say(f"kernel swlocal B={B} LA={LA} W={W} ({rows} rows, {int(live.sum())} "
        f"live, longest live pair {int(live.max())}; one warp a SM "
        f"sub-partition): {ms:.3f} ms (of it "
        f"the live-row plan {plan_ms:.3f} ms; {ms_row:.3f} in a row), plain "
        f"{pms:.1f} ms, live-cell bound {tm['bound_ms']:.3f} ms "
        f"({tm['bound_by']}), share {tm['share']:.4f}; all-rows bound "
        f"{all_rows:.3f} ms, share {all_rows / ms:.4f}; equal (best score max "
        f"{int(exp[0].max())})")
    return dict(tm, max_abs_err=err, shape=f"B {B}, LA {LA}, W {W}",
                live_rows=int(live.sum()), rows=rows,
                longest_live=int(live.max()), ms_in_a_row=ms_row,
                plan_ms=plan_ms, bound_all_rows_ms=all_rows)


def cyc_chunk(fa, dev):
    """The banded_local_dp call with the most rows that `cyc` makes on the
    reads of fa (its first DP, rc(read) against read, W 1600), formed as
    align_local_batch forms it: (the seven inputs on dev, LA)."""
    from smartdenovo_tpu_torch.data.readbank import revcomp_codes, seq_to_codes
    from smartdenovo_tpu_torch.io.fasta import read_seqs
    from smartdenovo_tpu_torch.pipeline import aln_tools

    codes = [seq_to_codes(seq) for _, _, seq in read_seqs([fa])]
    pairs = [(revcomp_codes(c), c) for c in codes]
    idx, LA = max(aln_tools.local_chunks(pairs),
                  key=lambda c: sum(min(len(codes[k]), c[1]) for k in c[0]))
    return aln_tools.local_inputs([pairs[k] for k in idx], LA, dev), LA


def _wide_step_batch(seed, B=64, LA=1024):
    """B pairs whose band moves more than one column a row (slopes of 1.2
    to 4 columns, and a few negative), b a random sequence and a its codes
    along that slope at 10% substitutions, so the DP scores along the band:
    the shared-memory path of swwide.  The seven numpy inputs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = np.full((B, LA), 4, np.uint8)
    Bm = rng.integers(0, 4, (B, 4 * LA + 64)).astype(np.uint8)
    sl = rng.integers(int(1.2 * 4096), 4 * 4096, B).astype(np.int32)
    sl[::16] = -4096
    for k in range(B):
        cols = (np.arange(LA, dtype=np.int64) * abs(int(sl[k]))) >> 12
        a = Bm[k, cols]
        sub = rng.random(LA) < 0.1
        A[k] = np.where(sub, (a + 1) % 4, a)
    alen = np.full(B, LA, np.int32)
    blen = np.full(B, Bm.shape[1], np.int32)
    zero = np.zeros(B, np.int32)
    return [A, Bm, alen, blen, zero, zero.copy(), sl]


def phase_swwide(dev, fa):
    """swwide (csrc/swwide.cu) on the call of `cyc` with the most rows on
    the E. coli reads (cyc_chunk: 2,048 reads of 8,193-16,384 bp against
    their reverse complements at LA 16,384, W 1600, every pair on the
    register path of unit band steps; the grid's blocks each take several
    pairs from the counter), timed (median of 5 calls, each alone, and the
    mean of 5 in a row) and held equal to its plain version on the same
    inputs (tolerance 0), whose one call is timed too; then a batch of 64
    pairs of wide band steps at W 1600 and LA 1,024 (_wide_step_batch: the
    shared-memory path), timed and held equal the same way.  The bound
    counts the cyc call's live cells (sw_live_rows_host x W) at
    SW_OPS_PER_CELL int32 operations, against the inputs' bytes.  Prints
    the block shape (swwide_shape) and the time of each call and of the
    cyc call's live-row plan (live_rows, unit_steps, longest_first)."""
    import torch

    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.ops import overlap_dp

    W = 1600
    t, LA = cyc_chunk(fa, dev)
    live = sw_live_rows_host([v.cpu().numpy() for v in t], LA, W)
    kw = dict(LA=LA, W=W)
    if not bool(overlap_dp.unit_steps(*t[2:], LA, W).all()):
        raise AssertionError("a cyc pair is off swwide's unit-step path")
    n0 = _build.LAUNCHES["swwide"]
    got = overlap_dp.banded_local_dp(*t, **kw)
    torch.cuda.synchronize()
    if _build.LAUNCHES["swwide"] != n0 + 1:
        raise AssertionError("banded_local_dp at W 1600 did not launch swwide")
    ms = cuda_ms(lambda: overlap_dp.banded_local_dp(*t, **kw), reps=5)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    exp = overlap_dp.banded_local_dp_plain(*t, **kw)
    ev[1].record()
    ev[1].synchronize()
    pms = ev[0].elapsed_time(ev[1])
    err = max(max_abs(g, e) for g, e in zip(got, exp))
    if err:
        raise AssertionError(f"swwide differs from its plain version (max "
                             f"abs err {err})")
    ms_row = cuda_ms(lambda: overlap_dp.banded_local_dp(*t, **kw), reps=5,
                     in_a_row=True)
    plan_ms = cuda_ms(lambda: (overlap_dp.longest_first(
        *overlap_dp.live_rows(*t[2:], LA, W)),
        overlap_dp.unit_steps(*t[2:], LA, W)), reps=5)
    # the shared-memory path: wide band steps
    x = [torch.from_numpy(v).to(dev) for v in _wide_step_batch(12)]
    LAw = x[0].shape[1]
    unit = overlap_dp.unit_steps(*x[2:], LAw, W)
    gw = overlap_dp.banded_local_dp(*x, LA=LAw, W=W)
    ew = overlap_dp.banded_local_dp_plain(*x, LA=LAw, W=W)
    errw = max(max_abs(g, e) for g, e in zip(gw, ew))
    if errw or bool(unit.any()) or int(ew[0].max()) < 400:
        raise AssertionError(f"swwide's wide-step batch: max abs err {errw}, "
                             f"{int(unit.sum())} unit pairs, best "
                             f"{int(ew[0].max())}")
    ms_w = cuda_ms(lambda: overlap_dp.banded_local_dp(*x, LA=LAw, W=W), reps=5)
    alen = t[2].clamp(max=LA)
    nbytes = int(alen.sum() + t[3].sum()) + 5 * 4 * t[2].numel() + 16 * t[2].numel()
    tm = timing(ms, pms, nbytes, SW_OPS_PER_CELL * int(live.sum()) * W)
    B = t[2].numel()
    P, warps = overlap_dp.swwide_shape(W)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    say(f"kernel swwide B={B} LA={LA} W={W} ({int(live.sum())} live rows, "
        f"longest {int(live.max())}; a block of {warps} warps x 32 threads x "
        f"{P} lanes a pair, {nsm} SMs): {ms:.3f} ms ({ms_row:.3f} in a row; "
        f"of it the live-row plan {plan_ms:.3f} ms), plain {pms:.1f} ms, "
        f"live-cell bound {tm['bound_ms']:.3f} ms ({tm['bound_by']}), share "
        f"{tm['share']:.4f}; equal (best scores {int(exp[0].max())} max, "
        f"{int((exp[0] >= 400).sum())} of {B} at 400 or more); wide steps "
        f"(B {x[0].shape[0]}, LA {LAw}, shared-memory path): {ms_w:.3f} ms, "
        f"equal (best {int(ew[0].max())})")
    return dict(tm, max_abs_err=max(err, errw), shape=f"B {B}, LA {LA}, W {W}",
                live_rows=int(live.sum()), longest_live=int(live.max()),
                ms_in_a_row=ms_row, plan_ms=plan_ms, block=[warps, P],
                wide_step_ms=ms_w)


NW_B, NW_L = 2048, 512     # phase 3's nwglobal batch


def _nw_batch(seed, B=NW_B, L=NW_L):
    """B pairs of windows of 384-512 bp: a random window and a copy of it
    mutated at 13% (utils/simulate.py mutate_read), cut to L: the inputs of
    batch_global_align (a, b [B, L] u8, alen, blen [B] i32)."""
    import numpy as np

    from smartdenovo_tpu_torch.utils.simulate import mutate_read

    rng = np.random.default_rng(seed)
    a = np.full((B, L), 4, np.uint8)
    b = np.full((B, L), 4, np.uint8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    for k in range(B):
        n = int(rng.integers(384, 513))
        src = rng.integers(0, 4, n).astype(np.uint8)
        mut = mutate_read(rng, src, 0.13)[:L]
        a[k, :n] = src
        b[k, :len(mut)] = mut
        alen[k], blen[k] = n, len(mut)
    return a, b, alen, blen


def nw_plan_text(L, B):
    """The instance batch_global_align takes on the card for B pairs at L
    (swdp.nw_plan), in words."""
    from smartdenovo_tpu_torch.ops import swdp

    plan = swdp.nw_plan(L, B)
    if plan[0] == "register":
        P, warps, pairs = plan[1:]
        return (f"register instance, P {P} rows a lane, {warps} warp(s) a "
                f"pair, {pairs} pair(s) a block")
    return "wide instance, " + ("shared memory" if plan[1]
                                else "global scratch")


def _nw_row(dev, x, name):
    """One nwglobal row: the inputs x (a, b, alen, blen as numpy) on the
    card, scores and every byte of the plane held equal to the plain
    version on the same device tensors (tolerance 0), timed (median of 10
    calls, each alone, and the mean of 10 in a row) beside the plain
    version (its one call, ~3 s at the DAG loop's shape).  The bound is
    the larger of the plane's and the inputs' bytes over HBM and the live
    cells, sum (alen + 1)(blen + 1), at SW_OPS_PER_CELL int32 operations
    over the int32 rate."""
    import torch

    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.ops import swdp

    t = [torch.from_numpy(v).to(dev) for v in x]
    B, L = t[0].shape
    n0 = _build.LAUNCHES["nwglobal"]
    got = swdp.batch_global_align(*t, max_len=L)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    exp = swdp.batch_global_align_plain(*t, max_len=L)
    ev[1].record()
    ev[1].synchronize()
    pms = ev[0].elapsed_time(ev[1])
    if _build.LAUNCHES["nwglobal"] != n0 + 1:
        raise AssertionError("batch_global_align did not launch nwglobal")
    if not torch.equal(got[1], exp[1]):
        raise AssertionError(f"nwglobal's direction plane differs from its "
                             f"plain version ({name})")
    err = max_abs(got[0], exp[0])
    if err:
        raise AssertionError(f"nwglobal's scores differ from its plain "
                             f"version ({name}; max abs err {err})")
    del got, exp
    call = lambda: swdp.batch_global_align(*t, max_len=L)  # noqa: E731
    ms, rms = cuda_ms(call), cuda_ms(call, in_a_row=True)
    cells = int(((t[2].to(torch.int64) + 1) * (t[3].to(torch.int64) + 1))
                .sum())
    plane = B * (2 * L + 1) * (L + 1)
    tm = timing(ms, pms, plane + 2 * B * L + 12 * B, SW_OPS_PER_CELL * cells)
    plan = nw_plan_text(L, B)
    say(f"kernel nwglobal {name} B={B} L={L} ({cells} live cells, plane "
        f"{plane} bytes; {plan}): {ms:.3f} ms ({rms:.3f} in a row), plain "
        f"{pms:.1f} ms, bound {tm['bound_ms']:.3f} ms ({tm['bound_by']}), "
        f"share {tm['share']:.4f}; equal (scores and plane)")
    return dict(tm, max_abs_err=err, shape=f"B {B}, L {L}", cells=cells,
                ms_in_a_row=rms, plan=plan)


def phase_nwglobal(dev):
    """nwglobal (csrc/nwglobal.cu) at its two callers' shapes (_nw_row
    each): NW_B pairs of 384-512 bp windows at 13% divergence, L NW_L,
    and phase 11 (c)'s DAG loop, iteration 1 (nw_dag_inputs: 24 reads
    against the backbone, L NW_DAG_L).  Each row prints the instance and
    shape swdp.nw_plan picked.  No PyTorch call computes this DP
    (library: none).  Returns the first row with both under "shapes"."""
    rows = [_nw_row(dev, _nw_batch(91), "phase-3 batch"),
            _nw_row(dev, nw_dag_inputs()[0], "DAG loop")]
    return dict(rows[0], shapes=rows)


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


def ecoli_reads(fa):
    """Simulate the E. coli-sized reads (GENOME_LEN at COVERAGE, 13% error,
    fixed seeds) into the FASTA fa."""
    import numpy as np

    from smartdenovo_tpu_torch.utils.simulate import (random_genome, simulate_reads,
                                                write_sim_fasta)

    t0 = time.perf_counter()
    rng = np.random.default_rng(46_000_000)
    genome = random_genome(rng, GENOME_LEN)
    names, seqs = simulate_reads(genome, coverage=COVERAGE, mean_len=9500,
                                 err=0.13, seed=18_460, circular=True)
    write_sim_fasta(fa, names, seqs)
    say(f"asm input: {len(seqs)} reads, {sum(len(s) for s in seqs)} bases "
        f"from a {GENOME_LEN} bp genome at {COVERAGE}x, simulated in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_asm(tmp):
    import torch

    from smartdenovo_tpu_torch import cli
    from smartdenovo_tpu_torch.kernels import _build

    fa = os.path.join(tmp, "ecoli_reads.fa")
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


# ---------------------------------------------------------------------------
# phase 8: the zmo (SW) engine
# ---------------------------------------------------------------------------

# tests/test_zmo_goldens.py's protocol: its subset and its bars
ZMO_SUB = 60
ZMO_BARS = dict(recall=0.95, precision=0.85, gbo_coverage=0.5)


def _pairs_of(path, nameset=None):
    pairs = set()
    with open(path) as fh:
        for line in fh:
            c = line.split("\t")
            if len(c) > 11:
                p = frozenset((c[0], c[5]))
                if nameset is None or p <= nameset:
                    pairs.add(p)
    return pairs


def phase_zmo(tmp, dev="cuda"):
    """(a) `asm -e zmo -c 0` through the CLI on phase 5's E. coli reads
    (batch_q 16 and the zmo flags' widths: band 256, 500 candidates, 64
    chains a query); (b) the golden protocol of tests/test_zmo_goldens.py
    on the card; (c) cuda against cpu on a small simulation: `zmo -e sw
    -n` records, wtgbo's rescue and wtext.  Returns the launches of (a),
    read with the counts set to 0 just before it."""
    launches = zmo_asm(tmp, dev)
    zmo_golden(dev)
    zmo_against_cpu(dev)
    return launches


def zmo_asm(tmp, dev):
    import torch

    from smartdenovo_tpu_torch.kernels import _build

    fa = os.path.join(tmp, "ecoli_reads.fa")
    prefix = os.path.join(tmp, "ecoli")
    on_card = dev != "cpu"
    _build.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    log, wall = _run_cli(["asm", fa, "-p", prefix, "-e", "zmo",
                          "--batch-q", "16", "--device", dev])
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    stages = {m[0]: float(m[1])
              for m in re.findall(r"stage (\w+): ([0-9.]+)s", log)}
    cands = re.findall(r"wtgbo iter \d+: (\d+) rescue candidates", log)
    news = re.findall(r"wtgbo iter \d+: (\d+) new overlaps", log)
    with open(prefix + ".zmo.ovl") as fh:
        n_ovl = sum(1 for _ in fh)
    with open(prefix + ".zmo.lay.utg") as fh:
        lens = sorted((int(m) for m in re.findall(r"^>\S+ length=(\d+)",
                                                  fh.read(), re.M)),
                      reverse=True)
    say(f"zmo asm stages (s): {json.dumps(stages)}; wall {wall:.1f} s")
    say(f"zmo asm overlaps: {n_ovl} in .zmo.ovl; wtgbo rounds: rescue "
        f"candidates {[int(x) for x in cands]}, new overlaps "
        f"{[int(x) for x in news]}")
    say(f"zmo asm unitigs: {len(lens)}, total {sum(lens)} bp, largest "
        f"{lens[0] if lens else 0} bp; genome {GENOME_LEN} bp")
    say(f"zmo asm launches: {json.dumps(launches)}; peak device memory "
        f"{peak} bytes")
    if n_ovl == 0 or not lens:
        raise AssertionError("zmo asm produced no overlaps or no unitigs")
    missing = [k for k in ("sseg", "swlocal", "banded") if launches[k] == 0]
    if on_card and missing:
        raise AssertionError(f"zmo path did not launch {missing}")
    return launches


def zmo_golden(dev):
    """tests/test_zmo_goldens.py's protocol on `dev`."""
    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.graph.gbo import GboParams, rescue_overlaps
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_reads

    full = ReadBank.from_fasta(os.path.join(GOLD, "smoke.fa"))
    names = full.names[:ZMO_SUB]
    rb = ReadBank(names, [full.get(i).copy() for i in range(ZMO_SUB)])
    t0 = time.perf_counter()
    ovls = overlap_reads(rb, ZmoParams.zmo(), progress=False, device=dev)
    resc = rescue_overlaps(rb, ovls, GboParams(), device=dev)
    t1 = time.perf_counter()
    nameset = set(names)

    def pairs(bank, recs):
        return {frozenset((bank.names[o.rid1], bank.names[o.rid2]))
                for o in recs}

    ours = pairs(rb, ovls)
    ref = _pairs_of(os.path.join(GOLD, "smoke.zmo.ref.ovl"), nameset)
    ref_gbo = _pairs_of(os.path.join(GOLD, "smoke.zmo.ref.gbo"), nameset)
    got = {"recall": len(ours & ref) / max(1, len(ref)),
           "precision": len(ours & ref) / max(1, len(ours))}
    if ref_gbo:   # the test skips its gbo bar when the reference has none
        got["gbo_coverage"] = (len((ours | pairs(rb, resc)) & ref_gbo)
                               / len(ref_gbo))
    ovf = overlap_reads(full, ZmoParams.zmo(), progress=False, device=dev)
    allf = pairs(full, ovf)
    ref_all = _pairs_of(os.path.join(GOLD, "smoke.zmo.ref.ovl"))
    say(f"zmo golden first {ZMO_SUB} reads of smoke.fa: {len(ovls)} "
        f"overlaps ({len(ref)} reference pairs), {len(resc)} rescued "
        f"({len(ref_gbo)} reference gbo pairs), {t1 - t0:.1f} s; "
        + ", ".join(f"{k} {v:.4f} (bar {ZMO_BARS[k]})" for k, v in got.items())
        + f"; all {len(full)} reads: {len(ovf)} overlaps, recall "
        f"{len(allf & ref_all) / max(1, len(ref_all)):.4f}, precision "
        f"{len(allf & ref_all) / max(1, len(allf)):.4f} ({len(ref_all)} "
        f"reference pairs)")
    short = [k for k, v in got.items() if v < ZMO_BARS[k]]
    if short:
        raise AssertionError(f"zmo golden below its bars: {short}")


def zmo_against_cpu(dev):
    """`zmo -e sw -n` records, wtgbo's rescue and wtext on `dev` and on the
    CPU: equal, with swlocal, refine and banded launched on the card."""
    import dataclasses

    import numpy as np

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.graph.gbo import GboParams, rescue_overlaps
    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline.ext import ExtParams, run_ext
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_reads
    from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(7)
    g = random_genome(rng, 8000)
    names, seqs = simulate_reads(g, coverage=6, mean_len=1200, err=0.13,
                                 seed=8, min_len=600)
    rb = ReadBank(names, [s[:2000] for s in seqs])
    p = ZmoParams.zmo(batch_q=4, ncand=16, align_cap=8, band_w=64,
                      refine=True)
    gp = GboParams(batch_q=4, cand_cap=8, band_w=64)
    ep = ExtParams(band_w=64)
    out, walls = {}, {}
    n0 = dict(_build.LAUNCHES)
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        o = overlap_reads(rb, p, progress=False, device=d)
        kept = [x for k, x in enumerate(o) if k % 3]
        r = rescue_overlaps(rb, kept, gp, device=d)
        shrunk = [dataclasses.replace(
            x, beg1=x.beg1 + 200, end1=x.end1 - 200, beg2=x.beg2 + 200,
            end2=x.end2 - 200,
            cigar=f"{max(x.end1 - x.beg1, x.end2 - x.beg2) - 400}M")
            for x in o[:20] if min(x.end1 - x.beg1, x.end2 - x.beg2) > 600]
        e = run_ext(rb, shrunk, params=ep, device=d)
        out[d] = (o, r, e)
        walls[d] = time.perf_counter() - t0
        if d == dev:
            n1 = {k: _build.LAUNCHES[k] - n0[k] for k in n0}
    if out[dev] != out["cpu"] or not all(out[dev]):
        raise AssertionError("zmo -e sw -n / wtgbo / wtext: cuda and cpu "
                             "differ, or one is empty")
    say(f"zmo -e sw -n, wtgbo, wtext on {len(rb)} reads: "
        f"{[len(x) for x in out[dev]]} records equal on {dev} and cpu; "
        f"{dev} {walls[dev]:.1f} s, cpu {walls['cpu']:.1f} s; launches "
        f"{json.dumps(n1)}")
    if dev != "cpu" and not (n1["swlocal"] and n1["refine"] and n1["banded"]):
        raise AssertionError(f"(c) did not launch swlocal, refine, banded: {n1}")


# ---------------------------------------------------------------------------
# phase 9: the side tools
# ---------------------------------------------------------------------------

# planted palindromes: (arm offset s, mirrored); the fold of arm + rc(arm[s:])
# is at len(arm), of its reverse complement at len(arm) - s; the first four
# are short (the cpu side of (b) runs them)
CYC_PLANTS = [(0, False), (150, True), (37, False), (799, True),
              (0, False), (0, True), (12, False), (90, True), (250, False),
              (400, True), (555, False), (700, True), (799, False),
              (333, True), (60, False), (5, True)]


def _write_fa(path, names, seqs):
    from smartdenovo_tpu_torch.utils.simulate import write_sim_fasta

    write_sim_fasta(path, names, seqs)
    return path


def _stdout_cli(argv):
    """cli.main(argv) with its standard output captured; returns (stdout,
    log, wall s)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        log, wall = _run_cli(argv)
    return buf.getvalue(), log, wall


def phase_tools(tmp, dev="cuda"):
    """(a) `cyc` through the CLI on phase 5's E. coli reads with 16 of them
    replaced by seeded palindromes, every one cut at its fold and every
    other read whole; (b) cyc, pairaln, dif, dotplot, mer and
    join_fragments_dag on `dev` and on the CPU, equal; (c) `mer` through
    the CLI on the E. coli reads and `idx` on the first IDX_READS of them,
    the snapshot read back equal to the build.  Returns the launches of (a), read with the counts set to 0
    just before it."""
    t0 = time.perf_counter()
    launches, cut = tools_cyc(tmp, dev)
    t1 = time.perf_counter()
    tools_against_cpu(tmp, cut, dev)
    t2 = time.perf_counter()
    tools_mer_idx(tmp, dev)
    say(f"tools phase times (s): cyc {t1 - t0:.1f}, cuda vs cpu "
        f"{t2 - t1:.1f}, mer and idx {time.perf_counter() - t2:.1f}")
    return launches


def tools_cyc(tmp, dev):
    import numpy as np

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.kernels import _build

    rb = ReadBank.from_fasta([os.path.join(tmp, "ecoli_reads.fa")], sort=False)
    names = list(rb.names)
    seqs = [rb.get(i) for i in range(len(rb))]
    rng = np.random.default_rng(9009)
    picks = rng.choice(len(rb), len(CYC_PLANTS), replace=False)
    expect = {}
    for k, (rid, (s, mirror)) in enumerate(zip(picks, CYC_PLANTS)):
        ln = int(rng.integers(1200, 2600)) if k < 4 else len(seqs[rid])
        arm = rng.integers(0, 4, (ln + s) // 2).astype(np.uint8)
        pal = np.concatenate([arm, 3 - arm[s:][::-1]]).astype(np.uint8)
        fold = len(arm)
        if mirror:
            pal, fold = (3 - pal[::-1]).astype(np.uint8), len(arm) - s
        seqs[rid] = pal
        L = len(pal)   # the JAX rule: keep the longer side of the fold
        expect[names[rid]] = ((fold, L - fold, L) if fold < L // 2
                              else (0, fold, L))
    fa = _write_fa(os.path.join(tmp, "ecoli_cyc.fa"), names, seqs)
    out = os.path.join(tmp, "ecoli.cyc")
    # swwide's launches timed between CUDA events on the wrapper's stream
    lib = _build.lib() if dev != "cpu" else None
    real, events = (lib.swwide_dp if lib else None), []

    def timed(*args):
        import torch

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        err = real(*args)
        ev[1].record()
        events.append(ev)
        return err

    _build.reset_launches()
    if lib:
        lib.swwide_dp = timed
    try:
        _log, wall = _run_cli(["cyc", fa, "-o", out, "--device", dev])
    finally:
        if lib:
            lib.swwide_dp = real
    launches = dict(_build.LAUNCHES)
    sw_ms = sum(a.elapsed_time(b) for a, b in events)
    recs = {}
    with open(out) as fh:
        for line in fh:
            c = line.rstrip("\n").split("\t")
            recs[c[0]] = tuple(int(v) for v in c[1:])
    bad = [(n, recs.get(n), e) for n, e in expect.items() if recs.get(n) != e]
    cut = [(n, r) for n, r in recs.items()
           if n not in expect and r != (0, r[2], r[2])]
    say(f"tools cyc on {len(recs)} E. coli reads ({sum(len(s) for s in seqs)} "
        f"bases, {len(expect)} planted palindromes): {wall:.1f} s, of it "
        f"{len(events)} swwide launches {sw_ms:.1f} ms (CUDA events); planted "
        f"records {sorted(expect.values())[:4]}...; other reads cut: "
        f"{cut[:5]}; launches {json.dumps(launches)}")
    if len(recs) != len(names) or bad or cut:
        raise AssertionError(f"cyc records: planted wrong {bad}, others cut "
                             f"{cut[:5]}")
    if dev != "cpu" and not launches["swwide"]:
        raise AssertionError("cyc did not launch swwide")
    # (b)'s 24-read cut: the four short palindromes and the 20 shortest
    # other reads
    short = [i for i in np.argsort([len(s) for s in seqs], kind="stable")
             if names[i] not in expect][:20]
    keep = sorted(list(picks[:4]) + short)
    cutfa = _write_fa(os.path.join(tmp, "cyc_cut.fa"),
                      [names[i] for i in keep], [seqs[i] for i in keep])
    return launches, cutfa


def _gap_fill_case():
    """tests/test_corr.py's join_fragments_dag scenario, from the port's
    copy of the simulator: (bank, fragments, overlaps)."""
    import numpy as np

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.pipeline.zmo import Overlap
    from smartdenovo_tpu_torch.utils.simulate import mutate_read, random_genome

    rng = np.random.default_rng(64)
    truth = random_genome(rng, 9000)[2000:7000]
    mid0, mid1 = 2200, 2800
    p1 = mutate_read(rng, truth[:mid0], 0.13)
    pg = mutate_read(rng, truth[mid0:mid1], 0.13)
    p2 = mutate_read(rng, truth[mid1:], 0.13)
    parent = np.concatenate([p1, pg, p2])
    names, seqs, ovls = ["P"], [parent], []
    for j in range(8):
        sup = mutate_read(rng, truth, 0.13)
        names.append(f"S{j}")
        seqs.append(sup)
        ovls.append(Overlap(rid1=0, dir1=0, beg1=0, end1=len(parent),
                            rid2=j + 1, dir2=0, beg2=0, end2=len(sup),
                            score=1000, identity=0.8, mat=1000, mis=0, ins=0,
                            dl=0, aln=len(parent)))
    frags = [("P", truth[:mid0].copy(), 0, len(p1)),
             ("P", truth[mid1:].copy(), len(p1) + len(pg), len(parent))]
    return ReadBank(names, seqs, sort=False), frags, ovls


def tools_against_cpu(tmp, cyc_fa, dev):
    """cyc on (a)'s 24-read cut, pairaln on 64 consecutive pairs of
    overlapping E. coli reads (of 4 kb or less, by simulated start), dif on
    32 seeded reads of one 12 kb locus against the first, dotplot on two
    overlapping reads, mer on 500 reads and join_fragments_dag on the gap
    fill of tests/test_corr.py: the same bytes (codes) on `dev` and on the
    CPU; swwide, swlocal, banded and segdp launched on the card."""
    import numpy as np

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline.corr import join_fragments_dag
    from smartdenovo_tpu_torch.utils.simulate import mutate_read, random_genome

    rb = ReadBank.from_fasta([os.path.join(tmp, "ecoli_reads.fa")], sort=False)
    pos = sorted((int(n.split("_")[1]), i) for i, n in enumerate(rb.names)
                 if rb.lengths[i] <= 4000)
    pairs = [(i, j) for (s0, i), (s1, j) in zip(pos, pos[1:])
             if s1 - s0 < rb.lengths[i] - 500][:64]
    pfa = _write_fa(os.path.join(tmp, "pairs.fa"),
                    [rb.names[k] for p in pairs for k in p],
                    [rb.get(k) for p in pairs for k in p])
    dfa = _write_fa(os.path.join(tmp, "dot.fa"),
                    [rb.names[k] for k in pairs[0]],
                    [rb.get(k) for k in pairs[0]])
    rng = np.random.default_rng(1212)
    locus = random_genome(rng, 12000)
    difa = _write_fa(os.path.join(tmp, "dif.fa"), [f"d{k}" for k in range(32)],
                     [mutate_read(rng, locus, 0.13) for _ in range(32)])
    n_mer = min(500, len(rb))
    mfa = _write_fa(os.path.join(tmp, "mer500.fa"), rb.names[:n_mer],
                    [rb.get(k) for k in range(n_mer)])
    gap = _gap_fill_case()
    outs, walls = {}, {}
    for d in (dev, "cpu"):
        n0 = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        o = {}
        _run_cli(["cyc", cyc_fa, "-o", os.path.join(tmp, f"cut.{d}.cyc"),
                  "--device", d])
        with open(os.path.join(tmp, f"cut.{d}.cyc")) as fh:
            o["cyc"] = fh.read()
        o["pairaln"] = _stdout_cli(["pairaln", pfa, "--device", d])[0]
        o["dif"] = _stdout_cli(["dif", difa, "--device", d])[0]
        pfx = os.path.join(tmp, f"dot.{d}")
        _run_cli(["dotplot", dfa, "-o", pfx, "--device", d])
        for ext in ("fwd", "rev"):
            with open(f"{pfx}.{ext}.txt") as fh:
                o["dotplot." + ext] = fh.read()
        o["mer"] = _stdout_cli(["mer", mfa, "--device", d])[0]
        o["jnt"] = [c.tobytes() for _, c in
                    join_fragments_dag(*gap, min_support=2, device=d)]
        outs[d] = o
        walls[d] = time.perf_counter() - t0
        if d == dev:
            n1 = {k: _build.LAUNCHES[k] - n0[k] for k in n0}
    differ = [k for k in outs[dev] if outs[dev][k] != outs["cpu"][k]]
    empty = [k for k in outs[dev] if not outs[dev][k]]
    say(f"tools cuda vs cpu: {', '.join(f'{k} {len(v)}' for k, v in outs[dev].items())} "
        f"(bytes; jnt: reads) equal on {dev} and cpu except {differ}; {dev} "
        f"{walls[dev]:.1f} s, cpu {walls['cpu']:.1f} s; launches {json.dumps(n1)}")
    if differ or empty:
        raise AssertionError(f"tools: {dev} and cpu differ in {differ}, empty "
                             f"{empty}")
    if dev != "cpu" and not all(n1[k] for k in ("swwide", "swlocal", "banded",
                                                "segdp")):
        raise AssertionError(f"(b) did not launch swwide, swlocal, banded and "
                             f"segdp: {n1}")


def tools_mer_idx(tmp, dev):
    """`mer` through the CLI on the E. coli reads and `idx` on the first
    IDX_READS of them; the in-memory indexes that idx saves are caught on
    their way to save_indexes, and load_indexes of the snapshot must give
    them back, array by array and dtype by dtype."""
    import torch

    from smartdenovo_tpu_torch.pipeline import idx

    fa = os.path.join(tmp, "ecoli_reads.fa")
    hist, _log, mwall = _stdout_cli(["mer", fa, "--device", dev])
    rows = [tuple(int(v) for v in r.split("\t")) for r in hist.splitlines()]
    caught = []
    save = idx.save_indexes

    def keep(path, kidx, zidx):
        caught.append((kidx, zidx))
        save(path, kidx, zidx)

    cut = os.path.join(tmp, "ecoli_idx_cut.fa")
    with open(cut, "w") as fh:
        fh.write("".join(f">{n}\n{q}\n" for n, q in
                         list(read_fasta(fa).items())[:IDX_READS]))
    npz = os.path.join(tmp, "ecoli.idx.npz")
    idx.save_indexes = keep
    try:
        _log, iwall = _run_cli(["idx", cut, "-o", npz, "--device", dev])
    finally:
        idx.save_indexes = save
    t0 = time.perf_counter()
    k2, z2 = idx.load_indexes(npz, device=dev)
    lwall = time.perf_counter() - t0
    (kidx, zidx), = caught
    diff = []
    for a, b, fields in ((k2, kidx, ("kmers", "post_rd", "post_dir")),
                         (z2, zidx, ("zmers", "post_rd", "post_dir", "post_off",
                                     "post_span", "post_packed"))):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype != y.dtype or x.device != y.device or not torch.equal(x, y):
                diff.append(f)
    meta = ((k2.max_freq, k2.ksize, k2.n_reads, z2.zsize, z2.max_per_read)
            == (kidx.max_freq, kidx.ksize, kidx.n_reads, zidx.zsize,
                zidx.max_per_read))
    say(f"tools mer on the E. coli reads: {mwall:.1f} s, {len(rows)} depths, "
        f"{sum(c for _, c in rows)} distinct k-mers, most at depth "
        f"{max(rows, key=lambda r: r[1])[0]}; idx on {kidx.n_reads} of the "
        f"reads: {iwall:.1f} s "
        f"({kidx.n_postings} k-mer and {zidx.zmers.numel()} z-mer postings, "
        f"{os.path.getsize(npz)} bytes), load_indexes {lwall:.1f} s, "
        f"{'equal' if not diff and meta else f'differs in {diff}'}")
    if diff or not meta or not rows:
        raise AssertionError(f"idx snapshot differs from the build: {diff}")


# ---------------------------------------------------------------------------
# phase 10: the read-block-partitioned overlapper
# ---------------------------------------------------------------------------

GCUT_LEN = 250_000   # bp genome of phase 10 (a)'s depth cut


def phase_partitioned(tmp, dev="cuda"):
    """(a) `zmo -G 2` through the CLI on phase 5's E. coli reads, then on
    the depth cut, beside `-G 1`; (b) `-G 2` on a small bank on `dev` and
    on the CPU; (c) the sharded driver: two gloo ranks sharing the card
    against the same world on the CPU, a world of one over nccl against
    overlap_dmo; (d) graft_entry's forward on `dev` and on the CPU.
    Returns the launches of (a)'s `-G 2` run on the cut, read with the
    counts set to 0 just before it."""
    t0 = time.perf_counter()
    launches = gparts_ecoli(tmp, dev)
    t1 = time.perf_counter()
    gparts_against_cpu(dev)
    t2 = time.perf_counter()
    sharded_against_cpu(dev)
    t3 = time.perf_counter()
    entry_against_cpu(dev)
    say(f"partitioned phase times (s): -G on E. coli {t1 - t0:.1f}, -G cuda "
        f"vs cpu {t2 - t1:.1f}, sharded {t3 - t2:.1f}, entry "
        f"{time.perf_counter() - t3:.1f}")
    return launches


def _zmo_g(fa, out, G, dev):
    """`zmo -G G --batch-q 64` through the CLI with the default dmo flags:
    (log, wall s, peak device bytes, launches, the error it raised or
    None)."""
    import torch

    from smartdenovo_tpu_torch import cli
    from smartdenovo_tpu_torch.kernels import _build

    _build.reset_launches()
    on_card = dev != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    err = None
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        try:
            rc = cli.main(["zmo", "-i", fa, "-o", out, "-G", str(G),
                           "--batch-q", "64", "--device", dev])
        except RuntimeError as e:
            err, rc = str(e), 0
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"zmo -G {G} exited {rc}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    return buf.getvalue(), wall, peak, dict(_build.LAUNCHES), err


def _ovl_pairs(path):
    with open(path) as fh:
        return {frozenset((c[0], c[5])) for c in
                (line.split("\t") for line in fh) if len(c) > 11}


def gparts_ecoli(tmp, dev):
    """`zmo -G 2` and `-G 1` on the E. coli reads and on the depth cut
    (the E. coli simulation's settings on a GCUT_LEN genome): wall, stage
    times, redispatches, K1 launches, peak device memory and the pair-set
    Jaccard of -G 2 against -G 1.  At full size the sweep's expansion of a
    batch against a part is far past expand_budget_cap, and -G 2 must
    raise there rather than drop matches."""
    import numpy as np

    from smartdenovo_tpu_torch.utils.simulate import (random_genome,
                                                      simulate_reads,
                                                      write_sim_fasta)

    fa = os.path.join(tmp, "ecoli_reads.fa")
    rng = np.random.default_rng(46_000_000)
    names, seqs = simulate_reads(random_genome(rng, GCUT_LEN),
                                 coverage=COVERAGE, mean_len=9500, err=0.13,
                                 seed=18_460, circular=True)
    cut = os.path.join(tmp, "gcut_reads.fa")
    write_sim_fasta(cut, names, seqs)
    got = {}
    for tag, path in (("E. coli", fa), ("cut", cut)):
        runs = {G: _zmo_g(path, os.path.join(tmp, f"g{G}.ovl"), G, dev)
                for G in (2, 1)}
        log2, wall2, peak2, launches2, err = runs[2]
        stages = {m[0]: float(m[1])
                  for m in re.findall(r"stage (\w+): ([0-9.]+)s", log2)}
        nred = re.findall(r"gpass: (\d+) redispatches", log2)
        if err is not None:
            if tag != "E. coli" or "exceeds the memory cap" not in err:
                raise AssertionError(f"zmo -G 2 on {tag} raised: {err}")
            say(f"-G 2 on {tag} ({_n_reads(path)} reads): raised "
                f"after {wall2:.1f} s, stages so far {json.dumps(stages)}, "
                f"K1 launches {launches2['sseg']}, peak device memory "
                f"{peak2} bytes: {err}; -G 1: wall {runs[1][1]:.1f} s, "
                f"peak {runs[1][2]} bytes")
            continue
        p2 = _ovl_pairs(os.path.join(tmp, "g2.ovl"))
        p1 = _ovl_pairs(os.path.join(tmp, "g1.ovl"))
        jac = len(p1 & p2) / max(1, len(p1 | p2))
        got[tag] = launches2
        say(f"-G 2 on {tag} ({_n_reads(path)} reads): wall "
            f"{wall2:.1f} s, stages {json.dumps(stages)}, redispatches "
            f"{nred[0] if nred else '?'}, K1 launches {launches2['sseg']}, "
            f"peak device memory {peak2} bytes; -G 1: wall "
            f"{runs[1][1]:.1f} s, peak {runs[1][2]} bytes; pairs {len(p2)} "
            f"vs {len(p1)}, Jaccard {jac:.4f} (bar 0.97, "
            f"tests/test_overlap_dmo.py)")
        if jac < 0.97 or not p2:
            raise AssertionError(f"-G 2 on {tag}: Jaccard {jac:.4f}")
        if dev != "cpu" and launches2["sseg"] == 0:
            raise AssertionError("-G 2 did not launch K1")
    return got["cut"]


def _n_reads(path):
    with open(path) as fh:
        return sum(1 for line in fh if line.startswith(">"))


def bank30k():
    """The 30 kb / 10x bank of tests/test_torch_overlap_asm.py."""
    import numpy as np

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(11)
    return ReadBank(*simulate_reads(random_genome(rng, 30000), coverage=10,
                                    mean_len=5000, err=0.13, seed=12))


def gparts_against_cpu(dev):
    """-G 2 on the 30 kb bank of tests/test_torch_overlap_asm.py, on `dev`
    and on the CPU: equal records."""
    import dataclasses

    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    rb = bank30k()
    p = ZmoParams.dmo(batch_q=8, ncand=64, gparts=2)
    out, walls = {}, {}
    n0 = _build.LAUNCHES["sseg"]
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        out[d] = [dataclasses.astuple(o)
                  for o in overlap_dmo(rb, p, progress=False, device=d)]
        walls[d] = time.perf_counter() - t0
        if d == dev:
            k1 = _build.LAUNCHES["sseg"] - n0
    if out[dev] != out["cpu"] or not out[dev]:
        raise AssertionError("-G 2: cuda and cpu differ, or found nothing")
    say(f"-G 2 on {len(rb)} reads: {len(out[dev])} records equal on {dev} "
        f"and cpu; {dev} {walls[dev]:.1f} s (K1 {k1}), cpu "
        f"{walls['cpu']:.1f} s")


def _gloo_cuda_probe():
    """Whether this build's gloo takes CUDA tensors in all_gather and
    all_reduce (run in each rank of a local world)."""
    import torch
    import torch.distributed as dist

    t = torch.full((4,), dist.get_rank() + 1, device="cuda:0")
    try:
        out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(out, t)
        dist.all_reduce(t)
        return (f"yes (all_gather {[int(o[0]) for o in out]}, all_reduce "
                f"{int(t[0])})")
    except (RuntimeError, ValueError) as e:
        return f"no ({type(e).__name__}: {str(e).splitlines()[0][:120]})"


def sharded_against_cpu(dev):
    """The sharded driver on the dry run's 60 kb sim: two gloo ranks on
    `dev` against the same world on the CPU, and a world of one over nccl
    against overlap_dmo on `dev`."""
    import dataclasses

    from smartdenovo_tpu_torch import graft_entry
    from smartdenovo_tpu_torch.parallel.multihost import run_local_world
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    probe = run_local_world(_gloo_cuda_probe, 2, "gloo")
    say(f"gloo with CUDA tensors (all_gather, all_reduce): {probe[0]}")
    out, walls = {}, {}
    for key, args in (("gloo2 " + dev, (2, "gloo", dev)),
                      ("gloo2 cpu", (2, "gloo", "cpu")),
                      ("nccl1 cuda", (1, "nccl", "cuda"))):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out[key] = graft_entry.dryrun_multichip(*args)
        walls[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = [dataclasses.astuple(o) for o in overlap_dmo(
        graft_entry.sim_bank(), ZmoParams.dmo(ncand=64, batch_q=2),
        progress=False, device=dev)]
    walls["overlap_dmo"] = time.perf_counter() - t0
    say("sharded on the 60 kb sim: " + ", ".join(
        f"{k} {len(v)} records {walls[k]:.1f} s" for k, v in out.items())
        + f", overlap_dmo {len(one)} records {walls['overlap_dmo']:.1f} s")
    if out["gloo2 " + dev] != out["gloo2 cpu"]:
        raise AssertionError("sharded: gloo ranks on the card and on the "
                             "CPU differ")
    if out["nccl1 cuda"] != one:
        raise AssertionError("sharded: a world of one over nccl differs from "
                             "overlap_dmo")


def entry_against_cpu(dev):
    """graft_entry.entry()'s forward on `dev` and on the CPU: the 8
    outputs equal."""
    from smartdenovo_tpu_torch import graft_entry

    outs = {}
    for d in (dev, "cpu"):
        fn, args = graft_entry.entry(device=d)
        outs[d] = [o.cpu() for o in fn(*args)]
    same = [bool((a == b).all()) and a.shape == b.shape
            for a, b in zip(outs[dev], outs["cpu"])]
    say(f"graft_entry forward: 8 outputs, equal on {dev} and cpu: {same}")
    if not all(same) or len(same) != 8:
        raise AssertionError("graft_entry forward differs on cuda and cpu")


# ---------------------------------------------------------------------------
# phase 11: the vtab matcher and the global NW DP
# ---------------------------------------------------------------------------

VTAB_P = 1 << 25     # the vt start packing's limit on the z-mer index width
NW_DAG_L = 2048      # phase 11 (c)'s window width


def phase_vtab(fa, dev="cuda", profile=False):
    """(a) overlap_dmo(matcher="vtab") on the E. coli reads (it must raise
    at the 2^25 index width) and on their longest prefix under it, beside
    matcher="auto", and with `profile` the vtab run once more under
    torch.profiler (~90 s with the profiler's own work, so only `--only
    vtab` asks for it); (b) the vtab on `dev` and on the CPU, dm and sw
    engines; (c) the consensus loop of tests/test_dagcns.py through
    batch_global_align at L NW_DAG_L.  Returns the launches of (a)'s vtab
    run on the cut and of (c), each read with the counts set to 0 just
    before it."""
    t0 = time.perf_counter()
    launches = vtab_ecoli(fa, dev, profile)
    t1 = time.perf_counter()
    vtab_against_cpu(dev)
    t2 = time.perf_counter()
    launches["nwglobal"] = nw_dag_loop(dev)
    say(f"vtab phase times (s): E. coli {t1 - t0:.1f}, cuda vs cpu "
        f"{t2 - t1:.1f}, DAG loop {time.perf_counter() - t2:.1f}")
    return launches


def _index_width(bases, n):
    """Tz, the z-mer index width overlap_dmo builds for n reads of this
    many bases (ops/flatseeds.py: the padded flat bank plus RM_BLK slots a
    read)."""
    from smartdenovo_tpu_torch.ops.flatseeds import RM_BLK, pad_pow2

    return pad_pow2(int(bases) + 1) + pad_pow2(n, lo=1 << 8) * RM_BLK


def _overlap_api(rb, matcher, dev):
    """overlap_dmo at the dmo defaults and --batch-q 64 with its log
    captured: (records, log, wall s, peak device bytes, launches, the
    assertion it raised or None)."""
    import torch

    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    recs, err = [], None
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        try:
            recs = overlap_dmo(rb, ZmoParams.dmo(batch_q=64, matcher=matcher),
                               device=dev)
        except AssertionError as e:
            err = str(e)
    torch.cuda.synchronize()
    return (recs, buf.getvalue(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(), dict(_build.LAUNCHES), err)


def vtab_ecoli(fa, dev, profile=False):
    """(a): the whole E. coli bank is past the vt packing (Tz >= 2^25) and
    must raise, as the JAX package does; the longest prefix of the reads
    (FASTA order, a depth cut) whose Tz stays under 2^25 runs with vtab and
    with auto: wall, stage split, redispatches, K1 launches (> 0), peak
    device memory, and the pair-set Jaccard of vtab against auto (bar
    0.99, tests/test_overlap_dmo.py)."""
    import numpy as np

    from smartdenovo_tpu_torch.data.readbank import ReadBank, seq_to_codes
    from smartdenovo_tpu_torch.io.fasta import read_seqs

    names, seqs = [], []
    for tag, _desc, seq in read_seqs([fa]):
        names.append(tag)
        seqs.append(seq_to_codes(seq))
    cum = np.cumsum([len(x) for x in seqs])
    tz_all = _index_width(cum[-1], len(seqs))
    recs, log, wall, peak, launches, err = _overlap_api(
        ReadBank(names, seqs), "vtab", dev)
    if err is None or "2^25" not in err:
        raise AssertionError(f"vtab on all {len(seqs)} E. coli reads (Tz "
                             f"{tz_all}) did not raise at 2^25: {err}")
    say(f"vtab on all {len(seqs)} E. coli reads ({cum[-1]} bases, Tz "
        f"{tz_all}): raised after {wall:.1f} s as the JAX package does: "
        f"{err}")
    k = len(seqs)
    while k and _index_width(cum[k - 1], k) >= VTAB_P:
        k -= 1
    rb = ReadBank(names[:k], seqs[:k])
    pairs, got = {}, {}
    for matcher in ("vtab", "auto"):
        recs, log, wall, peak, launches, err = _overlap_api(rb, matcher, dev)
        if err is not None:
            raise AssertionError(f"{matcher} on the cut raised: {err}")
        stages = {m[0]: float(m[1])
                  for m in re.findall(r"stage (\w+): ([0-9.]+)s", log)}
        nred = len(re.findall(r"budget overflow batch", log))
        pairs[matcher] = {(min(o.rid1, o.rid2), max(o.rid1, o.rid2))
                          for o in recs}
        got[matcher] = launches
        say(f"{matcher} on the E. coli cut ({k} reads, "
            f"{cum[k - 1]} bases, Tz {_index_width(cum[k - 1], k)}): "
            f"wall {wall:.1f} s, stages {json.dumps(stages)}, redispatches "
            f"{nred}, {len(recs)} overlaps, launches {json.dumps(launches)}, "
            f"peak device memory {peak} bytes")
    if profile:
        vtab_profile(rb, dev)
    a, v = pairs["auto"], pairs["vtab"]
    jac = len(a & v) / max(1, len(a | v))
    say(f"vtab against auto on the cut: pairs {len(v)} vs {len(a)}, "
        f"Jaccard {jac:.4f} (bar 0.99)")
    if jac < 0.99 or not v:
        raise AssertionError(f"vtab on the E. coli cut: Jaccard {jac:.4f}")
    if dev != "cpu" and got["vtab"]["sseg"] == 0:
        raise AssertionError("the vtab run did not launch K1")
    return {"sseg": got["vtab"]["sseg"]}


def vtab_profile(rb, dev, top=8):
    """The vtab run on the cut once more under torch.profiler: the device
    time summed over its kernels beside the wall (the card's busy share)
    and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        overlap_dmo(rb, ZmoParams.dmo(batch_q=64, matcher="vtab"),
                    progress=False, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # the device activities themselves (kernels, copies, sets): an aten
    # op's own row repeats the device time of the kernels it launched
    ev = [e for e in prof.key_averages()
          if dev_us(e) > 0 and not e.key.startswith("aten::")]
    busy = sum(dev_us(e) for e in ev) / 1e6
    ev.sort(key=dev_us, reverse=True)
    say(f"vtab on the cut under torch.profiler: device time {busy:.3f} s in "
        f"a wall of {wall:.1f} s (busy share {busy / wall:.3f}); most device "
        f"time: " + "; ".join(f"{e.key[:70]} {dev_us(e) / 1e3:.1f} ms "
                              f"({e.count} calls)" for e in ev[:top]))


def vtab_against_cpu(dev):
    """(b): matcher="vtab" on `dev` and on the CPU, equal records: the dm
    engine on the 30 kb bank of tests/test_torch_overlap_asm.py, the sw
    engine on the SW tests' 8 kb bank (tests/test_torch_cuda.py sw_bank,
    SW_PARAMS)."""
    import dataclasses

    import numpy as np

    from smartdenovo_tpu_torch.data.readbank import ReadBank
    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo
    from smartdenovo_tpu_torch.utils.simulate import random_genome, simulate_reads

    dm = bank30k()
    rng = np.random.default_rng(7)
    names, seqs = simulate_reads(random_genome(rng, 8000), coverage=6,
                                 mean_len=1200, err=0.13, seed=8, min_len=600)
    sw = ReadBank(names, [x[:2000] for x in seqs])
    for engine, rb, p in (
            ("dm", dm, ZmoParams.dmo(batch_q=8, ncand=64, matcher="vtab")),
            ("sw", sw, ZmoParams.zmo(matcher="vtab", batch_q=4, ncand=16,
                                     align_cap=8, band_w=64))):
        out, walls = {}, {}
        _build.reset_launches()
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            out[d] = [dataclasses.astuple(o)
                      for o in overlap_dmo(rb, p, progress=False, device=d)]
            walls[d] = time.perf_counter() - t0
            if d == dev:
                launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        if out[dev] != out["cpu"] or not out[dev]:
            raise AssertionError(f"vtab -e {engine}: cuda and cpu differ, or "
                                 f"found nothing")
        if dev != "cpu" and (not launches.get("sseg") or (
                engine == "sw" and not launches.get("swlocal"))):
            raise AssertionError(f"vtab -e {engine} launched {launches}")
        say(f"vtab -e {engine} on {len(rb)} reads: {len(out[dev])} records "
            f"equal on {dev} and cpu; {dev} {walls[dev]:.1f} s (launches "
            f"{json.dumps(launches)}), cpu {walls['cpu']:.1f} s")


def _dag_window(cns, reads, L):
    """batch_global_align's inputs of one DAG-loop iteration: the
    consensus against each read, in windows of L."""
    import numpy as np

    B = len(reads)
    a = np.full((B, L), 4, np.uint8)
    b = np.full((B, L), 4, np.uint8)
    alen = np.full(B, len(cns), np.int32)
    blen = np.array([len(r) for r in reads], np.int32)
    a[:, :len(cns)] = cns
    for i, r in enumerate(reads):
        b[i, :len(r)] = r
    return a, b, alen, blen


def nw_dag_inputs():
    """The DAG loop's data: a 2,000 bp truth, a backbone at 8% error and 24
    reads at 10% (seed 44, each cut at NW_DAG_L), and iteration 1's
    inputs.  Returns (inputs, truth, backbone, reads)."""
    import numpy as np

    from smartdenovo_tpu_torch.utils.simulate import mutate_read

    L = NW_DAG_L
    rng = np.random.default_rng(44)
    truth = rng.integers(0, 4, 2000).astype(np.uint8)
    backbone = mutate_read(rng, truth, 0.08)[:L]
    reads = [mutate_read(rng, truth, 0.10)[:L] for _ in range(24)]
    return _dag_window(backbone, reads, L), truth, backbone, reads


def nw_dag_loop(dev):
    """(c): tests/test_dagcns.py's consensus loop at a larger size
    (nw_dag_inputs), three iterations of batch_global_align on `dev`, the
    host traceback and the native DAG.  The first iteration's scores and
    plane must equal the plain version's on the same device tensors; the
    consensus identity must pass 0.97 and the backbone's.  Returns the
    nwglobal launches of the loop."""
    import torch

    from smartdenovo_tpu_torch.data.readbank import codes_to_seq
    from smartdenovo_tpu_torch.kernels import _build
    from smartdenovo_tpu_torch.ops import swdp
    from smartdenovo_tpu_torch.utils.native import DagCns

    L = NW_DAG_L
    (a, b, alen, blen), truth, backbone, reads = nw_dag_inputs()
    B = len(reads)
    cns = backbone
    _build.reset_launches()
    t0 = time.perf_counter()
    kernel_s = plain_s = 0.0
    for it in range(3):
        if it:
            a, b, alen, blen = _dag_window(cns, reads, L)
        x = [torch.from_numpy(v).to(dev) for v in (a, b, alen, blen)]
        tk = time.perf_counter()
        score, dd = swdp.batch_global_align(*x, max_len=L)
        dirs = dd.cpu()
        kernel_s += time.perf_counter() - tk
        if it == 0:
            tp = time.perf_counter()
            ps, pd = swdp.batch_global_align_plain(*x, max_len=L)
            same = torch.equal(score, ps) and torch.equal(dd, pd)
            plain_s = time.perf_counter() - tp
            if not same:
                raise AssertionError("nwglobal in the DAG loop differs from "
                                     f"the plain version on {dev}")
            del ps, pd
        del dd
        g = DagCns()
        g.set_backbone(cns)
        for i, (ops, counts) in enumerate(
                swdp.traceback_batch(dirs.numpy(), alen, blen)):
            a0, a1 = swdp.align_strings(a[i], b[i], ops, counts)
            g.add_alignment(0, int(alen[i]), a0, a1)
        g.merge_nodes()
        cns, _mp, _sc = g.consensus()
        if len(cns) > L:
            raise AssertionError(f"consensus of {len(cns)} bp past L {L}")
    launches = _build.LAUNCHES["nwglobal"]
    ident = identity(codes_to_seq(cns), codes_to_seq(truth))
    ident_bb = identity(codes_to_seq(backbone), codes_to_seq(truth))
    say(f"DAG loop through nwglobal (B {B}, L {L}, 3 iterations): "
        f"{time.perf_counter() - t0:.1f} s, of it the align calls with their "
        f"fetch {kernel_s:.2f} s; the plain version on {dev} (iteration "
        f"1) {plain_s:.1f} s, equal; consensus {len(cns)} bp, identity "
        f"{ident:.4f} (backbone {ident_bb:.4f}; bars 0.97 and the "
        f"backbone's); nwglobal launches {launches}")
    if not (ident > 0.97 and ident > ident_bb) or (dev != "cpu"
                                                   and launches != 3):
        raise AssertionError(f"DAG loop: identity {ident:.4f}, backbone "
                             f"{ident_bb:.4f}, launches {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="keep the work files (E. coli reads and stage files) "
                         "here instead of a temporary directory")
    ap.add_argument("--only", choices=["swlocal", "swwide", "nwglobal",
                                       "partitioned", "vtab"],
                    default=None,
                    help="run only this kernel's phase 3 check and timing, "
                         "or phase 10 (partitioned) or 11 (vtab) (no main "
                         "path, no closing result line)")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    with contextlib.ExitStack() as stack:
        tmp = args.workdir or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(tmp, exist_ok=True)
        fa = os.path.join(tmp, "ecoli_reads.fa")
        if args.only not in ("swlocal", "nwglobal"):
            ecoli_reads(fa)
        if args.only in ("partitioned", "vtab"):
            if args.only == "partitioned":
                phase_partitioned(tmp)
            else:
                phase_vtab(fa, profile=True)
            say(gpu_line())
            return 0
        if args.only:
            res = {"swlocal": lambda: phase_swlocal(dev),
                   "swwide": lambda: phase_swwide(dev, fa),
                   "nwglobal": lambda: phase_nwglobal(dev)}[args.only]()
            say(json.dumps({args.only: res}))
            say(gpu_line())
            return 0
        kres = phase_kernels(dev, fa)
        phase_join()
        launches = phase_asm(tmp)
        launches["segdp"], idents = phase_cns(tmp, CNS_CUT)
        launches.update(phase_wholeread(tmp, WR_CUT, idents))
        launches["swlocal"] = phase_zmo(tmp)["swlocal"]
        launches["swwide"] = phase_tools(tmp)["swwide"]
        phase_partitioned(tmp)
        launches["nwglobal"] = phase_vtab(fa)["nwglobal"]
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
                        "lax.scan, not Pallas)"),
           "swlocal": ("smartdenovo_tpu_torch/csrc/swlocal.cu",
                       "smartdenovo_tpu/ops/overlap_dp.py:48 (jax.jit "
                       "lax.scan, not Pallas)"),
           "swwide": ("smartdenovo_tpu_torch/csrc/swwide.cu",
                      "smartdenovo_tpu/ops/overlap_dp.py:48 (jax.jit "
                      "lax.scan, not Pallas), W outside swlocal's set; "
                      "pipeline/aln_tools.py:70 wtcyc W 1600"),
           "nwglobal": ("smartdenovo_tpu_torch/csrc/nwglobal.cu",
                        "smartdenovo_tpu/ops/swdp.py:32 (jax.jit lax.scan "
                        "at :88, not Pallas)")}
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k], **kres[k])
               for k in src]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"the main path did not launch {idle}")
    say(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(gpu_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
