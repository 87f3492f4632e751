"""Single-device -G multi-pass overlapper: index memory capping (port of
smartdenovo_tpu/parallel/gpass.py).

Reference wtzmo -G (wtzmo.c:1276-1303): when the posting index exceeds
memory, the reads are split into G blocks; each block is indexed in turn
and ALL queries run against the partial index, accumulating candidates;
alignment follows once every block has been seen.

Each pass holds only its block's k16/z10 posting index on the device
(~1/G of the full index); query seeds are extracted per batch from the
flat bank.  A candidate's coverage is computed entirely by the pass owning
it (read-block partition), so merging the per-pass top-A candidate lists
by coverage is exact, as is the positional combine of the per-pass chains
(parallel/sharded.py runs the same partition at once across ranks).
Frequency cutoffs are per pass, like the reference's per-iteration
index_wtzmo.

Budgets that a batch overflows are grown and the batch is run again
(where the JAX package warns and drops); past `expand_budget_cap` the run
raises.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..data.readbank import ReadBank
from ..ops.align import pad_tier
from ..ops.candidates import scan_candidates
from ..ops.dotmatrix import (build_query_occ_rows, dot_matrix_align,
                             extract_zmer_pairs_sweep_rows)
from ..ops.flatseeds import SENT_U32, build_bank_indexes, pad_pow2
from ..ops.seeds import extract_seeds, subsample_mask
from ..pipeline.zmo import (ZmoParams, _dm_emission, _emit_dm,
                             resolve_device)
from ..utils.log import log

I32 = torch.int32
INT32_MAX = 0x7FFFFFFF
# runs of one batch before a budget that still overflows raises
MAX_RUNS = 4


class Part(NamedTuple):
    """One read block's device indexes, read ids global."""

    k_kmers: torch.Tensor   # [T] int64 k16 codes, (kmer, rd) sorted
    k_rd: torch.Tensor      # [T] int32
    k_dir: torch.Tensor     # [T] int8
    rm_zsd: torch.Tensor    # [Tz] int32 zmer<<9|span<<1|dir, read-major
    rm_pk: torch.Tensor     # [Tz] int32 off<<9|span<<1|dir
    rm_rd: torch.Tensor     # [Tz] int32 (n past the live postings)
    rm_start: torch.Tensor  # [n+1] int32 global-read CSR (0-width rows for
                            #         reads of other blocks)
    stats: np.ndarray       # host stat pack (per-read blocks in local ids)


def build_part(rb: ReadBank, p: ZmoParams, lo: int, hi: int, dev,
               T: int | None = None):
    """Index reads [lo, hi) with the one-bank builder, at the global
    bank's Npad, and rebase the read ids to global ones.  T: the flat
    tier (default: the part's own).  Returns the Part and the part's k16
    seeds (parallel/sharded.py refilters them on global counts)."""
    n = len(rb)
    ptot = int(rb.offsets[hi] - rb.offsets[lo])
    pflat = np.full(T or pad_pow2(ptot + 1), 4, np.uint8)
    pflat[:ptot] = rb.bases[rb.offsets[lo]: rb.offsets[hi]]
    Npad = pad_pow2(n, lo=1 << 8)
    poffs = np.full(Npad + 1, ptot, np.int64)
    poffs[: hi - lo + 1] = rb.offsets[lo: hi + 1] - rb.offsets[lo]
    k16, _z10, didx = build_bank_indexes(
        torch.from_numpy(pflat).to(dev),
        torch.from_numpy(poffs.astype(np.int32)).to(dev),
        ksize=p.ksize, zsize=p.zsize, hz=p.hz, ksave=p.ksave,
        max_kmer_freq=p.max_kmer_freq, max_zmer_freq=p.max_zmer_freq,
        zbits=2 * p.zsize)
    live_k = didx.k_kmers != SENT_U32
    k_rd = torch.where(live_k, didx.k_rd + lo, didx.k_rd)
    st_l = didx.rm_start
    Ts = didx.rm_rd.shape[0]
    rm_rd = torch.where(torch.arange(Ts, device=dev) < st_l[hi - lo],
                        didx.rm_rd + lo, n)
    rm_start = torch.cat([
        torch.zeros(lo, dtype=I32, device=dev), st_l[: hi - lo + 1],
        st_l[hi - lo: hi - lo + 1].expand(max(0, n - hi))])
    return Part(didx.k_kmers, k_rd, didx.k_dir, didx.rm_zsd, didx.rm_pk,
                rm_rd, rm_start, didx.stats.cpu().numpy()), k16


def query_rows(flat, offs, rids, qlens, Ltier: int, n: int):
    """[Q, Ltier] uint8 bases of the batch's queries from the flat bank."""
    rr = rids.clamp(0, n - 1).long()
    lanes = torch.arange(Ltier, dtype=I32, device=rids.device)[None, :]
    pos = offs[rr][:, None] + lanes
    return torch.where(lanes < qlens[:, None],
                       flat[pos.clamp(0, flat.shape[0] - 1).long()],
                       torch.tensor(4, dtype=torch.uint8, device=rids.device))


def part_candidates(qb, rids, qlens, qskip, part: Part, read_lens,
                    p: ZmoParams, *, A: int, cbud: int, kq: int):
    """Pass 1 for one batch against one part: the part's top-A candidates,
    their coverage (-1 on empty slots) and the expansion and probe
    totals."""
    Q = rids.shape[0]
    dev = rids.device
    kres = extract_seeds(qb, qlens, p.ksize, p.hz)
    kvalid = kres["valid"] & subsample_mask(kres["kmer"], p.ksave)
    cands, ols, ct, pt = scan_candidates(
        kres["kmer"], kres["off"], kres["span"], kvalid, rids, qlens, qskip,
        part.k_kmers, part.k_rd, part.k_dir, read_lens,
        torch.zeros((Q, 0), dtype=I32, device=dev),
        torch.zeros(Q, dtype=I32, device=dev),
        budget=cbud, ncand=A, kovl=p.kovl, len_ratio=p.len_ratio,
        probe_budget=kq)
    return cands, torch.where(cands >= 0, ols, -1), ct, pt


def part_chains(qb, rids, qlens, qskip, csorted, part: Part, read_lens,
                p: ZmoParams, *, occ: int, cx: int, nbk: int):
    """Pass 2 for one batch against one part: the row-form sweep matcher,
    the dot matrix and the positional scatter.  Returns the [6, Q*A*2]
    pack (score, tb, te, qb, qe at each pair's position, then the match
    counts) and the totals (pairs, expansion, blocks, occurrences)."""
    n = read_lens.shape[0]
    Q, A = csorted.shape
    NP = Q * A * 2
    zres = extract_seeds(qb, qlens, p.zsize, p.hz)
    occ_t = build_query_occ_rows(
        zres["kmer"],
        (zres["off"] << 9) | (zres["span"].clamp(max=255) << 1)
        | zres["dir"].to(I32),
        zres["valid"] & ~qskip[:, None],
        occ_budget=occ, zbits=2 * p.zsize, max_per_read=p.max_zmer_freq)
    pairs = extract_zmer_pairs_sweep_rows(
        rids, csorted, occ_t, part.rm_zsd, part.rm_pk, part.rm_rd,
        part.rm_start, read_lens, cross_budget=cx, kvar=p.kvar,
        zbits=2 * p.zsize)
    clens = torch.where(csorted < n, read_lens[csorted.clamp(0, n - 1)], 0)
    res = dot_matrix_align(
        pairs, torch.repeat_interleave(qlens.to(I32), A * 2),
        torch.repeat_interleave(clens.to(I32).reshape(-1), 2),
        n_pairs=NP, nb=p.nb, xvar=p.xvar, yvar=p.yvar,
        min_block_len=p.min_block_len, max_overhang=p.max_overhang,
        deviation_penalty=p.deviation_penalty, gap_penalty=p.gap_penalty,
        nbk=nbk)
    # a pair has at most one row, so only the junk column NP takes several
    # values; max does not depend on their order
    rows = res.pair_id.clamp(max=NP).long()
    live = (res.pair_id < NP) & (res.score > 0)
    vals = torch.where(live[None],
                       torch.stack([res.score, res.tb, res.te, res.qb,
                                    res.qe]), 0)
    pos = torch.zeros((5, NP + 1), dtype=I32, device=rids.device)
    pos.scatter_reduce_(1, rows[None].expand(5, -1), vals, "amax")
    pack = torch.cat([pos[:, :NP], res.match_cnt[None]])
    totals = torch.stack([pairs.total, pairs.expand_total, res.blk_total,
                          occ_t[4]]).to(I32)
    return pack, totals


def grow(total: int, slack: int, cap: int, what: str) -> int:
    """A budget that fits `total`, at most `cap`; past the cap, raise."""
    if total > cap:
        raise RuntimeError(
            f"{what} {total} exceeds the memory cap {cap} (expand_budget_cap):"
            " lower batch_q or raise -G")
    return min(pad_pow2(total + slack), cap)


def overflowed(bud: dict, totals: dict, cap: int, Q: int) -> dict:
    """The budgets of `bud` that a batch's totals overflow, grown to fit
    (overlap_dmo's redispatch rules): the candidate and sweep expansions
    with 1024 of slack up to `cap` (past it, raise), the probe and
    occurrence widths with Q, the block width with 4096."""
    ov = {}
    for key, name, slack, what in (
            ("cbud", "cand", 1024, "candidate expansion"),
            ("kq", "probes", Q, None),
            ("cx", "sweep", 1024, "sweep expansion"),
            ("nbk", "blocks", 4096, None),
            ("occ", "occ", Q, None)):
        t = totals.get(name, 0)
        if key in bud and t > bud[key]:
            ov[key] = grow(t, slack, cap, what) if what else pad_pow2(t + slack)
    return ov


def chain_totals(t) -> dict:
    """part_chains' totals as `overflowed` reads them (without a pair
    budget the sweep's pairs are its expansion)."""
    return dict(sweep=max(int(t[0]), int(t[1])), blocks=int(t[2]),
                occ=int(t[3]))


def run_fitted(run, bud: dict, totals_of, cap: int, Q: int, what: str):
    """run(bud) for one batch until its totals fit `bud`, which grows in
    place (a grown budget stays for later batches).  Returns (the last
    output, the redispatches)."""
    out = run(bud)
    for k in range(MAX_RUNS):
        ov = overflowed(bud, totals_of(out), cap, Q)
        if not ov:
            return out, k
        if k == MAX_RUNS - 1:
            raise RuntimeError(f"{what}: budgets still overflow after "
                               f"{MAX_RUNS} runs")
        log("%s: budget overflow (%s): redispatch", what,
            " ".join(f"{b} {bud[b]}->{v}" for b, v in ov.items()))
        bud.update(ov)
        out = run(bud)


def _pass1_budgets(n_post: int, Q: int, Ltier: int, p: ZmoParams):
    """The JAX package's pass-1 widths: the expansion from the part's
    posting total, the probes from the batch's bases."""
    cbud = min(pad_pow2(n_post + (1 << 12), lo=1 << 14), p.expand_budget_cap)
    kq = pad_pow2(Q * Ltier // max(1, p.ksave), lo=1 << 12)
    return cbud, kq


def overlap_gparts(rb: ReadBank, params: ZmoParams | None = None,
                   progress: bool = True, parts: int = 1, part: int = 0, *,
                   device="cuda"):
    """Multi-pass (-G) all-vs-all overlap on `device`: only 1/G of the
    posting index is resident per pass.  Returns the same Overlap list as
    overlap_dmo (pair set exact modulo top-A coverage ties at the candidate
    cut and the per-pass frequency cutoffs)."""
    p = params or ZmoParams.dmo()
    dev = resolve_device(device)
    G = max(1, p.gparts)
    n = len(rb)
    if n == 0:
        return []
    t0 = time.time()
    A = min(p.dm_cand, p.ncand) if p.dm_cand > 0 else p.ncand
    Q = p.batch_q
    Ltier = pad_tier(int(rb.lengths[0]))
    m = (n + G - 1) // G
    bounds = np.minimum(np.arange(G + 1) * m, n)
    Npad = pad_pow2(n, lo=1 << 8)
    # the flat bank stays resident (the INDEX is the memory hog)
    total = rb.total_bases
    flat = np.full(pad_pow2(total + 1), 4, np.uint8)
    flat[:total] = rb.bases
    offs_pad = np.full(pad_pow2(n + 1, lo=1 << 8), total, np.int32)
    offs_pad[: n + 1] = rb.offsets.astype(np.int32)
    flat_d = torch.from_numpy(flat).to(dev)
    offs_d = torch.from_numpy(offs_pad).to(dev)
    read_lens_d = torch.from_numpy(rb.lengths.astype(np.int32)).to(dev)

    qarr = np.arange(n) if parts <= 1 else np.arange(n)[part::parts]
    batches = [qarr[i: i + Q] for i in range(0, len(qarr), Q)]
    B = len(batches)
    rids_all = np.zeros((B, Q), np.int32)
    qlens_all = np.zeros((B, Q), np.int32)
    qskip_all = np.ones((B, Q), bool)
    for bi, b in enumerate(batches):
        rids_all[bi, : len(b)] = b
        rids_all[bi, len(b):] = b[-1]
        qlens_all[bi] = rb.lengths[rids_all[bi]]
        qskip_all[bi, : len(b)] = False

    def batch(bi):
        rids = torch.from_numpy(rids_all[bi]).to(dev)
        qlens = torch.from_numpy(qlens_all[bi]).to(dev)
        return (query_rows(flat_d, offs_d, rids, qlens, Ltier, n), rids,
                qlens, torch.from_numpy(qskip_all[bi]).to(dev))

    NP = Q * A * 2
    cap = p.expand_budget_cap
    t_index = 0.0
    n_redispatch = 0

    def timed_part(g):
        nonlocal t_index
        ti = time.time()
        prt, _k16 = build_part(rb, p, int(bounds[g]), int(bounds[g + 1]),
                               dev)
        t_index += time.time() - ti
        return prt

    # ---- pass 1 over parts: candidates ----
    best_c = np.full((B, Q, G * A), INT32_MAX, np.int32)
    best_o = np.full((B, Q, G * A), -1, np.int32)
    stats_parts = []
    for g in range(G):
        t1 = time.time()
        prt = timed_part(g)
        lo, hi = int(bounds[g]), int(bounds[g + 1])
        stats_parts.append((prt.stats, lo, hi))
        cbud, kq = _pass1_budgets(int(prt.stats[5 * Npad + 2]), Q, Ltier, p)
        bud = dict(cbud=cbud, kq=kq)
        for bi in range(B):
            qb, rids, qlens, qskip = batch(bi)

            def run1(bud):
                c, o, ct, pt = part_candidates(
                    qb, rids, qlens, qskip, prt, read_lens_d, p, A=A, **bud)
                return torch.cat([c.reshape(-1), o.reshape(-1),
                                  torch.stack([ct, pt]).to(I32)]
                                 ).cpu().numpy()

            out, k = run_fitted(
                run1, bud, lambda o: dict(cand=int(o[-2]), probes=int(o[-1])),
                cap, Q, f"gpass {g + 1}/{G} pass 1 batch {bi}")
            n_redispatch += k
            best_c[bi, :, g * A:(g + 1) * A] = out[: Q * A].reshape(Q, A)
            best_o[bi, :, g * A:(g + 1) * A] = out[Q * A: 2 * Q * A].reshape(
                Q, A)
        del prt
        if progress:
            log("gpass %d/%d: indexed reads [%d, %d), candidates merged",
                g + 1, G, lo, hi)
            log("stage pass1_g%d: %.3fs", g + 1, time.time() - t1)
    # exact top-A merge (each candidate scored by exactly one pass)
    best_c = np.where(best_o > 0, best_c, INT32_MAX)
    ordi = np.argsort(np.where(best_c == INT32_MAX, -1, best_o) * -1,
                      axis=2, kind="stable")[:, :, :A]
    merged_c = np.take_along_axis(best_c, ordi, axis=2)
    csorted_all = np.sort(merged_c, axis=2).astype(np.int32)

    # ---- pass 2 over parts: matching + chaining ----
    zcnt_own = np.zeros(n, np.int64)
    cross_own = np.zeros(n, np.int64)
    for stats, lo, hi in stats_parts:
        zcnt_own[lo:hi] = stats[: hi - lo]
        cross_own[lo:hi] = stats[4 * Npad: 4 * Npad + hi - lo]
    occ_budget = pad_pow2(max(int(zcnt_own[rids_all[bi]].sum())
                              for bi in range(B)) + Q, lo=1 << 12)
    cross_budget = min(pad_pow2(2 * max(int(cross_own[rids_all[bi]].sum())
                                        for bi in range(B)) + 1024,
                                lo=1 << 14), cap)
    packs = np.zeros((B, 6, NP), np.int32)
    for g in range(G):
        t2 = time.time()
        prt = timed_part(g)
        bud = dict(occ=occ_budget, cx=cross_budget,
                   nbk=max(cross_budget // 4, 1 << 14))
        for bi in range(B):
            qb, rids, qlens, qskip = batch(bi)
            cs = torch.from_numpy(csorted_all[bi]).to(dev)

            def run2(bud):
                pk, tot = part_chains(qb, rids, qlens, qskip, cs, prt,
                                      read_lens_d, p, **bud)
                return torch.cat([pk.reshape(-1), tot]).cpu().numpy()

            out, k = run_fitted(run2, bud, lambda o: chain_totals(o[-4:]),
                                cap, Q, f"gpass {g + 1}/{G} pass 2 batch {bi}")
            n_redispatch += k
            pk = out[: 6 * NP].reshape(6, NP)
            # combine: a (q, slot) pair is produced by exactly one pass
            cur = packs[bi]
            cur[:5] = np.where(pk[:1] > cur[:1], pk[:5], cur[:5])
            cur[5] += pk[5]
        del prt
        if progress:
            log("gpass %d/%d: matched + chained", g + 1, G)
            log("stage pass2_g%d: %.3fs", g + 1, time.time() - t2)

    # ---- host emission (single-device semantics) ----
    t3 = time.time()
    overlaps: list = []
    rdcovs = np.zeros(n, np.int64)
    em = _dm_emission(rb, p, rb.avg_len())
    pos = np.arange(NP, dtype=np.int32)
    for bi in range(B):
        row = np.concatenate([pos, packs[bi].reshape(-1),
                              np.zeros(4, np.int32)])
        _emit_dm(em, rb, rids_all[bi], row, csorted_all[bi], Q, A, rdcovs,
                 overlaps, None)
    if progress:
        log("stage index: %.3fs", t_index)
        log("stage emission: %.3fs", time.time() - t3)
        log("gpass: %d redispatches", n_redispatch)
        log("overlap (-G %d passes) done: %d overlaps in %.1fs", G,
            len(overlaps), time.time() - t0)
    return overlaps
