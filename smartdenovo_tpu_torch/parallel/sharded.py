"""Multi-rank sharded overlap on torch.distributed (port of
smartdenovo_tpu/parallel/sharded.py).

Design (replaces the reference's -P/-p job split and -G index
partitioning, wtzmo.c:1431-1463), with single-device semantics:

  ranks form a (rd, idx) grid:
              rd  — data parallel over query batches
              idx — the read bank's posting indexes sharded by contiguous
                    read-id blocks; rank (rd, idx) builds only shard idx

  Sharding the index by READ ID makes candidate scoring local-exact: a
  candidate's postings live entirely on its own shard, so the per-(query,
  candidate) k-mer union length (wtzmo.c:1251-1357) is computed exactly by
  one shard.  The step needs two collectives over the rank's idx group:

    1. all_gather of each shard's local top-A candidate list -> the exact
       global top-A per query;
    2. all_reduce SUM of the positional dot-matrix results (each pair is
       chained by exactly one shard, the candidate's).

  Everything else is the single-device pipeline (parallel/gpass.py's
  per-part candidate scan and row-form sweep + dot matrix) run per shard.
  Every rank keeps the whole host ReadBank; the rows' results are gathered
  to every rank, which replays the same emission and returns the same
  overlap list.

Budgets are the JAX package's; a batch whose totals overflow them on any
rank is run again by every rank at grown budgets (all_reduce MAX of the
totals decides), and past `expand_budget_cap` every rank raises.

Collectives run on the process group's backend, named by the caller (no
backend is picked here): nccl with one card a rank, gloo on the CPU or for
ranks that share one card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.readbank import ReadBank
from ..ops.align import pad_tier
from ..ops.flatseeds import SENT_U32, pad_pow2
from ..ops.seeds import subsample_mask
from ..pipeline.zmo import (ZmoParams, _dm_emission, _emit_dm,
                             resolve_device)
from ..utils.log import log
from .gpass import (Part, build_part, chain_totals, part_candidates,
                    part_chains, run_fitted)

I32 = torch.int32
INT32_MAX = 0x7FFFFFFF


class OverlapGroups(NamedTuple):
    """This rank's place in the (rd, idx) grid and its idx group (the
    counterpart of the JAX package's (rd, idx) mesh)."""

    n_rd: int
    n_idx: int
    rd: int
    idx: int
    grid: tuple          # grid[r][i] = the rank at (rd r, idx i)
    idx_group: object    # process group of this rank's grid row


def groups_from_grid(grid) -> OverlapGroups:
    """OverlapGroups for this rank over a (rd, idx) grid of ranks.  Every
    rank creates every row's group, in the same order, as
    torch.distributed requires."""
    grid = tuple(tuple(int(r) for r in row) for row in grid)
    rank = dist.get_rank()
    rows = [dist.new_group(list(row)) for row in grid]
    for r, row in enumerate(grid):
        if rank in row:
            return OverlapGroups(len(grid), len(row), r, row.index(rank),
                                 grid, rows[r])
    raise ValueError(f"rank {rank} is not in the grid {grid}")


def make_overlap_groups(idx_shards: int | None = None) -> OverlapGroups:
    """The (rd, idx) grid over the world: rank r is (rd, idx) =
    divmod(r, idx_shards), as the JAX package's reshape(rd, idx)."""
    world = dist.get_world_size()
    if idx_shards is None:
        idx_shards = 2 if world % 2 == 0 and world >= 4 else 1
    if world % idx_shards:
        raise ValueError(f"world size {world} does not divide into "
                         f"{idx_shards} idx shards")
    rd = world // idx_shards
    return groups_from_grid([[r * idx_shards + i for i in range(idx_shards)]
                             for r in range(rd)])


def all_gather(t: torch.Tensor, group=None) -> list:
    """all_gather of equal-shape tensors, in the group's rank order (gloo
    takes CUDA tensors too: chip_smoke.py phase 10 (c) checks it)."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    """all_reduce into a new tensor."""
    t = t.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def shard_bounds(n: int, S: int) -> np.ndarray:
    m = (n + S - 1) // S
    return np.minimum(np.arange(S + 1) * m, n)


def shard_tier(rb, bounds) -> int:
    """Common flat tier across shards (one shape for every shard)."""
    Ts = 1
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        Ts = max(Ts, pad_pow2(int(rb.offsets[hi] - rb.offsets[lo]) + 1))
    return Ts


def build_one_shard(rb, p, lo: int, hi: int, Ts: int, dev):
    """Build ONE read-block shard's indexes with the single-device builder.

    Returns the shard's Part (its k16 arrays are replaced once the global
    counts are known) and its raw sampled k16 postings on the host (kmer,
    global rd, dir — unfiltered: the frequency rule must see GLOBAL
    counts)."""
    part, k16 = build_part(rb, p, lo, hi, dev, T=Ts)
    kval = (k16.valid & subsample_mask(k16.kmer, p.ksave)).cpu().numpy()
    raw = dict(raw_k=k16.kmer.cpu().numpy()[kval],
               raw_rd=k16.comp_rd.cpu().numpy()[kval] + lo,
               raw_dir=(k16.aux.cpu().numpy()[kval] & 1).astype(np.int8))
    return part, raw


def k16_freq_rule(counts: np.ndarray, max_kmer_freq: int) -> np.ndarray:
    """The reference's k-mer frequency keep rule on GLOBAL counts
    (wtzmo.c:380-418): drop singletons and over-frequent kmers."""
    n_post = int(counts.sum())
    kavg = max(n_post // max(1, len(counts)), 20)
    cutoff = max_kmer_freq if max_kmer_freq >= 2 else max(kavg * 5, 100)
    return (counts > 1) & (counts <= cutoff)


def filter_shard_k16(shard, uniq, keep_kmer, Ts):
    """Apply the global frequency rule to one shard's raw k16 postings and
    lay them out (kmer, rd)-sorted in the common tier (codes as int64,
    0xFFFFFFFF past the live ones)."""
    ki = np.searchsorted(uniq, shard["raw_k"])
    ok = keep_kmer[ki]
    km, rd_, dr = shard["raw_k"][ok], shard["raw_rd"][ok], shard["raw_dir"][ok]
    order = np.lexsort((rd_, km))
    cnt = len(km)
    if cnt > Ts:
        raise ValueError("k16 postings exceed shard tier")
    kk = np.full(Ts, SENT_U32, np.int64)
    krd = np.zeros(Ts, np.int32)
    kdr = np.zeros(Ts, np.int8)
    kk[:cnt] = km[order]
    krd[:cnt] = rd_[order]
    kdr[:cnt] = dr[order]
    return kk, krd, kdr


def _allgather_kmer_counts(uniq_local: np.ndarray, cnt_local: np.ndarray,
                           group, dev):
    """Exchange the shards' k16 (kmer, count) runs over `group`; return
    the global merge, equal to np.unique over all shards' postings."""
    n_all = torch.cat(all_gather(
        torch.tensor([len(uniq_local)], dtype=torch.int64, device=dev),
        group)).cpu().numpy()
    m = int(n_all.max())
    pk = np.full(m, SENT_U32, np.int64)
    pc = np.zeros(m, np.int64)
    pk[: len(uniq_local)] = uniq_local
    pc[: len(cnt_local)] = cnt_local
    gk = all_gather(torch.from_numpy(pk).to(dev), group)
    gc = all_gather(torch.from_numpy(pc).to(dev), group)
    allk = np.concatenate([k.cpu().numpy()[: int(c)]
                           for k, c in zip(gk, n_all)])
    allc = np.concatenate([k.cpu().numpy()[: int(c)]
                           for k, c in zip(gc, n_all)])
    uniq, inv = np.unique(allk, return_inverse=True)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(counts, inv, allc)
    return uniq, counts


class ShardedBank(NamedTuple):
    """This rank's shard, the shard bounds and the idx group's stats."""

    part: Part            # device indexes of this rank's shard
    bounds: np.ndarray    # [S+1] shard read-id boundaries
    stats: np.ndarray     # [S, 5*Npad+4] every shard's stat pack
    kneed: np.ndarray     # [n] per-read GLOBAL k16 expansion need


def build_sharded_indexes(rb, p, groups: OverlapGroups, dev) -> ShardedBank:
    """Build this rank's read-block shard, with the k16 frequency filter on
    GLOBAL counts (a shard-local filter would drop 2-frequency kmers split
    across shards — precisely the overlap signal), exchanged over the idx
    group; the per-read global expansion need and every shard's stats are
    summed and gathered there too, so every rank sizes the same budgets."""
    n = len(rb)
    S = groups.n_idx
    bounds = shard_bounds(n, S)
    Ts = shard_tier(rb, bounds)
    s = groups.idx
    part, raw = build_one_shard(rb, p, int(bounds[s]), int(bounds[s + 1]),
                                Ts, dev)
    uq_l, ct_l = np.unique(raw["raw_k"], return_counts=True)
    uniq, counts = _allgather_kmer_counts(uq_l, ct_l, groups.idx_group, dev)
    keep_kmer = k16_freq_rule(counts, p.max_kmer_freq)
    kk, krd, kdr = filter_shard_k16(raw, uniq, keep_kmer, Ts)
    ki = np.searchsorted(uniq, raw["raw_k"])
    ok = keep_kmer[ki]
    kneed_l = np.zeros(n, np.int64)
    np.add.at(kneed_l, raw["raw_rd"][ok], counts[ki][ok])
    kneed = all_reduce(torch.from_numpy(kneed_l).to(dev),
                       group=groups.idx_group).cpu().numpy()
    stats = torch.stack(all_gather(
        torch.from_numpy(part.stats).to(dev), groups.idx_group)).cpu().numpy()
    part = part._replace(k_kmers=torch.from_numpy(kk).to(dev),
                         k_rd=torch.from_numpy(krd).to(dev),
                         k_dir=torch.from_numpy(kdr).to(dev))
    return ShardedBank(part=part, bounds=bounds, stats=stats, kneed=kneed)


def sharded_overlap_step(qb, rids, qlens, qskip, part: Part, read_lens,
                         p: ZmoParams, groups: OverlapGroups, *, A: int,
                         cbud: int, kq: int, occ: int, cx: int, nbk: int):
    """One batch on one rank: the candidate scan against the local shard
    -> all_gather + exact top-A merge over idx -> the row-form sweep
    matcher + dot matrix on the local shard -> all_reduce SUM of the
    positional results over idx.  Returns (csorted [Ql, A], packed
    [6, Ql*A*2] summed over idx, this rank's totals: candidate expansion,
    probes, pairs, sweep expansion, blocks, occurrences)."""
    Ql = rids.shape[0]
    cands, ols, ct, pt = part_candidates(qb, rids, qlens, qskip, part,
                                         read_lens, p, A=A, cbud=cbud, kq=kq)
    S = groups.n_idx
    flat_c = torch.stack(all_gather(cands, groups.idx_group), 1).reshape(
        Ql, S * A)
    flat_o = torch.stack(all_gather(ols, groups.idx_group), 1).reshape(
        Ql, S * A)
    # lax.top_k's order: value descending, ties to the lower index
    top_o, top_i = torch.sort(flat_o, dim=1, descending=True, stable=True)
    gc = torch.take_along_dim(flat_c, top_i[:, :A], 1)
    gc = torch.where(top_o[:, :A] > 0, gc, INT32_MAX)
    csorted = torch.sort(gc, dim=1).values
    pack, tot = part_chains(qb, rids, qlens, qskip, csorted, part, read_lens,
                            p, occ=occ, cx=cx, nbk=nbk)
    packed = all_reduce(pack, group=groups.idx_group)
    return csorted, packed, torch.cat([torch.stack([ct, pt]).to(I32), tot])


def sharded_budgets(sb: ShardedBank, n: int, batches, Q: int, cap: int):
    """The JAX package's step widths, capped at `cap`: the own-shard
    per-read stats estimate the per-shard masses (a shard holds ~1/S of
    the genome's copies), with x2 slack on the sweep."""
    Npad = pad_pow2(n, lo=1 << 8)
    st = sb.stats   # per-read blocks are in LOCAL shard ids
    zcnt = np.zeros(n, np.int64)
    kprobes = np.zeros(n, np.int64)
    cross = np.zeros(n, np.int64)
    for s in range(st.shape[0]):
        lo, hi = int(sb.bounds[s]), int(sb.bounds[s + 1])
        ln = hi - lo
        zcnt[lo:hi] = st[s, :ln]
        kprobes[lo:hi] = st[s, 2 * Npad: 2 * Npad + ln]
        cross[lo:hi] = st[s, 4 * Npad: 4 * Npad + ln]
    cx = min(pad_pow2(2 * max(int(cross[b].sum()) for b in batches) + 1024,
                      lo=1 << 14), cap)
    return dict(
        cbud=min(pad_pow2(max(int(sb.kneed[b].sum()) for b in batches)
                          + 1024, lo=1 << 14), cap),
        kq=pad_pow2(max(int(kprobes[b].sum()) for b in batches) + Q,
                    lo=1 << 12),
        occ=pad_pow2(max(int(zcnt[b].sum()) for b in batches) + Q,
                     lo=1 << 12),
        cx=cx, nbk=max(cx // 4, 1 << 14))


def overlap_sharded(rb: ReadBank, params: ZmoParams | None = None,
                    groups: OverlapGroups | None = None,
                    progress: bool = True, *, device="cuda"):
    """Multi-rank overlap driver with single-device-identical semantics.

    Call on every rank of an initialised torch.distributed world with the
    same bank and parameters.  Query batches stream over the rd rows
    against the idx-sharded bank; every rank replays the single-device
    emission (`_emit_dm`: nbest, ledger, dedup) over the gathered
    rows and returns the same list, whose pair set equals overlap_dmo's
    modulo top-A coverage ties."""
    p = params or ZmoParams.dmo()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups = groups or make_overlap_groups()
    n = len(rb)
    if n == 0:
        return []
    sb = build_sharded_indexes(rb, p, groups, dev)
    A = min(p.ncand, p.dm_cand) if p.dm_cand > 0 else p.ncand
    Qloc = max(1, p.batch_q // groups.n_rd)
    Q = Qloc * groups.n_rd
    Ltier = pad_tier(int(rb.lengths.max()))
    read_lens = torch.from_numpy(rb.lengths.astype(np.int32)).to(dev)
    batches = [np.arange(n)[i: i + Q] for i in range(0, n, Q)]
    cap = p.expand_budget_cap
    bud = sharded_budgets(sb, n, batches, Q, cap)
    overlaps: list = []
    rdcovs = np.zeros(n, np.int64)
    em = _dm_emission(rb, p, rb.avg_len())
    NPl = Qloc * A * 2
    heads = [row[0] for row in groups.grid]    # idx 0 of each rd row
    n_redispatch = 0
    for b in batches:
        rids = np.concatenate(
            [b, np.full(Q - len(b), b[-1], b.dtype)]).astype(np.int32)
        qskip = np.zeros(Q, bool)
        qskip[len(b):] = True
        mine = slice(groups.rd * Qloc, (groups.rd + 1) * Qloc)
        batch, lens = rb.batch(rids[mine], pad_to=Ltier)
        args = (torch.from_numpy(batch).to(dev),
                torch.from_numpy(rids[mine]).to(dev),
                torch.from_numpy(lens.astype(np.int32)).to(dev),
                torch.from_numpy(qskip[mine]).to(dev))

        def run(bud):
            csorted, packed, tot = sharded_overlap_step(
                *args, sb.part, read_lens, p, groups, A=A, **bud)
            # every rank takes the same decision from the world's maxima
            return csorted, packed, all_reduce(tot, dist.ReduceOp.MAX).cpu()

        (csorted, packed, _), k = run_fitted(
            run, bud, lambda o: dict(cand=int(o[2][0]), probes=int(o[2][1]),
                                     **chain_totals(o[2][2:])),
            cap, Q, f"sharded batch at read {int(b[0])}")
        n_redispatch += k
        # every rank gathers every rd row's candidates and results
        rows = all_gather(torch.cat([csorted.reshape(-1),
                                     packed.reshape(-1)]))
        rows = [rows[r].cpu().numpy() for r in heads]
        cs_all = np.concatenate([r[: Qloc * A] for r in rows]).reshape(Q, A)
        pk_all = np.concatenate([r[Qloc * A:].reshape(6, NPl) for r in rows],
                                axis=1).astype(np.int64)
        row = np.concatenate([np.arange(Q * A * 2, dtype=np.int64),
                              pk_all.reshape(-1), np.zeros(4, np.int64)])
        _emit_dm(em, rb, rids, row, cs_all, Q, A, rdcovs, overlaps, None)
        if progress and dist.get_rank() == 0:
            log("sharded overlap %d/%d reads, %d overlaps",
                min(n, int(b[-1]) + 1), n, len(overlaps))
    if progress and dist.get_rank() == 0:
        log("sharded: %d redispatches", n_redispatch)
    return overlaps
