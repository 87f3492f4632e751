"""Driver entry points of the port (the twins of the repository root's
__graft_entry__.py): the one-batch overlap forward and the multi-rank dry
run."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _example_inputs(n_reads=24, glen=8000, Q=8, L=2048, A=16, *,
                    device="cuda"):
    from .data.readbank import ReadBank
    from .ops.index import build_kmer_index, build_zmer_index
    from .ops.seeds import extract_seeds, subsample_mask
    from .utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(9)
    g = random_genome(rng, glen)
    names, seqs = simulate_reads(g, coverage=5, mean_len=1500, err=0.12,
                                 seed=10, min_len=600)
    rb = ReadBank(names, seqs)
    kidx = build_kmer_index(rb, ksave=2, device=device)
    zidx = build_zmer_index(rb, device=device)
    rids = np.arange(Q)
    batch, lens = rb.batch(rids, pad_to=L)
    batch_d = torch.from_numpy(batch).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    kres = extract_seeds(batch_d, lens_d, 16, True)
    kvalid = kres["valid"] & subsample_mask(kres["kmer"], 2)
    zres = extract_seeds(batch_d, lens_d, 10, True)
    return rb, kidx, zidx, rids, lens, kres, kvalid, zres


def entry(device="cuda"):
    """Return (fn, example_args): the overlap forward step for one batch.

    The flagship compute, exactly the production path (pipeline/zmo.py):
    k-mer candidate scan -> index-sweep z-mer matcher -> dot-matrix chain
    alignment for one batch of query reads.  fn returns 8 tensors:
    csorted, score, tb, te, qb, qe, match_cnt, totals."""
    from .data.readbank import ReadBank
    from .ops.flatseeds import build_bank_indexes, pad_pow2
    from .pipeline import zmo as Z
    from .utils.simulate import random_genome, simulate_reads

    dev = Z.resolve_device(device)
    rng = np.random.default_rng(9)
    g = random_genome(rng, 8000)
    names, seqs = simulate_reads(g, coverage=5, mean_len=1500, err=0.12,
                                 seed=10, min_len=600)
    rb = ReadBank(names, seqs)
    p = Z.ZmoParams.dmo(ncand=16, batch_q=8)
    flat_d, offs_d, _lens_d, _T, Npad = Z._upload_bank(rb, dev)
    k16, z10, didx = build_bank_indexes(
        flat_d, offs_d, ksize=p.ksize, zsize=p.zsize, hz=p.hz,
        ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
        max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)
    Q, A = 8, 16
    rids = torch.arange(Q, dtype=torch.int32, device=dev)
    qlens = torch.from_numpy(rb.lengths[:Q].astype(np.int32)).to(dev)
    read_lens = torch.from_numpy(rb.lengths.astype(np.int32)).to(dev)
    Lc = pad_pow2(int(didx.stats[5 * Npad]), lo=1 << 10)
    st = dict(Q=Q, Lc=Lc, Adm=A, mb=1 << 14, pb=1 << 14, nbk=1 << 14,
              cx=1 << 16, qkb=1 << 13, nb=16, kvar=p.kvar,
              zbits=2 * p.zsize, max_per_read=p.max_zmer_freq, xvar=p.xvar,
              yvar=p.yvar, min_block_len=p.min_block_len,
              max_overhang=p.max_overhang,
              deviation_penalty=p.deviation_penalty,
              gap_penalty=p.gap_penalty, matcher="sweep")

    def forward(rids, qlens, k16, didx, read_lens):
        csorted, _os, _sz = Z._cand_core(
            rids, qlens, torch.zeros(Q, dtype=torch.bool, device=dev), k16,
            didx, read_lens, Q=Q, Lc=Lc, A=A, Adm=A, cbud=1 << 15,
            kq=1 << 13, ksave=p.ksave, kovl=p.kovl, len_ratio=p.len_ratio)
        res, totals = Z._pair_core(rids, qlens, csorted, z10, didx,
                                   read_lens, **st)
        return (csorted, res.score, res.tb, res.te, res.qb, res.qe,
                res.match_cnt, totals)

    args = (rids, qlens, k16, didx, read_lens)
    return forward, args


def sim_bank(genome_len: int = 60_000, seed: int = 42):
    """The dry run's simulation: a genome of genome_len at 8x, reads of
    4 kb mean at 12% error (reads from seed + 1)."""
    from .data.readbank import ReadBank
    from .utils.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(seed)
    g = random_genome(rng, genome_len)
    names, seqs = simulate_reads(g, coverage=8, mean_len=4000, err=0.12,
                                 seed=seed + 1)
    return ReadBank(names, seqs)


def sharded_rank(genome_len, seed, params_kw, idx_shards, device):
    """One rank of a sharded run on sim_bank(genome_len, seed): its
    overlap records as tuples (run through multihost.run_local_world)."""
    import torch.distributed as dist

    from .parallel.multihost import rank_device
    from .parallel.sharded import make_overlap_groups, overlap_sharded
    from .pipeline.zmo import ZmoParams

    rb = sim_bank(genome_len, seed)
    groups = make_overlap_groups(idx_shards)
    ovls = overlap_sharded(rb, ZmoParams.dmo(**params_kw), groups,
                           progress=False,
                           device=rank_device(device, dist.get_rank()))
    return [dataclasses.astuple(o) for o in ovls]


def dryrun_multichip(n_ranks: int, backend: str = "nccl", device="cuda", *,
                     genome_len: int = 60_000):
    """Run the FULL sharded overlap pipeline over a world of n_ranks
    processes on this host.

    Grid: rd (data parallel over query batches) x idx (bank + posting
    indexes sharded by read-id blocks, 2 shards for an even world of 4 or
    more).  Each step runs the single-device pipeline per shard with an
    all_gather (exact top-A candidate merge) and an all_reduce (positional
    dot-matrix results) over idx — see parallel/sharded.py.  Every rank
    must return the same records; returns them."""
    from .parallel.multihost import run_local_world

    idx_shards = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    n_rd = n_ranks // idx_shards
    # the 60 kb / 8x sim of the JAX package's sharded test: big enough that
    # shard budget tiers and the per-read frequency stats actually engage
    res = run_local_world(sharded_rank, n_ranks, backend, genome_len, 42,
                          dict(ncand=64, batch_q=2 * n_rd), idx_shards,
                          device)
    assert all(r == res[0] for r in res), "ranks returned different records"
    assert len(res[0]) > 100, (
        f"sharded pipeline found too few overlaps ({len(res[0])})")
    print(f"dryrun_multichip ok: grid rd={n_rd} x idx={idx_shards}, "
          f"{backend} on {device}, {len(res[0])} overlaps")
    return res[0]
