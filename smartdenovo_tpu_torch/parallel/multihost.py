"""Multi-host sharded overlap — N processes, the idx axis across them
(port of smartdenovo_tpu/parallel/multihost.py).

The reference scales to clusters by running fully independent jobs per
node with a REPLICATED index (-P/-p, README-tools.md:112-117) and by
splitting the index into sequential passes when it exceeds one node's
memory (-G, wtzmo.c:1431-1463).  Here one program does both at once:

  the (rd, idx) grid over ALL processes is laid out so that the idx axis
  spans processes: process h owns idx shard h.  Each process builds ONLY
  its own read-block index shard (1/H of the index a host — the -G memory
  division, resident at once instead of in sequential passes), and the rd
  axis data-parallelises query batches (the -P/-p split, with exact
  cross-shard candidate merges instead of replicated indexes).

Collective traffic per step (sharded.sharded_overlap_step):
  all_gather over idx of per-shard top-A candidates   (Q*A int32 x 2)
  all_reduce over idx of positional dot-matrix results (6*Q*A*2 int32)
plus the global k16 frequency exchange at build time (an all-gather of
per-shard (kmer, count) runs, sharded._allgather_kmer_counts).

Entry points:
  init_multihost(coordinator, num_processes, process_id, backend) — first
  overlap_multihost(rb, params, device=...) — every process returns the
                                              same full overlap list
  run_local_world(fn, n, backend, *args)    — a world of n processes on
                                              this host (tests, dry runs)
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist

from .sharded import OverlapGroups, groups_from_grid, overlap_sharded


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str) -> None:
    """Join the world over a TCP store at `coordinator` ("host:port";
    process 0 serves it).  `backend` is "nccl" (one card a process) or
    "gloo" (host collectives: the CPU, or processes sharing one card)."""
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def make_dcn_mesh(n_idx: int | None = None) -> OverlapGroups:
    """The (rd, idx) grid with the idx axis spanning processes: rank
    i * rd + r sits at (r, i), the JAX package's device grid, so every
    process owns n_idx / H index shards."""
    H = dist.get_world_size()
    if n_idx is None:
        n_idx = H
    if H % n_idx:
        raise ValueError(f"{H} processes do not divide into {n_idx} idx "
                         "shards")
    rd = H // n_idx
    return groups_from_grid([[i * rd + r for i in range(n_idx)]
                             for r in range(rd)])


def overlap_multihost(rb, params=None, mesh: OverlapGroups | None = None,
                      progress: bool = True, *, device="cuda"):
    """Multi-host overlap driver.  Every process runs the same program and
    replays the same deterministic emission, so each returns the identical
    full overlap list (callers typically write output only on process
    0)."""
    return overlap_sharded(rb, params, mesh or make_dcn_mesh(), progress,
                           device=device)


def rank_device(device: str, rank: int) -> str:
    """A rank's device: "cuda" without an index is card rank % count; any
    other name is taken as it is (all ranks on "cuda:0" share that card)."""
    if device == "cuda":
        return f"cuda:{rank % torch.cuda.device_count()}"
    return device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world_rank(rank, fn, n, backend, coordinator, outdir, threads, args):
    torch.set_num_threads(threads)
    init_multihost(coordinator, n, rank, backend)
    try:
        res = fn(*args)
        with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


def run_local_world(fn, n: int, backend: str, *args) -> list:
    """Start `n` processes on this host (spawned), each joining a world of
    n over a TCP store on localhost with `backend` and running fn(*args)
    (fn: a module-level function); returns their results in rank order.
    The ranks share this process's CPU threads.  A rank that raises makes
    this raise."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory() as outdir:
        mp.start_processes(
            _world_rank,
            args=(fn, n, backend, f"localhost:{_free_port()}", outdir,
                  threads, args),
            nprocs=n, join=True, start_method="spawn")
        res = []
        for r in range(n):
            with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as fh:
                res.append(pickle.load(fh))
    return res
