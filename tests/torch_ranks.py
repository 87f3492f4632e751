"""Rank bodies for the port's multi-process tests, run in spawned
processes by smartdenovo_tpu_torch.parallel.multihost.run_local_world
(this module imports no JAX)."""

import dataclasses

from smartdenovo_tpu_torch import graft_entry
from smartdenovo_tpu_torch.parallel import gpass, multihost, sharded
from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams


def _logged(run):
    """(records, this rank's redispatch log lines) of run(), or ("raised",
    message) when it raises RuntimeError."""
    msgs = []
    gpass.log = lambda m, *a: msgs.append(m % a)   # run_fitted's log
    try:
        ovls = run()
    except RuntimeError as e:
        return "raised", str(e)
    return ([dataclasses.astuple(o) for o in ovls],
            [m for m in msgs if "redispatch" in m and "redispatches" not in m])


def sharded_rank(genome_len, seed, params_kw, idx_shards, starve=False):
    """overlap_sharded on graft_entry.sim_bank(genome_len, seed) over the
    make_overlap_groups grid; starve: the sweep and block budgets start at
    their floor (2^14), so every batch overflows them."""
    if starve:
        budgets = sharded.sharded_budgets
        sharded.sharded_budgets = lambda *a: {
            **budgets(*a), "cx": 1 << 14, "nbk": 1 << 14}
    rb = graft_entry.sim_bank(genome_len, seed)
    return _logged(lambda: sharded.overlap_sharded(
        rb, ZmoParams.dmo(**params_kw),
        sharded.make_overlap_groups(idx_shards), progress=False,
        device="cpu"))


def multihost_rank(genome_len, seed, params_kw):
    """overlap_multihost (the idx axis across the processes)."""
    rb = graft_entry.sim_bank(genome_len, seed)
    return _logged(lambda: multihost.overlap_multihost(
        rb, ZmoParams.dmo(**params_kw), progress=False, device="cpu"))
