"""The port's sharded overlap driver (parallel/sharded.py) on gloo worlds
of CPU processes against the JAX package's overlap_sharded on a CPU mesh
of the same shape (tests/conftest.py gives 8 virtual devices): records
equal, every rank returns the same list, and the pair set is the port's
single-device overlap_dmo's (the JAX package's bar, Jaccard >= 0.99,
tests/test_sharded.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from smartdenovo_tpu.data.readbank import ReadBank
from smartdenovo_tpu.parallel.sharded import (make_overlap_mesh,
                                              overlap_sharded)
from smartdenovo_tpu.pipeline.zmo import ZmoParams as JParams
from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
from smartdenovo_tpu_torch import graft_entry
from smartdenovo_tpu_torch.parallel.multihost import run_local_world
from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams, overlap_dmo

import torch_ranks

torch.set_num_threads(1)

GLEN, SEED = 30_000, 77      # 60 reads of graft_entry.sim_bank
KW = dict(ncand=64, batch_q=8)


def jax_records(n_devices, idx_shards):
    """JAX overlap_sharded on the same bank over an (rd, idx) CPU mesh."""
    rng = np.random.default_rng(SEED)
    names, seqs = simulate_reads(random_genome(rng, GLEN), coverage=8,
                                 mean_len=4000, err=0.12, seed=SEED + 1)
    mesh = make_overlap_mesh(jax.devices()[:n_devices], idx_shards=idx_shards)
    return [dataclasses.astuple(o) for o in overlap_sharded(
        ReadBank(names, seqs), JParams.dmo(**KW), mesh, progress=False)]


def _pairs(recs):
    return {(min(r[0], r[4]), max(r[0], r[4])) for r in recs}


@pytest.mark.parametrize("n,idx_shards", [(2, 2), (4, 2)])
def test_sharded_world_equals_jax(n, idx_shards):
    """World of 2 (rd 1 x idx 2) and of 4 (rd 2 x idx 2): no rank
    redispatches (so the JAX package dropped nothing either)."""
    res = run_local_world(torch_ranks.sharded_rank, n, "gloo", GLEN, SEED,
                          KW, idx_shards)
    recs = res[0][0]
    assert all(r == res[0] for r in res), "ranks returned different lists"
    assert res[0][1] == [], res[0][1]
    assert len(recs) > 300
    assert recs == jax_records(n, idx_shards)
    one = _pairs(dataclasses.astuple(o) for o in overlap_dmo(
        graft_entry.sim_bank(GLEN, SEED), ZmoParams.dmo(**KW),
        progress=False, device="cpu"))
    mine = _pairs(recs)
    assert len(one & mine) / len(one | mine) >= 0.99
