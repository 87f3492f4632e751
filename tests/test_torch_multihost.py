"""The port's multi-host driver (parallel/multihost.py): two processes
joined by init_multihost over a TCP store give the JAX package's sharded
records (the (rd 1, idx 2) mesh that make_dcn_mesh lays over two
processes), and a budget overflow is decided by every rank together:
every rank redispatches, or every rank raises."""

from smartdenovo_tpu_torch.parallel.multihost import run_local_world

import torch_ranks
from test_torch_sharded import GLEN, KW, SEED, jax_records


def test_multihost_tcp_store_equals_jax():
    res = run_local_world(torch_ranks.multihost_rank, 2, "gloo", GLEN, SEED,
                          KW)
    assert res[0] == res[1]
    recs, redispatched = res[0]
    assert redispatched == []
    assert len(recs) > 300
    assert recs == jax_records(2, 2)


def test_overflow_redispatches_on_every_rank():
    """Sweep and block budgets starved to 2^14: every rank logs the same
    redispatches, and the records are those of the unstarved run."""
    base = run_local_world(torch_ranks.sharded_rank, 2, "gloo", GLEN, SEED,
                           KW, 2)
    res = run_local_world(torch_ranks.sharded_rank, 2, "gloo", GLEN, SEED,
                          KW, 2, True)
    assert res[0] == res[1]
    recs, redispatched = res[0]
    assert redispatched
    assert recs == base[0][0]


def test_overflow_past_the_cap_raises_on_every_rank():
    res = run_local_world(torch_ranks.sharded_rank, 2, "gloo", GLEN, SEED,
                          dict(KW, expand_budget_cap=1 << 14), 2)
    assert [r[0] for r in res] == ["raised", "raised"]
    assert all("exceeds the memory cap" in r[1] for r in res)
