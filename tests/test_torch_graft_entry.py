"""The port's twin of __graft_entry__.py (smartdenovo_tpu_torch/
graft_entry.py): the one-batch overlap forward's 8 outputs and the example
inputs equal the JAX package's on the CPU, and the multi-rank dry run
passes on a gloo world of two CPU processes."""

import numpy as np
import torch

import __graft_entry__ as jentry
from smartdenovo_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_entry_outputs_equal_jax():
    jfn, jargs = jentry.entry()
    tfn, targs = graft_entry.entry(device="cpu")
    jout, tout = jfn(*jargs), tfn(*targs)
    assert len(tout) == len(jout) == 8
    for k, (j, t) in enumerate(zip(jout, tout)):
        assert np.array_equal(t.numpy(), np.asarray(j)), k
    assert int((tout[1] > 0).sum()) > 0    # chained pairs


def test_example_inputs_equal_jax():
    j = jentry._example_inputs()
    t = graft_entry._example_inputs(device="cpu")
    assert t[0].names == j[0].names
    for f in ("kmers", "post_rd", "post_dir"):
        assert np.array_equal(getattr(t[1], f).numpy().astype(np.int64),
                              np.asarray(getattr(j[1], f)).astype(np.int64)), f
    for f in ("zmers", "post_rd", "post_dir", "post_off", "post_span",
              "rm_zsd", "rm_pk", "rm_start"):
        assert np.array_equal(getattr(t[2], f).numpy().astype(np.int64),
                              np.asarray(getattr(j[2], f)).astype(np.int64)), f
    assert np.array_equal(t[3], j[3]) and np.array_equal(t[4], j[4])
    for jr, tr in ((j[5], t[5]), (j[7], t[7])):
        for f in ("kmer", "dir", "off", "span", "valid", "n_comp"):
            assert np.array_equal(tr[f].numpy().astype(np.int64),
                                  np.asarray(jr[f]).astype(np.int64)), f
    assert np.array_equal(t[6].numpy(), np.asarray(j[6]))


def test_dryrun_multichip_gloo_cpu():
    recs = graft_entry.dryrun_multichip(2, "gloo", "cpu")
    assert len(recs) > 100
