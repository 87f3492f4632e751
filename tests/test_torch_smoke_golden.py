"""The port's overlapper on the smoke golden (179 reads): record for record
the JAX package's overlaps, and the reference binary's pair set
(tests/goldens/smoke.ref.ovl) at recall and precision >= 0.99, the bar
tests/test_goldens.py holds the JAX package to."""

import dataclasses
import os

import torch

from smartdenovo_tpu.data.readbank import ReadBank
from smartdenovo_tpu.pipeline import zmo as jzmo
from smartdenovo_tpu_torch.pipeline import zmo as tzmo
from test_goldens import ovl_pairs

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def test_smoke_golden_overlaps():
    rb = ReadBank.from_fasta(os.path.join(GOLD, "smoke.fa"))
    got = tzmo.overlap_dmo(rb, tzmo.ZmoParams.dmo(), progress=False,
                           device="cpu")
    exp = jzmo.overlap_dmo(rb, jzmo.ZmoParams.dmo(), progress=False)
    assert len(got) > 1000
    assert ([dataclasses.astuple(o) for o in got]
            == [dataclasses.astuple(o) for o in exp])
    ours = {frozenset((rb.names[o.rid1], rb.names[o.rid2])) for o in got}
    ref = ovl_pairs(os.path.join(GOLD, "smoke.ref.ovl"))
    common = len(ours & ref)
    assert common / len(ref) >= 0.99 and common / len(ours) >= 0.99
