"""POA consensus stage — equivalent of the reference `wtmsa` (host-only
copy of smartdenovo_tpu/pipeline/msa.py over the port's `cns` module).

Per unitig (reference run_wtmsa, wtmsa.c:410-548): backbone from the
layout, then each read is aligned directly to the growing partial-order
graph (native/poa.cpp banded graph DP, the pomsa.h equivalent) and
threaded in; consensus is the heaviest edge-coverage path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.log import log
from ..utils.native import PoaCns

from .cns import LayUnitig, _gen_backbone


@dataclasses.dataclass
class MsaParams:
    match: int = 2
    mismatch: int = -5
    gap: int = -3
    band: int = 100     # pomsa.h W=100
    win_margin: int = 400


def msa_unitig(unit: LayUnitig, p: MsaParams | None = None) -> np.ndarray:
    p = p or MsaParams()
    backbone = _gen_backbone(unit)
    if len(backbone) == 0:
        return backbone
    g = PoaCns(p.match, p.mismatch, p.gap, p.band)
    g.init_backbone(backbone)
    order = sorted(range(len(unit.reads)), key=lambda i: unit.offs[i])
    n_ok = 0
    for i in order:
        read = unit.reads[i]
        wlo = max(0, unit.offs[i] - p.win_margin)
        whi = min(len(backbone), unit.offs[i] + len(read) + p.win_margin)
        sc = g.align_and_add(read, wlo, whi)
        if sc > 0:
            n_ok += 1
    cns = g.consensus()
    log("wtmsa %s: %d/%d reads threaded, len %d -> %d",
        unit.name, n_ok, len(unit.reads), len(backbone), len(cns))
    return cns


def run_msa(units, params: MsaParams | None = None):
    p = params or MsaParams()
    out = []
    for unit in units:
        cns = msa_unitig(unit, p)
        if len(cns):
            out.append((unit.name, cns))
    return out
