"""End-to-end dmo assembly driver — equivalent of `smartdenovo.pl` without
consensus (port of smartdenovo_tpu/pipeline/driver.py).

  dmo:  wtzmo -k 16 -z 10 -Z 16 -U -1 -m 0.1 -A 1000  -> PREFIX.dmo.ovl
        wtclp -d 3 -k 300 -m 0.1 -FT                  -> PREFIX.dmo.obt
        wtlay -w 300 -s 200 -m 0.1 -r 0.95 -c 1       -> PREFIX.dmo.lay(.utg)

Only the overlap stage runs on the device; wtclp and wtlay are the
port's copies of the JAX package's host modules (graph/).  Stage times
are logged as "stage <name>: <seconds>s".
"""

from __future__ import annotations

import dataclasses
import time

from ..data.readbank import ReadBank
from ..graph.clip import (ClpParams, overlaps_to_clp_records, run_clp,
                          write_clp)
from ..graph.stringgraph import LayParams, StringGraph, run_lay
from ..utils.log import log

from .zmo import ZmoParams, overlap_dmo, write_overlaps


@dataclasses.dataclass
class AssemblyResult:
    rb: ReadBank           # the bank used for layout (post-clip)
    orig_rb: ReadBank      # the pre-clip overlap bank (overlaps are keyed to it)
    overlaps: list
    clips: dict
    graph: StringGraph


def remap_overlaps(overlaps, old_rb: ReadBank, new_rb: ReadBank):
    """Re-key overlap records into a (clipped) bank; skip dropped reads.

    In -F (whole-read) clip mode kept reads are unchanged, so coordinates
    remain valid; reads clipped to zero length are dropped (the reference
    skips rdlen==0 reads at overlap load, wtlay.h:246).
    """
    out = []
    for ov in overlaps:
        n1 = old_rb.names[ov.rid1]
        n2 = old_rb.names[ov.rid2]
        i1 = new_rb.name2id.get(n1)
        i2 = new_rb.name2id.get(n2)
        if i1 is None or i2 is None:
            continue
        if new_rb.lengths[i1] != old_rb.lengths[ov.rid1]:
            continue
        if new_rb.lengths[i2] != old_rb.lengths[ov.rid2]:
            continue
        out.append(dataclasses.replace(ov, rid1=i1, rid2=i2))
    return out


def assemble_dmo(
    rb: ReadBank,
    zmo_params: ZmoParams | None = None,
    clp_params: ClpParams | None = None,
    lay_params: LayParams | None = None,
    *,
    device="cuda",
) -> AssemblyResult:
    """Run the dmo (dot-matrix, SW-free) pipeline: overlap -> clip -> layout."""
    zp = zmo_params or ZmoParams.dmo()
    cp = clp_params or ClpParams.dmo()
    lp = lay_params or LayParams.dmo()
    overlaps = overlap_dmo(rb, zp, device=device)
    t0 = time.time()
    clips = run_clp(overlaps_to_clp_records(rb, overlaps), cp)
    log("stage clp: %.3fs", time.time() - t0)
    # -F mode: closed reads have kept_len 0 -> drop; others keep whole seq
    keep_names = []
    keep_seqs = []
    keep_quals = []
    for rid, name in enumerate(rb.names):
        c = clips.get(name)
        if c is not None and c[5] != 0:
            continue  # closed (chimeric/lonely/uncovered)
        keep_names.append(name)
        keep_seqs.append(rb.get(rid).copy())
        keep_quals.append(rb.quals[rid] if rb.quals else None)
    rb2 = ReadBank(keep_names, keep_seqs,
                   quals=keep_quals if rb.quals is not None else None)
    log("layout bank: %d/%d reads kept", len(rb2), len(rb))
    ovl2 = remap_overlaps(overlaps, rb, rb2)
    t1 = time.time()
    g = run_lay(rb2, ovl2, lp)
    log("stage lay: %.3fs", time.time() - t1)
    return AssemblyResult(rb=rb2, orig_rb=rb, overlaps=overlaps, clips=clips, graph=g)


def write_outputs(res: AssemblyResult, prefix: str):
    write_overlaps(prefix + ".ovl", res.orig_rb, res.overlaps)
    write_clp(prefix + ".obt", res.clips)
    with open(prefix + ".lay", "w") as lay_fh, open(prefix + ".lay.utg", "w") as utg_fh, \
         open(prefix + ".lay.dup", "w") as dup_lay, open(prefix + ".lay.utg.dup", "w") as dup_utg, \
         open(prefix + ".lay.lnk", "w") as lnk_fh:
        n = res.graph.output_layout(lay_fh, utg_fh, dup_lay, dup_utg,
                                    utg_sm=res.graph.p.utg_sm, lnk_fh=lnk_fh)
    log("wrote %d independent unitigs to %s.lay.utg", n, prefix)
    return n
