"""The `overlap_sw` unit: one wtzmo `-P/-p` job of the zmo recipe, the
port's `overlap_dmo(parts=P, part=p)` with the configuration's SW-engine
flags (what `sdtpu zmo -e sw -P P -p p` runs): the whole bank's index,
phases 1 and 2 of the part's queries batch by batch, the banded local DP
of each query's top chains on both strands, and the host emission with
the overlaps' CIGARs.  Parts are cycled in order from the part `seed %
P`; the warm-up unit runs the part before it.  The work of a unit is the
read bases of its part's queries, in Mbp, so a change cannot gain by
emitting more or fewer records.

The checks (portbench/reference/sw_ref.py): `record_mismatches`, every
record of the first query batch of each of the window's first
`judged_units` parts against the plain reference's records of that
batch, worked out from the reads alone (the emission starts empty
there); and `cigar_inconsistent`, every record of every unit whose CIGAR
does not replay over its two segments into its own counts."""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench.gen.workload import genome_bank
from portbench.reference import overlap_ref, sw_ref

WORK_UNIT = "Mbp"


def records_of(overlaps, lengths) -> list[tuple]:
    """The program's records as sw_ref.FIELDS tuples."""
    return [(o.rid1, o.dir1, int(lengths[o.rid1]), o.beg1, o.end1, o.rid2,
             o.dir2, int(lengths[o.rid2]), o.beg2, o.end2, o.score,
             o.identity, o.mat, o.mis, o.ins, o.dl, o.cigar, o.aln)
            for o in overlaps]


class Unit:
    work_unit = WORK_UNIT

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        from smartdenovo_tpu_torch.data.readbank import ReadBank
        from smartdenovo_tpu_torch.pipeline.zmo import ZmoParams

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        _genome, reads = genome_bank(cfg, seed)
        # longest first, as both sides index the bank; names keep that
        # order under the ReadBank's (length, name) sort
        lens = reads.lengths()
        order = np.lexsort((np.arange(lens.shape[0]), -lens))
        seqs = [reads.read(int(i)) for i in order]
        self.bank = overlap_ref.Bank(np.concatenate(seqs), lens[order])
        self.rb = ReadBank([f"r{k:08d}" for k in range(len(seqs))], seqs)
        self.params = ZmoParams.zmo(**cfg["zmo"])
        self.parts = int(cfg["parts"])
        self.start = seed % self.parts
        self.next = 0
        self.work = [float(self.bank.lengths[sw_ref.part_queries(
            len(self.bank), self.parts, p)].astype(np.int64).sum()) / 1e6
            for p in range(self.parts)]
        self.outputs = []

    def _run(self, part: int):
        from smartdenovo_tpu_torch.pipeline.zmo import overlap_dmo

        return overlap_dmo(self.rb, self.params, parts=self.parts, part=part,
                           device=self.device)

    def run(self) -> float:
        part = (self.start + self.next) % self.parts
        self.next += 1
        self.outputs.append((part, self._run(part)))
        return self.work[part]

    def warm(self):
        self._run((self.start - 1) % self.parts)

    def free(self):
        self.rb = None

    def checks(self, limits: dict) -> tuple[list, int]:
        """([(name, value, limit)], units failed): the most records of a
        judged batch that differ from the reference's, and the records of
        the window whose CIGAR does not replay."""
        t0 = time.perf_counter()
        p = sw_ref.SwParams.of(self.cfg["zmo"])
        n = len(self.bank)
        lens = self.bank.lengths
        lim_rec = limits["record_mismatches"]
        lim_cig = limits["cigar_inconsistent"]
        judged = self.outputs[: int(self.mix["judged_units"])]
        diff = []
        for part, ovl in judged:
            first = set(sw_ref.part_queries(n, self.parts,
                                            part)[: p.batch_q].tolist())
            got = [r for r in records_of(ovl, lens) if r[0] in first]
            ref = sw_ref.part_records(self.bank, p, self.parts, part,
                                      self.device, batches=1)
            diff.append(sw_ref.mismatches(ref, got))
        t1 = time.perf_counter()
        faults = [sw_ref.cigar_faults(records_of(ovl, lens), self.bank)
                  for _part, ovl in self.outputs]
        print(f"portbench: check: {len(judged)} first batches judged in "
              f"{t1 - t0:.3f}s ({diff} records differ); "
              f"{sum(len(o) for _p, o in self.outputs)} records' CIGARs "
              f"replayed in {time.perf_counter() - t1:.3f}s ({faults} "
              "inconsistent)", file=sys.stderr, flush=True)
        failed = sum((k < len(diff) and diff[k] > lim_rec) or f > lim_cig
                     for k, f in enumerate(faults))
        return ([("record_mismatches", max(diff, default=0), lim_rec),
                 ("cigar_inconsistent", sum(faults), lim_cig)], failed)
