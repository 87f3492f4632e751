"""The `overlap` unit: one `overlap_dmo` call over the whole filtered bank
of the configuration's genome (the index build, every query batch, the
host emission), with the configuration's dm-engine flags.  The work of a
unit is the bank's read bases, in Mbp, so a change cannot gain by
emitting more or fewer records.

The check: every record of every pass of the window against the plain
reference's records of the whole bank (portbench/reference/
overlap_ref.py)."""

from __future__ import annotations

import numpy as np

from portbench.gen.workload import genome_bank
from portbench.reference import overlap_ref

WORK_UNIT = "Mbp"


def records_of(overlaps) -> np.ndarray:
    """[k, 9] int64: rid1, rid2, dir2, beg1, end1, beg2, end2, score, aln;
    the fields that the dm emission computes (the rest follow from them)."""
    return np.array([(o.rid1, o.rid2, o.dir2, o.beg1, o.end1, o.beg2, o.end2,
                      o.score, o.aln) for o in overlaps],
                    np.int64).reshape(-1, overlap_ref.RECORD_FIELDS)


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
        self.params = ZmoParams.dmo(**cfg["zmo"])
        self.work = self.rb.total_bases / 1e6
        self.outputs = []

    def run(self) -> float:
        from smartdenovo_tpu_torch.pipeline.zmo import overlap_dmo

        self.outputs.append(overlap_dmo(self.rb, self.params,
                                        device=self.device))
        return self.work

    def warm(self):
        self.run()
        self.outputs.clear()

    def free(self):
        self.rb = None

    def checks(self, limits: dict) -> tuple[list, int]:
        """([(name, value, limit)], units failed): the worst pass's count
        of records that differ from the reference's."""
        p = overlap_ref.DmParams.of(self.cfg["zmo"])
        ref = overlap_ref.reference_records(self.bank, p, self.device)
        per_pass = [overlap_ref.mismatches(ref, records_of(ovl))
                    for ovl in self.outputs]
        lim = limits["record_mismatches"]
        worst = max(per_pass) if per_pass else 0
        return ([("record_mismatches", worst, lim)],
                sum(v > lim for v in per_pass))
