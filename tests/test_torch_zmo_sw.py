"""The port's SW (zmo) engine against the JAX package on the CPU: on an
8 kb / 6x simulation with reads under 2,048 bp, `overlap_reads` with the
flags of `zmo -e sw -A 16 --batch-q 4` gives the JAX package's Overlap
records (CIGARs, mat/mis/ins/del and every other field), and the port's
CLI writes the .ovl that JAX's `write_overlaps` writes, byte for byte.
tests/test_torch_zmo_refine.py does the same with -n."""

import dataclasses

import pytest
import torch

from smartdenovo_tpu.data.readbank import ReadBank as JReadBank
from smartdenovo_tpu.pipeline import zmo as jzmo
from smartdenovo_tpu_torch import cli
from smartdenovo_tpu_torch.data.readbank import ReadBank
from smartdenovo_tpu_torch.pipeline import zmo as tzmo
from smartdenovo_tpu_torch.utils.simulate import write_sim_fasta
from test_torch_cuda import sw_bank

torch.set_num_threads(1)

# zmo -e sw with the CLI's defaults (-Z 16, -m 0.1), -A 16 and --batch-q 4
CLI_FLAGS = ["-A", "16", "--batch-q", "4"]
CLI_PARAMS = dict(max_zmer_freq=16, min_id=0.1, ncand=16, batch_q=4)


def sw_runs(tmp, refine):
    """(JAX records, port records, JAX .ovl path, FASTA path)."""
    names, seqs = sw_bank()
    fa = str(tmp / "reads.fa")
    write_sim_fasta(fa, names, seqs)
    jrb = JReadBank(names, seqs)
    jo = jzmo.overlap_reads(jrb, jzmo.ZmoParams.zmo(refine=refine, **CLI_PARAMS),
                            progress=False)
    jzmo.write_overlaps(str(tmp / "jax.ovl"), jrb, jo)
    to = tzmo.overlap_reads(ReadBank(names, seqs),
                            tzmo.ZmoParams.zmo(refine=refine, **CLI_PARAMS),
                            progress=False, device="cpu")
    return jo, to, str(tmp / "jax.ovl"), fa


def check_records(runs):
    jo, to, _jp, _fa = runs
    assert len(to) > 30
    assert ([dataclasses.astuple(o) for o in to]
            == [dataclasses.astuple(o) for o in jo])
    # real alignments: CIGARs and their stats, not the dm placeholders
    assert all(o.cigar != f"{o.aln}M" and o.mat + o.mis + o.ins + o.dl == o.aln
               for o in to)


def check_cli(runs, tmp, extra=()):
    _jo, _to, jp, fa = runs
    out = str(tmp / "port.ovl")
    assert cli.main(["zmo", "-e", "sw", *extra, "-i", fa, "-o", out,
                     *CLI_FLAGS, "--device", "cpu"]) == 0
    with open(out, "rb") as f1, open(jp, "rb") as f2:
        got, exp = f1.read(), f2.read()
    assert got and got == exp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sw_runs(tmp_path_factory.mktemp("zmo_sw"), refine=False)


def test_sw_overlap_records_equal(runs):
    check_records(runs)


def test_cli_zmo_sw_ovl_byte_equal(runs, tmp_path):
    check_cli(runs, tmp_path)


def test_attach_cigars_split_under_caps_equals_one_call(runs, monkeypatch):
    """`_attach_cigars` aligns a batch's overlaps in calls of one length
    tier under ops/align.py's DIRS_CAP bytes of direction plane, and the
    refine pass (-n) its group under the same cap: with a cap that forces
    a call per pair or two, the records equal those of one call."""
    from smartdenovo_tpu_torch.ops import align

    _jo, to, _jp, _fa = runs
    names, seqs = sw_bank()
    rb = ReadBank(names, seqs)
    p = tzmo.ZmoParams.zmo(refine=True, **CLI_PARAMS)
    blank = [dataclasses.replace(o, cigar="0M", mat=0, mis=0, ins=0, dl=0)
             for o in to[:12]]
    one = [dataclasses.replace(o) for o in blank]
    sp_one = tzmo._attach_cigars(rb, p, one, device="cpu")
    assert ([(list(i), la) for i, la in align.tier_chunks(
        [900, 5000, 300], align.plane_fits(64))]
        == [([0, 2], 2048), ([1], 8192)])
    # a banded call (W 256) a pair, a refine call (W 64) a few pairs
    monkeypatch.setattr(align, "DIRS_CAP", 2 * 4097 * 64)
    assert [list(i) for i, _ in align.tier_chunks(
        [900, 300], align.plane_fits(256))] == [[0], [1]]
    split = [dataclasses.replace(o) for o in blank]
    sp = tzmo._attach_cigars(rb, p, split, device="cpu")
    assert sp.counts["calls"] == len(split) > sp_one.counts["calls"]
    assert ([dataclasses.astuple(o) for o in split]
            == [dataclasses.astuple(o) for o in one])
    assert all(o.cigar != "0M" for o in one)
