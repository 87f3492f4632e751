"""The port's consensus stage (pipeline/cns.py, segment engine, on the CPU)
against the JAX package: consensus codes and final read offsets equal on
the 12 kb unit of tests/test_cns.py and on a golden unitig of
tests/goldens/smoke.ref.lay; the segment state carries across
(convert.py); the POA engine's copy agrees; every host part copied from
the JAX package equals its source.  Checkpoints and the `cns` CLI are in
test_torch_cns_ckpt_cli.py, `asm -c 1` in test_torch_cns_asm.py."""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from smartdenovo_tpu.pipeline import cns as jcns
from smartdenovo_tpu.pipeline import msa as jmsa
from smartdenovo_tpu.utils.simulate import random_genome, simulate_reads
from smartdenovo_tpu_torch import convert
from smartdenovo_tpu_torch.pipeline import cns as tcns
from smartdenovo_tpu_torch.pipeline import msa as tmsa
from test_torch_cuda import unit_12kb

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _same(j, t):
    """(codes, offsets) of the two packages are equal."""
    assert np.array_equal(np.asarray(j[0]), np.asarray(t[0]))
    assert list(j[1]) == list(t[1])


def test_consensus_12kb_matches_jax():
    j = jcns.consensus_unitig(unit_12kb(jcns.LayUnitig),
                              jcns.CnsParams(n_iter=2), return_offs=True)
    t = tcns.consensus_unitig(unit_12kb(), tcns.CnsParams(n_iter=2),
                              return_offs=True, device="cpu")
    _same(j, t)
    assert 11000 < len(t[0]) < 13000


def test_golden_unitig_matches_jax():
    """utg1 of smoke.ref.lay (17 reads, 25 kb), one iteration, run_cns."""
    lay = os.path.join(GOLD, "smoke.ref.lay")
    ju = [u for u in jcns.parse_lay_file(lay) if u.name == "utg1"]
    tu = [u for u in tcns.parse_lay_file(lay) if u.name == "utg1"]
    j = jcns.run_cns(ju, jcns.CnsParams(n_iter=1))
    t = tcns.run_cns(tu, tcns.CnsParams(n_iter=1), device="cpu")
    assert [n for n, _ in t] == [n for n, _ in j] == ["utg1"]
    assert np.array_equal(j[0][1], t[0][1])


@pytest.mark.slow
def test_full_golden_matches_jax():
    """All four unitigs of smoke.ref.lay, six iterations (reference -n)."""
    lay = os.path.join(GOLD, "smoke.ref.lay")
    j = jcns.run_cns(jcns.parse_lay_file(lay), jcns.CnsParams(n_iter=6))
    t = tcns.run_cns(tcns.parse_lay_file(lay), tcns.CnsParams(n_iter=6),
                     device="cpu")
    assert [n for n, _ in t] == [n for n, _ in j]
    for (_, a), (_, b) in zip(j, t):
        assert np.array_equal(a, b)


def small_unit(mod):
    """A 3 kb unitig at 8x of reads 600 bp and longer, of different
    lengths (so the JAX package's checkpoint keeps colmap16 1-D)."""
    rng = np.random.default_rng(31)
    g = random_genome(rng, 3000)
    names, seqs = simulate_reads(g, coverage=8, mean_len=1200, err=0.1,
                                 seed=32, min_len=600)
    order = np.argsort([int(n.split("_")[-2]) for n in names])
    assert len({len(s) // 16 for s in seqs}) > 1
    return mod.LayUnitig(
        name="u", reads=[np.asarray(seqs[i]) for i in order],
        offs=[int(names[i].split("_")[-2]) for i in order],
        backbone=[True] * len(order))


def test_seg_state_from_jax():
    """The JAX package's seeded _SegState, carried across, segments like
    the JAX package's; the port seeds the same column maps itself."""
    p = jcns.CnsParams()
    ju = unit_12kb(jcns.LayUnitig)
    jst = jcns._SegState(ju)
    cns = jcns._gen_backbone(ju)
    jcns._seed_colmaps(ju, jst, list(ju.offs), cns, p)
    tst = convert.seg_state_to_torch(jst.flat, jst.flat_offs, jst.lens,
                                     jst.colmap16)
    jrows = jcns._build_segments(jst, len(ju.reads), len(cns))
    trows = tcns._build_segments(tst, len(ju.reads), len(cns))
    assert jrows[0] == trows[0] and jrows[2] == trows[2]
    assert all(np.array_equal(a, b) for a, b in zip(jrows[1], trows[1]))
    own = tcns._SegState(unit_12kb())
    tcns._seed_colmaps(unit_12kb(), own, list(ju.offs), cns, tcns.CnsParams(),
                       device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(jst.colmap16, own.colmap16))


def test_msa_matches_jax():
    """asm --cns-engine poa: the port's copy of msa_unitig."""
    j = jmsa.run_msa([small_unit(jcns)])
    t = tmsa.run_msa([small_unit(tcns)])
    assert [n for n, _ in t] == [n for n, _ in j] == ["u"]
    assert np.array_equal(j[0][1], t[0][1])


def _src(mod, name):
    """Source of mod.name, the JAX package's relative imports written as
    the port's absolute ones."""
    return inspect.getsource(getattr(mod, name)).replace(
        "from ..", "from smartdenovo_tpu.")


def _changed(j, t):
    jl, tl = j.splitlines(), t.splitlines()
    assert len(jl) == len(tl)
    return [(a, b) for a, b in zip(jl, tl) if a != b]


def _tail(src, first):
    lines = src.splitlines()
    return "\n".join(lines[lines.index(first):])


def test_copied_code_equals_sources():
    for name in ("LayUnitig", "units_from_graph",
                 "parse_lay_file", "_gen_backbone", "_pad_tier",
                 "_build_segments", "_cigar_pieces", "write_cns"):
        assert _src(tcns, name) == _src(jcns, name), name
    # _SegState takes pad_pow2 from the module's imports (ops/flatseeds.py)
    assert _src(tcns, "_SegState") == _src(jcns, "_SegState").replace(
        "        from .zmo import pad_pow2 as _pp2\n\n", "").replace(
        "_pp2(", "pad_pow2(")
    # CnsParams: the copy gives batch_reads' reason on the H100 in its
    # comment; every field and default is the source's
    j, t = _src(jcns, "CnsParams"), _src(tcns, "CnsParams")
    cut, after = "    batch_reads: int = 64 ", "    max_zmer_per_read"
    assert j.split(cut)[0] == t.split(cut)[0]
    assert j.split(after)[1] == t.split(after)[1]
    assert (dataclasses.astuple(tcns.CnsParams())
            == dataclasses.astuple(jcns.CnsParams()))
    for name in ("MsaParams", "msa_unitig", "run_msa"):
        assert _src(tmsa, name) == _src(jmsa, name), name
    for name in ("SEGR", "S_OVL", "S_STRIDE", "S_LBW", "S_W", "S_T",
                 "S_WMARG"):
        assert getattr(tcns, name) == getattr(jcns, name), name
    assert np.array_equal(tcns._BASE_BIT, jcns._BASE_BIT)
    assert np.array_equal(tcns._GAP_CHR, jcns._GAP_CHR)
    # the stitcher: the JAX _seg_align_pass from its first stitch line on
    first = "    fallbacks = 0"
    assert (_tail(_src(tcns, "_stitch_reads"), first)
            == _tail(_src(jcns, "_seg_align_pass"), first))
    # the seeding differs only where the device is passed
    assert _changed(_src(jcns, "_seed_colmaps"), _src(tcns, "_seed_colmaps")) == [
        ("                  batch: int = 512):",
         "                  batch: int = 512, *, device):"),
        ("        anchors = _anchor_reads(reads, windows, p, doffs)",
         "        anchors = _anchor_reads(reads, windows, p, doffs, device)")]
    # the anchoring's host half: the packing before the device call and
    # the median-diagonal filter after it
    j, t = _src(jcns, "_anchor_reads"), _src(tcns, "_anchor_reads")
    cut = "        wlen[i] = len(win)"
    assert (j.split(cut)[0].split("\n", 1)[1]
            == t.split(cut)[0].split("\n", 1)[1])
    assert _tail(t, "    anchors = []") == _tail(j, "    anchors = []")
