"""The port's global NW DP (smartdenovo_tpu_torch/ops/swdp.py) against the
JAX package's ops/swdp.py on the CPU: the plain anti-diagonal loop's
scores and direction planes byte for byte, the host traceback, and
tests/test_dagcns.py's three-iteration consensus loop, whose consensus
codes must be the JAX package's at every iteration.  Every comparison
is exact (integers and bytes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartdenovo_tpu.ops import swdp as jswdp
from smartdenovo_tpu.utils.native import DagCns as JDagCns
from smartdenovo_tpu.utils.simulate import mutate_read
from smartdenovo_tpu_torch.ops import banded as tbanded
from smartdenovo_tpu_torch.ops import swdp as tswdp
from smartdenovo_tpu_torch.utils.native import DagCns as TDagCns
from test_torch_cuda import nw_pairs

torch.set_num_threads(1)


def _both(a, b, alen, blen, L, **kw):
    js, jd = jswdp.batch_global_align(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(alen), jnp.asarray(blen),
                                      max_len=L, **kw)
    ts, td = tswdp.batch_global_align(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(alen),
                                      torch.from_numpy(blen), max_len=L, **kw)
    return (np.asarray(js), np.asarray(jd)), (ts.numpy(), td.numpy())


@pytest.mark.parametrize("L,scores", [
    (64, {}), (97, dict(match=1, mismatch=-2, gap=-2)), (128, {})])
def test_global_align_plain_equals_jax(L, scores):
    a, b, alen, blen = nw_pairs(np.random.default_rng(L), 24, L)
    (js, jd), (ts, td) = _both(a, b, alen, blen, L, **scores)
    assert td.shape == (24, 2 * L + 1, L + 1) and td.dtype == np.uint8
    assert np.array_equal(ts, js)
    assert np.array_equal(td, jd)
    # the first three pairs are pure gaps: gap * (alen + blen)
    gap = scores.get("gap", -3)
    assert list(ts[:3]) == [7 * gap, 5 * gap, 0]
    assert (td != 0).sum() > 0


def test_traceback_equals_jax():
    L = 80
    a, b, alen, blen = nw_pairs(np.random.default_rng(5), 16, L)
    (_js, jd), (_ts, td) = _both(a, b, alen, blen, L)
    jt = jswdp.traceback_batch(jd, alen, blen)
    tt = tswdp.traceback_batch(td, alen, blen)
    assert tt == jt
    for k, (ops, counts) in enumerate(tt):
        ra, rb = tswdp.align_strings(a[k], b[k], ops, counts)
        ja, jb = jswdp.align_strings(a[k], b[k], ops, counts)
        assert np.array_equal(ra, ja) and np.array_equal(rb, jb)
        assert len(ra) >= max(alen[k], blen[k])
    assert tswdp.align_strings is tbanded.align_strings


def test_dag_loop_equals_jax():
    """tests/test_dagcns.py::test_noisy_reads_converge on both packages:
    the same consensus codes after every iteration, and the bars of that
    test (identity > 0.97 and better than the backbone)."""
    from difflib import SequenceMatcher

    from smartdenovo_tpu_torch.data.readbank import codes_to_seq

    rng = np.random.default_rng(44)
    truth = rng.integers(0, 4, 200).astype(np.uint8)
    backbone = mutate_read(rng, truth, 0.08)
    reads = [mutate_read(rng, truth, 0.10) for _ in range(12)]
    L = 256
    cns = {"jax": backbone, "port": backbone}
    for _it in range(3):
        for side in ("jax", "port"):
            g = (JDagCns if side == "jax" else TDagCns)()
            g.set_backbone(cns[side])
            B = len(reads)
            a = np.full((B, L), 4, np.uint8)
            b = np.full((B, L), 4, np.uint8)
            alen = np.zeros(B, np.int32)
            blen = np.zeros(B, np.int32)
            for i, r in enumerate(reads):
                a[i, : len(cns[side])] = cns[side]
                alen[i] = len(cns[side])
                b[i, : len(r)] = r
                blen[i] = len(r)
            if side == "jax":
                _s, dirs = jswdp.batch_global_align(
                    jnp.asarray(a), jnp.asarray(b), jnp.asarray(alen),
                    jnp.asarray(blen), max_len=L)
                cigs = jswdp.traceback_batch(np.asarray(dirs), alen, blen)
                strings = jswdp.align_strings
            else:
                _s, dirs = tswdp.batch_global_align(
                    torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(alen), torch.from_numpy(blen), max_len=L)
                cigs = tswdp.traceback_batch(dirs.numpy(), alen, blen)
                strings = tswdp.align_strings
            for i, (ops, counts) in enumerate(cigs):
                a0, a1 = strings(a[i], b[i], ops, counts)
                g.add_alignment(0, int(alen[i]), a0, a1)
            g.merge_nodes()
            cns[side], _mp, _sc = g.consensus()
        assert np.array_equal(cns["port"], cns["jax"])

    def ident(x, y):
        return SequenceMatcher(None, codes_to_seq(x), codes_to_seq(y),
                               autojunk=False).ratio()

    assert ident(cns["port"], truth) > 0.97
    assert ident(cns["port"], truth) > ident(backbone, truth)


@pytest.mark.parametrize("B", [1, 24, 528, 2048])
def test_nw_shape_covers_rows_within_limits(B):
    """For every L from 1 to the register instance's top, nw_shape's
    (P, warps, pairs) covers the L + 1 rows with no strip left empty, P is
    a compiled instance, the block stays within the registers its launch
    bound gives (~3 P + 30 a thread of the SM's 65,536), its 1,024
    threads and 15 named barriers, and its shared memory (b with its
    128-byte margins and the ring) within the 48 KB a launch takes without an
    attribute; past the top nw_plan takes the wide instance."""
    top = tswdp.NW_REG_MAX_L
    assert top >= 4096
    seen = set()
    for L in range(1, top + 1):
        P, warps, pairs = tswdp.nw_shape(L, B)
        assert P in tswdp.NW_PS
        assert 32 * P * warps >= L + 1 > 32 * P * (warps - 1)
        assert warps * pairs <= tswdp.nw_max_warps(P)
        assert (3 * P + 30) * 32 * warps * pairs <= 65536
        assert warps == 1 or pairs <= 15
        smem = pairs * ((L + 256 + 3) // 4 * 4) + pairs * 2 * warps * 4
        assert smem <= 48 * 1024
        assert tswdp.nw_plan(L, B) == ("register", P, warps, pairs)
        seen.add(P)
        if B * warps < tswdp.NW_FILL_WARPS and warps > 1:
            assert P >= tswdp.NW_MIN_P
    assert tswdp.nw_shape(top + 1, B) is None
    assert tswdp.nw_plan(top + 1, B) == ("wide", True)
    assert tswdp.nw_plan(19_370, B) == ("wide", False)
    if B == 2048:
        assert seen == set(tswdp.NW_PS)


def test_nw_shape_at_the_callers():
    """The shapes of the two callers: phase 3's batch (one warp a pair,
    P 17, 8 pairs a block) and the DAG loop's (17 warps of P 4)."""
    assert tswdp.nw_plan(512, 2048) == ("register", 17, 1, 8)
    assert tswdp.nw_plan(2048, 24) == ("register", 4, 17, 1)
