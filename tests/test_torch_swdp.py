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
