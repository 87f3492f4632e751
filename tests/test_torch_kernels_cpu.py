"""The plain PyTorch versions of the three kernels against the JAX
package's Pallas kernels in interpret mode and against the repo's numpy
oracles (tests/test_sseg.py, test_jpost.py, test_pexpand.py): streams
that cross tiles, the max_per_read cap, the all-neutral "first" lane and
overflowing output budgets.  Exact comparisons throughout.  The CUDA
kernels are held against these plain versions in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from smartdenovo_tpu.ops import jpost as jjpost
from smartdenovo_tpu.ops import pexpand as jpexpand
from smartdenovo_tpu.ops import sseg as jsseg
from smartdenovo_tpu_torch.ops import jpost, pexpand, sseg
from test_jpost import mkstream
from test_jpost import oracle as jpost_oracle
from test_pexpand import oracle as pexpand_oracle
from test_sseg import oracle as sseg_oracle

torch.set_num_threads(1)

I32_MAX = (1 << 31) - 1
OPS = ("sum", "min", "min", "max", "max", "first", "first", "first")


@pytest.fixture(autouse=True)
def interpret_mode():
    old = (jsseg.INTERPRET, jjpost.INTERPRET, jpexpand.INTERPRET)
    jsseg.INTERPRET = jjpost.INTERPRET = jpexpand.INTERPRET = True
    yield
    jsseg.INTERPRET, jjpost.INTERPRET, jpexpand.INTERPRET = old


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K1 sseg


def _sseg_stream(seed, T, nt):
    rng = np.random.default_rng(seed)
    N = T * nt
    seg_new = (rng.random(N) < 0.02).astype(np.int32)
    seg_new[0] = 1
    seg_new[N // 2: N // 2 + T + 7] = 0       # a run across tile boundaries
    v8 = rng.integers(0, 1 << 17, (8, N)).astype(np.int32)
    v8[0] = rng.integers(-100, 1 << 10, N)
    v8[5:7] = rng.integers(0, 1 << 27, (2, N))
    v8[7, N - 3 * T // 2:] = I32_MAX           # a dead tail on a "first" lane
    return seg_new, v8


@pytest.mark.parametrize("seed,T,nt", [(1, 256, 3), (2, 256, 1), (3, 512, 2)])
def test_sseg_plain_matches_pallas_and_oracle(seed, T, nt):
    seg_new, v8 = _sseg_stream(seed, T, nt)
    exp = sseg_oracle(seg_new, v8)
    n = exp.shape[1]
    jout, jcnt = jsseg.seg_reduce_compact(seg_new, v8, ops=OPS,
                                          out_budget=max(T, 1024), tile=T)
    out, cnt = sseg.seg_reduce_compact(_t(seg_new), _t(v8), ops=OPS,
                                       out_budget=max(T, 1024))
    assert int(cnt) == int(jcnt) == n
    assert np.array_equal(out[:, :n].numpy(), exp.astype(np.int32))
    assert np.array_equal(out[:, :n].numpy(), np.asarray(jout)[:, :n])


def test_sseg_first_lane_neutral_and_overflow():
    """All-neutral "first" lane stays INT32_MAX; with fewer output columns
    than segments the kept records are the first ones and the count still
    reports every segment."""
    T = 256
    N = 2 * T
    seg_new = np.zeros(N, np.int32)
    seg_new[[0, 5, 100, 300, 301, 400]] = 1
    rng = np.random.default_rng(9)
    v8 = rng.integers(-50, 50, (8, N)).astype(np.int32)
    v8[5] = I32_MAX
    exp = sseg_oracle(seg_new, v8)
    out, cnt = sseg.seg_reduce_compact(_t(seg_new), _t(v8), ops=OPS,
                                       out_budget=1024)
    assert int(cnt) == 6
    assert (out[5, :6].numpy() == I32_MAX).all()
    assert np.array_equal(out[:, :6].numpy(), exp)
    out, cnt = sseg.seg_reduce_compact(_t(seg_new), _t(v8), ops=OPS,
                                       out_budget=4)
    assert int(cnt) == 6 and out.shape == (8, 4)
    assert np.array_equal(out.numpy(), exp[:, :4])


def test_sseg_cuda_specializes_main_path_ops():
    """csrc/sseg.cu compiles exactly the main path's lane-op sets with
    their ops known: its opcode(...) constants are sseg.MAIN_PATH_OPS."""
    import os
    import re

    src = os.path.join(os.path.dirname(sseg.__file__), os.pardir, "csrc",
                       "sseg.cu")
    with open(src) as fh:
        consts = re.findall(
            r"constexpr int OPS_\w+ = opcode\(([\d, ]+)\);", fh.read())
    names = ("sum", "min", "max", "first")
    compiled = {sseg.opcode([names[int(c)] for c in args.split(",")])
                for args in consts}
    assert len(consts) == 3
    assert compiled == {sseg.opcode(ops) for ops in sseg.MAIN_PATH_OPS}


# ---------------------------------------------------------------- K2 jpost


def _check_jpost(key, pay, aux, mpr, out_budget, tile=256):
    recs, total = jpost_oracle(key, pay, aux, mpr)
    out, nem, tot = jpost.join_emitters(_t(key), _t(pay), _t(aux),
                                        max_per_read=mpr, out_budget=out_budget)
    assert int(nem) == len(recs) and int(tot) == total
    n = min(len(recs), out_budget)
    exp = np.array(recs, np.int64).reshape(-1, 4).T[:, :n]
    assert out.shape == (4, out_budget)
    assert np.array_equal(out[:, :n].numpy(), exp)
    if out_budget >= len(recs) + tile + 128:
        jout, jnem, jtot = jjpost.join_emitters(
            key, pay, aux, max_per_read=mpr, out_budget=out_budget, tile=tile)
        jout = np.asarray(jout)
        assert (int(jnem), int(jtot)) == (int(nem), int(tot))
        # the JAX kernel's rows 4-7 are its zero padding
        assert np.array_equal(jout[:4, :n], out[:, :n].numpy())
        assert (jout[4:, :n] == 0).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jpost_plain_matches_pallas_and_oracle(seed):
    key, pay, aux = mkstream(np.random.default_rng(seed), 2048)
    _check_jpost(key, pay, aux, 16, 1024)


def test_jpost_cross_tile_runs_and_cap():
    """A run straddling tiles, and groups at and under max_per_read."""
    N = 1024
    key = np.full(N, I32_MAX, np.int32)
    pay = np.arange(N, dtype=np.int32) * 3
    aux = np.arange(N, dtype=np.int32) + 7
    key[0:250] = 2 << 1
    key[250:253] = 7 << 1
    key[253:703] = (7 << 1) | 1
    key[703:707] = 9 << 1             # 4 occurrences: dropped at mpr=4
    key[707] = (9 << 1) | 1
    key[708:710] = 11 << 1
    key[710:712] = (11 << 1) | 1
    _check_jpost(key, pay, aux, 4, 1024)
    _check_jpost(key, pay, aux, 16, 1024)


def test_jpost_overflow_keeps_counts():
    key, pay, aux = mkstream(np.random.default_rng(5), 2048)
    _check_jpost(key, pay, aux, 16, 37)


# ---------------------------------------------------------------- K3 pexpand


@pytest.mark.parametrize("seed,pb", [(1, 2048), (2, 2048), (3, 700)])
def test_pexpand_plain_matches_pallas_and_oracle(seed, pb):
    """pb=700 truncates: slots past the budget are dropped."""
    rng = np.random.default_rng(seed)
    NE = 1024
    ne = int(rng.integers(NE // 4, NE // 2))
    cnt = np.zeros(NE, np.int32)
    cnt[:ne] = rng.integers(1, 15, ne)
    cnt[np.cumsum(cnt) > 2048 - 16] = 0
    cnt[int(np.argmax(cnt == 0)):] = 0
    pay = rng.integers(-(1 << 30), 1 << 30, NE).astype(np.int32)
    aux = rng.integers(0, 1 << 17, NE).astype(np.int32)
    base = rng.integers(-(1 << 24), 1 << 24, NE).astype(np.int32)
    ocg, oav, obv, total = pexpand_oracle(cnt, pay, aux, base, pb)
    got = pexpand.expand_emit(_t(cnt), _t(pay), _t(aux), _t(base), pair_budget=pb)
    m = min(total, pb)
    for g, o in zip(got, (ocg, oav, obv)):
        assert g.shape == (pb,)
        assert np.array_equal(g[:m].numpy(), o[:m])
        assert (g[m:] == 0).all()
    if pb % 128 == 0:
        jgot = jpexpand.expand_emit(cnt, pay, aux, base, pair_budget=pb, tile=128)
        for g, j in zip(got, jgot):
            assert np.array_equal(g[:m].numpy(), np.asarray(j)[:m])
