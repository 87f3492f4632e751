"""Plain PyTorch versions of the overlapper's three hand kernels (K1
sorted-segment reduce, K2 join emitters, K3 pair expansion), frozen
copies of the plain versions in smartdenovo_tpu_torch/ops/{sseg,jpost,
pexpand}.py, run on whatever device their tensors are on."""

from __future__ import annotations

import torch

from .flatops import cumsum32, shift_right

I32_MAX = (1 << 31) - 1
I32_MIN = -(1 << 31)

_OPCODE = {"sum": 0, "min": 1, "max": 2, "first": 3}
# The main path's lane-op sets.  csrc/sseg.cu compiles each of them with
# its ops known (sseg_specialized); any other set reads its ops at run time
# and runs slower.
CAND_OPS = ("sum",) + ("first",) * 7          # candidate scan groups
BLOCK_OPS = ("sum", "min", "min", "max", "max", "first", "sum", "first")
DEFAULT_OPS = ("sum", "min", "min", "max", "max", "first", "first", "first")
MAIN_PATH_OPS = (CAND_OPS, BLOCK_OPS, DEFAULT_OPS)  # DEFAULT_OPS: windows


def _neutral(op: str) -> int:
    return {"sum": 0, "min": I32_MAX, "max": I32_MIN, "first": I32_MAX}[op]


def seg_reduce_compact(seg_new, v8, *, ops=DEFAULT_OPS, out_budget: int):
    return seg_reduce_compact_plain(seg_new, v8, ops=ops, out_budget=out_budget)


def seg_reduce_compact_plain(seg_new, v8, *, ops=DEFAULT_OPS, out_budget: int):
    """Plain PyTorch version: segment scatters at dense segment ids."""
    N = v8.shape[1]
    dev = v8.device
    flag = seg_new.reshape(-1) != 0
    flag[0] = True
    seg = torch.cumsum(flag, 0) - 1
    count = (seg[-1] + 1).to(torch.int32)
    idx = torch.where(seg < out_budget, seg, out_budget)
    out = torch.empty((8, out_budget), dtype=torch.int32, device=dev)
    pos = torch.arange(N, dtype=torch.int64, device=dev)
    for lane, op in enumerate(ops):
        v = v8[lane]
        r = torch.full((out_budget + 1,), _neutral(op), dtype=torch.int32,
                       device=dev)
        if op == "sum":
            r.index_add_(0, idx, v)
        elif op in ("min", "max"):
            r.scatter_reduce_(0, idx, v, reduce="a" + op)
        else:
            fpos = torch.full((out_budget + 1,), N, dtype=torch.int64,
                              device=dev)
            fpos.scatter_reduce_(0, idx, torch.where(v != I32_MAX, pos, N),
                                 reduce="amin")
            r = torch.where(fpos < N, v[fpos.clamp(max=N - 1)], I32_MAX)
        out[lane] = r[:out_budget]
    return out, count


def join_emitters(key, pay, aux, *, max_per_read: int, out_budget: int):
    return join_emitters_plain(key, pay, aux, max_per_read=max_per_read,
                               out_budget=out_budget)


def join_emitters_plain(key, pay, aux, *, max_per_read: int, out_budget: int):
    """Plain PyTorch version (the JAX fill branch's scans + compaction)."""
    svalid = key != I32_MAX
    tag1 = svalid & ((key & 1) == 1)
    tag0 = (svalid & ((key & 1) == 0)).to(torch.int32)
    grp = key >> 1
    run_new = grp != shift_right(grp, 0)
    run_new[0] = True
    pre0 = cumsum32(tag0) - tag0
    pre0_rs = torch.cummax(torch.where(run_new, pre0, -1), 0).values
    qcnt = pre0 - pre0_rs
    cnt2 = torch.where(tag1 & (qcnt > 0) & (qcnt < max_per_read), qcnt, 0)
    cum2 = cumsum32(cnt2)
    total2 = cum2[-1]
    ost2 = cum2 - cnt2
    em = torch.nonzero(cnt2 > 0).reshape(-1)
    nem = torch.tensor(em.shape[0], dtype=torch.int32, device=key.device)
    em = em[:out_budget]
    out = torch.zeros((4, out_budget), dtype=torch.int32, device=key.device)
    n = em.shape[0]
    out[0, :n] = cnt2[em]
    out[1, :n] = pay[em]
    out[2, :n] = aux[em]
    out[3, :n] = (pre0_rs - ost2)[em]
    return out, nem, total2


def expand_emit(cnt, pay, aux, base, *, pair_budget: int):
    return expand_emit_plain(cnt, pay, aux, base, pair_budget=pair_budget)


def expand_emit_plain(cnt, pay, aux, base, *, pair_budget: int):
    """Plain PyTorch version."""
    c = cnt.to(torch.int64)
    outs = []
    for v in (pay, aux, base):
        r = torch.repeat_interleave(v, c)[:pair_budget]
        if r.shape[0] < pair_budget:
            r = torch.cat([r, torch.zeros(pair_budget - r.shape[0],
                                          dtype=torch.int32, device=v.device)])
        outs.append(r)
    return tuple(outs)
