"""Sorted-segment reduce + compact: kernel K1
(port of the Pallas kernel smartdenovo_tpu/ops/sseg.py seg_reduce_compact).

The dot-matrix aligner and the candidate scan collapse SORTED streams
into per-segment records: coverage sums, bounding boxes, owning pair ids.
`seg_reduce_compact` does it in one call: on a CUDA tensor it launches
the hand-written kernel of csrc/sseg.cu; on a CPU tensor it runs the
plain PyTorch version below, which mirrors the JAX package's `fill`
branches (segment scatters at dense segment ids).
"""

from __future__ import annotations

import torch

from ..kernels import _build

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


def opcode(ops) -> int:
    """The lane ops packed 2 bits a lane, as the CUDA kernel takes them."""
    code = 0
    for lane, op in enumerate(ops):
        code |= _OPCODE[op] << (2 * lane)
    return code


def seg_reduce_compact(seg_new: torch.Tensor, v8: torch.Tensor, *,
                       ops: tuple = DEFAULT_OPS, out_budget: int):
    """Reduce a sorted-segment stream to compacted per-segment records.

    seg_new: [N] int32/bool, nonzero where a segment starts (entry 0
    always starts one).  v8: [8, N] int32 value lanes; lane l is reduced by
    ops[l] in ("sum", "min", "max", "first").  "first" keeps the first
    value that is not INT32_MAX (the repo's oracle, tests/test_sseg.py).
    The Pallas kernel keeps the leftmost value inside a tile instead; the
    two rules agree on every stream the callers build, whose "first" lanes
    are all live or all INT32_MAX within a segment.

    Returns (out [8, out_budget] int32, count 0-d int32): one record per
    segment in stream order; columns >= count are unspecified.  count >
    out_budget means records were dropped (the caller redispatches)."""
    assert len(ops) == 8 and all(o in _OPCODE for o in ops)
    if v8.device.type == "cuda":
        return _seg_reduce_cuda(seg_new, v8, ops, out_budget)
    if v8.device.type == "cpu":
        return seg_reduce_compact_plain(seg_new, v8, ops=ops,
                                        out_budget=out_budget)
    raise ValueError(f"seg_reduce_compact: unsupported device {v8.device}")


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


def _seg_reduce_cuda(seg_new, v8, ops, out_budget):
    seg_new = seg_new.reshape(-1)
    N = v8.shape[1]
    if seg_new.dtype != torch.int32:
        seg_new = seg_new.to(torch.int32)
    if (v8.dtype != torch.int32 or v8.dim() != 2 or v8.shape[0] != 8
            or seg_new.shape[0] != N or N < 1 or out_budget < 1):
        raise ValueError(f"seg_reduce_compact: bad inputs {seg_new.shape} "
                         f"{v8.shape} {v8.dtype} out_budget={out_budget}")
    if seg_new.device != v8.device:
        raise ValueError("seg_reduce_compact: inputs on different devices")
    seg_new = seg_new.contiguous()
    v8 = v8.contiguous()
    dev = v8.device
    lib = _build.lib()
    out = torch.empty((8, out_budget), dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    # tile counter, tile status words, tile aggregates and prefixes
    scratch = torch.empty(lib.sseg_scratch_ints(N), dtype=torch.int32,
                          device=dev)
    _build.LAUNCHES["sseg"] += 1
    _build.check(lib.sseg_reduce_compact(
        seg_new.data_ptr(), v8.data_ptr(), N, opcode(ops), out_budget,
        out.data_ptr(), count.data_ptr(), scratch.data_ptr(),
        _build.stream_of(v8)), "sseg_reduce_compact")
    return out, count[0]
