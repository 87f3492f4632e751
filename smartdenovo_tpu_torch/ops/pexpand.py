"""Segmented n x m co-occurrence expansion: kernel K3
(port of the Pallas kernel smartdenovo_tpu/ops/pexpand.py expand_emit).

Each emitter's three payloads are replicated over its contiguous run of
output slots.  On a CUDA tensor `expand_emit` launches csrc/pexpand.cu
(the cumsum of the counts and a merge-path expansion); on a CPU tensor it
runs the plain PyTorch version (repeat_interleave).
"""

from __future__ import annotations

import torch

from ..kernels import _build


def expand_emit(cnt: torch.Tensor, pay: torch.Tensor, aux: torch.Tensor,
                base: torch.Tensor, *, pair_budget: int):
    """Replicate emitter payloads over their output runs.

    cnt: [NE] int32 >= 0 slots per emitter (emitter e's run starts at the
    exclusive cumsum); pay, aux, base: [NE] int32.  Returns (pay, aux, base)
    each [pair_budget] int32; slots at or past the total are 0."""
    if cnt.device.type == "cuda":
        return _expand_emit_cuda(cnt, pay, aux, base, pair_budget)
    if cnt.device.type == "cpu":
        return expand_emit_plain(cnt, pay, aux, base, pair_budget=pair_budget)
    raise ValueError(f"expand_emit: unsupported device {cnt.device}")


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


def _expand_emit_cuda(cnt, pay, aux, base, pair_budget):
    NE = cnt.shape[0]
    for t in (cnt, pay, aux, base):
        if t.dtype != torch.int32 or t.shape != (NE,) or t.device != cnt.device:
            raise ValueError(f"expand_emit: bad input {t.shape} {t.dtype} "
                             f"{t.device}")
    if NE < 1 or pair_budget < 1:
        raise ValueError(f"expand_emit: NE={NE} pair_budget={pair_budget}")
    cnt, pay, aux, base = (t.contiguous() for t in (cnt, pay, aux, base))
    out = torch.empty((3, pair_budget), dtype=torch.int32, device=cnt.device)
    lib = _build.lib()
    # the scan's tile words and the merge-path cuts
    scratch = torch.empty(lib.pexpand_scratch_ints(NE, pair_budget),
                          dtype=torch.int32, device=cnt.device)
    _build.LAUNCHES["pexpand"] += 1
    _build.check(lib.pexpand_expand_emit(
        cnt.data_ptr(), pay.data_ptr(), aux.data_ptr(), base.data_ptr(),
        NE, pair_budget, out.data_ptr(), scratch.data_ptr(),
        _build.stream_of(cnt)), "pexpand_expand_emit")
    return out[0], out[1], out[2]
