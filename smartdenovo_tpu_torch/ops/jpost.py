"""Join-matcher emitter extraction: kernel K2
(port of the Pallas kernel smartdenovo_tpu/ops/jpost.py join_emitters).

After the join sort, every candidate entry needs its run's
query-occurrence count and its output placement.  On a CUDA tensor
`join_emitters` launches csrc/jpost.cu; on a CPU tensor it runs the plain
PyTorch version, the scan family of the JAX `fill` branch
(smartdenovo_tpu/ops/dotmatrix.py:386-398) followed by a compaction.
"""

from __future__ import annotations

import torch

from ..kernels import _build
from .flatops import cumsum32, shift_right

I32_MAX = (1 << 31) - 1


def join_emitters(key: torch.Tensor, pay: torch.Tensor, aux: torch.Tensor,
                  *, max_per_read: int, out_budget: int):
    """Dense emitter records from the sorted join stream.

    key: [N] int32 sorted (q<<zb+1 | zmer<<1 | side), INT32_MAX pad;
    pay, aux: [N] int32 payloads.  Returns (records [4, out_budget] int32,
    n_emitters 0-d int32, total_slots 0-d int32).  Record rows: 0 = qcnt,
    1 = pay, 2 = aux, 3 = query-table base (rs - ost2); the JAX kernel's
    rows 4-7 are its zero padding and are not kept.  Columns >= n_emitters
    are unspecified; emitters past out_budget are dropped (n_emitters still
    counts them)."""
    if key.device.type == "cuda":
        return _join_emitters_cuda(key, pay, aux, max_per_read, out_budget)
    if key.device.type == "cpu":
        return join_emitters_plain(key, pay, aux, max_per_read=max_per_read,
                                   out_budget=out_budget)
    raise ValueError(f"join_emitters: unsupported device {key.device}")


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


def _join_emitters_cuda(key, pay, aux, max_per_read, out_budget):
    N = key.shape[0]
    for t in (key, pay, aux):
        if t.dtype != torch.int32 or t.shape != (N,) or t.device != key.device:
            raise ValueError(f"join_emitters: bad input {t.shape} {t.dtype} "
                             f"{t.device}")
    if not 1 <= N < 1 << 30 or out_budget < 1:
        # the kernel packs its tile counts in 30 bits
        raise ValueError(f"join_emitters: N={N} out_budget={out_budget}")
    key, pay, aux = key.contiguous(), pay.contiguous(), aux.contiguous()
    dev = key.device
    lib = _build.lib()
    out = torch.empty((4, out_budget), dtype=torch.int32, device=dev)
    totals = torch.empty(2, dtype=torch.int32, device=dev)
    # the tile counter and each tile's two look-back words
    scratch = torch.empty(lib.jpost_scratch_ints(N), dtype=torch.int32,
                          device=dev)
    _build.LAUNCHES["jpost"] += 1
    _build.check(lib.jpost_join_emitters(
        key.data_ptr(), pay.data_ptr(), aux.data_ptr(), N, max_per_read,
        out_budget, out.data_ptr(), totals.data_ptr(), scratch.data_ptr(),
        _build.stream_of(key)), "jpost_join_emitters")
    return out, totals[0], totals[1]
