"""Flat-array primitives shared by the overlap ops
(port of smartdenovo_tpu/ops/flatops.py, plus the scatter, segment and
sort helpers that stand in for JAX's `.at[]`, `segment_*` and
multi-key `lax.sort`)."""

from __future__ import annotations

import torch

I32 = torch.int32


def arange32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum (torch widens integer cumsums by default)."""
    return torch.cumsum(x.to(I32), 0, dtype=I32)


def scatter_set(size: int, idx: torch.Tensor, vals: torch.Tensor, fill,
                dtype=I32) -> torch.Tensor:
    """`jnp.full(size + 1, fill).at[idx].set(vals, mode="drop")[:size]`.

    Indices outside [0, size) land in the junk slot `size`, the only slot
    that may receive several writes (whose winner is unspecified on CUDA);
    every caller keeps its live targets unique."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=idx.device)
    idx = torch.where((idx >= 0) & (idx < size), idx, size).to(torch.int64)
    out[idx] = vals.to(dtype)
    return out[:size]


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.ops.segment_sum` with out-of-range ids dropped (integer adds,
    so the result does not depend on the order of the atomics)."""
    idx = torch.where((ids >= 0) & (ids < n), ids, n).to(torch.int64)
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:n]


def shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """[fill, x[0], ..., x[-2]] — the previous element of every position."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """[x[1], ..., x[-1], fill] — the next element of every position."""
    return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype,
                                        device=x.device)])


def _pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One int64 key ordered like the int32 pair (a, b)."""
    return (a.to(torch.int64) << 32) + (b.to(torch.int64) + (1 << 31))


def sort_pairs(a: torch.Tensor, b: torch.Tensor):
    """The int32 pairs (a, b) sorted lexicographically, as (a, b)."""
    k = torch.sort(_pack2(a, b)).values
    return (k >> 32).to(I32), ((k & 0xFFFFFFFF) - (1 << 31)).to(I32)


def lexsort_perm(keys) -> torch.Tensor:
    """Permutation of the stable lexicographic sort over `keys` (most
    significant first) — `jax.lax.sort(..., num_keys=len(keys))`.

    int32 keys are packed two to an int64 key; the packed groups are then
    sorted with stable sorts from the least significant group up."""
    groups = []
    i = 0
    while i < len(keys):
        k = keys[i]
        if (k.dtype == I32 and i + 1 < len(keys)
                and keys[i + 1].dtype == I32):
            groups.append(_pack2(k, keys[i + 1]))
            i += 2
        else:
            groups.append(k)
            i += 1
    perm = None
    for g in reversed(groups):
        if perm is None:
            perm = torch.sort(g, stable=True).indices
        else:
            perm = perm[torch.sort(g[perm], stable=True).indices]
    return perm


def expand_ranges(cnt: torch.Tensor, budget: int):
    """Budgeted expansion of variable-length ranges.

    cnt: [N] int32 items per source.  Returns (src [budget] int32 source
    per output slot (clipped), within [budget] int32 offset inside the
    source, alive [budget] bool, total 0-d int32)."""
    dev = cnt.device
    cum = cumsum32(cnt)
    total = cum[-1]
    starts = cum - cnt
    n = cnt.shape[0]
    idx = torch.where(cnt > 0, starts.clamp(0, budget), budget).to(torch.int64)
    mark = torch.zeros(budget + 1, dtype=I32, device=dev)
    mark.scatter_reduce_(0, idx, torch.arange(1, n + 1, dtype=I32, device=dev),
                         reduce="amax")
    src = torch.cummax(mark[:budget], 0).values - 1
    src_c = src.clamp(0, n - 1)
    p = arange32(budget, dev)
    within = p - starts[src_c]
    alive = (p < total) & (src >= 0)
    return src_c, within, alive, total


def bounded_bisect(values: torch.Tensor, probes: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor, steps: int) -> torch.Tensor:
    """Lower bound of probes within per-probe ranges [lo, hi) of `values`."""
    n = values.shape[0]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        mv = values[mid.clamp(0, n - 1)]
        go = (mv < probes) & (mid < hi)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, torch.where(mid < hi, mid, hi))
    return lo
