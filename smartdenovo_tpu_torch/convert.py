"""Carry the JAX package's overlap and consensus state across to the port.

The state of the overlapper is the two `FlatSeeds` (k16 candidate seeds,
z10 matcher seeds) and the `DeviceIndexes`.  Given as numpy arrays (for
example `np.asarray` of each field of the JAX NamedTuples), `state_to_torch`
returns the port's tensors on a device, so a test can feed the identical
index to both packages.  uint32 k-mer codes become int64 (ops/seeds.py);
every other field keeps its dtype.

The state of the consensus segment engine is `_SegState` (the read bank
flattened, its offsets and lengths, one column map per read): host numpy
in both packages, so `seg_state_to_torch` only copies it into the port's
class."""

from __future__ import annotations

import numpy as np
import torch

from .ops.flatseeds import DeviceIndexes, FlatSeeds

# fields that are uint32 in the JAX package and int64 in the port
_U32_FIELDS = {"kmer", "k_kmers"}


def _to_torch(name, arr, device):
    a = np.array(arr, order="C")   # a writable copy; 0-d stays 0-d
    if name in _U32_FIELDS:
        a = a.astype(np.uint32).astype(np.int64)
    return torch.from_numpy(a).to(device)


def _to_numpy(name, t):
    a = t.detach().cpu().numpy()
    if name in _U32_FIELDS:
        a = a.astype(np.uint32)
    return a


def state_to_torch(k16, z10, didx, device):
    """(FlatSeeds, FlatSeeds, DeviceIndexes) of numpy-convertible fields
    -> the port's NamedTuples of tensors on `device`."""
    def conv(cls, src):
        return cls(**{f: _to_torch(f, getattr(src, f), device)
                      for f in cls._fields})

    return conv(FlatSeeds, k16), conv(FlatSeeds, z10), conv(DeviceIndexes, didx)


def state_to_numpy(k16, z10, didx):
    """Inverse of `state_to_torch`: fields as numpy arrays in the JAX
    package's dtypes, as dicts keyed by field name."""
    def conv(src):
        return {f: _to_numpy(f, getattr(src, f)) for f in src._fields}

    return conv(k16), conv(z10), conv(didx)


def seg_state_to_torch(flat, flat_offs, lens, colmap16):
    """The JAX package's `_SegState` fields as numpy arrays (colmap16: a
    list of int arrays or None per read) -> the port's `_SegState`."""
    from .pipeline.cns import _SegState

    st = _SegState.__new__(_SegState)
    st.flat = np.array(flat, np.uint8)
    st.flat_offs = np.array(flat_offs, np.int64)
    st.lens = np.array(lens, np.int64)
    st.colmap16 = [None if c is None else np.array(c, np.int64)
                   for c in colmap16]
    return st
