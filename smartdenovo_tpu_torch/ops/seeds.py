"""Seed hashing and strand bit math (port of smartdenovo_tpu/ops/seeds.py).

torch has no uint32 arithmetic, so uint32 k-mer codes and hashes are
carried in int64 tensors holding values in [0, 2^32): every left shift
and add is masked back to 32 bits, and right shifts of non-negative
int64 values are the logical shifts of uint32.  The sentinel 0xFFFFFFFF
therefore still sorts after every real code.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def jenkins_hash_u32(key: torch.Tensor) -> torch.Tensor:
    """__lh3_Jenkins_hash_int (reference hashset.h:452-462) on uint32 values."""
    key = key.to(torch.int64) & MASK32
    key = (key + (key << 12)) & MASK32
    key = key ^ (key >> 22)
    key = (key + (key << 4)) & MASK32
    key = key ^ (key >> 9)
    key = (key + (key << 10)) & MASK32
    key = key ^ (key >> 2)
    key = (key + (key << 7)) & MASK32
    key = key ^ (key >> 12)
    return key


def revcomp_kmer_u32(kmer: torch.Tensor, ksize: int) -> torch.Tensor:
    """Reverse complement of a 2-bit packed k-mer (k <= 16), dna.h:85-97."""
    x = (~kmer.to(torch.int64)) & MASK32
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x << 16) & MASK32) | (x >> 16)
    return x >> (32 - (ksize << 1))


def subsample_mask(kmer: torch.Tensor, ksave: int,
                   kmer_mod: int = 1024) -> torch.Tensor:
    """Deterministic 1/ksave k-mer subsampling (wtzmo.c:270-271)."""
    if ksave <= 1:
        return torch.ones(kmer.shape, dtype=torch.bool, device=kmer.device)
    h = jenkins_hash_u32(kmer) % (kmer_mod * ksave)
    return h < kmer_mod
