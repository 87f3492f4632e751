"""Seed hashing, strand bit math and the legacy per-batch seed extraction
(port of smartdenovo_tpu/ops/seeds.py; wtgbo's rescue aligner, the
legacy k-mer and z-mer indexes, wtmer and the dot plot use
`extract_seeds` and `compact_seed_batch`; the numpy twins are copies:
`np_canonical_kmers`, which wtcorr's DBG build uses, `extract_seeds_np`,
the scan loop of wtzmo.c:255-276 that the tests hold the extractor to,
and `np_jenkins_u32`).

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


def extract_seeds(batch: torch.Tensor, lengths: torch.Tensor, ksize: int,
                  hz: bool = True) -> dict:
    """Canonical homopolymer-compressed k-mers of a padded [B, L] base
    batch, in compressed-position space (entry i: the k-mer starting at
    the i-th homopolymer run).

    Returns a dict of [B, L] tensors: kmer (int64 holding the uint32
    canonical code, 0xFFFFFFFF where not valid), dir (bool, the canonical
    form is the reverse complement), off (int32 raw start), span (int32
    raw covered length, hzm_aln.h:101-103), valid (bool: inside the read
    and not a palindrome); and n_comp [B] int32 compressed lengths."""
    B, L = batch.shape
    dev = batch.device
    i32 = torch.int32
    pos = torch.arange(L, dtype=i32, device=dev)[None, :]
    inbounds = pos < lengths.to(i32)[:, None]
    base = batch.to(i32)
    if hz:
        prev = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev),
                          base[:, :-1]], 1)
        keep = inbounds & (base != prev)
    else:
        keep = inbounds
    comp_idx = torch.cumsum(keep.to(i32), 1, dtype=i32) - 1
    n_comp = comp_idx[:, -1] + 1
    scatter_idx = torch.where(keep, comp_idx, L).long()
    # compressed codes and raw offsets of each run start; kept positions of
    # a row have distinct targets, the rest go to the junk column L
    comp_seq = torch.zeros((B, L + 1), dtype=i32, device=dev)
    comp_seq.scatter_(1, scatter_idx, base)
    comp_seq = comp_seq[:, :L]
    hzoff = torch.zeros((B, L + 1), dtype=i32, device=dev)
    hzoff.scatter_(1, scatter_idx, pos.expand(B, L).contiguous())
    hzoff = hzoff[:, :L]
    # rolling k-mer codes: kmer[i] packs comp_seq[i..i+k) MSB-first, uint32
    kmer = torch.zeros((B, L), dtype=torch.int64, device=dev)
    for t in range(ksize):
        shifted = torch.cat([comp_seq[:, t:],
                             torch.zeros((B, t), dtype=i32, device=dev)], 1)
        kmer = ((kmer << 2) & MASK32) | (shifted.to(torch.int64) & MASK32)
    krev = revcomp_kmer_u32(kmer, ksize)
    direction = krev <= kmer     # revcomp canonical; == is a palindrome
    canon = torch.minimum(kmer, krev)
    exists = pos + ksize <= n_comp[:, None]
    palin = krev == kmer
    valid = exists & ~palin
    last_run = torch.cat([hzoff[:, ksize - 1:],
                          torch.zeros((B, ksize - 1), dtype=i32, device=dev)], 1)
    span = torch.where(valid, last_run + 1 - hzoff, 0)
    return {
        "kmer": torch.where(valid, canon, MASK32),
        "dir": direction & valid,
        "off": hzoff,
        "span": span,
        "valid": valid,
        "n_comp": n_comp,
    }


def compact_seed_batch(batch, lengths, rids, ksize: int, hz: bool = True,
                       ksave: int = 0, with_pos: bool = False):
    """Extract seeds and compact the valid ones to the front of flat
    arrays.

    Returns (kmer [B*L] int64 uint32 codes, aux [B*L] int32, total 0-d)
    where aux packs rd<<1|dir (with_pos=False), or (kmer, aux, rd, total)
    with aux = off<<9|min(span,255)<<1|dir (with_pos=True).  Entries past
    total are 0."""
    res = extract_seeds(batch, lengths, ksize, hz)
    valid = res["valid"]
    if ksave > 1:
        valid = valid & subsample_mask(res["kmer"], ksave)
    B, L = valid.shape
    N = B * L
    dev = batch.device
    v = valid.reshape(-1)
    dst = torch.cumsum(v.to(torch.int32), 0, dtype=torch.int32) - 1
    total = dst[-1] + 1
    dst = torch.where(v, dst, N).long()

    def scat(vals, dtype=torch.int32):
        out = torch.zeros(N + 1, dtype=dtype, device=dev)
        out[dst] = vals.reshape(-1).to(dtype)
        return out[:N]

    rd_of = rids.to(torch.int32)[:, None].expand(B, L)
    d = res["dir"].to(torch.int32)
    kc = scat(res["kmer"], torch.int64)
    if with_pos:
        aux = ((res["off"] << 9) | (torch.clamp(res["span"], max=255) << 1)
               | d)
        return kc, scat(aux), scat(rd_of), total
    aux = (rd_of << 1) | d
    return kc, scat(aux), total


def extract_seeds_np(seq, ksize: int, hz: bool = True):
    import numpy as np

    mask = (1 << (2 * ksize)) - 1
    kmer = 0
    b = -1
    hzoff = []
    out = []
    i = 0
    for j, c in enumerate(seq):
        c = int(c)
        if hz and c == b:
            continue
        b = c
        i += 1
        hzoff.append(j)
        kmer = ((kmer << 2) | c) & mask
        if i < ksize:
            continue
        # revcomp
        rc = 0
        t = kmer
        for _ in range(ksize):
            rc = (rc << 2) | (3 - (t & 3))
            t >>= 2
        if rc == kmer:
            continue
        d = 0 if rc > kmer else 1
        canon = min(kmer, rc)
        off = hzoff[i - ksize]
        out.append((canon, d, off, j + 1 - off))
    return out


def np_canonical_kmers(batch, lengths, ksize: int, hz: bool = True):
    """Numpy twin of extract_seeds returning only (codes, valid) — used by
    the host to size expansion budgets exactly without a device sync."""
    import numpy as np

    B, L = batch.shape
    base = batch.astype(np.int64)
    pos = np.arange(L)[None, :]
    inb = pos < lengths[:, None]
    if hz:
        prev = np.concatenate([np.full((B, 1), -1), base[:, :-1]], axis=1)
        keep = inb & (base != prev)
    else:
        keep = inb
    comp_idx = np.cumsum(keep, axis=1) - 1
    n_comp = comp_idx[:, -1] + 1
    comp = np.zeros((B, L + 1), np.int64)
    rows = np.broadcast_to(np.arange(B)[:, None], (B, L))
    sidx = np.where(keep, comp_idx, L)
    comp[rows, sidx] = base
    comp = comp[:, :L]
    kmer = np.zeros((B, L), np.uint64)
    for t in range(ksize):
        shifted = np.concatenate([comp[:, t:], np.zeros((B, t), np.int64)], axis=1)
        kmer = (kmer << np.uint64(2)) | shifted.astype(np.uint64)
    mask = np.uint64((1 << (2 * ksize)) - 1)
    kmer &= mask
    # revcomp via bit ops
    x = (~kmer) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x & np.uint64(0x3333333333333333)) << np.uint64(2)) | ((x & np.uint64(0xCCCCCCCCCCCCCCCC)) >> np.uint64(2))
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | ((x & np.uint64(0xF0F0F0F0F0F0F0F0)) >> np.uint64(4))
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | ((x & np.uint64(0xFF00FF00FF00FF00)) >> np.uint64(8))
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | ((x & np.uint64(0xFFFF0000FFFF0000)) >> np.uint64(16))
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    rc = x >> np.uint64(64 - 2 * ksize)
    canon = np.minimum(kmer, rc)  # uint64: supports k>16 (DBG correction)
    cpos = np.arange(L)[None, :]
    valid = (cpos + ksize <= n_comp[:, None]) & (kmer != rc)
    return canon, valid


def np_jenkins_u32(key):
    """Numpy twin of jenkins_hash_u32."""
    import numpy as np

    key = key.astype(np.uint32)
    key = key + (key << np.uint32(12))
    key ^= key >> np.uint32(22)
    key = key + (key << np.uint32(4))
    key ^= key >> np.uint32(9)
    key = key + (key << np.uint32(10))
    key ^= key >> np.uint32(2)
    key = key + (key << np.uint32(7))
    key ^= key >> np.uint32(12)
    return key
