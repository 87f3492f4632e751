"""Whole-bank flat seed extraction + the posting index build
(port of smartdenovo_tpu/ops/flatseeds.py).

The bank is one flat [T] array: homopolymer compaction, rolling k-mers,
canonicalisation and validity are 1-D masked scans, and both posting
indexes are sorted and filtered on the device.  Field layouts and values
are those of the JAX package; uint32 k-mer codes ride in int64 (see
ops/seeds.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .flatops import (arange32, cumsum32, lexsort_perm, scatter_set,
                      segment_sum, shift_right)
from .seeds import revcomp_kmer_u32, subsample_mask

I32 = torch.int32
SENT_U32 = 0xFFFFFFFF
RM_BLK = 128  # read-major slice alignment of the z-mer index


def pad_pow2(n: int, lo: int = 1 << 12) -> int:
    """Pad to quarter-power-of-two tiers (1, 1.25, 1.5, 1.75 x pow2).

    Budget widths are copied from the JAX package so that every budget,
    and with it every overflow decision, is the same."""
    n = max(n, lo)
    p = 1 << (n - 1).bit_length()
    step = max(p // 8, 128)
    return (n + step - 1) // step * step


class FlatSeeds(NamedTuple):
    kmer: torch.Tensor        # [T] int64 canonical code (SENT where invalid)
    aux: torch.Tensor         # [T] int32 off<<9 | min(span,255)<<1 | dir
    valid: torch.Tensor       # [T] bool
    comp_rd: torch.Tensor     # [T] int32 read id of compressed position
    comp_start: torch.Tensor  # [Npad+1] int32 per-read compressed CSR
    total: torch.Tensor       # 0-d int32 total compressed positions


class DeviceIndexes(NamedTuple):
    """Both overlap indexes + stats (fields as in the JAX package)."""

    k_kmers: torch.Tensor   # [T] int64 k16 codes, (kmer, rd, dir) sorted
    k_rd: torch.Tensor      # [T] int32
    k_dir: torch.Tensor     # [T] int8
    rm_zsd: torch.Tensor    # [Tz] int32 zmer<<9|span<<1|dir, (rd, zmer) sorted
    rm_pk: torch.Tensor     # [Tz] int32 off<<9|span<<1|dir
    rm_rd: torch.Tensor     # [Tz] int32 read id per posting
    rm_start: torch.Tensor  # [Npad+1] int32 RM_BLK-aligned CSR
    rm_cnt: torch.Tensor    # [Npad] int32 live postings per read
    stats: torch.Tensor     # [5*Npad+4] int32 (layout: JAX DeviceIndexes)


def flat_seeds(flat: torch.Tensor, offsets: torch.Tensor, ksize: int,
               hz: bool = True) -> FlatSeeds:
    """Canonical hpc k-mers for every read of the bank at once.

    flat:    [T] uint8 base codes (PAD=4 beyond the live prefix)
    offsets: [Npad+1] int32 read start offsets (trailing entries = total)
    """
    dev = flat.device
    T = flat.shape[0]
    pos = arange32(T, dev)
    mark = segment_sum(torch.ones(offsets.shape[0] - 1, dtype=I32, device=dev),
                       offsets[1:], T)
    rd_of = cumsum32(mark)
    base = flat.to(I32)
    inb = base < 4
    prev = shift_right(base, -1)
    new_read = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          rd_of[1:] != rd_of[:-1]])
    keep = inb & ((base != prev) | new_read) if hz else inb
    cidx = cumsum32(keep) - 1
    total = cidx[-1] + 1
    dst = torch.where(keep, cidx, T)

    def scat(vals):
        return scatter_set(T, dst, vals, 0)

    comp_seq = scat(base)
    comp_raw = scat(pos)
    Npad = offsets.shape[0] - 1
    cpos = arange32(T, dev)
    comp_rd = torch.where(cpos < total, scat(rd_of), Npad)
    ccnt = segment_sum(keep.to(I32), rd_of, Npad)
    comp_start = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                            cumsum32(ccnt)])
    kmer = torch.zeros(T, dtype=torch.int64, device=dev)
    for t in range(ksize):
        shifted = torch.cat([comp_seq[t:], torch.zeros(t, dtype=I32, device=dev)])
        kmer = ((kmer << 2) & 0xFFFFFFFF) | shifted.to(torch.int64)
    krev = revcomp_kmer_u32(kmer, ksize)
    direction = krev <= kmer
    canon = torch.minimum(kmer, krev)
    last = (cpos + ksize - 1).clamp(0, T - 1)
    same_read = (comp_rd[last] == comp_rd) & (cpos + ksize - 1 < T)
    exists = (cpos < total) & same_read
    valid = exists & (krev != kmer)
    read_beg = offsets[comp_rd.clamp(0, Npad - 1)]
    off = comp_raw - read_beg
    span = comp_raw[last] + 1 - comp_raw
    aux = torch.where(
        valid,
        (off << 9) | (span.clamp(max=255) << 1) | direction.to(I32),
        0)
    return FlatSeeds(
        kmer=torch.where(valid, canon, SENT_U32),
        aux=aux,
        valid=valid,
        comp_rd=torch.where(cpos < total, comp_rd, Npad),
        comp_start=comp_start,
        total=total,
    )


def build_indexes_device(k16: FlatSeeds, z10: FlatSeeds, *, ksave: int = 4,
                         max_kmer_freq: int = 0, max_zmer_freq: int = 16,
                         zbits: int = 20) -> DeviceIndexes:
    """Sort + filter both posting indexes on the device.

    k16 follows wtzmo.c:380-418 (auto cutoff = 5x the average depth of
    distinct kmers when max_kmer_freq < 2; singleton and high-frequency
    kmers dropped); z10 follows hzm_aln.h:107 ((read, zmer) groups with
    >= max_zmer_freq occurrences dropped)."""
    dev = k16.kmer.device
    T = k16.kmer.shape[0]
    Npad = k16.comp_start.shape[0] - 1
    one = torch.ones(1, dtype=torch.bool, device=dev)
    # ---- k16 candidate index ----
    kval = k16.valid & subsample_mask(k16.kmer, ksave)
    kk = torch.where(kval, k16.kmer, SENT_U32)
    krdpk = (k16.comp_rd << 1) | (k16.aux & 1)
    perm = torch.sort(kk, stable=True).indices
    kk, krdpk = kk[perm], krdpk[perm]
    live = kk != SENT_U32
    n_post = live.to(I32).sum(dtype=I32)
    new = torch.cat([one, kk[1:] != kk[:-1]]) & live
    gid = cumsum32(new) - 1
    n_distinct = torch.clamp(gid[-1] + 1, min=1)
    freq = segment_sum(live.to(I32), torch.where(live, gid, T), T)
    myfreq = freq[gid.clamp(0, T - 1)]
    kavg = torch.clamp(torch.div(n_post, n_distinct, rounding_mode="floor"),
                       min=20)
    if max_kmer_freq >= 2:
        cutoff = torch.tensor(max_kmer_freq, dtype=I32, device=dev)
    else:
        cutoff = torch.clamp(kavg * 5, min=100)
    keepk = live & (myfreq > 1) & (myfreq <= cutoff)
    kdst = torch.where(keepk, cumsum32(keepk) - 1, T)
    kk2 = scatter_set(T, kdst, kk, SENT_U32, dtype=torch.int64)
    krdpk2 = scatter_set(T, kdst, krdpk, 0)
    k_rd = krdpk2 >> 1
    myfreq2 = torch.where(keepk, myfreq, 0)
    kneed = segment_sum(myfreq2, torch.where(keepk, krdpk >> 1, Npad), Npad)
    # ---- z10 read-major index ----
    zval = z10.valid
    zkey1 = torch.where(zval, z10.comp_rd, Npad + 1)
    zkey2 = torch.where(zval, z10.kmer.to(I32), 0x7FFFFFFF)
    perm = lexsort_perm([zkey1, zkey2])
    zk1, zk2, zaux = zkey1[perm], zkey2[perm], z10.aux[perm]
    zlive = zk1 <= Npad
    gnew = torch.cat([one, (zk1[1:] != zk1[:-1]) | (zk2[1:] != zk2[:-1])]) & zlive
    zgid = cumsum32(gnew) - 1
    gcnt = segment_sum(zlive.to(I32), torch.where(zlive, zgid, T), T)
    mycnt = gcnt[zgid.clamp(0, T - 1)]
    keepz = zlive & (mycnt < max_zmer_freq)
    zrd = torch.where(keepz, zk1, Npad)
    zcnt_per_rd = segment_sum(keepz.to(I32), zrd, Npad)
    asz = (zcnt_per_rd + (RM_BLK - 1)) // RM_BLK * RM_BLK
    zero1 = torch.zeros(1, dtype=I32, device=dev)
    rm_start = torch.cat([zero1, cumsum32(asz)])
    lstart = torch.cat([zero1, cumsum32(zcnt_per_rd)])
    Tz = T + Npad * RM_BLK
    shift = rm_start[:-1] - lstart[:-1]
    zdst = cumsum32(keepz) - 1
    zdst = torch.where(keepz, zdst + shift[zrd.clamp(0, Npad - 1)], Tz)
    SENT_ZSD = 1 << (zbits + 9)
    rm_zsd = scatter_set(Tz, zdst, (zk2 << 9) | ((zaux & 0x1FF) >> 1 << 1)
                         | (zaux & 1), SENT_ZSD)
    rm_pk = scatter_set(Tz, zdst, zaux, 0)
    rm_rd = scatter_set(Tz, zdst, zk1, Npad)
    zspace = 1 << zbits
    zfreq = segment_sum(torch.ones_like(zk2),
                        torch.where(keepz, zk2.clamp(max=zspace), zspace),
                        zspace + 1)
    gfreq = torch.where(keepz, zfreq[zk2.clamp(0, zspace)], 0)
    cross_per_rd = segment_sum(gfreq, zrd, Npad)
    comp_len = k16.comp_start[1:] - k16.comp_start[:-1]
    kprobes = segment_sum(kval.to(I32), k16.comp_rd, Npad)
    stats = torch.cat([
        zcnt_per_rd, kneed, kprobes, comp_len, cross_per_rd,
        torch.stack([comp_len.max(), cutoff.to(I32), n_post.to(I32),
                     (new & keepk).to(I32).sum(dtype=I32)]),
    ])
    return DeviceIndexes(
        k_kmers=kk2, k_rd=k_rd, k_dir=(krdpk2 & 1).to(torch.int8),
        rm_zsd=rm_zsd, rm_pk=rm_pk, rm_rd=rm_rd,
        rm_start=rm_start, rm_cnt=zcnt_per_rd, stats=stats,
    )


def build_bank_indexes(flat, offsets, *, ksize: int, zsize: int,
                       hz: bool = True, ksave: int = 4, max_kmer_freq: int = 0,
                       max_zmer_freq: int = 16, zbits: int = 20):
    """Both seed extractions + the index build."""
    k16 = flat_seeds(flat, offsets, ksize, hz)
    z10 = flat_seeds(flat, offsets, zsize, hz)
    didx = build_indexes_device(
        k16, z10, ksave=ksave, max_kmer_freq=max_kmer_freq,
        max_zmer_freq=max_zmer_freq, zbits=zbits)
    return k16, z10, didx


def gather_query_rows(seeds: FlatSeeds, rids: torch.Tensor, Lc: int):
    """[Q, Lc] query seed rows (kmer, off, span, dir, valid) in per-read
    compressed-position space."""
    Npad = seeds.comp_start.shape[0] - 1
    r = rids.clamp(0, Npad - 1)
    base = seeds.comp_start[r]
    cnt = seeds.comp_start[r + 1] - base
    j = arange32(Lc, rids.device)[None, :]
    idx = (base[:, None] + j).clamp(0, seeds.kmer.shape[0] - 1)
    inrow = j < cnt[:, None]
    kmer = torch.where(inrow, seeds.kmer[idx], SENT_U32)
    aux = torch.where(inrow, seeds.aux[idx], 0)
    valid = inrow & seeds.valid[idx]
    return kmer, aux >> 9, (aux >> 1) & 0xFF, (aux & 1).to(torch.bool), valid
