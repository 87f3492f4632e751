"""All-vs-all overlap stage — equivalent of `wtzmo` (port of
smartdenovo_tpu/pipeline/zmo.py): the dot-matrix engine (`wtzmo -U`, dm)
and the SW engine (wtzmo without -U, sw).

The bank goes to the device once; seeds for the whole bank are extracted
flat and both posting indexes are built there.  Phase 1 scans candidates
batch by batch; the host then fetches the exact phase-2 sizes, picks
budgets (and, with matcher "auto", the sweep or join matcher) per chunk of
batches, and phase 2 matches z-mers and chains blocks batch by batch.
Batches that overflow a budget are recomputed at a bigger one, and the
host replays the reference's sequential emission (nbest early stop
wtzmo.c:806-807, attempted-pair ledger :813-820) in batch order, a batch
a call of native/emitdm.cpp (`_emit_dm`).

The SW engine runs the same phases 1-2, then, per batch, the banded local
DP on the top `align_cap` chains of each query (ops/zmo_sw.py, over
csrc/swlocal.cu on the card); its emission filters on the DP's score and
matches, and the accepted overlaps of each batch get their CIGARs and
mat/mis/ins/del from a traceback banded alignment (`_attach_cigars`,
csrc/banded.cu; with `refine`, -n, csrc/refine.cu).

Budgets, tiers, the matcher pick and the emission are the JAX package's,
so the overlap records are the same record for record.  Stage times are
logged as "stage <name>: <seconds>s".
"""

from __future__ import annotations

import dataclasses
import gc
import itertools

import numpy as np
import torch

from ..data.readbank import ReadBank
from ..utils.log import log
from ..utils.native import EmitDm, cigar_segments, cigar_strings
from ..utils.timing import span, split_line

from ..ops.align import banded_runs, pad_tier, run_lists
from ..ops.banded import align_strings
from ..ops.candidates import scan_candidates
from ..ops.dotmatrix import (dot_matrix_align, extract_zmer_pairs_join,
                             extract_zmer_pairs_sweep,
                             extract_zmer_pairs_vtab)
from ..ops.flatseeds import build_bank_indexes, gather_query_rows, pad_pow2
from ..ops.refine import refine_alignment_batch
from ..ops.seeds import subsample_mask
from ..ops.zmo_sw import sw_align_batch

INT32_MAX = np.int32(0x7FFFFFFF)
# batches share budget tiers and the matcher pick in chunks of this many
# (pow2 decomposition, as the JAX package's scan_chunk default)
CHUNK = 16


@dataclasses.dataclass
class ZmoParams:
    # seeding (wtzmo defaults, wtzmo.c:1536-1588; dmo pipeline overrides)
    ksize: int = 16
    zsize: int = 10
    hz: bool = True
    ksave: int = 4            # -S subsampling
    max_kmer_freq: int = 0    # -K 0 => auto 5x avg depth
    max_zmer_freq: int = 64   # -Z (dmo: 16) per-read zmer cap
    kvar: int = 2             # -l max span difference of matched zmers
    kovl: int = 300           # -d min kmer covered len for a candidate
    ztot: int = 300           # -r min total zmer seeding region
    ncand: int = 500          # -A (dmo: 1000)
    dm_cand: int = 0          # dot-matrix candidate width; 0 = ncand
    nbest: int = 100          # -B
    min_score: int = 200      # -s
    min_id: float = 0.5       # -m (dmo: 0.1)
    max_unalign_dovetail: int = 200
    len_ratio: float = 1.2
    # dot matrix (wtzmo.c:1583-1588, -U -1 defaults)
    xvar: int = 128
    yvar: int = 64
    min_block_len: int = 160
    max_overhang: int = 256
    deviation_penalty: float = 1.0
    gap_penalty: float = 0.05
    # batching / budgets, sized from the dataset stats; "field parity":
    # read by no code, the JAX package's fields (gbo's are GboParams')
    batch_q: int = 64
    gparts: int = 1           # -G: index the bank in G read-block passes
                              #   (parallel/gpass.py; dm engine only)
    cand_budget: int = 1 << 20          # read by no code (field parity)
    expand_budget: int = 1 << 22        # read by no code (field parity)
    expand_budget_cap: int = 1 << 26    # hard memory ceiling
    pair_budget: int = 1 << 20          # read by no code (field parity)
    nb: int = 32
    matcher: str = "auto"     # "auto" = per-chunk pick of sweep vs join by
                              #   exact expansion mass; "sweep"; "join";
                              #   "vtab" (direct-addressed zmer table; never
                              #   picked by auto); -G runs the sweep alone
    # SW (zmo) engine
    engine: str = "dm"        # "dm" = dot-matrix (-U), "sw" = banded local DP
    sw_match: int = 2         # -M
    sw_mismatch: int = -5     # -X
    sw_gap: int = -3          # -O
    band_w: int = 256         # band width around the chain diagonal
    align_cap: int = 64       # chains aligned per query per batch (SW engine)
    emit_cigar: bool = True   # attach real CIGARs + mat/mis/ins/dl to SW
                              # overlaps
    refine: bool = False      # -n: affine refine pass around each SW hit's
                              # CIGAR before emission (wtzmo.c:1031-1033)

    @classmethod
    def dmo(cls, **kw) -> "ZmoParams":
        """smartdenovo.pl dmo engine flags: -k 16 -z 10 -Z 16 -U -1 -m 0.1 -A 1000."""
        d = dict(max_zmer_freq=16, min_id=0.1, ncand=1000, engine="dm")
        d.update(kw)
        return cls(**d)

    @classmethod
    def zmo(cls, **kw) -> "ZmoParams":
        """smartdenovo.pl zmo engine flags: wtzmo -s 200 -m 0.6 (SW mode)."""
        d = dict(min_id=0.6, min_score=200, ncand=500, engine="sw")
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass
class Overlap:
    """One 17-column overlap record (README-tools.md:119-139)."""

    rid1: int
    dir1: int
    beg1: int
    end1: int
    rid2: int
    dir2: int
    beg2: int
    end2: int
    score: int
    identity: float
    mat: int
    mis: int
    ins: int
    dl: int
    aln: int
    cigar: str = "0M"

    def to_tsv(self, names, lengths) -> str:
        return (
            f"{names[self.rid1]}\t{'+-'[self.dir1]}\t{lengths[self.rid1]}\t{self.beg1}\t{self.end1}"
            f"\t{names[self.rid2]}\t{'+-'[self.dir2]}\t{lengths[self.rid2]}\t{self.beg2}\t{self.end2}"
            f"\t{self.score}\t{self.identity:.3f}\t{self.mat}\t{self.mis}\t{self.ins}\t{self.dl}"
            f"\t{self.cigar}"
        )


def resolve_device(device) -> torch.device:
    """The requested device; CUDA must be present when asked for (no
    fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# ---------------------------------------------------------------------------
# device pipeline
# ---------------------------------------------------------------------------


def _cand_core(rids, qlens, qskip, k16, didx, read_lens,
               *, Q, Lc, A, Adm, cbud, kq, ksave, kovl, len_ratio):
    """Phase 1 for one batch: the sorted top-Adm candidate table and the
    batch's exact phase-2 sizes."""
    n = read_lens.shape[0]
    dev = rids.device
    qk, qoff, qspan, qdir, qvalid = gather_query_rows(k16, rids, Lc)
    kvalid = qvalid & subsample_mask(qk, ksave)
    sup0 = torch.zeros((Q, 0), dtype=torch.int32, device=dev)
    supc0 = torch.zeros((Q,), dtype=torch.int32, device=dev)
    cands, ols, cand_total, probe_total = scan_candidates(
        qk, qoff, qspan, kvalid, rids, qlens, qskip,
        didx.k_kmers, didx.k_rd, didx.k_dir, read_lens,
        sup0, supc0, budget=cbud, ncand=A, kovl=kovl, len_ratio=len_ratio,
        probe_budget=kq,
    )
    cands_dm = cands[:, :Adm]
    key = torch.where(cands_dm < 0, int(INT32_MAX), cands_dm)
    order = torch.argsort(key, dim=1, stable=True)
    csorted = torch.take_along_dim(key, order, 1)
    osorted = torch.take_along_dim(ols[:, :Adm], order, 1)
    # exact zmer-expansion need of phase 2: sum of candidates' rm counts
    c = csorted.clamp(0, n - 1)
    zneed = torch.where(csorted < n, didx.rm_start[c + 1] - didx.rm_start[c],
                        0).sum(dtype=torch.int32)
    live_cands = (csorted < n).sum(dtype=torch.int32)
    sizes = torch.stack([zneed, cand_total.to(torch.int32),
                         probe_total.to(torch.int32), live_cands])
    return csorted, osorted, sizes


def _pair_core(rids, qlens, csorted, z10, didx, read_lens,
               *, Q, Lc, Adm, mb, pb, nbk, qkb, nb, kvar, zbits,
               max_per_read, xvar, yvar, min_block_len, max_overhang,
               deviation_penalty, gap_penalty, matcher="sweep", cx=0,
               pd=None, max_len=1 << 17):
    """Phase 2 for one batch: z-mer matching (sweep, vtab or join) and
    the dot-matrix chain."""
    n = read_lens.shape[0]
    dev = rids.device
    if matcher == "sweep":
        pairs = extract_zmer_pairs_sweep(
            rids, torch.zeros(Q, dtype=torch.bool, device=dev), csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_rd, didx.rm_start, read_lens,
            didx.rm_cnt,
            cross_budget=cx or pb, occ_budget=mb, kvar=kvar, zbits=zbits,
            pair_budget=pb if cx else None,
        )
    elif matcher == "vtab":
        pairs = extract_zmer_pairs_vtab(
            rids, csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_start, read_lens, didx.rm_cnt,
            expand_budget=mb, pair_budget=pb, qm_budget=qkb, kvar=kvar,
            zbits=zbits, max_per_read=max_per_read,
        )
    else:
        zk, zoff, zspan, zdir, zvalid = gather_query_rows(z10, rids, Lc)
        pairs = extract_zmer_pairs_join(
            zk, zdir, zoff, zspan, zvalid, csorted,
            didx.rm_zsd, didx.rm_pk, didx.rm_start, read_lens,
            expand_budget=mb, pair_budget=pb, kvar=kvar, zbits=zbits,
            max_per_read=max_per_read, qprobe_budget=qkb,
        )
    clen_of_pair = torch.repeat_interleave(
        torch.where(csorted < n, read_lens[csorted.clamp(0, n - 1)], 0)
        .to(torch.int32).reshape(-1), 2)
    qlen_of_pair = torch.repeat_interleave(qlens.to(torch.int32), Adm * 2)
    res = dot_matrix_align(
        pairs, qlen_of_pair, clen_of_pair,
        n_pairs=Q * Adm * 2, nb=nb, xvar=xvar, yvar=yvar,
        min_block_len=min_block_len, max_overhang=max_overhang,
        deviation_penalty=deviation_penalty, gap_penalty=gap_penalty, nbk=nbk,
        pd=pd, max_len=max_len,
    )
    totals = torch.stack([
        pairs.total.to(torch.int32), pairs.expand_total.to(torch.int32),
        res.blk_total.to(torch.int32), res.row_total.to(torch.int32),
    ])
    return res, totals


def _pair_pack(res, totals):
    """One int32 row per batch, in the JAX package's pack layout."""
    return torch.cat([res.pair_id, res.score, res.tb, res.te, res.qb, res.qe,
                      res.match_cnt, totals])


def _sw_core(rids, qlens, csorted, z10, didx, read_lens, flat_bases,
             read_offs, *, C, Ltier, W, match, mismatch, gap, **st):
    """SW-engine batch: the dot-matrix chains, then the banded local DP of
    each query's top C chains.  Returns the batch's int32 pack row (cand,
    dir, chain score, score, mat, beg_a, end_a, beg_b, end_b, [Q*C] each,
    then the four budget totals), the JAX package's layout.

    The DP call is the span `zmo.swdp` (count `pairs`, its B), from the
    dot matrix's end to the DP's end: the device is waited for on both
    sides, where the DP's own duplicate check and the next batch's upload
    would wait for it anyway."""
    res, totals = _pair_core(rids, qlens, csorted, z10, didx, read_lens, **st)
    # the query batch from the flat bank on the device
    dev = rids.device
    rr = rids.clamp(0, read_lens.shape[0] - 1).long()
    lanes = torch.arange(Ltier, dtype=torch.int32, device=dev)[None, :]
    pos = read_offs[rr][:, None] + lanes
    inb = lanes < qlens[:, None]
    qbatch = torch.where(
        inb, flat_bases[pos.clamp(0, flat_bases.shape[0] - 1).long()],
        torch.tensor(4, dtype=torch.uint8, device=dev))
    _settle(dev)
    with span("zmo.swdp", pairs=2 * st["Q"] * C):
        sw = sw_align_batch(
            res.pair_id, res.score, res.tb, res.te, res.qb, res.qe,
            csorted, qbatch, qlens, flat_bases, read_offs, read_lens,
            Q=st["Q"], A=st["Adm"], C=C, Ltier=Ltier, W=W,
            match=match, mismatch=mismatch, gap=gap,
        )
        _settle(dev)
    return torch.cat([sw.cand, sw.dir, sw.chain_score, sw.score, sw.mat,
                      sw.beg_a, sw.end_a, sw.beg_b, sw.end_b, totals])


def _settle(dev: torch.device):
    """Wait for the work queued on `dev` (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _upload_bank(rb: ReadBank, device):
    """Flat device copies of the bank (quarter-pow2 tiers)."""
    n = len(rb)
    total = rb.total_bases
    T = pad_pow2(total + 1)
    Npad = pad_pow2(n, lo=1 << 8)
    flat = np.full(T, 4, np.uint8)
    flat[:total] = rb.bases
    offs = np.full(Npad + 1, total, np.int64)
    offs[: n + 1] = rb.offsets
    lens = np.zeros(Npad, np.int32)
    lens[:n] = rb.lengths
    return (torch.from_numpy(flat).to(device),
            torch.from_numpy(offs.astype(np.int32)).to(device),
            torch.from_numpy(lens).to(device), T, Npad)


def overlap_dmo(rb: ReadBank, params: ZmoParams | None = None,
                progress: bool = True, preattempted=None,
                attempted_out: list | None = None, parts: int = 1,
                part: int = 0, *, device="cuda"):
    """Run the all-vs-all overlapper (dm or sw engine) on `device`.
    Returns list[Overlap].

    preattempted: iterable of (name1, name2) pairs to skip (-L ledger);
    attempted_out: if a list, every attempted pair is appended (-9);
    parts/part: overlap only queries with index % parts == part (-P/-p).
    gparts > 1 (-G) runs the read-block passes of parallel/gpass.py.
    """
    p = params or ZmoParams.dmo()
    if p.engine not in ("dm", "sw"):
        raise ValueError(f"unknown engine {p.engine!r}")
    if p.gparts > 1:
        # the JAX package's -G path runs the dm engine whatever the engine
        # and drops the pair ledgers (ROADMAP queue 3): refuse both.  It
        # also matches with the row-form sweep whatever `matcher` says
        # (vtab included), and so does overlap_gparts
        if p.engine == "sw":
            raise NotImplementedError(
                "-G runs the dot-matrix engine only; -e sw with gparts > 1 "
                "is refused")
        if preattempted is not None or attempted_out is not None:
            raise NotImplementedError(
                "the pair ledgers (preattempted, attempted_out) are not "
                "kept under gparts > 1")
        from ..parallel.gpass import overlap_gparts

        return overlap_gparts(rb, p, progress=progress, parts=parts,
                              part=part, device=device)
    if p.matcher not in ("auto", "sweep", "join", "vtab"):
        raise ValueError(f"unknown matcher {p.matcher!r}")
    dev = resolve_device(device)
    if len(rb) == 0:
        return []
    with span("zmo.pass") as sp_pass:
        return _dm_pass(rb, p, dev, progress, preattempted,
                        attempted_out, parts, part, sp_pass)


def _dm_pass(rb, p, dev, progress, preattempted, attempted_out, parts,
             part, sp_pass):
    """One pass of the dm or sw engine inside the `zmo.pass` span
    `sp_pass`; each stage is a child span, logged as it closes."""
    n = len(rb)
    with span("zmo.index") as sp:
        flat_d, offs_d, _lens_d, T, Npad = _upload_bank(rb, dev)
        k16, z10, didx = build_bank_indexes(
            flat_d, offs_d, ksize=p.ksize, zsize=p.zsize, hz=p.hz,
            ksave=p.ksave, max_kmer_freq=p.max_kmer_freq,
            max_zmer_freq=p.max_zmer_freq, zbits=2 * p.zsize)
        stats = didx.stats.cpu().numpy()              # sync 1: index stats
        zcnt = stats[:Npad][:n].astype(np.int64)
        kneed = stats[Npad: 2 * Npad][:n].astype(np.int64)
        kprobes = stats[2 * Npad: 3 * Npad][:n].astype(np.int64)
        comp_len = stats[3 * Npad: 4 * Npad][:n].astype(np.int64)
        cross = stats[4 * Npad: 5 * Npad][:n].astype(np.int64)
        max_comp = int(stats[5 * Npad])
        distinct_kept = int(stats[5 * Npad + 3])
        # coverage estimate: compressed bases / (distinct kept kmers * ksave)
        kavg = int(comp_len.sum() // max(1, distinct_kept * p.ksave))
    if progress:
        log("indexes: %d k16 postings (freq cutoff %d), %d zmer postings, "
            "~%dx est coverage; %.1fs",
            int(stats[5 * Npad + 2]), int(stats[5 * Npad + 1]),
            int(zcnt.sum()), kavg, sp.seconds)
        log("stage index: %.3fs", sp.seconds)

    A = p.ncand
    Adm = min(p.dm_cand, A) if p.dm_cand > 0 else A
    Q = p.batch_q
    Lc = pad_pow2(max_comp, lo=1 << 10)
    qarr = np.arange(n) if parts <= 1 else np.arange(n)[part::parts]
    batches = [qarr[i: i + Q] for i in range(0, len(qarr), Q)]
    B = len(batches)
    # pow2 chunk decomposition (budget tiers and the matcher pick are per
    # chunk, as in the JAX package)
    chunks = []
    c0 = 0
    while c0 < B:
        sz = min(CHUNK, 1 << (B - c0).bit_length() - 1)
        while sz > B - c0:
            sz >>= 1
        chunks.append((c0, sz))
        c0 += sz
    sw_engine = p.engine == "sw"
    C = min(p.align_cap, Adm)
    Ltier = pad_tier(int(rb.lengths[0]) if n else 1024)
    NP = Q * Adm * 2
    read_lens_d = torch.from_numpy(rb.lengths.astype(np.int32)).to(dev)

    def batch_inputs(rids_np):
        rids = np.concatenate(
            [rids_np, np.full(Q - len(rids_np), rids_np[-1], rids_np.dtype)]
        ).astype(np.int32)
        qskip = np.zeros(Q, bool)
        qskip[len(rids_np):] = True
        qlens = rb.lengths[rids].astype(np.int32)
        return rids, qlens, qskip

    # ---- phase 1: candidates (exact budgets from the stats pack) ----
    with span("zmo.phase1", batches=B) as sp:
        cbud = min(pad_pow2(max((int(kneed[b].sum()) for b in batches),
                                default=1) + 1024, lo=1 << 14),
                   p.expand_budget_cap)
        kq = pad_pow2(max((int(kprobes[b].sum()) for b in batches),
                          default=1) + Q, lo=1 << 12)
        cand_static = dict(Q=Q, Lc=Lc, A=A, Adm=Adm, cbud=cbud, kq=kq,
                           ksave=p.ksave, kovl=p.kovl, len_ratio=p.len_ratio)
        rids_all = np.zeros((B, Q), np.int32)
        qlens_all = np.zeros((B, Q), np.int32)
        candbuf = []
        size_rows = []
        for bi, b in enumerate(batches):
            rids, qlens, qskip = batch_inputs(b)
            rids_all[bi] = rids
            qlens_all[bi] = qlens
            cs, _os, sz = _cand_core(
                torch.from_numpy(rids).to(dev),
                torch.from_numpy(qlens).to(dev),
                torch.from_numpy(qskip).to(dev), k16, didx, read_lens_d,
                **cand_static)
            candbuf.append(cs)
            size_rows.append(sz)
        # sync 2: phase-2 sizes — sizes[:, 0] is the join matcher's exact
        # expansion mass, sizes[:, 3] the live candidate count (sizes pd)
        sizes = torch.stack(size_rows).cpu().numpy()
    if progress:
        log("stage phase1: %.3fs", sp.seconds)

    # ---- phase 2: zmer match + dot-matrix at per-chunk budgets ----
    with span("zmo.phase2", chunks=len(chunks), chunks_sweep=0) as sp:
        qkb_z = pad_pow2(max((int(zcnt[rids_all[bi]].sum())
                              for bi in range(B)), default=1) + Q,
                         lo=1 << 13)
        qkb_c = pad_pow2(max((int(comp_len[b].sum()) for b in batches),
                             default=1) + Q, lo=1 << 13)
        if p.matcher in ("vtab", "sweep"):
            qkb = qkb_z
        elif p.matcher == "join":
            qkb = qkb_c
        else:
            qkb = max(qkb_z, qkb_c)
        # dense pair-row budget: live pairs <= 2 dirs x live candidate slots
        pd = pad_pow2(2 * int(sizes[:, 3].max()) + 64, lo=1 << 12)
        pair_static = dict(
            Q=Q, Lc=Lc, Adm=Adm, qkb=qkb, nb=p.nb, kvar=p.kvar,
            zbits=2 * p.zsize, max_per_read=p.max_zmer_freq, xvar=p.xvar,
            yvar=p.yvar, min_block_len=p.min_block_len,
            max_overhang=p.max_overhang,
            deviation_penalty=p.deviation_penalty,
            gap_penalty=p.gap_penalty, pd=pd, max_len=Ltier,
        )
        if sw_engine:
            pair_static.update(C=C, Ltier=Ltier, W=p.band_w,
                               match=p.sw_match, mismatch=p.sw_mismatch,
                               gap=p.sw_gap)

        def pair_budgets(zneed, matcher):
            if zneed > p.expand_budget_cap:
                log("WARNING: join expansion %d exceeds the memory cap %d; "
                    "matches will be dropped — lower batch_q", int(zneed),
                    p.expand_budget_cap)
            mb = min(pad_pow2(int(zneed) + 1024, lo=1 << 14),
                     p.expand_budget_cap)
            pb = min(pad_pow2(int(zneed) * 3 // 4 + 1024, lo=1 << 14), mb)
            nbk = pad_pow2(max(pb * 3 // 16, 1 << 14))
            return dict(mb=mb, pb=pb, nbk=nbk, cx=0, matcher=matcher)

        def sweep_budgets(bi_lo, bi_hi):
            occ = max(int(zcnt[rids_all[bi]].sum())
                      for bi in range(bi_lo, bi_hi))
            cxn = max(int(cross[rids_all[bi]].sum())
                      for bi in range(bi_lo, bi_hi))
            mb = pad_pow2(occ + Q, lo=1 << 12)
            cx = min(pad_pow2(cxn + 1024, lo=1 << 14), p.expand_budget_cap)
            if cxn + 1024 > p.expand_budget_cap:
                log("WARNING: sweep cross mass %d exceeds the memory cap %d; "
                    "matches will be dropped — use matcher='auto'", cxn,
                    p.expand_budget_cap)
            pb = max(cx // (2 if kavg >= 10 else 4), 1 << 14)
            return dict(mb=mb, cx=cx, pb=pb, nbk=max(pb // 4, 1 << 14),
                        matcher="sweep")

        def chunk_budgets(c0, sz):
            """Pick the matcher for this chunk by exact mass: the sweep's
            cross axis vs the join's candidate-posting expansion."""
            if p.matcher == "sweep":
                return sweep_budgets(c0, c0 + sz)
            if p.matcher in ("vtab", "join"):
                return pair_budgets(int(sizes[c0: c0 + sz, 0].max()),
                                    p.matcher)
            join_need = int(sizes[c0: c0 + sz, 0].max())
            cross_need = max(int(cross[rids_all[bi]].sum())
                             for bi in range(c0, c0 + sz))
            if cross_need <= join_need and cross_need < p.expand_budget_cap:
                return sweep_budgets(c0, c0 + sz)
            return pair_budgets(join_need, "join")

        def run_pair(bi, st):
            args = (torch.from_numpy(rids_all[bi]).to(dev),
                    torch.from_numpy(qlens_all[bi]).to(dev), candbuf[bi],
                    z10, didx, read_lens_d)
            if sw_engine:
                return _sw_core(*args, flat_d, offs_d, **st)
            return _pair_pack(*_pair_core(*args, **st))

        batch_static = [None] * B
        packs_d = []
        for c0, sz in chunks:
            bud = chunk_budgets(c0, sz)
            sp.counts["chunks_sweep"] += bud["matcher"] == "sweep"
            if progress and p.matcher == "auto":
                log("chunk %d: matcher=%s mb=%d pb=%d cx=%d", c0,
                    bud["matcher"], bud["mb"], bud["pb"], bud["cx"])
            for bi in range(c0, c0 + sz):
                batch_static[bi] = {**pair_static, **bud}
                packs_d.append(run_pair(bi, batch_static[bi]))
        packs = torch.stack(packs_d).cpu().numpy()        # sync 3: results
        csorted_all = torch.stack(candbuf).cpu().numpy()  # sync 4: candidates
        del packs_d
        # the live pair rows of the batches' dot matrices (packs' last total)
        sp.counts["pair_rows"] = int(packs[:, -1].sum())
    if progress:
        log("stage phase2: %.3fs", sp.seconds)

    # ---- overflow redispatch (rare; overflowing budgets grow to fit) ----
    with span("zmo.redispatch", redispatched=0, attempts=0) as sp:
        pack_rows = [packs[bi] for bi in range(B)]
        batch_pd = [pd] * B
        for bi in range(B):
            st2 = dict(batch_static[bi])
            for _attempt in range(4):
                sp.counts["attempts"] += 1
                ptot, etot, btot, rtot = (int(x) for x in pack_rows[bi][-4:])
                ov = {}
                exp_key = "cx" if st2.get("matcher") == "sweep" else "mb"
                if etot > st2[exp_key]:
                    ov[exp_key] = min(pad_pow2(etot + 1024),
                                      p.expand_budget_cap)
                    if ov[exp_key] <= st2[exp_key]:
                        log("WARNING: batch %d expansion %d exceeds the "
                            "memory cap %d; matches dropped", bi, etot,
                            p.expand_budget_cap)
                        ov.pop(exp_key)
                if ptot > st2["pb"]:
                    ov["pb"] = pad_pow2(ptot + 1024)
                # blocks past nbk were dropped (the segment reduce reports
                # them in its count)
                if btot > st2["nbk"]:
                    ov["nbk"] = pad_pow2(btot + 4096)
                    if ov["nbk"] <= st2["nbk"]:
                        ov.pop("nbk")
                # live rows are at most 2 per live candidate slot, and pd
                # is sized from that count, so no batch can exceed pd; the
                # JAX package checks it for the dm engine only, and so does
                # this
                if not sw_engine and rtot > st2["pd"]:
                    ov["pd"] = pad_pow2(rtot + 64)
                if not ov:
                    break
                st2.update(ov)
                log("budget overflow batch %d (pair %d expand %d blk %d rows "
                    "%d): redispatch", bi, ptot, etot, btot, rtot)
                sp.counts["redispatched"] += 1
                pack_rows[bi] = run_pair(bi, st2).cpu().numpy()
                batch_pd[bi] = st2.get("pd", pd)
    if progress:
        log("stage redispatch: %.3fs", sp.seconds)
        if sp.counts["redispatched"]:
            log("redispatched %d of %d overflow checks",
                sp.counts["redispatched"], sp.counts["attempts"])

    # ---- host emission (sequential reference semantics) ----
    with span("zmo.emission", candidates=0, attempted=0, native=0) as sp:
        overlaps: list[Overlap] = []
        emitted_pairs: set[tuple[int, int]] = set()
        pre_pairs: set[tuple[int, int]] = set()
        if preattempted:
            for n1, n2 in preattempted:
                i1 = rb.name2id.get(n1)
                i2 = rb.name2id.get(n2)
                if i1 is None or i2 is None:
                    continue
                pre_pairs.add((min(i1, i2), max(i1, i2)))
        rdcovs = np.zeros(n, np.int64)
        rdmask = np.zeros(n, bool)
        avg_len = rb.avg_len()
        # the SW emission's CIGARs run here, on `device`, batch by batch as
        # _emit_batch_sw would attach them (p_emit has emit_cigar off)
        p_emit = dataclasses.replace(p, emit_cigar=False)
        cig_spans = []
        em = None if sw_engine else _dm_emission(rb, p, avg_len, pre_pairs)
        for bi in range(B):
            csorted = csorted_all[bi].reshape(Q, Adm)
            if sw_engine:
                n0 = len(overlaps)
                _emit_batch_sw(rb, p_emit, rids_all[bi], pack_rows[bi],
                               csorted, Q, Adm, C, rdcovs, rdmask, overlaps,
                               emitted_pairs, pre_pairs, attempted_out,
                               avg_len)
                if p.emit_cigar and len(overlaps) > n0:
                    cig_spans.append(_attach_cigars(rb, p, overlaps[n0:],
                                                    device=dev))
            else:
                ncand, natt = _emit_dm(em, rb, rids_all[bi], pack_rows[bi],
                                       csorted, Q, Adm, rdcovs, overlaps,
                                       attempted_out, pd=batch_pd[bi])
                sp.counts["candidates"] += ncand
                sp.counts["attempted"] += natt
                sp.counts["native"] += 1
        sp.counts["records"] = len(overlaps)
    if progress:
        t_cig = sum(c.seconds for c in cig_spans)
        log("stage emission: %.3fs", sp.seconds - t_cig)
        if sw_engine and p.emit_cigar:
            log("stage cigars: %.3fs", t_cig)
            log("cigars split: %s", split_line(cig_spans))
        log("overlap done: %d overlaps in %.1fs", len(overlaps),
            sp_pass.seconds)
    return overlaps


def _dm_emission(rb, p, avg_len, pre_pairs=()) -> EmitDm:
    """The native emission state of one dm pass over `rb` with the
    overlapper's gates (native/emitdm.cpp; `pre_pairs` read-id pairs)."""
    return EmitDm(rb.lengths, zsize=p.zsize, ztot=p.ztot,
                  min_score=p.min_score, min_id=p.min_id, nbest=p.nbest,
                  avg_len=avg_len,
                  max_unalign_dovetail=p.max_unalign_dovetail,
                  pre_pairs=pre_pairs)


def _emit_dm(em, rb, rids, row, csorted, Q, A, rdcovs, overlaps,
             attempted_out, pd=None):
    """_emit_batch_dm through the pass's native emission `em`: the same
    records in the same order, coverage and attempted pairs, in one call
    (span `emit_native`); the Overlap objects are built from its arrays
    (span `records`).  Returns (candidate rows replayed, attempted rows)."""
    with span("emit_native"):
        recs, att, counts = em.batch(rids, row, csorted, Q, A, rdcovs,
                                     pd=pd,
                                     attempted=attempted_out is not None)
    with span("records"):
        if len(recs):
            (rid1, beg1, end1, rid2, dir2, beg2, end2, score,
             aln) = recs.T.tolist()
            zero = itertools.repeat(0)
            # an Overlap refers to no other object, so no cycle can form
            # while they are made: the collector, which would walk them
            # again and again as they pile up, waits until they are all made
            collecting = gc.isenabled()
            gc.disable()
            try:
                overlaps.extend(map(Overlap, rid1, zero, beg1, end1, rid2,
                                    dir2, beg2, end2, score,
                                    (recs[:, 7] / recs[:, 8]).tolist(),
                                    score, zero, zero, zero, aln))
            finally:
                if collecting:
                    gc.enable()
    if attempted_out is not None:
        # a set filled in _replay_dm's insertion order iterates in its order
        names = rb.names
        for qrid, cand in set(map(tuple, att.tolist())):
            attempted_out.append((names[qrid], names[cand]))
    return counts


# ---------------------------------------------------------------------------
# host emission: copied verbatim from smartdenovo_tpu/pipeline/zmo.py (the
# tests hold each copy equal to its source; _emit_dm replaces the dm
# engine's copies on every path, which the tests hold it to)
# ---------------------------------------------------------------------------


def _nbest_of(p, length, avg_len):
    # per-read nbest scales with length (wtzmo.c:806-807)
    return max(p.nbest, p.nbest * int(length) // max(1, avg_len))


def _emit_batch_dm(rb, p, rids, row, csorted, Q, A, rdcovs, rdmask, overlaps,
                   emitted_pairs, pre_pairs, attempted_out, avg_len, pd=None):
    """Host-side combine (vectorised): dir choice, ztot gate, ledger, dedup.

    Split into a stateless vector EXTRACTION and a sequential acceptance
    REPLAY so the multihost driver can extract per host and replay the
    merged candidate stream identically on every process (VERDICT r4
    weak #10).  pd: dense pair-row width of the packed result arrays
    (None = the full positional Q*A*2 layout of the sharded drivers)."""
    cand_arr, att_arr = _extract_candidates_dm(
        rb, p, rids, row, csorted, Q, A, avg_len, pd=pd)
    _replay_dm(rb, p, cand_arr, att_arr, rdcovs, rdmask, overlaps,
               emitted_pairs, pre_pairs, attempted_out, avg_len)


def _extract_candidates_dm(rb, p, rids, row, csorted, Q, A, avg_len,
                           pd=None, q0=0):
    """Stateless vector phase: returns (cand_arr [n, 11], att_arr [m, 4]).

    cand_arr rows: (q_order, qrid, qlen, cand, score, dir, tb, te, qb,
    qe, ol), sorted by (q_order asc, score desc) — the sequential
    emission order.  att_arr rows: (q_order, qrid, qlen, cand) for every
    attempted (ztot-passing) pair.  q0 offsets the batch-local query
    index into the global order (per-host extraction)."""
    n = len(rb)
    NP = Q * A * 2
    W = NP if pd is None else pd
    pair_id = row[0: W]
    score_a = row[W: 2 * W]
    tb_a = row[2 * W: 3 * W]
    te_a = row[3 * W: 4 * W]
    qb_a = row[4 * W: 5 * W]
    qe_a = row[5 * W: 6 * W]
    match_cnt = row[6 * W: 6 * W + NP]
    lens = rb.lengths[rids]
    rowmap = np.full(NP + 1, -1, np.int64)
    livep = pair_id < NP
    rowmap[pair_id[livep]] = np.nonzero(livep)[0]
    # per (q, slot): matches, best dir, row
    mc = match_cnt.reshape(Q, A, 2).sum(axis=2)
    live_slot = csorted < n
    attempted_mask = live_slot & (mc * p.zsize >= p.ztot)
    pid0 = (np.arange(Q)[:, None] * A + np.arange(A)[None, :]) * 2
    r0 = rowmap[np.minimum(pid0, NP)]
    r1 = rowmap[np.minimum(pid0 + 1, NP)]
    w0 = np.where(r0 >= 0, score_a[np.clip(r0, 0, W - 1)], 0)
    w1 = np.where(r1 >= 0, score_a[np.clip(r1, 0, W - 1)], 0)
    d_best = (w0 < w1).astype(np.int64)
    r_best = np.where(d_best == 1, r1, r0)
    w_best = np.where(d_best == 1, w1, w0)
    has_row = r_best >= 0
    rb_c = np.clip(r_best, 0, W - 1)
    tb = tb_a[rb_c]
    te = te_a[rb_c]
    qb = qb_a[rb_c]
    qe = qe_a[rb_c]
    ol = np.maximum(te - tb, qe - qb)
    ok = (
        attempted_mask & has_row & (ol > 0)
        & (w_best >= p.min_score)
        & (w_best >= (p.min_id * ol).astype(np.int64))
    )
    qs, ss = np.nonzero(ok)
    order = np.lexsort((-w_best[qs, ss], qs))
    qs, ss = qs[order], ss[order]
    cand_arr = np.stack([
        qs + q0, rids[qs], lens[qs], csorted[qs, ss], w_best[qs, ss],
        d_best[qs, ss], tb[qs, ss], te[qs, ss], qb[qs, ss], qe[qs, ss],
        ol[qs, ss],
    ], axis=1).astype(np.int64) if qs.size else np.zeros((0, 11), np.int64)
    aq, as_ = np.nonzero(attempted_mask)
    att_arr = np.stack([
        aq + q0, rids[aq], lens[aq], csorted[aq, as_],
    ], axis=1).astype(np.int64) if aq.size else np.zeros((0, 4), np.int64)
    return cand_arr, att_arr


def _replay_dm(rb, p, cand_arr, att_arr, rdcovs, rdmask, overlaps,
               emitted_pairs, pre_pairs, attempted_out, avg_len):
    """Sequential acceptance over the (merged) candidate stream.

    Applies the batch-start coverage gate (qdead — the reference skips
    queries that reached nbest, wtzmo.c:806), within-batch attempted
    bookkeeping, dedup, and coverage updates — identical no matter how
    the extraction was partitioned."""
    # evaluate the coverage gate for every query UP FRONT, against the
    # batch-START coverage (the original vectorized semantics): queries
    # gaining coverage as candidates mid-batch must not flip to dead
    qdead_cache: dict = {}
    for arr in (att_arr, cand_arr):
        for r in arr[:, :3].tolist():
            if r[1] not in qdead_cache:
                qdead_cache[r[1]] = rdcovs[r[1]] >= _nbest_of(
                    p, r[2], avg_len)

    def qdead(qrid, qlen):
        return qdead_cache[qrid]

    attempted_now = set()
    for qo, qrid, qlen, cand in att_arr.tolist():
        if qrid != cand and not qdead(qrid, qlen) \
                and (min(qrid, cand), max(qrid, cand)) not in pre_pairs:
            attempted_now.add((qrid, cand))
    for qo, qrid, qlen, cand, sc, dr, tb, te, qb, qe, o in cand_arr.tolist():
        if cand == qrid or qdead(qrid, qlen):
            continue
        key = (min(qrid, cand), max(qrid, cand))
        if key in pre_pairs or key in emitted_pairs:
            continue
        if (cand, qrid) in attempted_now and cand < qrid:
            continue
        emitted_pairs.add(key)
        clen = int(rb.lengths[cand])
        overlaps.append(Overlap(
            rid1=qrid, dir1=0, beg1=tb, end1=te,
            rid2=cand, dir2=dr, beg2=qb, end2=qe,
            score=sc, identity=sc / o, mat=sc, mis=0, ins=0, dl=0, aln=o,
        ))
        x1 = min(tb, qb)
        x2 = min(qlen - te, clen - qe)
        if x1 + x2 <= p.max_unalign_dovetail:
            rdcovs[qrid] += 1
            rdcovs[cand] += 1
    if attempted_out is not None:
        for qrid, cand in attempted_now:
            attempted_out.append((rb.names[qrid], rb.names[cand]))


def _emit_batch_sw(rb, p, rids, row, csorted, Q, A, C, rdcovs, rdmask,
                   overlaps, emitted_pairs, pre_pairs, attempted_out, avg_len):
    """Host combine for the SW engine: DP-score filters, containment mask."""
    QC = Q * C
    o = 0
    def col():
        nonlocal o
        v = row[o: o + QC]
        o += QC
        return v
    cand = col(); drs = col(); _chain = col(); score = col(); mat = col()
    ba = col(); ea = col(); bb = col(); eb = col()
    lens = rb.lengths[rids]
    attempted_now: set[tuple[int, int]] = set()
    n_before = len(overlaps)
    hits = []
    for i in range(QC):
        c = int(cand[i])
        if c < 0:
            continue
        qi = i // C
        qrid = int(rids[qi])
        if c == qrid:
            continue
        if rdmask[qrid] or rdcovs[qrid] >= _nbest_of(p, lens[qi], avg_len):
            continue  # contained / nbest-satisfied query (wtzmo.c:806,1320)
        key = (min(qrid, c), max(qrid, c))
        if key in pre_pairs:
            continue
        attempted_now.add((qrid, c))
        sc = int(score[i])
        aln = max(int(ea[i] - ba[i]), int(eb[i] - bb[i]))
        if aln <= 0 or sc < p.min_score:
            continue
        ident = mat[i] / aln
        if ident < p.min_id:
            continue
        hits.append((qrid, int(lens[qi]), c, int(drs[i]),
                     int(ba[i]), int(ea[i]), int(bb[i]), int(eb[i]),
                     sc, int(mat[i]), aln))
    for qrid, qlen, c, dr, tb, te, qb, qe, sc, m, aln in hits:
        if (c, qrid) in attempted_now and c < qrid:
            continue
        key = (min(qrid, c), max(qrid, c))
        if key in emitted_pairs:
            continue
        emitted_pairs.add(key)
        clen = int(rb.lengths[c])
        overlaps.append(Overlap(
            rid1=qrid, dir1=0, beg1=tb, end1=te,
            rid2=c, dir2=dr, beg2=qb, end2=qe,
            score=sc, identity=m / aln, mat=m,
            mis=0, ins=0, dl=0, aln=aln, cigar=f"{aln}M",
        ))
        x1 = min(tb, qb)
        x2 = min(qlen - te, clen - qe)
        if x1 + x2 <= p.max_unalign_dovetail:
            rdcovs[qrid] += 1
            rdcovs[c] += 1
        # contained candidate (skip_contained, max_unalign_in_contained=0)
        if qb <= 0 and qe >= clen:
            rdmask[c] = True
    n_new = len(overlaps) - n_before
    if attempted_out is not None:
        for qrid, c in attempted_now:
            attempted_out.append((rb.names[qrid], rb.names[c]))
    if p.emit_cigar and n_new:
        _attach_cigars(rb, p, overlaps[-n_new:])


# ---------------------------------------------------------------------------
# the SW overlaps' CIGARs, and the engine-dispatching entry point
# ---------------------------------------------------------------------------


def _attach_cigars(rb, p, ovls, *, device="cuda"):
    """Fill Overlap.cigar/mis/ins/dl with a traceback banded alignment of
    the accepted overlap segments (reference kswx CIGARs, wtzmo.c SW mode),
    on `device`, through the batched stage (ops/align.py banded_runs:
    each length tier in calls under its cap, where the JAX package takes
    a batch in one call; a pair's result depends on no other pair).  With
    p.refine (-n) the refine pass takes the batch's pairs in one group, as
    in the JAX package: its band width depends on the group.  The host
    parts are batched calls of native/cigars.cpp, equal to the plain
    helpers make_band_centers, traceback_banded and `_cigar_stats`.

    Returns its span, `zmo.cigars`, with the counts `overlaps` (records
    given a CIGAR), `calls` (`banded_align` launches) and `cells` (their
    band cells, sum of alen x W); its parts are its children: segs, the
    stage's centers, banded and banded_rle, with -n refine's band, refine
    and rle, and strings (the counts and the CIGAR text)."""
    with span("zmo.cigars", overlaps=0, calls=0, cells=0) as sp:
        if not ovls:
            return sp
        with span("segs"):
            segs = cigar_segments(rb.bases, rb.offsets, [
                (o.rid1, o.beg1, o.end1, o.rid2, o.dir2, o.beg2, o.end2)
                for o in ovls])
        r = banded_runs(segs, p.band_w, match=p.sw_match,
                        mismatch=p.sw_mismatch, gap_a=p.sw_gap,
                        gap_b=p.sw_gap, device=device)
        sp.counts["calls"] += r.calls
        sp.counts["cells"] += int(segs.alen.sum()) * p.band_w
        ops, counts = [r.ops], [r.counts]
        if p.refine:
            _refine_runs(p, segs, r, ops, counts, device)
        with span("strings"):
            stats, text_offs, text = cigar_strings(
                segs, r.b_beg, r.run_beg, r.run_end, np.concatenate(ops),
                np.concatenate(counts))
            given = np.flatnonzero(r.run_end > r.run_beg)
            text = text.tobytes().decode("ascii")
            offs = text_offs.tolist()
            for i, (m, x, ins, dl, aln) in zip(given.tolist(),
                                               stats[given].tolist()):
                ov = ovls[i]
                ov.mat, ov.mis, ov.ins, ov.dl, ov.aln = m, x, ins, dl, aln
                ov.identity = m / max(1, aln)
                ov.cigar = text[offs[i]:offs[i + 1]]
            sp.counts["overlaps"] += len(given)
    return sp


_OPS = "MID"


def _refine_runs(p, segs, r, ops, counts, dev):
    """Reference -n: kswx_refine_alignment around each hit's CIGAR
    (wtzmo.c:1031-1033), canonical affine gap placement.  The refined
    runs are appended to ops/counts and r.run_beg/r.run_end point at
    them."""
    nrun = len(r.ops)
    cigs = run_lists(r.ops, r.counts, r.run_beg, r.run_end)
    rpairs, rcigs, rmap = [], [], []
    for i, cig in enumerate(cigs):
        seg_b = segs.cand(i)[int(r.b_beg[i]): int(r.end_col[i])]
        if not cig[0] or seg_b.size == 0 or int(segs.alen[i]) == 0:
            continue
        rpairs.append((segs.query(i), seg_b))
        rcigs.append(cig)
        rmap.append(i)
    for i, res in zip(rmap, refine_alignment_batch(
            rpairs, rcigs, W_base=64, match=p.sw_match,
            mismatch=p.sw_mismatch, open_i=p.sw_gap, open_d=p.sw_gap,
            ext=-1, device=dev)):
        ops.append(np.array([_OPS.index(o) for o in res["ops"]], np.uint8))
        counts.append(np.array(res["counts"], np.int32))
        r.run_beg[i] = nrun
        nrun += len(res["ops"])
        r.run_end[i] = nrun


def _cigar_stats(segs, cigs, b_begs, ovls) -> int:
    """Each overlap's CIGAR, aln, mat/mis/ins/dl and identity from its
    alignment, as the JAX package's `_attach_cigars` sets them; returns
    how many overlaps were given one (an empty traceback leaves its
    overlap as it was).  The plain version, which the tests hold
    native/cigars.cpp's `cig_strings` to."""
    given = 0
    for i, ov in enumerate(ovls):
        ops, counts = cigs[i]
        if not ops:
            continue
        given += 1
        ra, rb_ = align_strings(segs[i][0], segs[i][1][int(b_begs[i]):],
                                ops, counts)
        both = (ra != 4) & (rb_ != 4)
        ov.mat = int(np.sum(both & (ra == rb_)))
        ov.mis = int(np.sum(both & (ra != rb_)))
        ov.ins = int(np.sum((ra != 4) & (rb_ == 4)))
        ov.dl = int(np.sum((ra == 4) & (rb_ != 4)))
        ov.aln = int(ra.shape[0])
        ov.identity = ov.mat / max(1, ov.aln)
        ov.cigar = "".join(f"{int(c)}{o}" for o, c in zip(ops, counts))
    return given


def overlap_reads(rb: ReadBank, params: ZmoParams | None = None,
                  progress: bool = True, preattempted=None,
                  attempted_out=None, *, device="cuda"):
    """Engine-dispatching alias (dm = dot-matrix, sw = banded local DP)."""
    return overlap_dmo(rb, params, progress, preattempted, attempted_out,
                       device=device)


def read_pair_ledger(paths):
    """Load -L ledger files: two read names per line."""
    pairs = []
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        with open(path) as fh:
            for line in fh:
                c = line.split()
                if len(c) >= 2:
                    pairs.append((c[0], c[1]))
    return pairs


def write_pair_ledger(path, pairs):
    with open(path, "w") as fh:
        for a, b in pairs:
            fh.write(f"{a}\t{b}\n")


def write_overlaps(path: str, rb: ReadBank, overlaps) -> None:
    lengths = rb.lengths
    with open(path, "w") as fh:
        for ov in overlaps:
            fh.write(ov.to_tsv(rb.names, lengths))
            fh.write("\n")
