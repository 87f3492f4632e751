"""Overlap rescue on the graph — equivalent of the reference `wtgbo` (port
of smartdenovo_tpu/graph/gbo.py; the candidate collectors are copies, the
aligner runs on a torch device).

Iterates (<=5 rounds, wtgbo.c:536-587): build the string graph from the
current overlap set, run best-overlap selection, then find read pairs
that *should* overlap but have no record:

  - graph candidates (gbo_core, wtgbo.c:143-209): for nodes missing a
    two-way BOG edge on a side, an offset-ordered BFS (<=2 levels,
    wtgbo.c:62-116) proposes nearby reads;
  - anchor candidates (abo_core, wtgbo.c:217-316): co-tiling interval
    sweep over each read's overlap projections proposes read pairs that
    tile the same region.

Proposed pairs are aligned in batches with the SW engine's device kernels
(zmer pair extraction -> dot-matrix chain -> banded local DP) and
accepted with the same score/identity filters; new overlaps feed the next
round until none are found.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from ..data.readbank import ReadBank
from ..ops.align import pad_tier
from ..ops.seeds import extract_seeds
from ..ops.index import build_zmer_index
from ..ops.dotmatrix import extract_zmer_pairs, dot_matrix_align
from ..ops.zmo_sw import sw_align_batch
from ..utils.log import log
from .stringgraph import LayParams, StringGraph

INT32_MAX = np.int32(0x7FFFFFFF)
GRAPH_TRACE_LEVEL = 2


@dataclasses.dataclass
class GboParams:
    min_score: int = 200
    min_id: float = 0.6
    margin: int = 100          # -u overlap margin for graph building
    edgecov_cutoff: int = 1
    best_score_cutoff: float = 0.95
    max_ext: int = 0
    max_iter: int = 5
    max_zmer_freq: int = 16
    kvar: int = 2
    batch_q: int = 16
    cand_cap: int = 32         # aligned candidates per rescue node per round
    band_w: int = 256
    expand_budget: int = 1 << 21
    pair_budget: int = 1 << 19


def _pair_key(a: int, b: int, dir: int) -> tuple:
    return (a, b, dir) if a < b else (b, a, dir)


def collect_graph_candidates(g: StringGraph, node_id: int, max_ext: int,
                             closed: set, out: list):
    """Port of collect_graph_candidates_wtgbo (offset-ordered BFS, <=2 levels)."""
    maxoff = max_ext + int(g.rb.lengths[node_id])
    heap = []
    heapq.heappush(heap, (0, 0, node_id, 0, 0))  # (off, lv, nid, dir, k)
    heapq.heappush(heap, (0, 0, node_id, 1, 1))
    seen = {(node_id, 0), (node_id, 1)}
    first = True
    while heap:
        off1, lv, nid, dir, k = heapq.heappop(heap)
        n1 = g.nodes[nid]
        edges = list(n1.edges[k])
        if not edges and g.dead[nid]:
            # contained read: follow its containment edge (wtgbo.c:84-92)
            edges = [e for e in n1.edges[1 - k] if e.att]
        for e in edges:
            off2 = off1 + e.off
            if off2 > maxoff:
                continue
            val = (e.node_id, dir ^ e.dir)
            if val in seen:
                continue
            seen.add(val)
            if not first and not g.dead[e.node_id]:
                key = _pair_key(node_id, e.node_id, dir ^ e.dir)
                if key not in closed:
                    closed.add(key)
                    out.append(val)
            if lv < GRAPH_TRACE_LEVEL:
                heapq.heappush(heap, (off2, lv + 1, e.node_id, dir, e.dir))
        first = False


def collect_anchor_candidates(g: StringGraph, node_id: int, closed: set,
                              out: list):
    """Port of collect_anchor_candidates_wtgbo (co-tiling interval sweep)."""
    n = g.nodes[node_id]
    ln = int(g.rb.lengths[node_id])
    marks = []
    for k in (0, 1):
        for e in n.edges[k]:
            if g.dead[e.node_id]:
                continue
            if k:
                beg = ln - (e.off + g.edge_overlap(node_id, e))
                end = ln - e.off
            else:
                beg = e.off
                end = e.off + g.edge_overlap(node_id, e)
            d = e.dir ^ k
            marks.append((beg, 0, e.node_id, d))
            marks.append((end, 1, e.node_id, d))
    marks.sort(key=lambda t: t[0])
    active: dict[int, int] = {}
    for pos, isend, nid, d in marks:
        if isend:
            active.pop(nid, None)
            for other, od in active.items():
                key = _pair_key(nid, other, d ^ od)
                if key in closed:
                    continue
                closed.add(key)
                out.append((nid, other, d ^ od))
        else:
            active[nid] = d


def align_pairs_sw(rb: ReadBank, zidx, pair_map: dict[int, list[tuple[int, int]]],
                   p: GboParams, *, device="cuda"):
    """Batch-align explicit (query -> [(cand, dir)]) pairs with the SW engine
    on `device`: extract_seeds -> extract_zmer_pairs -> dot_matrix_align
    (nb 16) -> sw_align_batch.

    Returns list of hit tuples (qrid, cand, dir, tb, te, qb, qe, score,
    mat, aln).  Alignment orientation: query forward vs candidate in the
    given relative strand.
    """
    hits = []
    queries = sorted(pair_map)
    if not queries:
        return hits
    dev = torch.device(device)
    n = len(rb)
    read_lens = torch.from_numpy(rb.lengths.astype(np.int32)).to(dev)
    flat_bases = torch.from_numpy(rb.bases).to(dev)
    read_offs = torch.from_numpy(rb.offsets.astype(np.int32)).to(dev)
    A = p.cand_cap
    Q = p.batch_q
    for b0 in range(0, len(queries), Q):
        chunk = queries[b0 : b0 + Q]
        rids = np.array(chunk + [chunk[-1]] * (Q - len(chunk)), np.int64)
        Ltier = pad_tier(int(rb.lengths[rids].max()))
        batch, lens = rb.batch(rids, pad_to=Ltier)
        # each row's candidates are a set: extract_zmer_pairs's slot table
        # has distinct targets per row
        cands = np.full((Q, A), INT32_MAX, np.int32)
        for i, qi in enumerate(chunk):
            cl = sorted({c for c, d in pair_map[qi]})[:A]
            cands[i, : len(cl)] = cl
        batch_d = torch.from_numpy(batch).to(dev)
        lens_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
        cands_d = torch.from_numpy(cands).to(dev)
        zres = extract_seeds(batch_d, lens_d, zidx.zsize, True)
        pairs = extract_zmer_pairs(
            zres["kmer"], zres["dir"], zres["off"], zres["span"], zres["valid"],
            torch.from_numpy(rids.astype(np.int32)).to(dev), cands_d,
            zidx.zmers, zidx.post_rd, zidx.post_packed,
            read_lens,
            expand_budget=p.expand_budget, pair_budget=p.pair_budget, kvar=p.kvar,
        )
        clen_of_pair = torch.repeat_interleave(
            torch.where(cands_d < n, read_lens[cands_d.clamp(0, n - 1).long()], 0)
            .to(torch.int32).reshape(-1), 2)
        qlen_of_pair = torch.repeat_interleave(lens_d, A * 2)
        res = dot_matrix_align(pairs, qlen_of_pair, clen_of_pair,
                               n_pairs=Q * A * 2, nb=16)
        sw = sw_align_batch(
            res.pair_id, res.score, res.tb, res.te, res.qb, res.qe,
            cands_d, batch_d, lens_d, flat_bases, read_offs, read_lens,
            Q=Q, A=A, C=min(A, p.cand_cap), Ltier=Ltier, W=p.band_w,
        )
        q_l, cd, dr, sc, mt, ba, ea, bb, eb = (
            t.cpu().numpy() for t in (sw.q_local, sw.cand, sw.dir, sw.score,
                                      sw.mat, sw.beg_a, sw.end_a, sw.beg_b,
                                      sw.end_b))
        for i in range(len(q_l)):
            if cd[i] < 0 or q_l[i] >= len(chunk):
                continue
            qrid = chunk[q_l[i]]
            c = int(cd[i])
            if c == qrid:
                continue
            # the chain may pick the other strand than the one proposed;
            # it is accepted anyway (stronger signal), as in the JAX package
            aln = max(int(ea[i] - ba[i]), int(eb[i] - bb[i]))
            if aln <= 0 or int(sc[i]) < p.min_score:
                continue
            if mt[i] / aln < p.min_id:
                continue
            hits.append((qrid, c, int(dr[i]), int(ba[i]), int(ea[i]),
                         int(bb[i]), int(eb[i]), int(sc[i]), int(mt[i]), aln))
    return hits


def rescue_overlaps(rb: ReadBank, overlaps: list, params: GboParams | None = None,
                    *, device="cuda"):
    """Run wtgbo-style rescue on `device`; returns the list of NEW Overlap
    records."""
    from ..pipeline.zmo import Overlap, resolve_device

    p = params or GboParams()
    device = resolve_device(device)
    zidx = build_zmer_index(rb, 10, True, p.max_zmer_freq, device=device)
    closed: set = set()
    for ov in overlaps:
        closed.add(_pair_key(ov.rid1, ov.rid2, ov.dir1 ^ ov.dir2))
    all_ovls = list(overlaps)
    new_total = []
    for it in range(p.max_iter):
        lp = LayParams(min_score=p.min_score, min_id=p.min_id, margin=p.margin,
                       edgecov_cutoff=p.edgecov_cutoff,
                       best_score_cutoff=p.best_score_cutoff)
        g = StringGraph(rb, lp)
        g.load_overlaps(all_ovls)
        g.cal_edge_coverage()
        g.remove_duplicate_edges()
        g.mask_contained_reads()
        g.mask_low_cov_edges(p.edgecov_cutoff)
        g.best_overlap(p.best_score_cutoff)
        pair_map: dict[int, list[tuple[int, int]]] = {}
        cands_buf: list = []
        for nid in range(len(rb)):
            if g.dead[nid]:
                continue
            n = g.nodes[nid]
            if n.bogs[1][0][0] and n.bogs[1][1][0]:
                continue
            cands_buf.clear()
            collect_graph_candidates(g, nid, p.max_ext, closed, cands_buf)
            if cands_buf:
                pair_map.setdefault(nid, []).extend(cands_buf)
        abuf: list = []
        for nid in range(len(rb)):
            if g.dead[nid]:
                continue
            collect_anchor_candidates(g, nid, closed, abuf)
        for a, b, d in abuf:
            pair_map.setdefault(a, []).append((b, d))
        n_cand = sum(len(v) for v in pair_map.values())
        log("wtgbo iter %d: %d rescue candidates", it + 1, n_cand)
        if n_cand == 0:
            break
        hits = align_pairs_sw(rb, zidx, pair_map, p, device=device)
        news = []
        for qrid, c, d, tb, te, qb, qe, sc, mt, aln in hits:
            news.append(Overlap(
                rid1=qrid, dir1=0, beg1=tb, end1=te,
                rid2=c, dir2=d, beg2=qb, end2=qe,
                score=sc, identity=mt / aln, mat=mt, mis=0, ins=0, dl=0,
                aln=aln, cigar=f"{aln}M",
            ))
        log("wtgbo iter %d: %d new overlaps", it + 1, len(news))
        if not news:
            break
        all_ovls.extend(news)
        new_total.extend(news)
    return new_total
