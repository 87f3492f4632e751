"""String graph + Best Overlap Graph layout — equivalent of `wtlay`.

Host graph plane (pointer-chasing over <=1e5 read nodes; milliseconds on
host, cf. SURVEY.md §7).  The graph model and every operation mirror the
reference wtlay.h / wtlay.c:

  node  = read, with per-direction edge lists and BOG degree counters
          bogs[in/out][dir][two-way/one-way] (wtlay.h:39-46)
  edge  = dovetail overlap with offset/score/containment flags and a twin
          (wtlay.h:57-64); "one-way" (mark=1) means the twin was cut

Default op sequence is the reference's `-Q gCwgBgRURg` (wtlay.c:2934):
contained-read masking, low-coverage edge masking, best-overlap
selection, iterative BOG repair (tips, bubbles, chimera, loops,
recoveries), unitig generation, inter-unitig edge recovery, and layout
output in the reference's .lay/.utg format (README-tools.md:248-268).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..data.readbank import ReadBank, codes_to_seq, revcomp_codes
from ..utils.log import log

MERGE_BUBBLE_MAX_STEP = 20
CUT_LOOP_MAX_STEP = 5
MIN_LAY_NODES = 4
SG_MAX_EDGE = 1023


@dataclasses.dataclass
class LayParams:
    min_score: int = 500      # -s (dmo: 200)
    min_id: float = 0.6       # -m (dmo: 0.1)
    margin: int = 100         # -w max overlap margin (dmo: 300)
    edgecov_cutoff: int = 1   # -c
    best_score_cutoff: float = 0.95  # -r
    utg_sm: float = 0.4       # -q duplicated-unitig coverage
    mat_score: bool = False   # -R use matches as score
    score_var: float = 0.2    # -S better_overlap tolerance (wtlay.c:2953)
    commands: str = "gCwgBgRURg"  # reference default (wtlay.c:2934);
                                  # 'g' dumps graphviz when dot_prefix set
    dot_prefix: str = ""      # write {prefix}.{N}.dot at each 'g' command

    @classmethod
    def dmo(cls, **kw) -> "LayParams":
        """dmo pipeline: wtlay -w 300 -s 200 -m 0.1 -r 0.95 -c 1 (smartdenovo.pl:55)."""
        d = dict(min_score=200, min_id=0.1, margin=300)
        d.update(kw)
        return cls(**d)


class Edge:
    __slots__ = ("node_id", "dir", "off", "ol_var", "score", "closed", "mark",
                 "att", "tta", "cov", "rev")

    def __init__(self, node_id, dir, off, ol_var, score):
        self.node_id = node_id
        self.dir = dir
        self.off = off
        self.ol_var = ol_var
        self.score = score
        self.closed = 0
        self.mark = 0
        self.att = 0
        self.tta = 0
        self.cov = 0
        self.rev: "Edge" = None


class Node:
    __slots__ = ("edges", "bogs", "lay_id", "lay_dir", "lay_off", "lay_end")

    def __init__(self):
        self.edges: tuple[list[Edge], list[Edge]] = ([], [])
        # bogs[in(0)/out(1)][dir][two-way(0)/one-way(1)]
        self.bogs = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
        self.lay_id = -1
        self.lay_dir = 0
        self.lay_off = 0
        self.lay_end = 0


class StringGraph:
    def __init__(self, rb: ReadBank, params: LayParams):
        self.rb = rb
        self.p = params
        n = len(rb)
        self.n = n
        self.nodes = [Node() for _ in range(n)]
        self.dead = np.zeros(n, bool)
        self.contained_in: dict[int, int] = {}
        self.lays: list[list] = []  # each: list of [node_id, dir, off, contained]

    # ------------------------------------------------------------------
    # construction (wtlay.h:238-470)
    # ------------------------------------------------------------------

    def load_overlaps(self, overlaps) -> int:
        """overlaps: Overlap records (rid1/rid2 are bank ids).

        Mirrors parse + overlap_item2biedge + load_overlaps_core:
        dovetail margin test, canonical orientation (larger left margin
        first), containment (att/tta) flags, per-(node,dir) edge cap.
        """
        p = self.p
        lens = self.rb.lengths
        cnt = 0
        for ov in overlaps:
            score = ov.mat if p.mat_score else ov.score
            if score < p.min_score:
                continue
            if int(ov.identity * 1000) < int(1000 * p.min_id):
                continue
            i1, i2 = ov.rid1, ov.rid2
            if i1 == i2 or self.dead[i1] or self.dead[i2]:
                continue
            len1, len2 = int(lens[i1]), int(lens[i2])
            l = [ov.beg1, ov.beg2]
            r = [len1 - ov.end1, len2 - ov.end2]
            lm = min(l[0], l[1])
            rm = min(r[0], r[1])
            if lm + rm > p.margin:
                continue
            if l[0] >= l[1]:
                a, b = i1, i2
                da, db = ov.dir1, ov.dir2
                offa = l[0] - lm
                offb = r[1] - rm
                ola, olb = ov.end1 - ov.beg1, ov.end2 - ov.beg2
            else:
                a, b = i2, i1
                da, db = ov.dir2, ov.dir1
                offa = l[1] - lm
                offb = r[0] - rm
                ola, olb = ov.end2 - ov.beg2, ov.end1 - ov.beg1
            lena, lenb = int(lens[a]), int(lens[b])
            na, nb = self.nodes[a], self.nodes[b]
            if len(na.edges[da]) >= SG_MAX_EDGE or len(nb.edges[1 - db]) >= SG_MAX_EDGE:
                continue
            ln = lena - offa if offa + lenb > lena else lenb
            e1 = Edge(b, db, offa, ola - ln, score)
            ln = lenb - offb if offb + lena > lenb else lena
            e2 = Edge(a, 1 - da, offb, olb - ln, score)
            e1.rev = e2
            e2.rev = e1
            na.edges[da].append(e1)
            nb.edges[1 - db].append(e2)
            # containment flags (wtlay.h:416-438)
            if offa == 0:
                if offb == 0:
                    if lena < lenb:
                        e1.att, e2.tta = 1, 1
                    elif lena > lenb:
                        e2.att, e1.tta = 1, 1
                    elif a < b:
                        e2.att, e1.tta = 1, 1
                    else:
                        e1.att, e2.tta = 1, 1
                else:
                    e1.att, e2.tta = 1, 1
            elif offb == 0:
                e2.att, e1.tta = 1, 1
            cnt += 1
        return cnt

    # ------------------------------------------------------------------
    # basic edge helpers (wtlay.h:471-560)
    # ------------------------------------------------------------------

    def owner_of(self, e: Edge) -> int:
        return e.rev.node_id

    def write_dot(self, fh) -> None:
        """Graphviz dump, one digraph per connected component — the
        reference's main graph-debugging surface (print_dot_strgraph,
        wtlay.c:2433-2465): edge label '+-:off:score:identity', colors
        blue/green/red/gray by (k, dir)."""
        colors = (("blue", "green"), ("red", "gray"))
        seen = np.zeros(self.n, bool)
        for node_id in range(self.n):
            if self.dead[node_id] or seen[node_id]:
                continue
            if not (self.living_edges(node_id, 0)
                    or self.living_edges(node_id, 1)):
                continue
            fh.write(f"digraph {node_id} {{\n")
            stack = [node_id]
            seen[node_id] = True
            while stack:
                idx = stack.pop()
                for k in (0, 1):
                    for e in self.nodes[idx].edges[k]:
                        if e.closed:
                            continue
                        ovl = max(1, self.edge_overlap(idx, e))
                        fh.write(
                            f"{self.rb.names[idx]} -> {self.rb.names[e.node_id]}"
                            f" [label=\"{'+-'[k]}{'+-'[e.dir]}:{e.off}"
                            f":{e.score}:{e.score / ovl:.3f}\""
                            f" color=\"{colors[k][e.dir]}\"]\n")
                        if not seen[e.node_id]:
                            stack.append(e.node_id)
                            seen[e.node_id] = True
            fh.write("}\n")

    def edge_overlap(self, node_id: int, e: Edge) -> int:
        len1 = int(self.rb.lengths[node_id])
        len2 = int(self.rb.lengths[e.node_id])
        ln = len1 - e.off if e.off + len2 > len1 else len2
        return ln + e.ol_var

    def living_edges(self, node_id, dir):
        return [e for e in self.nodes[node_id].edges[dir] if e.closed == 0]

    def first_living_edge(self, node_id, dir):
        for e in self.nodes[node_id].edges[dir]:
            if e.closed == 0:
                return e
        return None

    def single_living_edge(self, node_id, dir):
        ret = None
        for e in self.nodes[node_id].edges[dir]:
            if e.closed:
                continue
            if ret is not None:
                return None
            ret = e
        return ret

    def first_one_way_input_edge(self, node_id, dir):
        """wtlay.c:940-954: partner of a closed out-edge in !dir whose twin is open."""
        for e in self.nodes[node_id].edges[1 - dir]:
            if e.closed != 1:
                continue
            if e.rev.closed:
                continue
            return e.rev
        return None

    def mask_node(self, node_id, closed=1):
        n = self.nodes[node_id]
        for k in (0, 1):
            for e in n.edges[k]:
                e.closed = closed
                e.rev.closed = closed
        self.dead[node_id] = True

    # ------------------------------------------------------------------
    # coverage / duplicates / contained (wtlay.h:601-766)
    # ------------------------------------------------------------------

    def cal_edge_coverage(self):
        for node in self.nodes:
            for k in (0, 1):
                for e in node.edges[k]:
                    e.cov = -1
        for nid, node in enumerate(self.nodes):
            neigh = set()
            for k in (0, 1):
                for e in node.edges[k]:
                    if e.closed == 1:
                        continue
                    neigh.add(e.node_id)
            for k in (0, 1):
                for e in node.edges[k]:
                    if e.closed == 1 or e.cov != -1:
                        continue
                    cov = 0
                    n2 = self.nodes[e.node_id]
                    for k2 in (0, 1):
                        for e2 in n2.edges[k2]:
                            if e2.closed == 1:
                                continue
                            if e2.node_id in neigh:
                                cov += 1
                    cov = min(cov, 62)
                    e.cov = cov
                    e.rev.cov = cov

    def remove_duplicate_edges(self) -> int:
        ret = 0
        for nid, node in enumerate(self.nodes):
            if self.dead[nid]:
                continue
            for k in (0, 1):
                best: dict[int, Edge] = {}
                for e in node.edges[k]:
                    if e.closed:
                        continue
                    o = best.get(e.node_id)
                    if o is None:
                        best[e.node_id] = e
                    else:
                        ret += 1
                        if e.score < o.score:
                            e.closed = e.rev.closed = 1
                        else:
                            o.closed = o.rev.closed = 1
                            best[e.node_id] = e
        return ret

    def mask_low_cov_edges(self, cutoff) -> int:
        ret = 0
        if cutoff == 0:
            return 0
        for node in self.nodes:
            for k in (0, 1):
                for e in node.edges[k]:
                    if e.closed == 1 or e.cov >= cutoff:
                        continue
                    e.closed = 1
                    ret += 1
        return ret

    def mask_contained_reads(self) -> int:
        flags = np.zeros(self.n, bool)
        for nid, node in enumerate(self.nodes):
            if self.dead[nid]:
                continue
            found = False
            for k in (0, 1):
                for e in node.edges[k]:
                    if e.closed == 1:
                        continue
                    if e.att:
                        found = True
                        break
                if found:
                    break
            if found:
                flags[nid] = True
        ret = int(flags.sum())
        for nid, node in enumerate(self.nodes):
            if self.dead[nid] or not flags[nid]:
                continue
            c = -1
            max_score = 0
            for k in (0, 1):
                for e in node.edges[k]:
                    if e.closed == 1 or not e.att:
                        continue
                    if flags[e.node_id]:
                        if c == -1:
                            c = e.node_id
                        continue
                    if e.score > max_score:
                        c = e.node_id
                        max_score = e.score
            for k in (0, 1):
                for e in node.edges[k]:
                    if e.node_id != c:
                        e.att = 0
            if c != -1:
                self.contained_in[nid] = c
        for nid in range(self.n):
            if flags[nid]:
                self.mask_node(nid)
        return ret

    # ------------------------------------------------------------------
    # best overlap graph (wtlay.h:768-830)
    # ------------------------------------------------------------------

    def best_overlap(self, best_score_cutoff: float) -> int:
        ret = 0
        for nid, node in enumerate(self.nodes):
            if self.dead[nid]:
                continue
            for k in (0, 1):
                bestS = 0.0
                for e in node.edges[k]:
                    if e.closed or e.att or e.tta:
                        continue
                    if e.score > bestS:
                        bestS = e.score
                bestS = bestS * best_score_cutoff
                best_off = int(self.rb.lengths[nid])
                b = None
                for e in node.edges[k]:
                    if e.closed or e.att or e.tta:
                        continue
                    if e.score < bestS:
                        continue
                    if e.off < best_off:
                        best_off = e.off
                        b = e
                for e in node.edges[k]:
                    if e is not b:
                        if e.closed == 0:
                            ret += 1
                        e.closed = 1
        for node in self.nodes:
            node.bogs = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
        for nid, node in enumerate(self.nodes):
            if self.dead[nid]:
                continue
            for k in (0, 1):
                for e in node.edges[k]:
                    if e.closed:
                        continue
                    m = self.nodes[e.node_id]
                    if e.rev.closed:
                        e.mark = 1
                        node.bogs[1][k][1] += 1
                        m.bogs[0][e.dir][1] += 1
                    else:
                        e.mark = 0
                        node.bogs[1][k][0] += 1
                        m.bogs[0][e.dir][0] += 1
        return ret

    # BOG mutation primitives (wtlay.c:850-922) -------------------------

    def cut_edge_bog(self, e: Edge):
        if e.closed:
            return
        p = e.rev
        n1 = self.nodes[p.node_id]
        n2 = self.nodes[e.node_id]
        e.closed = 1
        if e.mark:
            n1.bogs[1][1 - p.dir][1] -= 1
            n2.bogs[0][e.dir][1] -= 1
        else:
            p.mark = 1
            n1.bogs[1][1 - p.dir][0] -= 1
            n1.bogs[0][p.dir][0] -= 1
            n1.bogs[0][p.dir][1] += 1
            n2.bogs[1][1 - e.dir][0] -= 1
            n2.bogs[1][1 - e.dir][1] += 1
            n2.bogs[0][e.dir][0] -= 1

    def repair_one_way_edge_bog(self, e: Edge):
        if e.closed or e.mark == 0:
            return
        p = e.rev
        n1 = self.nodes[p.node_id]
        n2 = self.nodes[e.node_id]
        if n2.bogs[1][1 - e.dir][0] or n2.bogs[1][1 - e.dir][1]:
            return  # would break BOG (wtlay.c:880-882)
        p.closed = 0
        e.mark = 0
        p.mark = 0
        n1.bogs[1][1 - p.dir][1] -= 1
        n1.bogs[1][1 - p.dir][0] += 1
        n1.bogs[0][p.dir][0] += 1
        n2.bogs[0][e.dir][1] -= 1
        n2.bogs[0][e.dir][0] += 1
        n2.bogs[1][1 - e.dir][0] += 1

    def revive_edge_bog(self, e: Edge) -> int:
        if e.closed == 0:
            return 0
        p = e.rev
        n1 = self.nodes[p.node_id]
        n2 = self.nodes[e.node_id]
        if n1.bogs[1][1 - p.dir][0] + n1.bogs[1][1 - p.dir][1]:
            return 0
        if p.closed:
            e.closed = 0
            e.mark = 1
            n1.bogs[1][1 - p.dir][1] += 1
            n2.bogs[0][e.dir][1] += 1
        elif n1.bogs[1][1 - p.dir][0] == 0:
            e.closed = 0
            e.mark = 0
            p.mark = 0
            n1.bogs[0][p.dir][1] -= 1
            n1.bogs[0][p.dir][0] += 1
            n1.bogs[1][1 - p.dir][0] += 1
            n2.bogs[0][e.dir][0] += 1
            n2.bogs[1][1 - e.dir][1] -= 1
            n2.bogs[1][1 - e.dir][0] += 1
        else:
            return 0
        return 1

    def count_linear_nodes(self, node_id, dir, max_nodes) -> int:
        cnt = 0
        while cnt < max_nodes:
            n = self.nodes[node_id]
            if n.bogs[1][dir][0] == 0:
                break
            if n.bogs[0][1 - dir][1]:
                break
            e = self.first_living_edge(node_id, dir)
            node_id = e.node_id
            dir = e.dir
            cnt += 1
        return cnt

    def bflag(self, nid) -> tuple:
        b = self.nodes[nid].bogs
        return (
            min(b[0][0][0], 255), min(b[0][0][1], 255),
            min(b[0][1][0], 255), min(b[0][1][1], 255),
            min(b[1][0][0], 255), min(b[1][0][1], 255),
            min(b[1][1][0], 255), min(b[1][1][1], 255),
        )

    # ------------------------------------------------------------------
    # BOG repair sub-operations (wtlay.c:959-1586)
    # ------------------------------------------------------------------

    def cut_tip1(self, nid, dir):
        self.cut_edge_bog(self.first_living_edge(nid, dir))
        return 1

    def cut_tip4(self, nid, dir):
        e1 = self.first_one_way_input_edge(nid, dir)
        self.cut_edge_bog(e1)
        p = e1.rev  # the closed half from nid back to the source
        n2 = self.nodes[p.node_id]
        if n2.bogs[0][p.dir][1] != 1:
            return 1
        e2 = self.first_one_way_input_edge(p.node_id, p.dir)
        if e2 is not None:
            self.repair_one_way_edge_bog(e2)
        return 1

    def cut_tip2(self, nid):
        e1 = self.first_living_edge(nid, 0)
        e2 = self.first_living_edge(nid, 1)
        self.cut_edge_bog(e1)
        self.cut_edge_bog(e2)
        return 1

    def cut_tip5(self, nid, dir):
        e1 = self.first_living_edge(nid, dir)
        e2 = self.first_one_way_input_edge(nid, 1 - dir)
        self.cut_edge_bog(e1)
        self.cut_edge_bog(e2)
        return 1

    _CLEAN_THRU = (1, 0, 1, 0, 1, 0, 1, 0)
    _T3_D0 = (1, 1, 1, 0, 1, 0, 1, 0)
    _T3_D1 = (1, 0, 1, 1, 1, 0, 1, 0)

    def cut_tip3(self, nid, dir):
        e1 = self.first_living_edge(nid, dir)
        step = 0
        while True:
            step += 1
            if step > 10:
                return 0
            flag = self.bflag(e1.node_id)
            if flag == self._CLEAN_THRU:
                e1 = self.first_living_edge(e1.node_id, e1.dir)
            else:
                if e1.dir:
                    if flag != self._T3_D1:
                        return 0
                else:
                    if flag != self._T3_D0:
                        return 0
                break
        e2 = self.first_one_way_input_edge(e1.node_id, e1.dir)
        if e2 is None:
            return 0
        p = e1.rev
        self.cut_edge_bog(e1)
        self.cut_edge_bog(p)
        self.repair_one_way_edge_bog(e2)
        return 1

    def cut_tip6(self, nid, dir):
        step = 0
        e = self.first_living_edge(nid, dir)
        while True:
            step += 1
            if step > 10:
                return 0
            if e.mark == 1:
                self.cut_edge_bog(e)
                return 1
            n = self.nodes[e.node_id]
            if n.bogs[0][e.dir][1] == 1:
                p0 = self.first_one_way_input_edge(e.node_id, e.dir)
                if p0 is None:
                    return 0
                p = p0.rev
                if self.count_linear_nodes(p.node_id, p.dir, 10) < 10:
                    return 0
                self.cut_edge_bog(e)
                self.cut_edge_bog(e.rev)
                self.repair_one_way_edge_bog(p0)
                return 1
            if n.bogs[0][1 - e.dir][1] == 1:
                if n.bogs[0][1 - e.dir][0]:
                    return 0
                p0 = self.first_one_way_input_edge(e.node_id, 1 - e.dir)
                if p0 is None:
                    return 0
                p = p0.rev
                n2 = self.nodes[p.node_id]
                if n2.bogs[0][p.dir][1] != 1:
                    return 0
                if self.count_linear_nodes(p.node_id, p.dir, 10) < 10:
                    return 0
                self.cut_edge_bog(p0)
                p0 = self.first_one_way_input_edge(p.node_id, p.dir)
                if p0 is not None:
                    self.repair_one_way_edge_bog(p0)
                return 1
            e = self.first_living_edge(e.node_id, e.dir)
            if e is None:
                return 0

    def cut_nail(self, nid, dir):
        step = 0
        e = self.first_living_edge(nid, 1 - dir)
        while True:
            step += 1
            if step > 5:
                return 0
            if e.mark == 1:
                break
            f = self.bflag(e.node_id)
            if f[1] or f[3]:  # any one-way input (0x00FF00FF00000000)
                return 0
            e = self.first_living_edge(e.node_id, e.dir)
            if e is None:
                return 0
        e2 = e
        e1 = self.first_living_edge(nid, dir)
        self.cut_edge_bog(e1)
        self.cut_edge_bog(e2)
        return 1

    def repair_jump(self, nid, dir):
        if self.count_linear_nodes(nid, 1 - dir, 4) < 4:
            return 0
        e1 = self.first_living_edge(nid, dir)
        if self.count_linear_nodes(e1.node_id, 0, 4) < 4:
            return 0
        if self.count_linear_nodes(e1.node_id, 1, 4) < 4:
            return 0
        e2 = self.first_one_way_input_edge(nid, 1 - dir)
        if e2 is None:
            return 0
        p = e2.rev
        if self.count_linear_nodes(p.node_id, p.dir, 4) < 4:
            return 0
        self.cut_edge_bog(e1)
        self.repair_one_way_edge_bog(e2)
        return 1

    def cut_nasty_jump(self, nid, dir):
        e1 = self.first_living_edge(nid, dir)
        if self.count_linear_nodes(e1.node_id, 0, 4) < 4:
            return 0
        if self.count_linear_nodes(e1.node_id, 1, 4) < 4:
            return 0
        score = e1.score / max(1, self.edge_overlap(nid, e1))
        e = self.first_living_edge(e1.node_id, 0)
        s = e.score / max(1, self.edge_overlap(e1.node_id, e))
        if score >= s:
            return 0
        e = self.first_living_edge(e1.node_id, 1)
        s = e.score / max(1, self.edge_overlap(e1.node_id, e))
        if score >= s:
            return 0
        self.cut_edge_bog(e1)
        return 1

    def mask_chimeric_node(self, nid):
        n = self.nodes[nid]
        if n.bogs[1][0][0] + n.bogs[1][0][1] != 1:
            return 0
        if n.bogs[1][1][0] + n.bogs[1][1][1] != 1:
            return 0
        e1 = self.first_living_edge(nid, 0)
        e2 = self.first_living_edge(nid, 1)
        n1 = self.nodes[e1.node_id]
        for e in n1.edges[1 - e1.dir]:
            if e.node_id == e2.node_id:
                return 0  # n1 and n2 connected
        if n1.bogs[0][e1.dir][1] + n1.bogs[1][1 - e1.dir][1] + n1.bogs[1][1 - e1.dir][0] <= 1:
            return 0
        n2 = self.nodes[e2.node_id]
        if n2.bogs[0][e2.dir][1] + n2.bogs[1][1 - e2.dir][1] + n2.bogs[1][1 - e2.dir][0] <= 1:
            return 0
        for k in (0, 1):
            for e in n.edges[k]:
                self.cut_edge_bog(e)
        self.dead[nid] = True
        return 1

    def repair_lonely_one_way_edge(self, nid, dir):
        e1 = self.first_living_edge(nid, dir)
        n2 = self.nodes[e1.node_id]
        if n2.bogs[1][1 - e1.dir][0] > 0 or n2.bogs[1][1 - e1.dir][1] > 0:
            return 0
        self.repair_one_way_edge_bog(e1)
        return 1

    def repair_all_lonely_one_way_edges(self):
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            if n.bogs[1][0][0] == 0 and n.bogs[1][0][1] == 1:
                ret += self.repair_lonely_one_way_edge(nid, 0)
            if n.bogs[1][1][0] == 0 and n.bogs[1][1][1] == 1:
                ret += self.repair_lonely_one_way_edge(nid, 1)
        return ret

    def merge_bubble_core(self, nid, dir):
        """Generic two-path bubble merge (wtlay.c:1652-1738)."""
        e1 = self.first_living_edge(nid, dir)
        e2in = self.first_one_way_input_edge(nid, 1 - dir)
        if e2in is None:
            return 0
        e2 = e2in.rev  # closed out-half from nid along the second path
        paths = [[(nid, dir, e1)], [(nid, dir, e2)]]
        paths[0].append((e1.node_id, e1.dir, None))
        paths[1].append((e2.node_id, e2.dir, None))
        hash_ = {e1.node_id: (2, 0), e2.node_id: (2, 1)}
        dead = 0
        step = 0
        found = False
        while not found:
            step += 1
            if step >= MERGE_BUBBLE_MAX_STEP:
                return 0
            for k in (0, 1):
                if dead >> k & 1:
                    continue
                tnode, tdir, _ = paths[k][-1]
                n1 = self.nodes[tnode]
                if n1.bogs[1][tdir][0] or n1.bogs[1][tdir][1]:
                    e = self.first_living_edge(tnode, tdir)
                elif n1.bogs[0][1 - tdir][1] == 1:
                    ein = self.first_one_way_input_edge(tnode, 1 - tdir)
                    if ein is None:
                        dead |= 1 << k
                        if dead == 3:
                            return 0
                        continue
                    e = ein.rev
                else:
                    dead |= 1 << k
                    if dead == 3:
                        return 0
                    continue
                paths[k][-1] = (tnode, tdir, e)
                paths[k].append((e.node_id, e.dir, None))
                if e.node_id in hash_:
                    idx, kk = hash_[e.node_id]
                    if kk == k:
                        return 0
                    del paths[kk][idx:]
                    found = True
                    break
                hash_[e.node_id] = (len(paths[k]), k)
        k = 1 if len(paths[0]) >= len(paths[1]) else 0
        e = paths[k][0][2]
        for edge in (e, e.rev):
            if edge.closed == 0:
                self.cut_edge_bog(edge)
        e = paths[k][-2][2]
        for edge in (e, e.rev):
            if edge.closed == 0:
                self.cut_edge_bog(edge)
        return 1

    def merge_bubbles_bog(self):
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            for k in (0, 1):
                if n.bogs[0][1 - k][1] == 0:
                    continue
                if n.bogs[1][k][0] + n.bogs[1][k][1] != 1:
                    continue
                ret += self.merge_bubble_core(nid, k)
        return ret

    def cut_loop_core(self, nid, dir, max_step):
        cur, k = nid, dir
        for _ in range(max_step):
            e = self.first_living_edge(cur, k)
            if e is None:
                return 0
            if e.node_id == nid:
                self.cut_edge_bog(e)
                self.cut_edge_bog(e.rev)
                return 1
            cur, k = e.node_id, e.dir
        return 0

    def cut_loops(self):
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            if n.bogs[0][0][0] + n.bogs[0][0][1] > 1:
                ret += self.cut_loop_core(nid, 0, CUT_LOOP_MAX_STEP)
            if n.bogs[0][1][0] + n.bogs[0][1][1] > 1:
                ret += self.cut_loop_core(nid, 1, CUT_LOOP_MAX_STEP)
        return ret

    _T6_D0 = (0, 0, 1, 0, 1, 0, 0, 0)
    _T6_D1 = (1, 0, 0, 0, 0, 0, 1, 0)

    def recover_paired_dead_ends(self):
        """wtlay.c:1800-1905."""
        cands = {}
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            flag = self.bflag(nid)
            if flag == self._T6_D0:
                if self.count_linear_nodes(nid, 0, 10) < 10:
                    continue
            elif flag == self._T6_D1:
                if self.count_linear_nodes(nid, 1, 10) < 10:
                    continue
            else:
                continue
            cands[nid] = 0
        for nid in list(cands):
            n = self.nodes[nid]
            c = 0
            for k in (0, 1):
                for e in n.edges[k]:
                    if e.closed != 1:
                        continue
                    if e.node_id in cands:
                        c += 1
            cands[nid] = c
        cands = {nid: v for nid, v in cands.items() if v == 1}
        partner = {}
        for nid in cands:
            n = self.nodes[nid]
            val = -1
            for k in (0, 1):
                for e in n.edges[k]:
                    if e.closed != 1:
                        continue
                    if e.node_id < nid:
                        continue
                    if e.node_id not in cands:
                        continue
                    val = e.node_id
                    break
                if val >= 0:
                    break
            partner[nid] = val
        ret = 0
        for nid, val in partner.items():
            if val < 0:
                continue
            n = self.nodes[nid]
            k = n.bogs[1][0][0]
            n2 = self.nodes[val]
            dir = 1 - n2.bogs[1][0][0]
            step = 0
            while True:
                step += 1
                if step > 10:
                    break
                done = False
                for e in n.edges[k]:
                    if e.closed != 1 or e.node_id != val:
                        continue
                    if e.dir != dir:
                        done = True
                        break
                    n2 = self.nodes[val]
                    if n2.bogs[0][dir][0]:
                        p = self.first_living_edge(val, 1 - dir)
                        self.cut_edge_bog(p)
                        self.cut_edge_bog(p.rev)
                    p = e.rev
                    e.closed = 0
                    p.closed = 0
                    e.mark = 0
                    p.mark = 0
                    n.bogs[1][k][0] += 1
                    n.bogs[0][1 - k][0] += 1
                    n2.bogs[1][1 - e.dir][0] += 1
                    n2.bogs[0][e.dir][0] += 1
                    ret += 1
                    val = -1
                    done = True
                    break
                if done and val == -1:
                    break
                if done:
                    break
                e = self.first_living_edge(val, dir)
                if e is None:
                    break
                val = e.node_id
                dir = e.dir
        return ret

    _T1_D0 = (0, 0, 0, 0, 0, 1, 0, 0)
    _T1_D1 = (0, 0, 0, 0, 0, 0, 0, 1)
    _T4_D0 = (0, 1, 0, 0, 0, 0, 0, 0)
    _T4_D1 = (0, 0, 0, 1, 0, 0, 0, 0)
    _T2 = (0, 0, 0, 0, 0, 1, 0, 1)
    _NAIL_D0 = (1, 0, 0, 0, 0, 1, 1, 0)
    _NAIL_D1 = (0, 0, 1, 0, 1, 0, 0, 1)
    _JUMP_D0 = (1, 0, 0, 1, 0, 1, 1, 0)
    _JUMP_D1 = (0, 1, 1, 0, 1, 0, 0, 1)

    def repair_best_overlap(self) -> int:
        """One iteration of `R` (wtlay.c:1907-2065)."""
        tip = bub = single = rec = chi = 0
        live = [nid for nid in range(self.n) if not self.dead[nid]]
        for nid in live:
            n = self.nodes[nid]
            if n.bogs[1][0][1] and n.bogs[0][0][0] + n.bogs[0][0][1] == 0:
                self.cut_edge_bog(self.first_living_edge(nid, 0))
                tip += 1
            elif n.bogs[1][1][1] and n.bogs[0][1][0] + n.bogs[0][1][1] == 0:
                self.cut_edge_bog(self.first_living_edge(nid, 1))
                tip += 1
        for pattern, fn in (
            ((self._T1_D0, self._T1_D1), self.cut_tip1),
            ((self._T4_D0, self._T4_D1), self.cut_tip4),
        ):
            for nid in live:
                if self.dead[nid]:
                    continue
                flag = self.bflag(nid)
                if flag == pattern[0]:
                    tip += fn(nid, 0)
                elif flag == pattern[1]:
                    tip += fn(nid, 1)
        for nid in live:
            if self.dead[nid]:
                continue
            if self.bflag(nid) == self._T2:
                tip += self.cut_tip2(nid)
        for nid in live:
            if self.dead[nid]:
                continue
            flag = self.bflag(nid)
            if flag == self._NAIL_D0:
                tip += self.cut_nail(nid, 0)
            elif flag == self._NAIL_D1:
                tip += self.cut_nail(nid, 1)
        for nid in live:
            if self.dead[nid]:
                continue
            flag = self.bflag(nid)
            if flag == self._T6_D0:
                tip += self.cut_tip6(nid, 0)
            elif flag == self._T6_D1:
                tip += self.cut_tip6(nid, 1)
        bub += self.merge_bubbles_bog()
        for nid in live:
            if self.dead[nid]:
                continue
            flag = self.bflag(nid)
            if flag == self._T6_D0:
                tip += self.cut_tip3(nid, 0)
            elif flag == self._T6_D1:
                tip += self.cut_tip3(nid, 1)
        for nid in live:
            if self.dead[nid]:
                continue
            flag = self.bflag(nid)
            if flag == self._JUMP_D0:
                chi += self.repair_jump(nid, 0)
            elif flag == self._JUMP_D1:
                chi += self.repair_jump(nid, 1)
        for nid in live:
            if self.dead[nid]:
                continue
            chi += self.mask_chimeric_node(nid)
        for nid in live:
            if self.dead[nid]:
                continue
            flag = self.bflag(nid)
            if flag == self._NAIL_D0:
                chi += self.cut_nasty_jump(nid, 0)
            elif flag == self._NAIL_D1:
                chi += self.cut_nasty_jump(nid, 1)
        bub += self.cut_loops()
        for nid in live:
            if self.dead[nid]:
                continue
            flag = self.bflag(nid)
            if flag == self._NAIL_D0:
                single += self.repair_lonely_one_way_edge(nid, 0)
            elif flag == self._NAIL_D1:
                single += self.repair_lonely_one_way_edge(nid, 1)
        rec += self.recover_paired_dead_ends()
        return tip + bub + single + rec

    # ------------------------------------------------------------------
    # optional -Q strategy ops (wtlay.c:186-800, 2106-2143)
    # ------------------------------------------------------------------

    def reduce_transitive(self) -> int:
        """Myers-style transitive reduction (`T`, wtlay.c:495-547):
        per node and direction, edges ranked by off descending (shortest
        overlap first); an edge is cut (closed=2, recoverable) when a
        two-hop path from its endpoint reaches a longer-overlap
        neighbour of the same node."""
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            for d in (0, 1):
                edges = n.edges[d]
                order = sorted(range(len(edges)),
                               key=lambda j: -edges[j].off)
                rank = {}
                for j, ei in enumerate(order):
                    if edges[ei].closed == 1:
                        continue
                    rank[edges[ei].node_id] = j
                for j, ei in enumerate(order[:-1]):
                    e = edges[ei]
                    if e.closed:
                        continue
                    for e2 in self.nodes[e.node_id].edges[1 - e.dir]:
                        if e2.closed == 1:
                            continue
                        k = rank.get(e2.node_id)
                        if k is None or k <= j:
                            continue
                        e.closed = 2
                        e.rev.closed = 2
                        ret += 1
                        break
        return ret

    def better_overlap(self, score_var: float) -> int:
        """`b` (wtlay.c:186-260): mark all edges scoring below
        (1-var) x the best score-per-overlap-base among above-average
        edges; cut (closed=3) where BOTH an edge and its partner are
        marked."""
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            for d in (0, 1):
                live = [e for e in n.edges[d] if not e.closed]
                if len(live) < 2:
                    continue
                cutoff = sum(e.score for e in live) / len(live)
                best = 0.0
                for e in live:
                    if e.score < cutoff:
                        continue
                    e.mark = 0
                    s = e.score / max(1, self.edge_overlap(nid, e))
                    if s > best:
                        best = s
                if best == 0:
                    continue
                for e in live:
                    s = e.score / max(1, self.edge_overlap(nid, e))
                    if s < (1 - score_var) * best:
                        e.mark = 1
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            for d in (0, 1):
                for e in self.nodes[nid].edges[d]:
                    if e.closed or not e.mark:
                        continue
                    if e.rev.mark:
                        e.closed = 3
                        e.rev.closed = 3
                        ret += 1
        return ret

    def longest_overlap(self) -> int:
        """`L` (wtlay.c:746-800): per node+dir keep only the longest
        overlap (smallest off), unless a near-as-long edge scores >5%
        better."""
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            for d in (0, 1):
                live = [e for e in n.edges[d] if not e.closed]
                if not live:
                    continue
                best_off = int(self.rb.lengths[nid])
                b = None
                for e in live:
                    if e.off < best_off:
                        best_off = e.off
                        b = e
                if b is None:
                    continue
                best_off += 50
                bestS, c = 0.0, None
                for e in live:
                    if e.off > best_off:
                        continue
                    if e.score > bestS:
                        bestS = e.score
                        c = e
                if c is not b and b.score < 0.95 * bestS:
                    b = c
                for e in live:
                    if e is not b:
                        e.closed = 1
                        ret += 1
        self._rebuild_bogs()
        return ret

    def best_score_overlap(self) -> int:
        """`S` (wtlay.c:700-744): mark all but the best-scoring edge per
        node+dir; cut biedges where both sides are marked."""
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            for d in (0, 1):
                live = [e for e in self.nodes[nid].edges[d] if not e.closed]
                if not live:
                    continue
                best = max(live, key=lambda e: e.score)
                if best.score <= 0:
                    continue
                for e in live:
                    e.mark = 0 if e is best else 1
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            for d in (0, 1):
                for e in self.nodes[nid].edges[d]:
                    if e.closed or not e.mark or not e.rev.mark:
                        continue
                    e.closed = 1
                    e.rev.closed = 1
                    ret += 1
        return ret

    def mask_self_circle_reads(self) -> int:
        """`O` (wtlay.c:462-493): mask reads with a >= len/3 overlap to
        the SAME partner in both directions (collapsed tandem circles)."""
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            ln = int(self.rb.lengths[nid])
            fwd = {e.node_id for e in n.edges[0]
                   if not e.closed and self.edge_overlap(nid, e) >= ln // 3}
            hit = any(e.node_id in fwd for e in n.edges[1]
                      if not e.closed and self.edge_overlap(nid, e) >= ln // 3)
            if hit:
                self.mask_node(nid)
                ret += 1
        return ret

    def _rebuild_bogs(self):
        for n in self.nodes:
            n.bogs = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            for d in (0, 1):
                for e in self.nodes[nid].edges[d]:
                    if e.closed:
                        continue
                    one_way = 1 if e.rev.closed else 0
                    self.nodes[nid].bogs[1][d][one_way] += 1
                    self.nodes[e.node_id].bogs[0][e.dir][one_way] += 1

    def bog_cut_tips(self, max_step: int = 10) -> int:
        """`t` (wtlay.c:2106-2143): walk boldly up to max_step from pure
        tip starts; cut where the walk hits a branching node."""
        ret = 0
        for ms in range(1, max_step + 1):
            for nid in range(self.n):
                if self.dead[nid]:
                    continue
                for d in (0, 1):
                    n = self.nodes[nid]
                    if (n.bogs[0][d][0] + n.bogs[0][d][1]
                            + n.bogs[1][1 - d][1]):
                        continue
                    cur, cd = nid, d
                    for _ in range(ms):
                        e = self._bog_boldly_walk(cur, cd)
                        if e is None:
                            break
                        n2 = self.nodes[e.node_id]
                        if (n2.bogs[0][e.dir][0] + n2.bogs[0][e.dir][1]
                                + n2.bogs[1][1 - e.dir][1]) != 1:
                            ret += 1
                            p = e.rev
                            if e.closed == 0:
                                self.cut_edge_bog(e)
                            if p.closed == 0:
                                self.cut_edge_bog(p)
                                if (n2.bogs[e.dir][0] == 0
                                        and n2.bogs[0][e.dir][1] == 1):
                                    t = self.first_one_way_input_edge(
                                        e.node_id, e.dir)
                                    if t is not None:
                                        self.repair_one_way_edge_bog(t)
                            break
                        cur, cd = e.node_id, e.dir
        self.repair_all_lonely_one_way_edges()
        return ret

    def _bog_boldly_walk(self, nid, d):
        n = self.nodes[nid]
        if n.bogs[1][d][0] + n.bogs[1][d][1] != 1:
            return None
        return self.first_living_edge(nid, d)

    def bog_tips_bubbles_loop(self) -> int:
        """`M` (wtlay.c:3066-3088): alternate tip cutting, bubble
        merging and dead-end recovery to fixpoint, then loops."""
        total = self.bog_cut_tips(10)
        while True:
            n = self.merge_bubbles_bog()
            if n == 0:
                break
            total += n
            total += self.bog_cut_tips(10)
            total += self.recover_paired_dead_ends()
        while True:
            n = self.merge_bubbles_bog() + self.cut_loops()
            if n == 0:
                break
            total += n
            total += self.bog_cut_tips(10)
            total += self.recover_paired_dead_ends()
        return total

    # ------------------------------------------------------------------
    # unitig generation + output (wtlay.c:2331-2838)
    # ------------------------------------------------------------------

    def cut_all_branches(self) -> int:
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n = self.nodes[nid]
            for k in (0, 1):
                if n.bogs[0][k][1]:
                    for e in n.edges[1 - k]:
                        if e.closed != 1:
                            continue
                        p = e.rev
                        if p.closed:
                            continue
                        self.cut_edge_bog(p)
                        ret += 1
        return ret

    def _bog_step_once(self, lay, visited) -> bool:
        nid, dir, _fwd, _bwd, off, cont = lay[-1]
        n1 = self.nodes[nid]
        if n1.bogs[1][dir][1]:
            return False
        if n1.bogs[1][dir][0] == 0:
            return False
        e = self.single_living_edge(nid, dir)
        if e is None:
            return False
        if visited[e.node_id]:
            return False
        n2 = self.nodes[e.node_id]
        if n2.bogs[0][e.dir][1]:
            return False
        lay[-1] = (nid, dir, e, _bwd, off, cont)
        lay.append((e.node_id, e.dir, None, e.rev, off + e.off, 0))
        return True

    def _reverse_flip(self, lay):
        lay.reverse()
        off = 0
        for i in range(len(lay)):
            nid, dir, fwd, bwd, _off, cont = lay[i]
            dir = 1 - dir
            fwd, bwd = bwd, fwd
            lay[i] = (nid, dir, fwd, bwd, off, cont)
            if fwd is not None:
                off += fwd.off

    def gen_unitigs_layout(self) -> int:
        visited = np.zeros(self.n, bool)
        self.lays = []
        for nid in range(self.n):
            n = self.nodes[nid]
            n.lay_id = -1
            n.lay_dir = 0
            n.lay_off = 0
            n.lay_end = 0
        self.cut_all_branches()
        for nid in range(self.n):
            if self.dead[nid] or visited[nid]:
                continue
            if self.rb.lengths[nid] == 0:
                continue
            lay = [(nid, 0, None, None, 0, 0)]
            visited[nid] = True
            while self._bog_step_once(lay, visited):
                visited[lay[-1][0]] = True
            self._reverse_flip(lay)
            while self._bog_step_once(lay, visited):
                visited[lay[-1][0]] = True
            self.lays.append(lay)
        for i, lay in enumerate(self.lays):
            if len(lay) < MIN_LAY_NODES:
                continue
            for j, (nd, dir, fwd, bwd, off, cont) in enumerate(lay):
                n = self.nodes[nd]
                n.lay_id = i
                n.lay_dir = dir
                n.lay_off = off
                n.lay_end = 1 if (j < 2 or j + 2 > len(lay)) else 0
        return len(self.lays)

    def recover_edges_inter_unitigs(self, best_score_cutoff: float) -> int:
        ret = 0
        for nid in range(self.n):
            if self.dead[nid]:
                continue
            n1 = self.nodes[nid]
            if n1.lay_id == -1 or n1.lay_end == 0:
                continue
            for k in (0, 1):
                bestS = 0.0
                for e in n1.edges[k]:
                    if e.closed not in (0, 1):
                        continue
                    n2 = self.nodes[e.node_id]
                    if n2.lay_id == -1 or n2.lay_end == 0:
                        continue
                    if e.score > bestS:
                        bestS = e.score
                if bestS == 0:
                    continue
                bestS *= best_score_cutoff
                best_off = int(self.rb.lengths[nid])
                b = None
                for e in n1.edges[k]:
                    if e.closed not in (0, 1):
                        continue
                    n2 = self.nodes[e.node_id]
                    if n2.lay_id == -1 or n2.lay_end == 0:
                        continue
                    if e.score < bestS:
                        continue
                    if e.off < best_off:
                        best_off = e.off
                        b = e
                if b is None or b.closed == 0:
                    continue
                for e in n1.edges[k]:
                    if e.closed:
                        continue
                    self.cut_edge_bog(e)
                ret += self.revive_edge_bog(b)
        self.repair_all_lonely_one_way_edges()
        return ret

    def _is_duplicated(self, lay, min_cov: float):
        """wtlay.c:2656-2738."""
        votes: set[tuple[int, int]] = set()
        my_lay = self.nodes[lay[0][0]].lay_id
        for i, entry in enumerate(lay):
            n1 = self.nodes[entry[0]]
            for k in (0, 1):
                for e in n1.edges[k]:
                    if e.closed != 1:
                        continue
                    n2 = self.nodes[e.node_id]
                    if n2.lay_id == -1 or n2.lay_id == my_lay:
                        continue
                    votes.add((n2.lay_id, i))
        if not votes:
            return False, -1, 0.0
        counts: dict[int, int] = {}
        for layid, _ in votes:
            counts[layid] = counts.get(layid, 0) + 1
        layid = max(counts, key=lambda x: (counts[x], -x))
        tot_len = cov_len = 0
        for entry in lay:
            nid = entry[0]
            n1 = self.nodes[nid]
            rdlen = int(self.rb.lengths[nid])
            tot_len += rdlen
            ivs = []
            for k in (0, 1):
                for e in n1.edges[k]:
                    if e.closed != 1:
                        continue
                    if self.nodes[e.node_id].lay_id != layid:
                        continue
                    if k:
                        y = e.off
                        x = y + self.edge_overlap(nid, e)
                        x, y = rdlen - x, rdlen - y
                    else:
                        x = e.off
                        y = x + self.edge_overlap(nid, e)
                    ivs.append((x, y))
            if not ivs:
                continue
            ivs.sort()
            x, y = ivs[0]
            cov = 0
            for x2, y2 in ivs[1:]:
                if x2 > y:
                    cov += y - x
                    x, y = x2, y2
                elif y2 > y:
                    y = y2
            cov += y - x
            cov_len += cov
        frac = cov_len / max(1, tot_len)
        return cov_len >= int(min_cov * tot_len), layid, frac

    def _recurit_contained(self, lay):
        """Re-insert contained reads around their containers (wtlay.c:2468-2497)."""
        out = []
        for entry in lay:
            nid, dir, fwd, bwd, off, cont = entry
            n = self.nodes[nid]
            len1 = int(self.rb.lengths[nid])
            out.append(entry)
            for k in (0, 1):
                for e in n.edges[k]:
                    if not self.dead[e.node_id]:
                        continue
                    if not e.rev.att:
                        continue
                    d2 = dir ^ k ^ e.dir
                    if dir ^ k:
                        o2 = off + len1 - (e.off + self.edge_overlap(nid, e))
                    else:
                        o2 = off + e.off
                    out.append((e.node_id, d2, None, None, o2, 1))
        lay[:] = out

    def lay_length(self, lay) -> int:
        ln = 0
        for entry in lay:
            ln = max(ln, entry[4] + int(self.rb.lengths[entry[0]]))
        return ln

    def output_layout(self, lay_fh, utg_fh, dup_lay_fh=None, dup_utg_fh=None,
                      utg_sm: float = 0.4, lnk_fh=None):
        """Write .lay + .utg (and .dup/.lnk variants) — wtlay.c:2740-2838."""
        n_indep = 0
        for i, lay in enumerate(self.lays):
            if len(lay) < MIN_LAY_NODES:
                is_dup, dup_utg, dup_cov = True, 19830203, 0.0
            else:
                is_dup, dup_utg, dup_cov = self._is_duplicated(lay, utg_sm)
            self._recurit_contained(lay)
            ln = self.lay_length(lay)
            if is_dup:
                hdr = f">utg{i} length={ln} nodes={len(lay)} dup=utg{dup_utg} cov={dup_cov:.3f}\n"
                out_lay = dup_lay_fh
                out_seq = dup_utg_fh
            else:
                hdr = f">utg{i} length={ln} nodes={len(lay)}\n"
                out_lay = lay_fh
                out_seq = utg_fh
                n_indep += 1
            if out_lay is not None:
                out_lay.write(hdr)
            if out_seq is not None:
                out_seq.write(hdr)
            ctg = np.zeros(ln, dtype=np.uint8)
            built = 0
            for nid, dir, fwd, bwd, off, cont in lay:
                if lnk_fh is not None and not cont:
                    n1 = self.nodes[nid]
                    for k in (0, 1):
                        for e in n1.edges[k]:
                            if e.closed == 2:
                                continue
                            n2 = self.nodes[e.node_id]
                            if n2.lay_id == i or n2.lay_id == -1:
                                continue
                            p = e.rev
                            ovl = self.edge_overlap(nid, e)
                            ovl2 = self.edge_overlap(e.node_id, p)
                            lnk_fh.write(
                                f"utg{n1.lay_id}\t{self.rb.names[nid]}\t{'+-'[n1.lay_dir]}\t{n1.lay_off}"
                                f"\tutg{n2.lay_id}\t{self.rb.names[e.node_id]}\t{'+-'[n2.lay_dir]}\t{n2.lay_off}"
                                f"\t{'+-'[k]}\t{self.rb.lengths[nid]}\t{e.off}\t{e.off + ovl}"
                                f"\t{'+-'[e.dir]}\t{self.rb.lengths[e.node_id]}\t{p.off}\t{p.off + ovl2}"
                                f"\t{e.score}\n")
                rdlen = int(self.rb.lengths[nid])
                codes = self.rb.get(nid)
                if dir:
                    codes = revcomp_codes(codes)
                if out_lay is not None:
                    row = (f"{'YN'[cont]}\t{self.rb.names[nid]}\t{'+-'[dir]}"
                           f"\t{off}\t{rdlen}\t{codes_to_seq(codes)}")
                    # f5q column 7: oriented 7-track qualities
                    # (reference wtlay.c:2801-2822)
                    q = (self.rb.quals[nid]
                         if getattr(self.rb, "quals", None) else None)
                    if q is not None:
                        from ..data.readbank import encode_f5q, revcomp_f5q

                        row += "\t" + encode_f5q(revcomp_f5q(q) if dir else q)
                    out_lay.write(row + "\n")
                if cont or off + rdlen <= built:
                    continue
                ctg[off : off + rdlen] = codes
                built = off + rdlen
            if out_seq is not None:
                seq = codes_to_seq(ctg[:built])
                for j in range(0, built, 100):
                    out_seq.write(seq[j : j + 100])
                    out_seq.write("\n")
        return n_indep


def run_lay(rb: ReadBank, overlaps, params: LayParams | None = None) -> StringGraph:
    """Full wtlay pipeline with the default command sequence."""
    p = params or LayParams()
    g = StringGraph(rb, p)
    ne = g.load_overlaps(overlaps)
    log("wtlay: %d reads, %d dovetail overlaps", len(rb), ne)
    g.cal_edge_coverage()
    nd = g.remove_duplicate_edges()
    log("wtlay: removed %d duplicate edges", nd)
    dot_idx = 0
    for cmd in p.commands:
        if cmd == "C":
            n = g.mask_contained_reads()
            log("wtlay: masked %d contained reads", n)
        elif cmd == "w":
            n = g.mask_low_cov_edges(p.edgecov_cutoff)
            log("wtlay: masked %d low coverage edges", n)
        elif cmd == "B":
            n = g.best_overlap(p.best_score_cutoff)
            log("wtlay: best_overlap cut %d edges", n)
        elif cmd == "R":
            while True:
                n = g.repair_best_overlap()
                if n == 0:
                    break
                log("wtlay: repaired %d bog elements", n)
        elif cmd == "U":
            n = g.gen_unitigs_layout()
            log("wtlay: generated %d unitigs", n)
            n = g.recover_edges_inter_unitigs(p.best_score_cutoff)
            log("wtlay: recovered %d inter-unitig edges", n)
        elif cmd == "T":
            n = g.reduce_transitive()
            log("wtlay: reduced %d transitive edges", n)
        elif cmd == "b":
            n = g.better_overlap(p.score_var)
            log("wtlay: better_overlap cut %d bad edges", n)
        elif cmd == "L":
            n = g.longest_overlap()
            log("wtlay: longest_overlap cut %d edges", n)
        elif cmd == "S":
            n = g.best_score_overlap()
            log("wtlay: best_score cut %d edges", n)
        elif cmd == "O":
            n = g.mask_self_circle_reads()
            log("wtlay: masked %d self circle reads", n)
        elif cmd == "t":
            n = g.bog_cut_tips(10)
            log("wtlay: cut %d read tips", n)
        elif cmd == "M":
            n = g.bog_tips_bubbles_loop()
            log("wtlay: tips/bubbles/loops fixpoint removed %d elements", n)
        elif cmd == "X":
            n = 0
            for nid in range(g.n):
                if not g.dead[nid]:
                    n += g.mask_chimeric_node(nid)
            log("wtlay: masked %d chimeric reads", n)
        elif cmd == "g":
            if p.dot_prefix:
                dot_idx += 1
                with open(f"{p.dot_prefix}.{dot_idx}.dot", "w") as fh:
                    g.write_dot(fh)
        else:
            raise ValueError(
                f"unsupported wtlay -Q command {cmd!r} "
                f"(supported: g C w B R U T b L S O t M X)")
    n = g.gen_unitigs_layout()
    log("wtlay: final %d unitigs", n)
    g.recover_edges_inter_unitigs(p.best_score_cutoff)
    return g
