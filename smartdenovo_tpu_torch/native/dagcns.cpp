// DAG consensus engine — native host component of the consensus stage.
//
// Re-implementation of the reference's DAGCon-style consensus semantics
// (reference dagcns.h: gen_pregraph :167-183, alignment2dagcns :264-310,
// polish_pairwise_aln :214-262, merge_nodes :427-480, gen_consensus
// topological DP :486-559) with idiomatic C++ data structures (indexed
// edge pools + per-node edge index vectors instead of intrusive linked
// lists).  The device side (batched banded alignment producing the
// pairwise alignment strings) lives in smartdenovo_tpu/ops; this module
// only consumes alignment strings and emits consensus bases.
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <deque>
#include <queue>
#include <vector>

namespace {

constexpr uint32_t NIL = 0xFFFFFFFFu;
constexpr uint8_t GAP = 4;

struct Edge {
    uint32_t from, to;
    uint32_t cov;
    bool visited;
    bool alive;
};

struct Node {
    uint32_t pos;
    uint8_t base;
    float aux;
    uint32_t fw_edge;
    std::vector<uint32_t> outs;  // edge ids
    std::vector<uint32_t> ins;
};

struct Dag {
    std::vector<Node> nodes;
    std::vector<Edge> edges;
    std::vector<uint8_t> cns;
    std::vector<uint32_t> deps;
    uint32_t backbone_size = 0;
    double cns_score = 0;
    float ref_penalty = 0.5f;
    float alt_penalty = 0.2f;

    uint32_t new_node(uint32_t pos, uint8_t base) {
        nodes.push_back(Node{pos, base, 0.f, NIL, {}, {}});
        return (uint32_t)nodes.size() - 1;
    }

    uint32_t find_edge(uint32_t a, uint32_t b) const {
        const Node& n = nodes[a];
        for (uint32_t eid : n.outs) {
            if (edges[eid].alive && edges[eid].to == b) return eid;
        }
        return NIL;
    }

    uint32_t add_edge(uint32_t a, uint32_t b, uint32_t cov) {
        edges.push_back(Edge{a, b, cov, false, true});
        uint32_t eid = (uint32_t)edges.size() - 1;
        // PREPEND, mirroring the reference's intrusive lists
        // (dagcns.h:153-157): every iteration order — DP tie-breaks,
        // merge survivor pick, alt-node reuse — sees newest-first,
        // exactly as the binary does
        nodes[a].outs.insert(nodes[a].outs.begin(), eid);
        nodes[b].ins.insert(nodes[b].ins.begin(), eid);
        return eid;
    }

    uint32_t prepare_edge(uint32_t a, uint32_t b) {
        uint32_t eid = find_edge(a, b);
        if (eid != NIL) {
            edges[eid].cov++;
            return eid;
        }
        return add_edge(a, b, 1);
    }

    void remove_edge(uint32_t eid) {
        edges[eid].alive = false;  // lazily skipped during scans
    }

    void compact_node_edges(uint32_t nid) {
        Node& n = nodes[nid];
        auto keep = [&](std::vector<uint32_t>& v) {
            size_t w = 0;
            for (size_t r = 0; r < v.size(); r++)
                if (edges[v[r]].alive) v[w++] = v[r];
            v.resize(w);
        };
        keep(n.outs);
        keep(n.ins);
    }

    void set_backbone(const uint8_t* seq, uint32_t len) {
        nodes.clear();
        edges.clear();
        cns.assign(seq, seq + len);
        deps.assign(len, 0);
        backbone_size = len;
        for (uint32_t i = 0; i < len; i++) {
            new_node(i, seq[i]);
            if (i) add_edge(i - 1, i, 0);  // connectivity backbone, cov 0
        }
    }
};

// --- pairwise alignment polish (dagcns.h:214-262) -------------------------

static void polish(std::vector<uint8_t>& a0, std::vector<uint8_t>& a1) {
    // phase 1: split mismatch columns into deletion+insertion.  DEL-first
    // matches the reference pipeline's effective order: aln_read_wtcns
    // emits mismatches pre-split with the target base first
    // (wtcns.c:404-414, has_mismatch=0), so polish_pairwise_aln's own
    // ins-first split never fires on the rows that reach the DAG.  The
    // order shifts alt-node positions by one and flips homopolymer-tie
    // left-shift outcomes, which perturbs vote stacking.
    std::vector<uint8_t> r0, r1;
    r0.reserve(a0.size() * 2);
    r1.reserve(a1.size() * 2);
    for (size_t i = 0; i < a0.size(); i++) {
        if (a0[i] != a1[i] && a0[i] != GAP && a1[i] != GAP) {
            r0.push_back(a0[i]);
            r1.push_back(GAP);
            r0.push_back(GAP);
            r1.push_back(a1[i]);
        } else {
            r0.push_back(a0[i]);
            r1.push_back(a1[i]);
        }
    }
    // phase 2: shift bases left into gap runs until fixpoint
    uint8_t* rows[2] = {r0.data(), r1.data()};
    size_t len = r0.size();
    while (true) {
        int changed = 0;
        size_t gaps[2] = {0, 0};
        for (size_t i = 0; i < len; i++) {
            for (int j = 0; j < 2; j++) {
                if (rows[j][i] == GAP) {
                    gaps[j]++;
                    continue;
                }
                if (gaps[j] == 0) continue;
                size_t m = i - gaps[j];
                for (; m < i; m++) {
                    if (rows[1 - j][m] == rows[j][i]) {
                        rows[j][m] = rows[j][i];
                        rows[j][i] = GAP;
                        changed++;
                        break;
                    }
                }
                gaps[j] = i - m;
            }
        }
        if (!changed) break;
    }
    a0.swap(r0);
    a1.swap(r1);
}

// --- read insertion (dagcns.h:264-310) ------------------------------------

static void add_alignment(Dag& g, int beg, int end, const uint8_t* aln0,
                          const uint8_t* aln1, int len) {
    std::vector<uint8_t> a0(aln0, aln0 + len), a1(aln1, aln1 + len);
    polish(a0, a1);
    size_t n = a0.size();
    while (n && a0[n - 1] == GAP) n--;
    int x1 = beg;
    uint32_t lst = NIL;
    for (size_t i = 0; i < n; i++) {
        if (a0[i] == a1[i]) {
            if (a0[i] == GAP) continue;
            uint32_t cur = (uint32_t)x1++;
            if (lst == NIL) {
                lst = cur;
                continue;
            }
            g.prepare_edge(lst, cur);
            lst = cur;
        } else if (a0[i] == GAP) {
            if (lst == NIL) continue;
            uint8_t base = a1[i];
            uint32_t cur = NIL;
            for (uint32_t eid : g.nodes[lst].outs) {
                if (!g.edges[eid].alive) continue;
                uint32_t to = g.edges[eid].to;
                if (to >= g.backbone_size && g.nodes[to].base == base) {
                    g.edges[eid].cov++;
                    cur = to;
                    break;
                }
            }
            if (cur == NIL) {
                cur = g.new_node((uint32_t)x1, base);
                g.prepare_edge(lst, cur);
            }
            lst = cur;
        } else {
            x1++;
        }
    }
    for (int j = beg; j < end && j < (int)g.deps.size(); j++) g.deps[j]++;
}

// --- node merging (dagcns.h:318-480) --------------------------------------

static void merge_core(Dag& g, uint32_t start, int dir,
                       std::vector<uint32_t>& stack) {
    stack.clear();
    stack.push_back(start);
    while (!stack.empty()) {
        uint32_t nid = stack.back();
        stack.pop_back();
        g.compact_node_edges(nid);
        Node& n0 = g.nodes[nid];
        auto& elist = dir ? n0.ins : n0.outs;
        if (elist.empty()) continue;
        std::vector<uint32_t> cache[4];
        for (uint32_t eid : elist) {
            if (!g.edges[eid].alive) continue;
            uint32_t to = dir ? g.edges[eid].from : g.edges[eid].to;
            Node& t = g.nodes[to];
            // only merge targets whose sole reverse link is this node
            auto& back = dir ? t.outs : t.ins;
            int nb = 0;
            for (uint32_t b : back)
                if (g.edges[b].alive && ++nb > 1) break;
            if (nb == 1) cache[t.base].push_back(eid);
        }
        for (int base = 0; base < 4; base++) {
            for (uint32_t eid : cache[base]) g.edges[eid].visited = true;
            if (cache[base].size() < 2) continue;
            uint32_t e1 = cache[base][0];
            uint32_t nid1 = dir ? g.edges[e1].from : g.edges[e1].to;
            for (size_t i = 1; i < cache[base].size(); i++) {
                uint32_t e2 = cache[base][i];
                uint32_t nid2 = dir ? g.edges[e2].from : g.edges[e2].to;
                g.edges[e1].cov += g.edges[e2].cov;
                g.remove_edge(e2);
                Node& v = g.nodes[nid2];
                auto& fwd = dir ? v.ins : v.outs;
                for (uint32_t feid : fwd) {
                    if (!g.edges[feid].alive) continue;
                    uint32_t far = dir ? g.edges[feid].from : g.edges[feid].to;
                    uint32_t cov = g.edges[feid].cov;
                    uint32_t ne;
                    if (dir)
                        ne = g.find_edge(far, nid1);
                    else
                        ne = g.find_edge(nid1, far);
                    if (ne != NIL) {
                        g.edges[ne].cov += cov;
                    } else {
                        ne = dir ? g.add_edge(far, nid1, cov)
                                 : g.add_edge(nid1, far, cov);
                    }
                    g.edges[ne].visited = true;
                    g.remove_edge(feid);
                }
                fwd.clear();
            }
            stack.push_back(nid1);
        }
    }
}

static bool has_unvisited(Dag& g, uint32_t nid, int dir) {
    Node& n = g.nodes[nid];
    auto& elist = dir ? n.ins : n.outs;
    for (uint32_t eid : elist)
        if (g.edges[eid].alive && !g.edges[eid].visited) return true;
    return false;
}

static void merge_nodes(Dag& g) {
    for (auto& e : g.edges) e.visited = false;
    std::deque<uint32_t> queue;
    for (uint32_t i = 0; i < g.nodes.size(); i++) {
        g.compact_node_edges(i);
        if (g.nodes[i].ins.empty()) queue.push_back(i);
    }
    std::vector<uint32_t> stack;
    while (!queue.empty()) {
        uint32_t nid = queue.front();
        queue.pop_front();
        merge_core(g, nid, 1, stack);
        merge_core(g, nid, 0, stack);
        g.compact_node_edges(nid);
        for (uint32_t eid : g.nodes[nid].outs) {
            if (!g.edges[eid].alive) continue;
            g.edges[eid].visited = true;
        }
        for (uint32_t eid : g.nodes[nid].outs) {
            if (!g.edges[eid].alive) continue;
            uint32_t to = g.edges[eid].to;
            if (!has_unvisited(g, to, 1)) queue.push_back(to);
        }
    }
}

// --- consensus path (dagcns.h:486-559) ------------------------------------

static void gen_consensus(Dag& g, std::vector<uint32_t>* map) {
    std::deque<uint32_t> queue;
    for (uint32_t i = 0; i < g.nodes.size(); i++) {
        g.compact_node_edges(i);
        Node& n = g.nodes[i];
        if (n.outs.empty() && !n.ins.empty()) {
            queue.push_back(i);
            n.fw_edge = NIL;
            n.aux = 0;
        }
    }
    for (auto& e : g.edges) e.visited = false;
    while (!queue.empty()) {
        uint32_t nid = queue.front();
        queue.pop_front();
        Node& n1 = g.nodes[nid];
        float best_s = -3.4e38f;
        uint32_t best_e = NIL;
        for (uint32_t eid : n1.outs) {
            if (!g.edges[eid].alive) continue;
            uint32_t to = g.edges[eid].to;
            float pen = (to < g.backbone_size) ? g.ref_penalty : g.alt_penalty;
            uint32_t dep = (n1.pos < g.deps.size()) ? g.deps[n1.pos] : 0;
            float score = g.nodes[to].aux + g.edges[eid].cov - pen * dep;
            if (score > best_s) {
                best_s = score;
                best_e = eid;
            }
        }
        if (best_s > -3.4e38f) n1.aux = best_s;
        n1.fw_edge = best_e;
        for (uint32_t eid : n1.ins) {
            if (!g.edges[eid].alive) continue;
            g.edges[eid].visited = true;
            uint32_t from = g.edges[eid].from;
            if (!has_unvisited(g, from, 0)) queue.push_back(from);
        }
    }
    g.cns.clear();
    if (map) map->clear();
    uint32_t head = 0;  // backbone start
    Node* n1 = &g.nodes[head];
    g.cns_score = n1->aux;
    uint32_t lst = 0;
    g.cns.push_back(n1->base);
    while (n1->fw_edge != NIL) {
        Edge& e = g.edges[n1->fw_edge];
        if (map && e.to < g.backbone_size) {
            while (lst < e.to) {
                map->push_back((uint32_t)g.cns.size());
                lst++;
            }
        }
        n1 = &g.nodes[e.to];
        g.cns.push_back(n1->base);
    }
    if (map)
        while (lst <= g.backbone_size) {
            map->push_back((uint32_t)g.cns.size());
            lst++;
        }
    g.deps.assign(g.cns.size(), 0);
}

}  // namespace

extern "C" {

void* dagcns_new(float ref_penalty, float alt_penalty) {
    Dag* g = new Dag();
    g->ref_penalty = ref_penalty;
    g->alt_penalty = alt_penalty;
    return g;
}

void dagcns_free(void* h) { delete (Dag*)h; }

void dagcns_set_backbone(void* h, const uint8_t* seq, int len) {
    ((Dag*)h)->set_backbone(seq, (uint32_t)len);
}

void dagcns_add_alignment(void* h, int beg, int end, const uint8_t* aln0,
                          const uint8_t* aln1, int len) {
    add_alignment(*(Dag*)h, beg, end, aln0, aln1, len);
}

void dagcns_merge_nodes(void* h) { merge_nodes(*(Dag*)h); }

// Runs the consensus DP; returns new consensus length.  map_out (optional,
// capacity backbone_size+2) receives old->new coordinate mapping.
int dagcns_consensus(void* h, uint32_t* map_out, int map_cap) {
    Dag& g = *(Dag*)h;
    std::vector<uint32_t> map;
    gen_consensus(g, map_out ? &map : nullptr);
    if (map_out) {
        int m = (int)map.size();
        if (m > map_cap) m = map_cap;
        memcpy(map_out, map.data(), m * sizeof(uint32_t));
    }
    return (int)g.cns.size();
}

// Copies the current consensus bases (after dagcns_consensus).
int dagcns_get_cns(void* h, uint8_t* out, int cap) {
    Dag& g = *(Dag*)h;
    int n = (int)g.cns.size();
    if (n > cap) n = cap;
    memcpy(out, g.cns.data(), n);
    return (int)g.cns.size();
}

double dagcns_score(void* h) { return ((Dag*)h)->cns_score; }

int dagcns_num_nodes(void* h) { return (int)((Dag*)h)->nodes.size(); }

// SNV calling along the consensus path (reference dagcns.h:620-662):
// at each consensus step, compare the consensus edge's support with the
// best alternative single-node bridge to the node after next; report
// positions where an alternative base has count >= min_cnt and
// >= min_freq * consensus count.  Writes up to cap records of
// (pos, cns_base, alt_base, cns_cnt, alt_cnt) into out5.
int dagcns_call_snv(void* h, int min_cnt, float min_freq, int32_t* out5,
                    int cap) {
    Dag& g = *(Dag*)h;
    if (g.cns.size() < 3) return 0;
    int nrec = 0;
    // walk consensus path: node ids along fw_edge chain from node 0
    uint32_t n0 = 0;
    int pos = 0;
    while (g.nodes[n0].fw_edge != NIL && nrec < cap) {
        pos++;
        const Edge& e1 = g.edges[g.nodes[n0].fw_edge];
        uint32_t n1 = e1.to;
        if (g.nodes[n1].fw_edge == NIL) break;
        uint32_t n2 = g.edges[g.nodes[n1].fw_edge].to;
        uint32_t cns_cnt = std::min(e1.cov, g.edges[g.nodes[n1].fw_edge].cov);
        uint32_t alt_cnt[4] = {0, 0, 0, 0};
        Node& nd0 = g.nodes[n0];
        for (uint32_t eid : nd0.outs) {
            if (!g.edges[eid].alive) continue;
            uint32_t mid = g.edges[eid].to;
            if (mid == n1) continue;
            uint32_t e2 = g.find_edge(mid, n2);
            if (e2 == NIL) continue;
            uint32_t c = std::min(g.edges[eid].cov, g.edges[e2].cov);
            uint8_t b = g.nodes[mid].base;
            if (c > alt_cnt[b]) alt_cnt[b] = c;
        }
        uint8_t cb = g.nodes[n1].base;
        for (int b = 0; b < 4; b++) {
            if (b == cb) continue;
            if ((int)alt_cnt[b] >= min_cnt &&
                alt_cnt[b] >= min_freq * std::max<uint32_t>(1, cns_cnt)) {
                out5[nrec * 5 + 0] = pos;
                out5[nrec * 5 + 1] = cb;
                out5[nrec * 5 + 2] = b;
                out5[nrec * 5 + 3] = (int32_t)cns_cnt;
                out5[nrec * 5 + 4] = (int32_t)alt_cnt[b];
                nrec++;
                break;
            }
        }
        n0 = n1;
    }
    return nrec;
}

}  // extern "C"
