// Partial-order alignment (POA) consensus — native host engine.
//
// Equivalent of the reference's pomsa.h (wtmsa consensus caller #2):
// reads are aligned directly TO the growing partial-order graph with a
// banded DP over topologically-ordered nodes (pomsa.h:310-714
// beg_update/update_pomsa, band W=100 around the backbone coordinate),
// threaded in as new nodes/edges, and the consensus is the heaviest
// edge-coverage path (call_consensus_pomsa :820-903).
//
// Graph DP follows Lee/Grasso/Sharlow's POA formulation; the banding,
// backbone-position windows and coverage bookkeeping mirror the
// reference's semantics without copying its layout.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <queue>
#include <vector>

namespace {

constexpr uint32_t NIL = 0xFFFFFFFFu;

struct PNode {
    uint32_t pos;        // backbone coordinate (for banding/windows)
    uint8_t base;
    uint32_t cov;        // reads passing through this node
    uint32_t next;       // topological linked list (insert-after is O(1))
    std::vector<uint32_t> preds;
    std::vector<uint32_t> succs;
};

struct PEdge {};  // edge coverage kept in a map keyed (from,to)

struct Poa {
    std::vector<PNode> nodes;
    // edge coverage: per node, parallel arrays over succs
    std::vector<std::vector<uint32_t>> ecov;
    uint32_t backbone_len = 0;
    int match = 2, mismatch = -5, gap = -3;
    int band = 100;

    uint32_t head = NIL;

    // create a node and splice it into the topo list right after `after`
    // (NIL = new head); threading only ever inserts after the previous
    // consumed node, so list order is always a valid topological order.
    uint32_t new_node(uint32_t pos, uint8_t base, uint32_t after) {
        nodes.push_back(PNode{pos, base, 0, NIL, {}, {}});
        ecov.push_back({});
        uint32_t id = (uint32_t)nodes.size() - 1;
        if (after == NIL) {
            nodes[id].next = head;
            head = id;
        } else {
            nodes[id].next = nodes[after].next;
            nodes[after].next = id;
        }
        return id;
    }

    void add_edge(uint32_t u, uint32_t v, uint32_t cov) {
        PNode& a = nodes[u];
        for (size_t i = 0; i < a.succs.size(); i++) {
            if (a.succs[i] == v) {
                ecov[u][i] += cov;
                return;
            }
        }
        a.succs.push_back(v);
        ecov[u].push_back(cov);
        nodes[v].preds.push_back(u);
    }

    void init_backbone(const uint8_t* seq, uint32_t len) {
        nodes.clear();
        ecov.clear();
        head = NIL;
        backbone_len = len;
        uint32_t prev = NIL;
        for (uint32_t i = 0; i < len; i++) {
            prev = new_node(i, seq[i], prev);
            if (i) add_edge(i - 1, i, 0);
        }
    }

    // Topological order of the nodes with pos in [lo, hi), over the edges
    // between them (Kahn's algorithm).  The linked list is not always a
    // topological order: a substitution node that opens a read's path is
    // spliced in after node id v - 1, which is v's list predecessor only
    // on the backbone.  Ties go to the earlier list position, so where the
    // list is topological this is the list order.  Nodes left on a cycle,
    // if any, follow in list order.
    void topo_window(uint32_t lo, uint32_t hi, std::vector<uint32_t>& order) {
        std::vector<uint32_t> list;
        for (uint32_t v = head; v != NIL; v = nodes[v].next) {
            if (nodes[v].pos >= lo && nodes[v].pos < hi) list.push_back(v);
        }
        std::vector<int> rank(nodes.size(), -1);
        for (size_t r = 0; r < list.size(); r++) rank[list[r]] = (int)r;
        std::vector<int> indeg(list.size(), 0);
        for (size_t r = 0; r < list.size(); r++) {
            for (uint32_t u : nodes[list[r]].preds) indeg[r] += rank[u] >= 0;
        }
        std::priority_queue<int, std::vector<int>, std::greater<int>> ready;
        for (size_t r = 0; r < list.size(); r++) {
            if (indeg[r] == 0) ready.push((int)r);
        }
        std::vector<char> out(list.size(), 0);
        order.clear();
        while (!ready.empty()) {
            const int r = ready.top();
            ready.pop();
            out[r] = 1;
            order.push_back(list[r]);
            for (uint32_t s : nodes[list[r]].succs) {
                const int k = rank[s];
                if (k >= 0 && --indeg[k] == 0) ready.push(k);
            }
        }
        for (size_t r = 0; r < list.size(); r++) {
            if (!out[r]) order.push_back(list[r]);
        }
    }

    // Align read to the graph in window [wlo, whi); thread it in.
    // Returns alignment score, or INT32_MIN on failure.
    int align_and_add(const uint8_t* read, int rlen, uint32_t wlo, uint32_t whi) {
        std::vector<uint32_t> order;
        topo_window(wlo, whi, order);
        if (order.empty() || rlen <= 0) return INT32_MIN;
        int N = (int)order.size();
        int W = band * 2;
        // read-position band per node: center = (pos - wlo) * rlen / window
        double scale = (double)rlen / std::max<uint32_t>(1, whi - wlo);
        std::vector<int> jlo(N), jhi(N);
        std::vector<int> idx_of(nodes.size(), -1);
        for (int i = 0; i < N; i++) {
            idx_of[order[i]] = i;
            int c = (int)((nodes[order[i]].pos - wlo) * scale);
            jlo[i] = std::max(0, c - band);
            jhi[i] = std::min(rlen, c + band);
            if (jlo[i] >= jhi[i]) {
                jlo[i] = std::max(0, std::min(jlo[i], rlen - 1));
                jhi[i] = std::min(rlen, jlo[i] + 1);
            }
        }
        constexpr int NEG = -(1 << 28);
        // H[i][j-jlo[i]]: best score of alignment ending by consuming node i
        // (as match/mismatch or deletion step) with j read chars consumed.
        std::vector<std::vector<int>> H(N), BJ(N);
        std::vector<std::vector<int>> BI(N);  // predecessor node index (-1 root)
        std::vector<std::vector<int8_t>> OP(N);  // 0=sub,1=del(node only),2=ins(read)
        int best = NEG, bi = -1, bj = -1;
        for (int i = 0; i < N; i++) {
            int w = jhi[i] - jlo[i] + 1;
            H[i].assign(w, NEG);
            BI[i].assign(w, -2);
            BJ[i].assign(w, -1);
            OP[i].assign(w, 0);
            const PNode& nd = nodes[order[i]];
            for (int j = jlo[i]; j <= jhi[i]; j++) {
                int off = j - jlo[i];
                int sc = NEG, pbi = -2, pbj = -1;
                int8_t op = 0;
                // start fresh (local): consume node i with read char j
                if (j > jlo[i]) {
                    int sub = (read[j - 1] == nd.base) ? match : mismatch;
                    // from predecessors (match/mismatch)
                    int cand = 0 + sub;  // local restart
                    if (cand > sc) { sc = cand; pbi = -1; pbj = j - 1; op = 0; }
                    for (uint32_t u : nd.preds) {
                        int ui = idx_of[u];
                        if (ui < 0 || ui >= i) continue;  // no row yet
                        int pj = j - 1;
                        if (pj >= jlo[ui] && pj <= jhi[ui]) {
                            int v = H[ui][pj - jlo[ui]] + sub;
                            if (v > sc) { sc = v; pbi = ui; pbj = pj; op = 0; }
                        }
                    }
                    // insertion in read (stay before node, consume read char):
                    // handled as horizontal move within this node's row below
                }
                // deletion (consume node, no read char)
                for (uint32_t u : nd.preds) {
                    int ui = idx_of[u];
                    if (ui < 0 || ui >= i) continue;  // no row yet
                    if (j >= jlo[ui] && j <= jhi[ui]) {
                        int v = H[ui][j - jlo[ui]] + gap;
                        if (v > sc) { sc = v; pbi = ui; pbj = j; op = 1; }
                    }
                }
                // insertion: previous cell in same row
                if (off > 0 && H[i][off - 1] + gap > sc) {
                    sc = H[i][off - 1] + gap;
                    pbi = i;
                    pbj = j - 1;
                    op = 2;
                }
                H[i][off] = sc;
                BI[i][off] = pbi;
                BJ[i][off] = pbj;
                OP[i][off] = op;
                if (sc > best) { best = sc; bi = i; bj = j; }
            }
        }
        if (bi < 0 || best <= 0) return INT32_MIN;
        // traceback: thread the read into the graph
        // collect the path of (node consumed / read char consumed) moves
        struct Move { int i, j; int8_t op; };
        std::vector<Move> path;
        int ci = bi, cj = bj;
        for (size_t guard = nodes.size() * 4 + (size_t)rlen + 16; guard; guard--) {
            if (ci < 0 || H[ci][cj - jlo[ci]] <= 0) break;
            int off = cj - jlo[ci];
            int pi = BI[ci][off], pj = BJ[ci][off];
            int8_t op = OP[ci][off];
            path.push_back({ci, cj, op});
            if (pi < 0) break;  // local restart or root
            ci = pi;
            cj = pj;
        }
        std::reverse(path.begin(), path.end());
        // walk the path creating inserted nodes for read-insertions and
        // bumping node/edge coverage for matches
        uint32_t last_node = NIL;
        for (const Move& mv : path) {
            uint32_t v = order[mv.i];
            if (mv.op == 0) {
                // read char mv.j-1 aligned to node v
                uint8_t rb = read[mv.j - 1];
                uint32_t tgt;
                if (rb == nodes[v].base) {
                    tgt = v;
                } else {
                    // branch node for the substituted base at same pos
                    tgt = NIL;
                    if (last_node != NIL) {
                        for (size_t s = 0; s < nodes[last_node].succs.size(); s++) {
                            uint32_t cnd = nodes[last_node].succs[s];
                            if (cnd >= backbone_len && nodes[cnd].base == rb &&
                                nodes[cnd].pos == nodes[v].pos) {
                                tgt = cnd;
                                break;
                            }
                        }
                    }
                    if (tgt == NIL)
                        tgt = new_node(nodes[v].pos, rb,
                                       last_node == NIL ? (v ? v - 1 : NIL) : last_node);
                }
                nodes[tgt].cov++;
                if (last_node != NIL && last_node != tgt) add_edge(last_node, tgt, 1);
                last_node = tgt;
            } else if (mv.op == 1) {
                // deletion: node skipped, nothing consumed from read
            } else {
                // insertion: new node between last and next
                uint8_t rb = read[mv.j - 1];
                uint32_t tgt = NIL;
                if (last_node != NIL) {
                    for (size_t s = 0; s < nodes[last_node].succs.size(); s++) {
                        uint32_t cnd = nodes[last_node].succs[s];
                        if (cnd >= backbone_len && nodes[cnd].base == rb &&
                            nodes[cnd].pos == nodes[order[mv.i]].pos) {
                            tgt = cnd;
                            break;
                        }
                    }
                }
                if (tgt == NIL)
                    tgt = new_node(nodes[order[mv.i]].pos, rb,
                                   last_node == NIL ? NIL : last_node);
                nodes[tgt].cov++;
                if (last_node != NIL && last_node != tgt) add_edge(last_node, tgt, 1);
                last_node = tgt;
            }
        }
        return best;
    }

    // heaviest-coverage path from the start (call_consensus_pomsa analog):
    // DP over topological order maximising sum of edge coverage, with a
    // small penalty for nodes no read confirmed.
    int consensus(uint8_t* out, int cap) {
        size_t n = nodes.size();
        std::vector<uint32_t> order;
        topo_window(0, UINT32_MAX, order);
        std::vector<double> score(n, -1e18);
        std::vector<uint32_t> bp(n, NIL);
        // process in reverse topo order: score[v] = best forward continuation
        for (size_t k = order.size(); k-- > 0;) {
            uint32_t v = order[k];
            double s = -1e18;
            uint32_t be = NIL;
            for (size_t e = 0; e < nodes[v].succs.size(); e++) {
                uint32_t u = nodes[v].succs[e];
                double cand = score[u] + ecov[v][e];
                if (cand > s) { s = cand; be = u; }
            }
            if (be == NIL) s = 0;  // terminal node
            score[v] = s;
            bp[v] = be;
        }
        // best start among nodes at backbone position 0
        uint32_t cur = 0;
        double bestS = -1e18;
        for (uint32_t v = 0; v < n; v++) {
            if (nodes[v].pos != 0) continue;
            if (score[v] > bestS) { bestS = score[v]; cur = v; }
        }
        int m = 0;
        while (cur != NIL && m < cap) {
            out[m++] = nodes[cur].base;
            cur = bp[cur];
        }
        return m;
    }
};

}  // namespace

extern "C" {

void* poa_new(int match, int mismatch, int gap, int band) {
    Poa* g = new Poa();
    g->match = match;
    g->mismatch = mismatch;
    g->gap = gap;
    g->band = band;
    return g;
}

void poa_free(void* h) { delete (Poa*)h; }

void poa_init_backbone(void* h, const uint8_t* seq, int len) {
    ((Poa*)h)->init_backbone(seq, len);
}

int poa_align_and_add(void* h, const uint8_t* read, int rlen, int wlo, int whi) {
    Poa& g = *(Poa*)h;
    uint32_t lo = (uint32_t)std::max(0, wlo);
    uint32_t hi = (uint32_t)std::min<int>((int)g.backbone_len, whi);
    return g.align_and_add(read, rlen, lo, hi);
}

int poa_consensus(void* h, uint8_t* out, int cap) {
    return ((Poa*)h)->consensus(out, cap);
}

int poa_num_nodes(void* h) { return (int)((Poa*)h)->nodes.size(); }

}  // extern "C"
