// Dot-matrix (dm) engine emission — native host component of the overlap
// stage's last step.
//
// One call a query batch does what pipeline/zmo.py _emit_batch_dm does
// (its stateless extraction, _extract_candidates_dm, then its sequential
// acceptance replay, _replay_dm), step for step and with the same integer
// arithmetic, in one pass over the batch's packed result row:
//
//  - extraction: the row map (pair id -> result row, the last row of an id
//    kept), per (query, slot) the matches of both strands against the ztot
//    gate, the strand of the higher score (strand 0 on a tie), the
//    min_score gate and the min_id gate w >= (int64)(min_id * ol), the
//    double product truncated as numpy's astype truncates it; the passing
//    candidates of a query ordered by score, descending, ties in slot
//    order (np.lexsort's order);
//  - replay: the nbest gate of every query against the coverage at the
//    batch's start, the pairs this batch attempted (ordered, for the
//    within-batch tie rule), the pair ledger (pre-attempted pairs), the
//    pass's emitted pairs, and the coverage updates of the accepted
//    overlaps whose unaligned dovetail is at most max_unalign_dovetail.
//
// The pre-attempted and emitted pairs live here for the whole pass; the
// coverage array is the caller's, updated in place.  The accepted records
// go to the handle's buffers, in emission order, as rows (rid1, beg1,
// end1, rid2, dir2, beg2, end2, score, aln), and, when asked for, the
// attempted pairs in the order they were first inserted.  Exposed as a C
// ABI for ctypes (utils/native.py EmitDm).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum : int { OK = 0, OUT_OF_BOUNDS = 1 };

// Open-addressing set of 64-bit keys (a pair of read ids), linear probing
// at a load of at most one half; EMPTY is no key (read ids are < 2^31).
class PairSet {
  public:
    static constexpr uint64_t EMPTY = ~0ull;

    PairSet() : slots_(16, EMPTY), mask_(15) {}

    bool contains(uint64_t k) const {
        for (uint64_t i = hash(k) & mask_;; i = (i + 1) & mask_) {
            if (slots_[i] == k) return true;
            if (slots_[i] == EMPTY) return false;
        }
    }

    // true when k was not in the set
    bool insert(uint64_t k) {
        if (2 * (size_ + 1) > slots_.size()) grow();
        for (uint64_t i = hash(k) & mask_;; i = (i + 1) & mask_) {
            if (slots_[i] == k) return false;
            if (slots_[i] == EMPTY) {
                slots_[i] = k;
                ++size_;
                return true;
            }
        }
    }

    // empties the set, keeping its table: the keys in `keys` are the ones
    // inserted since the last clear
    void clear(const std::vector<uint64_t>& keys) {
        if (keys.size() * 8 < slots_.size()) {
            for (uint64_t k : keys) {
                uint64_t i = hash(k) & mask_;
                while (slots_[i] != EMPTY) {
                    slots_[i] = EMPTY;
                    i = (i + 1) & mask_;
                }
            }
        } else {
            std::fill(slots_.begin(), slots_.end(), EMPTY);
        }
        size_ = 0;
    }

    int64_t size() const { return (int64_t)size_; }

    int64_t dump(int64_t* out) const {
        int64_t m = 0;
        for (uint64_t k : slots_)
            if (k != EMPTY) {
                out[2 * m] = (int64_t)(k >> 32);
                out[2 * m + 1] = (int64_t)(k & 0xFFFFFFFFull);
                ++m;
            }
        return m;
    }

  private:
    static uint64_t hash(uint64_t x) {
        x ^= x >> 33;
        x *= 0xff51afd7ed558ccdull;
        x ^= x >> 33;
        x *= 0xc4ceb9fe1a85ec53ull;
        return x ^ (x >> 33);
    }

    void grow() {
        std::vector<uint64_t> old(slots_.size() * 2, EMPTY);
        old.swap(slots_);
        mask_ = slots_.size() - 1;
        for (uint64_t k : old) {
            if (k == EMPTY) continue;
            uint64_t i = hash(k) & mask_;
            while (slots_[i] != EMPTY) i = (i + 1) & mask_;
            slots_[i] = k;
        }
    }

    std::vector<uint64_t> slots_;
    uint64_t mask_;
    uint64_t size_ = 0;
};

inline uint64_t ordered(int64_t a, int64_t b) {
    return ((uint64_t)a << 32) | (uint64_t)b;
}
inline uint64_t unordered(int64_t a, int64_t b) {
    return a < b ? ordered(a, b) : ordered(b, a);
}

struct Cand {
    int64_t q, c, score, dir, tb, te, qb, qe, ol;
};

struct Emitter {
    int64_t n;
    std::vector<int64_t> lens;  // the bank's read lengths
    int64_t zsize, ztot, min_score, nbest, avg_len, max_dovetail;
    double min_id;
    PairSet pre, emitted, attempted;
    // per batch
    std::vector<int32_t> rowmap;
    std::vector<uint8_t> dead;
    std::vector<Cand> cands;
    std::vector<uint64_t> att_keys;  // attempted pairs, first insertion order
    std::vector<int64_t> recs;       // accepted records, 9 a row
    int64_t n_att_rows = 0;
};

}  // namespace

extern "C" {

// A pass's emission state over a bank of n reads of lengths lens, with
// npre pre-attempted pairs (pre[2 i], pre[2 i + 1]; pairs naming a read
// outside the bank are the caller's to drop).  NULL for a pair outside it.
void* emitdm_new(int64_t n, const int64_t* lens, int64_t zsize, int64_t ztot,
                 int64_t min_score, double min_id, int64_t nbest,
                 int64_t avg_len, int64_t max_dovetail, int64_t npre,
                 const int64_t* pre) {
    Emitter* e = new Emitter();
    e->n = n;
    e->lens.assign(lens, lens + n);
    e->zsize = zsize;
    e->ztot = ztot;
    e->min_score = min_score;
    e->min_id = min_id;
    e->nbest = nbest;
    e->avg_len = std::max<int64_t>(1, avg_len);
    e->max_dovetail = max_dovetail;
    for (int64_t i = 0; i < npre; ++i) {
        const int64_t a = pre[2 * i], b = pre[2 * i + 1];
        if (a < 0 || a >= n || b < 0 || b >= n) {
            delete e;
            return nullptr;
        }
        e->pre.insert(unordered(a, b));
    }
    return e;
}

void emitdm_free(void* h) { delete static_cast<Emitter*>(h); }

// One batch: Q queries rids[Q] of A candidate slots csorted[Q * A] (a slot
// is live when its read id is < n), and the batch's packed row: pair ids,
// scores, tb, te, qb, qe of W rows each, then NP = Q * A * 2 match counts
// (two strands a slot).  rdcovs[n] is updated in place.  Writes counts[3]:
// accepted records, candidate rows replayed, attempted rows.  Returns
// OUT_OF_BOUNDS for a query or live candidate id outside the bank or a
// negative pair id; the coverage and the pass's pairs are unchanged then.
int emitdm_batch(void* h, int64_t Q, int64_t A, const int32_t* rids,
                 const int32_t* csorted, const int32_t* row, int64_t W,
                 int64_t* rdcovs, int64_t* counts) {
    Emitter& e = *static_cast<Emitter*>(h);
    const int64_t n = e.n, NP = Q * A * 2;
    const int32_t *pair_id = row, *score = row + W, *tb_a = row + 2 * W,
                  *te_a = row + 3 * W, *qb_a = row + 4 * W,
                  *qe_a = row + 5 * W, *match = row + 6 * W;
    for (int64_t q = 0; q < Q; ++q)
        if (rids[q] < 0 || rids[q] >= n) return OUT_OF_BOUNDS;
    // the row map (pair ids >= NP are dead rows)
    e.rowmap.assign(NP, -1);
    for (int64_t i = 0; i < W; ++i) {
        const int64_t pid = pair_id[i];
        if (pid >= NP) continue;
        if (pid < 0) return OUT_OF_BOUNDS;
        e.rowmap[pid] = (int32_t)i;
    }
    // the nbest gate at the batch's start
    e.dead.resize(Q);
    for (int64_t q = 0; q < Q; ++q) {
        const int64_t qlen = e.lens[rids[q]];
        const int64_t nb = std::max(e.nbest, e.nbest * qlen / e.avg_len);
        e.dead[q] = rdcovs[rids[q]] >= nb;
    }
    // extraction and the batch's attempted pairs
    e.attempted.clear(e.att_keys);
    e.att_keys.clear();
    e.cands.clear();
    e.recs.clear();
    e.n_att_rows = 0;
    for (int64_t q = 0; q < Q; ++q) {
        const int64_t qrid = rids[q];
        const size_t first = e.cands.size();
        for (int64_t s = 0; s < A; ++s) {
            const int64_t k = q * A + s, c = csorted[k];
            if (c >= n) continue;
            if ((int64_t)(match[2 * k] + (int64_t)match[2 * k + 1]) * e.zsize
                < e.ztot)
                continue;
            if (c < 0) return OUT_OF_BOUNDS;
            ++e.n_att_rows;
            if (qrid != c && !e.dead[q] && !e.pre.contains(unordered(qrid, c))
                && e.attempted.insert(ordered(qrid, c)))
                e.att_keys.push_back(ordered(qrid, c));
            const int32_t r0 = e.rowmap[2 * k], r1 = e.rowmap[2 * k + 1];
            const int64_t w0 = r0 >= 0 ? score[r0] : 0;
            const int64_t w1 = r1 >= 0 ? score[r1] : 0;
            const int64_t d = w0 < w1;
            const int32_t r = d ? r1 : r0;
            if (r < 0) continue;
            const int64_t w = d ? w1 : w0;
            const int64_t tb = tb_a[r], te = te_a[r], qb = qb_a[r],
                          qe = qe_a[r];
            const int64_t ol = std::max(te - tb, qe - qb);
            if (ol <= 0 || w < e.min_score) continue;
            if (w < (int64_t)(e.min_id * (double)ol)) continue;
            e.cands.push_back(Cand{q, c, w, d, tb, te, qb, qe, ol});
        }
        std::stable_sort(e.cands.begin() + first, e.cands.end(),
                         [](const Cand& a, const Cand& b) {
                             return a.score > b.score;
                         });
    }
    // replay
    for (const Cand& x : e.cands) {
        const int64_t qrid = rids[x.q], c = x.c;
        if (c == qrid || e.dead[x.q]) continue;
        const uint64_t key = unordered(qrid, c);
        if (e.pre.contains(key)) continue;
        if (e.emitted.contains(key)) continue;
        if (c < qrid && e.attempted.contains(ordered(c, qrid))) continue;
        e.emitted.insert(key);
        const int64_t rec[9] = {qrid, x.tb, x.te, c, x.dir, x.qb, x.qe,
                                x.score, x.ol};
        e.recs.insert(e.recs.end(), rec, rec + 9);
        const int64_t x1 = std::min(x.tb, x.qb);
        const int64_t x2 = std::min(e.lens[qrid] - x.te, e.lens[c] - x.qe);
        if (x1 + x2 <= e.max_dovetail) {
            rdcovs[qrid] += 1;
            rdcovs[c] += 1;
        }
    }
    counts[0] = (int64_t)(e.recs.size() / 9);
    counts[1] = (int64_t)e.cands.size();
    counts[2] = e.n_att_rows;
    return OK;
}

// The last batch's records [counts[0], 9] and, when att is not NULL, its
// attempted pairs [m, 2] in first insertion order; returns m.
int64_t emitdm_fetch(void* h, int64_t* recs, int64_t* att) {
    const Emitter& e = *static_cast<const Emitter*>(h);
    if (!e.recs.empty())
        std::memcpy(recs, e.recs.data(), e.recs.size() * sizeof(int64_t));
    if (att)
        for (size_t i = 0; i < e.att_keys.size(); ++i) {
            att[2 * i] = (int64_t)(e.att_keys[i] >> 32);
            att[2 * i + 1] = (int64_t)(e.att_keys[i] & 0xFFFFFFFFull);
        }
    return (int64_t)e.att_keys.size();
}

int64_t emitdm_npairs(void* h) {
    return static_cast<const Emitter*>(h)->emitted.size();
}

// The pass's emitted pairs [npairs, 2], (smaller id, larger id), in no
// particular order.
void emitdm_pairs(void* h, int64_t* out) {
    static_cast<const Emitter*>(h)->emitted.dump(out);
}

}  // extern "C"
