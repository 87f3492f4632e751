// The batched banded-alignment stage's host side — native part of
// ops/align.py `banded_runs` and pipeline/zmo.py `_attach_cigars`.
//
// Four batched calls over a batch's accepted overlaps, each doing what the
// plain per-overlap helpers of ops/ do, byte for byte:
//
//   cig_segs    the query and candidate segments (the candidate on its
//               strand, reverse-complemented as readbank.revcomp_codes
//               does: code c becomes (uint8)(3 - c)) into two flat buffers;
//   cig_band    one `banded_align` group's padded a [n, LA] and b [n, LB]
//               (4 = pad) and its band `base` [n, LA + 1], equal to
//               ops/banded.py make_band_centers with the anchors (0, 0) and
//               (alen, blen), its np.interp double arithmetic included;
//   cig_rle_*   the group's moves (banded_align's [T, n], transposed to
//               [n, T]) run-length encoded, equal to traceback_banded →
//               rle_moves: no-op moves (0) dropped, the rest reversed, then
//               runs of M (1), I (2) and D (3);
//   cig_text_len / cig_strings
//               per overlap mat, mis, ins, dl and aln over its runs, equal to
//               pipeline/zmo.py _cigar_stats over align_strings (an N, code
//               4, at an M column counts as an insertion or a deletion),
//               and the CIGAR text ("%d%c" a run).
//
// Run ops are 0 = M, 1 = I, 2 = D.  Every call checks its indices and
// returns an error code instead of reading out of an array.  Exposed as a
// C ABI for ctypes (utils/native.py); single-threaded.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum : int { OK = 0, OUT_OF_BOUNDS = 1, BAD_MOVE = 2, BAD_COUNT = 3 };

inline uint64_t word(const void* p) {
    uint64_t x;
    std::memcpy(&x, p, 8);
    return x;
}

inline int digits(int64_t c) {
    int d = 1;
    while (c >= 10) {
        c /= 10;
        ++d;
    }
    return d;
}

// 0x80 in each byte of x that is 0, else 0 (exact: no carry crosses a
// byte).
constexpr uint64_t HIGH = 0x8080808080808080ull;
constexpr uint64_t ONES = 0x0101010101010101ull, FOURS = 4 * ONES;
inline uint64_t zero_bytes(uint64_t x) {
    const uint64_t lo7 = 0x7F7F7F7F7F7F7F7Full;
    return ~(((x & lo7) + lo7) | x | lo7);
}

// The number of bytes of z (a zero_bytes mask) that are marked.
inline int64_t marks(uint64_t z) { return (int64_t)(((z >> 7) * ONES) >> 56); }

// Bytes [0, k) of a word marked (k <= 0: none, k >= 8: all).
inline uint64_t first_bytes(int64_t k) {
    return k >= 8 ? HIGH : (k <= 0 ? 0 : HIGH & ((1ull << (8 * k)) - 1));
}

// The equal bytes of a[0, m) and b[0, m), 16 a turn (16 bytes past either
// end are read).
inline int64_t count_eq(const uint8_t* a, const uint8_t* b, int64_t m) {
    int64_t eq = 0;
    for (int64_t t = 0; t < m; t += 16) {
        eq += marks(zero_bytes(word(a + t) ^ word(b + t)) & first_bytes(m - t));
        eq += marks(zero_bytes(word(a + t + 8) ^ word(b + t + 8)) &
                    first_bytes(m - t - 8));
    }
    return eq;
}

// Whether s[0, m) holds an N (4).
inline bool has_n(const uint8_t* s, int64_t m) {
    uint64_t z = 0;
    int64_t t = 0;
    for (; t + 8 <= m; t += 8) z |= zero_bytes(word(s + t) ^ FOURS);
    for (; t < m; ++t) z |= s[t] == 4;
    return z != 0;
}

// A group's runs, overlap after overlap, as count << 2 | op: runs[0, o).
struct Runs {
    std::vector<uint32_t> runs;
    int64_t o = 0;

    // room for 8 more runs
    uint32_t* room() {
        if (o + 8 > (int64_t)runs.size()) runs.resize(2 * runs.size() + 64);
        return runs.data();
    }
};

// Appends the runs of one overlap's moves, row[T - 1], row[T - 2], ...,
// row[0] without the no-ops (0), to g: a run ends where a move differs
// from the one before it.  Flags a code outside 0..3 in bad.
void rle_row(const uint8_t* row, int64_t T, Runs& g, bool& bad) {
    uint64_t prev = 0;   // the last move taken, 0 before the first
    uint32_t cnt = 0;    // moves of the current run
    auto scalar = [&](uint8_t v, uint32_t* out) {
        if (v == 0) return;
        bad |= v > 3;
        if (v == prev) {
            ++cnt;
        } else {
            if (prev) out[g.o++] = cnt << 2 | (uint32_t)(prev - 1);
            prev = v;
            cnt = 1;
        }
    };
    int64_t t = T;
    for (; t >= 8; t -= 8) {
        uint64_t w = word(row + t - 8);
        if (w == 0) continue;
        w = __builtin_bswap64(w);   // byte j: row[t - 1 - j]
        uint32_t* out = g.room();
        bad |= (w & 0xFCFCFCFCFCFCFCFCull) != 0;
        if (zero_bytes(w) != 0 || prev == 0) {
            for (int j = 0; j < 8; ++j) scalar((uint8_t)(w >> (8 * j)), out);
            continue;
        }
        // eight moves: byte j of `before` is the move before byte j of w;
        // a run ends before each byte that differs from it
        const uint64_t before = w << 8 | prev;
        uint64_t ne = ~zero_bytes(w ^ before) & HIGH;
        uint32_t s = 0;   // the current run's first byte in w
        while (ne) {
            const uint32_t j = __builtin_ctzll(ne) >> 3;
            out[g.o++] = (cnt + j - s) << 2 |
                         (uint32_t)(((before >> (8 * j)) & 0xFF) - 1);
            cnt = 0;
            s = j;
            ne &= ne - 1;
        }
        cnt += 8 - s;
        prev = w >> 56;
    }
    uint32_t* out = g.room();
    while (t > 0) scalar(row[--t], out);
    if (prev) out[g.o++] = cnt << 2 | (uint32_t)(prev - 1);
}

}  // namespace

extern "C" {

// Overlap i's query segment: bases[read_offs[q_rid[i]] + q_beg[i] ...] of
// q_len[i] codes, to q_out[q_offs[i] ...]; its candidate segment: c_len[i]
// codes from c_beg[i] of read c_rid[i], or, where c_rev[i], of its reverse
// complement, to c_out[c_offs[i] ...].  Returns OUT_OF_BOUNDS where a
// segment leaves its read or the bank.
int cig_segs(int64_t n, const uint8_t* bases, int64_t nbases,
             const int64_t* read_offs, int64_t nreads, const int64_t* q_rid,
             const int64_t* q_beg, const int64_t* q_len, const int64_t* c_rid,
             const int64_t* c_beg, const int64_t* c_len, const int64_t* c_rev,
             const int64_t* q_offs, const int64_t* c_offs, uint8_t* q_out,
             uint8_t* c_out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t qr = q_rid[i], cr = c_rid[i];
        if (qr < 0 || qr >= nreads || cr < 0 || cr >= nreads) return OUT_OF_BOUNDS;
        const int64_t q0 = read_offs[qr], qL = read_offs[qr + 1] - q0;
        const int64_t c0 = read_offs[cr], cL = read_offs[cr + 1] - c0;
        if (q0 < 0 || read_offs[qr + 1] > nbases || c0 < 0 ||
            read_offs[cr + 1] > nbases || q_beg[i] < 0 || q_len[i] < 0 ||
            q_beg[i] + q_len[i] > qL || c_beg[i] < 0 || c_len[i] < 0 ||
            c_beg[i] + c_len[i] > cL)
            return OUT_OF_BOUNDS;
        std::memcpy(q_out + q_offs[i], bases + q0 + q_beg[i], q_len[i]);
        uint8_t* out = c_out + c_offs[i];
        if (c_rev[i]) {
            // element j of the reverse complement is 3 - read[cL - 1 - j]
            const uint8_t* src = bases + c0 + cL - 1 - c_beg[i];
            for (int64_t j = 0; j < c_len[i]; ++j)
                out[j] = (uint8_t)(3 - src[-j]);
        } else {
            std::memcpy(out, bases + c0 + c_beg[i], c_len[i]);
        }
    }
    return OK;
}

// Group row k is overlap idx[k]: a[k] = its query segment, then 4s, to
// LA; b[k] = its candidate segment, then 4s, to LB; base[k] = the band's
// leftmost column of rows 0..LA.  Returns OUT_OF_BOUNDS where a segment
// does not fit its row.
int cig_band(int64_t n, const int64_t* idx, const uint8_t* q,
             const int64_t* q_offs, const int64_t* alen, const uint8_t* c,
             const int64_t* c_offs, const int64_t* blen, int64_t LA,
             int64_t LB, int64_t W, uint8_t* a, uint8_t* b, int32_t* base) {
    for (int64_t k = 0; k < n; ++k) {
        const int64_t i = idx[k], al = alen[i], bl = blen[i];
        if (al < 0 || al > LA || bl < 0 || bl > LB) return OUT_OF_BOUNDS;
        std::memcpy(a + k * LA, q + q_offs[i], al);
        std::memset(a + k * LA + al, 4, LA - al);
        std::memcpy(b + k * LB, c + c_offs[i], bl);
        std::memset(b + k * LB + bl, 4, LB - bl);
        // np.interp(min(r, al), [0, al], [0, bl]) (just [0], [0] where al is
        // 0): 0 at 0, bl from al on, slope * r between, slope = bl / al;
        // less W / 2, clipped to [-(W - 1), max(0, bl)], made non-decreasing.
        // Between 0 and al the product lies in [0, bl] and grows with r
        // (rounding is monotone, and slope * (al - 1) rounds to bl at most),
        // so there the clip and the running maximum change nothing.
        const double slope = al > 0 ? (double)bl / (double)al : 0.0;
        const int64_t hi = bl > 0 ? bl : 0, lo = -(W - 1);
        auto clip = [&](int64_t v) {
            return (int32_t)(v < lo ? lo : (v > hi ? hi : v));
        };
        int32_t* row = base + k * (LA + 1);
        const int32_t half = (int32_t)(W / 2);
        row[0] = clip(-half);
        for (int64_t r = 1; r < al; ++r)
            row[r] = (int32_t)(slope * (double)r) - half;
        const int32_t end = al > 0 ? clip(bl - half) : row[0];
        for (int64_t r = al > 0 ? al : 1; r <= LA; ++r) row[r] = end;
    }
    return OK;
}

// Run-length encodes one group's moves mvs [n, T] (row k: overlap k's
// moves, the first at column 0, as `banded_align` gives them, transposed)
// and sets b_beg[k] = max(j_final[k], 0).  Fills nruns[k] and returns
// the group's handle for cig_rle_fetch, or null with *err set (BAD_MOVE:
// a code outside 0..3; BAD_COUNT: T too long for a run's 30-bit count).
void* cig_rle_run(const uint8_t* mvs, int64_t n, int64_t T,
                  const int64_t* j_final, int64_t* b_beg, int64_t* nruns,
                  int* err) {
    *err = OK;
    if (T >= (int64_t)1 << 30) {
        *err = BAD_COUNT;
        return nullptr;
    }
    Runs* g = new Runs;
    bool bad = false;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t o = g->o;
        rle_row(mvs + k * T, T, *g, bad);
        nruns[k] = g->o - o;
        b_beg[k] = j_final[k] > 0 ? j_final[k] : 0;
    }
    if (bad) {
        delete g;
        *err = BAD_MOVE;
        return nullptr;
    }
    return g;
}

// Writes the group's runs, overlap after overlap, to ops and counts.
void cig_rle_fetch(void* h, uint8_t* ops, int32_t* counts) {
    const Runs* g = static_cast<const Runs*>(h);
    for (int64_t o = 0; o < g->o; ++o) {
        ops[o] = (uint8_t)(g->runs[o] & 3);
        counts[o] = (int32_t)(g->runs[o] >> 2);
    }
}

void cig_rle_free(void* h) { delete static_cast<Runs*>(h); }

// Overlap i's runs are ops/counts[run_beg[i], run_end[i]).  Sets
// text_offs[0..n]: where each one's CIGAR text starts in the buffer
// cig_strings fills.  Returns BAD_COUNT for a negative count.
int cig_text_len(int64_t n, const int64_t* run_beg, const int64_t* run_end,
                 const int32_t* counts, int64_t* text_offs) {
    int64_t o = 0;
    text_offs[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t r = run_beg[i]; r < run_end[i]; ++r) {
            if (counts[r] < 0) return BAD_COUNT;
            o += digits(counts[r]) + 1;
        }
        text_offs[i + 1] = o;
    }
    return OK;
}

// Overlap i aligns its query segment q[q_offs[i] ...] (alen[i] codes)
// against its candidate segment from column b_beg[i], c[c_offs[i] +
// b_beg[i] ...] (blen[i] - b_beg[i] codes, none where b_beg[i] >=
// blen[i]), along its runs.  Fills stats [n, 5] (mat, mis, ins, dl, aln)
// and the text at text_offs (cig_text_len).  q and c must have 16
// readable bytes past their last segment, text 8 writable bytes past its
// last CIGAR.  Returns OUT_OF_BOUNDS where the runs consume past either
// segment's end, BAD_MOVE for an op outside 0..2.
int cig_strings(int64_t n, const uint8_t* q, const int64_t* q_offs,
                const int64_t* alen, const uint8_t* c, const int64_t* c_offs,
                const int64_t* blen, const int64_t* b_beg,
                const int64_t* run_beg, const int64_t* run_end,
                const uint8_t* ops, const int32_t* counts,
                const int64_t* text_offs, int64_t* stats, char* text) {
    static const char OPS[3] = {'M', 'I', 'D'};
    for (int64_t i = 0; i < n; ++i) {
        if (b_beg[i] < 0) return OUT_OF_BOUNDS;
        const uint8_t* a = q + q_offs[i];
        const uint8_t* b = c + c_offs[i] + (b_beg[i] < blen[i] ? b_beg[i] : blen[i]);
        const int64_t al = alen[i], bl = blen[i] > b_beg[i] ? blen[i] - b_beg[i] : 0;
        const int64_t r0 = run_beg[i], r1 = run_end[i];
        // the text, "%d%c" a run, and the columns of each op
        int64_t cols[3] = {0, 0, 0};
        char* out = text + text_offs[i];
        for (int64_t r = r0; r < r1; ++r) {
            const int64_t m = counts[r];
            const uint8_t op = ops[r];
            if (m < 0) return BAD_COUNT;
            if (op > 2) return BAD_MOVE;
            cols[op] += m;
            if (m < 1000) {
                // up to 3 digits and the op in one 4-byte store; the bytes
                // past the op are the next run's or the slack
                const int d = 1 + (m >= 10) + (m >= 100);
                const uint32_t w = (uint32_t)('0' + m / 100) |
                                   (uint32_t)('0' + m / 10 % 10) << 8 |
                                   (uint32_t)('0' + m % 10) << 16 |
                                   (uint32_t)OPS[op] << 24;
                const uint32_t tail = w >> (8 * (3 - d));   // little-endian
                std::memcpy(out, &tail, 4);
                out += d + 1;
            } else {
                const int d = digits(m);
                int64_t v = m;
                for (int j = d - 1; j >= 0; --j) {
                    out[j] = (char)('0' + v % 10);
                    v /= 10;
                }
                out[d] = OPS[op];
                out += d + 1;
            }
        }
        // an M column takes a code of both segments, an I of a alone and a
        // D of b alone; the runs take cols[0] + cols[1] codes of a in all
        const int64_t na = cols[0] + cols[1], nb = cols[0] + cols[2];
        if (na > al || nb > bl) return OUT_OF_BOUNDS;
        int64_t mat = 0, mis = 0, ins = 0, dl = 0, x = 0, y = 0;
        if (!has_n(a, na) && !has_n(b, nb)) {
            // no N: an I or D column is one, an M column a match or not
            for (int64_t r = r0; r < r1; ++r) {
                const int64_t m = counts[r];
                const uint8_t op = ops[r];
                if (op == 0) mat += count_eq(a + x, b + y, m);
                x += op != 2 ? m : 0;
                y += op != 1 ? m : 0;
            }
            mis = cols[0] - mat;
            ins = cols[1];
            dl = cols[2];
        } else {
            // as align_strings: the other side of an I or D column is a gap,
            // 4, as an N; a column with one 4 is an I or a D
            for (int64_t r = r0; r < r1; ++r) {
                const int64_t m = counts[r];
                const uint8_t op = ops[r];
                const int64_t sa = op != 2, sb = op != 1;
                const uint64_t ka = -(uint64_t)sa, kb = -(uint64_t)sb;
                for (int64_t t = 0; t < m; t += 8) {
                    const uint64_t lv = first_bytes(m - t);
                    const uint64_t u = (word(a + x + t * sa) & ka) | (FOURS & ~ka);
                    const uint64_t v = (word(b + y + t * sb) & kb) | (FOURS & ~kb);
                    const uint64_t nu = ~zero_bytes(u ^ FOURS) & lv;
                    const uint64_t nv = ~zero_bytes(v ^ FOURS) & lv;
                    const uint64_t eq = zero_bytes(u ^ v), both = nu & nv;
                    mat += marks(both & eq);
                    mis += marks(both & ~eq);
                    ins += marks(nu & ~nv);
                    dl += marks(nv & ~nu);
                }
                x += m * sa;
                y += m * sb;
            }
        }
        int64_t* s = stats + 5 * i;
        s[0] = mat;
        s[1] = mis;
        s[2] = ins;
        s[3] = dl;
        s[4] = cols[0] + cols[1] + cols[2];
    }
    return OK;
}

}  // extern "C"
