// Segment stitcher — native host component of the consensus stage's
// segment engine.
//
// One call joins every read's segment alignments of a round into one
// alignment of the read against the consensus, as the plain stitcher
// pipeline/cns.py _stitch_reads does, step for step and with the same
// integer arithmetic: the segments' backward move streams are filtered of
// their padding and reversed, adjacent segments are cut at a read row of
// their overlap where both pass through the same consensus column (or,
// failing that, where their columns are closest, near the zone's middle),
// the column gap such a fallback leaves is bridged with deletions or shed
// from the next piece's head, and the stitched moves give the aligned code
// rows, the affine score and the read's refreshed column map.
//
// The plain stitcher takes the row and column cursors of every move of a
// segment; this one takes them only for the rows a junction reads: the
// overlap with the previous segment, scanned forward from the segment's
// start, and the overlap with the next, scanned backward from its end.
//
// Two calls, so that the caller can size the outputs: stitch_run cuts and
// joins the moves of every read, stitch_fetch writes the aligned rows,
// scores and column maps into the caller's buffers.  Exposed as a C ABI
// for ctypes (utils/native.py stitch_round).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum : int64_t { STITCHED = 0, RESEED = 1, SKIPPED = 2 };
enum : int8_t { MV_M = 0, MV_I = 1, MV_D = 2, MV_NONE = 3 };

struct BadIndex {};

// Byte (i, j) of the 8 x 8 tile in x[0..7] (byte j of x[i]) to byte i of
// x[j]: byte, 16-bit and 32-bit interleaves of row pairs, in registers.
inline void transpose8(uint64_t x[8]) {
    const uint64_t m8 = 0x00FF00FF00FF00FFull, m16 = 0x0000FFFF0000FFFFull,
                   m32 = 0x00000000FFFFFFFFull;
#define SWAP(a, b, m, k)                                   \
    {                                                      \
        const uint64_t lo = (a & m) | ((b & m) << k);      \
        const uint64_t hi = ((a >> k) & m) | (b & ~m);     \
        a = lo;                                            \
        b = hi;                                            \
    }
    uint64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3], x4 = x[4],
             x5 = x[5], x6 = x[6], x7 = x[7];
    SWAP(x0, x1, m8, 8) SWAP(x2, x3, m8, 8) SWAP(x4, x5, m8, 8)
    SWAP(x6, x7, m8, 8)
    SWAP(x0, x2, m16, 16) SWAP(x1, x3, m16, 16) SWAP(x4, x6, m16, 16)
    SWAP(x5, x7, m16, 16)
    SWAP(x0, x4, m32, 32) SWAP(x1, x5, m32, 32) SWAP(x2, x6, m32, 32)
    SWAP(x3, x7, m32, 32)
#undef SWAP
    x[0] = x0; x[1] = x1; x[2] = x2; x[3] = x3;
    x[4] = x4; x[5] = x5; x[6] = x6; x[7] = x7;
}

inline int64_t clip(int64_t x, int64_t lo, int64_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// Eight moves a word: 0x80 in each byte of x that is 0, else 0 (exact: no
// carry crosses a byte), and the number of such bytes.
constexpr uint64_t ONES = 0x0101010101010101ull;
inline uint64_t zero_bytes(uint64_t x) {
    const uint64_t lo7 = 0x7F7F7F7F7F7F7F7Full;
    return ~(((x & lo7) + lo7) | x | lo7);
}
inline int64_t marks(uint64_t z) { return (int64_t)(((z >> 7) * ONES) >> 56); }
inline uint64_t word(const void* p) {
    uint64_t x;
    std::memcpy(&x, p, 8);
    return x;
}

// D and I moves of mv[0, n), and the runs of each (gap opens)
void count_gaps(const int8_t* mv, int64_t n, int64_t& nd, int64_t& ni,
                int64_t& od, int64_t& oi) {
    nd = ni = od = oi = 0;
    int64_t t = 0;
    if (n > 0) {
        nd = od = mv[0] == MV_D;
        ni = oi = mv[0] == MV_I;
        t = 1;
    }
    for (; t + 8 <= n; t += 8) {
        const uint64_t x = word(mv + t), y = word(mv + t - 1);
        const uint64_t d = zero_bytes(x ^ (MV_D * ONES));
        const uint64_t i = zero_bytes(x ^ (MV_I * ONES));
        nd += marks(d);
        ni += marks(i);
        od += marks(d & ~zero_bytes(y ^ (MV_D * ONES)));
        oi += marks(i & ~zero_bytes(y ^ (MV_I * ONES)));
    }
    for (; t < n; ++t) {
        nd += mv[t] == MV_D;
        ni += mv[t] == MV_I;
        od += (mv[t] == MV_D) & (mv[t - 1] != MV_D);
        oi += (mv[t] == MV_I) & (mv[t - 1] != MV_I);
    }
}

// One segment: its forward moves, row and column counts, and the move
// index and column before the move of the rows a junction reads.
struct Seg {
    std::vector<int8_t> mv;
    int64_t r0, c0, nrow, ncol;
    std::vector<int64_t> pidx, pcol;   // rows [0, k1) of prefix(k1)
    std::vector<int64_t> sidx, scol;   // rows [k0, nrow) of suffix(k0)

    // rows [0, k1), k1 <= nrow, scanned forward
    void prefix(int64_t k1) {
        pidx.resize(k1);
        pcol.resize(k1);
        int64_t row = 0, col = c0;
        for (int64_t t = 0; row < k1; ++t) {
            const int8_t m = mv[t];
            // a D's store is overwritten by the next row move's
            pidx[row] = t;
            pcol[row] = col;
            row += m != MV_D;
            col += m != MV_I;
        }
    }

    // rows [k0, nrow), 0 <= k0, scanned backward from the end
    void suffix(int64_t k0) {
        sidx.resize(nrow - k0);
        scol.resize(nrow - k0);
        int64_t row = nrow, col = c0 + ncol;
        for (int64_t t = (int64_t)mv.size() - 1; row > k0; --t) {
            const int8_t m = mv[t];
            col -= m != MV_I;
            // row - 1 is this move's row, or, for a D, the row whose move
            // comes next and overwrites the slot
            sidx[row - 1 - k0] = t;
            scol[row - 1 - k0] = col;
            row -= m != MV_D;
        }
    }

    // the move index of row k, k < nrow, scanned forward
    int64_t row_move(int64_t k) const {
        if (k < 0) throw BadIndex();
        for (int64_t t = 0, row = 0;; ++t) {
            if (mv[t] != MV_D && row++ == k) return t;
        }
    }
};

struct Round {
    // inputs
    const int64_t *first, *nseg, *r0;
    const uint8_t* mv_all;
    int64_t np, T, s_row, s_col;
    const int64_t* arr;
    const int64_t* b_beg;
    const uint8_t* flat;
    int64_t flat_len;
    const int64_t *flat_offs, *lens;
    const uint8_t* cns_pad;
    int64_t Lc;
    int64_t match, mismatch, open_i, open_d, ext;
    // per read: status, consensus span, stitched moves at
    // mvf[aln_offs[i]:aln_offs[i + 1]], column map at cm_offs[i]
    std::vector<int64_t> status, beg, end, aln_offs, cm_offs;
    std::vector<int64_t> gaps;   // the score's gap terms
    std::vector<int8_t> mvf;
    int64_t fallbacks = 0;
    // where mv_all holds a segment a column (s_col != 1): the streams of
    // segments strip_g0 .. strip_g0 + 7, a stream a row of T
    std::vector<uint8_t> strip;
    int64_t strip_g0 = -1;

    // Segment gi's stream, contiguous.  The segment DP's streams come a
    // segment a column: eight adjacent ones are turned into rows at a
    // time, 8 x 8 tiles, into a strip that stays in cache.
    const uint8_t* stream(int64_t gi) {
        if (s_col == 1) return mv_all + gi * s_row;
        const int64_t g0 = gi / 8 * 8;
        if (g0 != strip_g0) {
            strip.resize(8 * T);
            uint8_t* dst = strip.data();
            const int64_t T8 = s_row == 1 && g0 + 8 <= np ? T / 8 * 8 : 0;
            for (int64_t t0 = 0; t0 < T8; t0 += 8) {
                uint64_t x[8];
                for (int i = 0; i < 8; ++i)
                    x[i] = word(mv_all + g0 + (t0 + i) * s_col);
                transpose8(x);
                for (int j = 0; j < 8; ++j)
                    std::memcpy(dst + j * T + t0, &x[j], 8);
            }
            for (int64_t g = g0; g < std::min(g0 + 8, np); ++g)
                for (int64_t t = T8; t < T; ++t)
                    dst[(g - g0) * T + t] = mv_all[g * s_row + t * s_col];
            strip_g0 = g0;
        }
        return strip.data() + (gi - g0) * T;
    }

    // mv[mv != 3][::-1] of segment gi, with its counts
    void load(int64_t gi, Seg& g) {
        const uint8_t* col = stream(gi);
        g.mv.resize(T);
        int8_t* mv = g.mv.data();
        int64_t n = 0;
        // the segment DP writes its padding past the start, so a forward
        // move stream is most often the reversed prefix before it
        const void* pad = std::memchr(col, MV_NONE, T);
        const int64_t p = pad ? (const uint8_t*)pad - col : T;
        bool tail = true;
        int64_t t = p;
        for (; t + 8 <= T; t += 8) tail &= word(col + t) == MV_NONE * ONES;
        for (; t < T; ++t) tail &= col[t] == MV_NONE;
        if (tail) {
            // reversed eight bytes a word
            int64_t i = 0;
            for (; i + 8 <= p; i += 8) {
                const uint64_t x = __builtin_bswap64(word(col + p - 8 - i));
                std::memcpy(mv + i, &x, 8);
            }
            for (; i < p; ++i) mv[i] = (int8_t)col[p - 1 - i];
            n = p;
        } else {
            for (int64_t t = T - 1; t >= 0; --t) {
                const uint8_t m = col[t];
                mv[n] = (int8_t)m;
                n += m != MV_NONE;
            }
        }
        g.mv.resize(n);
        int64_t nd, ni, od, oi;
        count_gaps(mv, n, nd, ni, od, oi);
        g.nrow = n - nd;
        g.ncol = n - ni;
        g.c0 = arr[gi * 5 + 3] + b_beg[gi];
    }

    // Cuts and joins read rid's segments onto mvf; returns its status.
    int64_t read(int64_t rid, std::vector<Seg>& segs) {
        const int64_t first_ = first[rid], S = nseg[rid];
        if (S == 0) return SKIPPED;
        const int64_t rl = lens[rid];
        if (first_ < 0 || S < 0 || first_ + S > np) throw BadIndex();
        if ((int64_t)segs.size() < S) segs.resize(S);
        for (int64_t s = 0; s < S; ++s) {
            const int64_t gi = first_ + s;
            load(gi, segs[s]);
            segs[s].r0 = r0[gi];
            if (segs[s].nrow != arr[gi * 5 + 2]) return RESEED;
        }
        const size_t start = mvf.size();
        int64_t cut_prev = 0, head_fix = 0, lo = 0;
        for (int64_t s = 0; s < S; ++s) {
            Seg& a = segs[s];
            const int64_t nmv = (int64_t)a.mv.size(), nr = a.nrow;
            int64_t cut, cutc = 0, cutc2 = 0, hi;
            if (s + 1 < S) {
                Seg& b = segs[s + 1];
                const int64_t zlo = b.r0, zhi = a.r0 + nr;
                const int64_t z0 = std::max(zlo, cut_prev + 1), n = zhi - z0;
                if (n <= 0) return RESEED;
                if (z0 - a.r0 < 0 || zhi - b.r0 > b.nrow) throw BadIndex();
                a.suffix(z0 - a.r0);
                b.prefix(zhi - b.r0);
                const int64_t* cl = a.scol.data();
                const int64_t* cr = b.pcol.data() + (z0 - b.r0);
                const int64_t mid = n / 2;
                // the shared column nearest the zone's middle, the first
                // of two as near
                int64_t pick = -1;
                for (int64_t d = 0; pick < 0 && (mid - d >= 0 || mid + d < n);
                     ++d) {
                    if (mid - d >= 0 && cl[mid - d] == cr[mid - d])
                        pick = mid - d;
                    else if (d > 0 && mid + d < n && cl[mid + d] == cr[mid + d])
                        pick = mid + d;
                }
                if (pick < 0) {
                    ++fallbacks;
                    int64_t best = 0;
                    for (int64_t i = 0; i < n; ++i) {
                        const int64_t d =
                            std::llabs(cl[i] - cr[i]) + std::llabs(i - mid) / 8;
                        if (pick < 0 || d < best) {
                            pick = i;
                            best = d;
                        }
                    }
                }
                cut = z0 + pick;
                cutc = cl[pick];
                cutc2 = cr[pick];
                hi = a.sidx[pick];
            } else {
                cut = rl;
                hi = cut - a.r0 < nr ? a.row_move(cut - a.r0) : nmv;
            }
            if (s == 0)
                lo = cut_prev - a.r0 < nr ? a.row_move(cut_prev - a.r0) : nmv;
            int64_t t = lo;
            if (head_fix > 0) {
                // shed head_fix column-consuming moves: M -> I, D dropped
                int64_t shed = 0;
                for (; t < hi && shed < head_fix; ++t) {
                    const int8_t m = a.mv[t];
                    if (m == MV_M) {
                        mvf.push_back(MV_I);
                        ++shed;
                    } else if (m == MV_D) {
                        ++shed;
                    } else {
                        mvf.push_back(m);
                    }
                }
                head_fix -= shed;
                if (head_fix > 0) return RESEED;
            }
            if (t < hi) mvf.insert(mvf.end(), a.mv.data() + t, a.mv.data() + hi);
            if (s + 1 < S) {
                if (cutc2 > cutc)   // bridge the gap with deletions
                    mvf.insert(mvf.end(), cutc2 - cutc, (int8_t)MV_D);
                else if (cutc2 < cutc)
                    head_fix = cutc - cutc2;
                // the next piece starts at the cut's row move
                lo = segs[s + 1].pidx[cut - segs[s + 1].r0];
            }
            cut_prev = cut;
        }
        const int64_t b0 = arr[first_ * 5 + 3] + b_beg[first_];
        const int64_t L = (int64_t)(mvf.size() - start);
        int64_t nd, ni, od, oi;
        count_gaps(mvf.data() + start, L, nd, ni, od, oi);
        const int64_t e = b0 + (L - ni);
        if (L - nd != rl || e > Lc) return RESEED;
        // the plain stitcher indexes run_start[0] and the read's codes
        const int64_t off = flat_offs[rid];
        if (L == 0 || rl == 0 || off < 0 || off + rl > flat_len) throw BadIndex();
        beg[rid] = b0;
        end[rid] = e;
        gaps[rid] = oi * open_i + ni * ext + od * open_d + nd * ext;
        return STITCHED;
    }

    // Stitched read rid's rows, column map and score: ra = the read's code
    // at a row move (M, I), else 4; rb = the consensus code at a column
    // move (M, D), else 4; the column map takes, at every 16th row move,
    // the column before it, then end and end + 16.
    int64_t write(int64_t rid, uint8_t* ra, uint8_t* rb, int64_t* cm) const {
        const int8_t* mv = mvf.data() + aln_offs[rid];
        const int64_t L = aln_offs[rid + 1] - aln_offs[rid];
        const int64_t rl = lens[rid], b0 = beg[rid];
        const uint8_t* rcodes = flat + flat_offs[rid];
        int64_t row = 0, col = 0, n_eq = 0;
        // the read's code at min(row, rl - 1) and the consensus's at
        // clip(b0 + col, 0, Lc - 1), loaded before the move is known
        const int64_t rmax = rl - 1;
        for (int64_t t = 0; t < L; ++t) {
            const int8_t m = mv[t];
            const int64_t is_row = m != MV_D, is_col = m != MV_I;
            const uint8_t a = rcodes[std::min(row, rmax)];
            const uint8_t b = cns_pad[clip(b0 + col, 0, Lc - 1)];
            // selects by mask: a branch on the move mispredicts
            const uint8_t keep_a = -(uint8_t)is_row, keep_b = -(uint8_t)is_col;
            ra[t] = (a & keep_a) | (4 & ~keep_a);
            rb[t] = (b & keep_b) | (4 & ~keep_b);
            n_eq += (m == MV_M) & (a == b);
            if ((row & 15) == 0 && is_row) *cm++ = b0 + col;
            row += is_row;
            col += is_col;
        }
        cm[0] = end[rid];
        cm[1] = end[rid] + 16;
        const int64_t n_m = row + col - L;   // L = M + I + D
        return n_eq * match + (n_m - n_eq) * mismatch + gaps[rid];
    }
};

}  // namespace

extern "C" {

// Stitches reads 0..nreads-1 of a round.  Read i's segments are rows
// first[i] .. first[i] + nseg[i] - 1 of the segment arrays: r0 [np] (their
// first read row), mv_all (backward 2-bit move streams, row gi at
// mv_all[gi * s_row + t * s_col] for t < T, 3 = padding), arr [np, 5]
// (rid, r0, alen, w0, blen) and b_beg [np].  Fills status, beg, end
// [nreads], aln_offs and cm_offs [nreads + 1] (the offsets of each read's
// aligned rows and column map in the buffers stitch_fetch fills) and
// counts [1] (junctions cut by the fallback).  Returns the round's handle,
// or null when an index runs out of its array.  The inputs must live
// until stitch_fetch has run.
void* stitch_run(int64_t nreads, const int64_t* first, const int64_t* nseg,
                 const int64_t* r0, const uint8_t* mv_all, int64_t np,
                 int64_t T, int64_t s_row, int64_t s_col, const int64_t* arr,
                 const int64_t* b_beg, const uint8_t* flat, int64_t flat_len,
                 const int64_t* flat_offs, const int64_t* lens,
                 const uint8_t* cns_pad, int64_t Lc, int64_t match,
                 int64_t mismatch, int64_t open_i, int64_t open_d, int64_t ext,
                 int64_t* status, int64_t* beg, int64_t* end,
                 int64_t* aln_offs, int64_t* cm_offs, int64_t* counts) {
    Round* r = new Round{first,   nseg,     r0,   mv_all,  np,     T,
                         s_row,   s_col,    arr,  b_beg,   flat,   flat_len,
                         flat_offs, lens,   cns_pad, Lc,   match,  mismatch,
                         open_i,  open_d,   ext};
    r->status.assign(nreads, 0);
    r->beg.assign(nreads, 0);
    r->end.assign(nreads, 0);
    r->gaps.assign(nreads, 0);
    r->aln_offs.assign(nreads + 1, 0);
    r->cm_offs.assign(nreads + 1, 0);
    int64_t rows = 0;   // a stitched read's moves: its rows and an eighth
    for (int64_t i = 0; i < nreads; ++i)
        if (nseg[i] > 0) rows += std::max<int64_t>(lens[i], 0);
    r->mvf.reserve(rows + rows / 8 + 64);
    std::vector<Seg> segs;
    try {
        for (int64_t i = 0; i < nreads; ++i) {
            const size_t before = r->mvf.size();
            const int64_t st = r->read(i, segs);
            if (st != STITCHED) r->mvf.resize(before);
            r->status[i] = st;
            r->aln_offs[i + 1] = (int64_t)r->mvf.size();
            r->cm_offs[i + 1] = r->cm_offs[i] +
                                (st == STITCHED ? (lens[i] + 15) / 16 + 2 : 0);
        }
    } catch (const BadIndex&) {
        delete r;
        return nullptr;
    }
    std::copy(r->status.begin(), r->status.end(), status);
    std::copy(r->beg.begin(), r->beg.end(), beg);
    std::copy(r->end.begin(), r->end.end(), end);
    std::copy(r->aln_offs.begin(), r->aln_offs.end(), aln_offs);
    std::copy(r->cm_offs.begin(), r->cm_offs.end(), cm_offs);
    counts[0] = r->fallbacks;
    return r;
}

// Writes every stitched read's score into sc [nreads], its aligned read
// and consensus rows into ra, rb [aln_offs[nreads]] and its column map
// into cm [cm_offs[nreads]].
void stitch_fetch(void* h, int64_t* sc, uint8_t* ra, uint8_t* rb,
                  int64_t* cm) {
    const Round* r = static_cast<const Round*>(h);
    for (size_t i = 0; i < r->status.size(); ++i) {
        const int64_t a = r->aln_offs[i];
        sc[i] = r->status[i] == STITCHED
                    ? r->write(i, ra + a, rb + a, cm + r->cm_offs[i]) : 0;
    }
}

void stitch_free(void* h) { delete static_cast<Round*>(h); }

}  // extern "C"
