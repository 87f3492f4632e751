// Score-only banded Smith-Waterman along a linear chain diagonal at any band
// width up to SWWIDE_MAX_W: the wide-band instance of the SW local DP, for
// Hopper.
//
// Replaces smartdenovo_tpu/ops/overlap_dp.py:48 banded_local_dp (`jax.jit`
// over a `lax.scan` of rows, not Pallas) at the widths that csrc/swlocal.cu
// does not take (it takes a multiple of 32 up to 256): wtcyc aligns each
// read against its own reverse complement at W 1600
// (smartdenovo_tpu/pipeline/aln_tools.py:70, 75).  It computes exactly what
// swlocal.cu computes, with the same inputs and outputs: for each pair a
// local DP of `a` (rows) against `b` (columns) over W band lanes whose
// leftmost column in row i is
//     clip(qb + (((i - tb) * slope) >> 12) - W/2, -(W-1), max(0, blen))
// in int32 (the product wraps, the shift floors).  A cell is
//     m = max(dg + sub, up + gap)      (the diagonal wins ties),
// restarted at 0 (with its match count) when negative, masked to NEG_INF
// outside 1 <= j <= blen, then the in-row linear gap
//     s[j] = max over k <= j of m[k] + gap (j - k)
// with the match count of the rightmost k that reaches it.  The pair's best
// is the highest s, then its earliest row, then its lowest column.  The
// carry to the next row clamps every s below 0 to 0 and clears the count
// where it is 0.  Outputs: best score, its match count, its row and column,
// [4, B] int32.
//
// What bounds it.  As swlocal: each pair's live rows (ops/overlap_dp.py
// live_rows, which takes W) x W cells of about 12 int32 operations, so the
// card's int32 rate on the live cells; the bytes (each pair's codes once)
// are far below it.  A row is a dependent chain (cells, gap scan, one
// barrier, the carry into the next row), so the levers are instructions a
// cell, barriers a row, dead lanes and the warps resident to hide the
// chain's latency.
//
// Design.  One block a pair, the pairs taken longest first from a counter
// (the wrapper's order), the grid what is resident at once; outputs
// written at the pair's own index.  The block is cut to W: `warps` warps
// of 32 threads with P lanes each (the wrapper's swwide_shape: the fewest
// dead lanes, then the most lanes a thread; W 1600 is 5 x 32 x 10, none
// dead).  Thread t owns the band lanes P t .. P t + P - 1; lanes >= W are
// dead (they lie right of every real lane, so the left-to-right gap scan
// never carries them into one) and carry NEG_INF.  Row i + 1's band start
// and `a` code are loaded while row i computes.  Two paths, picked per
// pair by the wrapper's flag:
// - unit steps (every live row's band start moves 0 or 1 column, which is
//   every call wtcyc makes): the previous row's H and counts stay in the
//   thread's registers.  On a step of 1, cell k's diagonal is its own
//   previous lane k and its up is lane k + 1: one shuffle for a thread's
//   last lane, and for a warp's last lane the next warp's first lane; on a
//   step of 0 the diagonal comes from the left neighbour the same way.
//   The `b` codes move one lane a row, so a thread loads one new code a
//   row ahead.
// - any other band: the previous row sits in shared memory, double
//   buffered (16 W bytes), and a cell reads its diagonal and up at any
//   offset (NEG_INF and 0 outside [0, W)); all P codes of a thread are
//   loaded a row ahead.
// A cell is a compare (diagonal or up), one 3-way max that restarts it at
// 0, and the select of its count; a warp whose lanes all lie inside the
// row (1 <= j <= blen, k < W) skips the masks and, where gap <= 0, the
// restart's clearing of the count (see cell).  The gap scan is a serial
// scan over a thread's own lanes, warpdp.cuh's three-round radix-4 scan of
// the thread totals (warp_carry_payload: a key of value and lane, the
// count from the winning lane), and a fold of the warp totals before this
// warp (keys of value and warp, one warp max-reduction); every combine is
// the JAX scan's (a shifted left operand wins only when strictly higher:
// the key's lane or warp breaks a tie to the right).  The keys clamp
// values below FLOOR, which
// changes no carry that can win: a cell inside the row is >= 0 and
// FLOOR + gap W < 0 on the scores the wrapper lets through.  The warps
// meet once a row: each publishes its total and its first lane's own
// value (before any carry) in a per-row slot, double buffered (no warp can
// write row i + 2's slot before every warp has left row i's barrier), and
// after the barrier each folds the totals before it.  From its last lane's
// final value a warp also derives the next warp's first-lane carry (what
// it reads as `up` on a step of 1), and from the fold the previous warp's
// last-lane carry (the diagonal on a step of 0).  The shared-memory path
// adds a second barrier after its row is written.  Each thread keeps the
// best of its own cells: a row's maximum is one 3-way max a pair of cells,
// and only a thread whose row maximum beats its best looks for its lowest
// column.  One block reduction at the end orders by (value, -row,
// -column).  Every index is clipped before it loads.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "warpdp.cuh"

namespace {

constexpr int NEG_INF = -(1 << 28);
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_W = 4096;  // SWWIDE_MAX_W
constexpr int MAX_P = 12;    // lanes a thread: the template instances
constexpr int MAX_WARPS = 16;
constexpr int FLOOR = -(1 << 25);  // scan keys clamp values below it
// added to the carry into the row's first thread, which has none
constexpr int NO_CARRY = -(1 << 30);

// the band's leftmost column of row i, in the JAX function's int32
// arithmetic (wrapping products and sums, an arithmetic shift)
__device__ __forceinline__ int base_at(int i, int tb, int qb, int slope, int bl,
                                       int W) {
  const int d = (int)((unsigned)i - (unsigned)tb);
  const int prod = (int)((unsigned)d * (unsigned)slope);
  int c = (int)((unsigned)qb + (unsigned)(prod >> 12));
  c = (int)((unsigned)c - (unsigned)(W / 2));
  return min(max(c, -(W - 1)), max(0, bl));
}

struct Best {
  int v, mat, a, b;  // score, its matches, row, column
};

// o before b: the higher value, then the earlier row, then the lower column
__device__ __forceinline__ bool before(const Best& o, const Best& b) {
  return o.v > b.v || (o.v == b.v && (o.a < b.a || (o.a == b.a && o.b < b.b)));
}

// A warp's entry in a row's slot: the key of its total at its last cell
// before the warps ahead of it ((max(T, FLOOR) - gap WL warp) 16 + warp),
// that total's count, and its first cell's own value and count (before
// any carry).
struct Slot {
  int key, tc, fv, fc;
};

__device__ __forceinline__ int load_code(const uint8_t* __restrict__ br, int x,
                                         int LB) {
  return br[min(max(x, 0), LB - 1)];
}

// The cell from its diagonal (dh, dm) and up (uh, um) carries: (s, sm)
// before the gap scan.  MASK: NEG_INF outside the row, and a restart clears
// the count.  Without MASK (a warp inside the row, gap <= 0) the count of a
// restarted cell is left as it is: its value 0 carries nothing into a cell
// (a carry wins only when strictly higher, and a cell is >= 0), and the
// carry to the next row clears the count of every value <= 0.
template <bool MASK>
__device__ __forceinline__ void cell(int dh, int dm, int uh, int um, int bc,
                                     int acx, bool ok, int match, int mismatch,
                                     int gap, int& s, int& sm) {
  const bool is_m = bc == acx;  // acx is -1 for a code >= 4
  const int cd = dh + (is_m ? match : mismatch), cu = uh + gap;
  const bool td = cd >= cu;
  const int mm = td ? dm + (int)is_m : um;
  const int m = __vimax3_s32(cd, cu, 0);  // restarted at 0
  s = !MASK || ok ? m : NEG_INF;
  sm = !MASK || (td ? cd : cu) >= 0 ? mm : 0;
}

__device__ __forceinline__ bool in_row(int bs, int k, int W, int bl) {
  return k < W && (unsigned)(bs + k - 1) < (unsigned)bl;
}

// The unit path's cells: on SHIFT 1 the diagonal is the own lane and up
// the lane to the right (xh, xm: the next thread's first lane); on SHIFT 0
// the diagonal is the lane to the left (xh, xm: the previous thread's last)
// and up the own lane.
template <int P, int SHIFT, bool MASK>
__device__ __forceinline__ void cells_unit(const int (&h)[P], const int (&hm)[P],
                                           int xh, int xm, const int (&bc)[P],
                                           int acx, int bs, int k0, int W, int bl,
                                           int match, int mismatch, int gap,
                                           int (&s)[P], int (&sm)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const bool ok = MASK && in_row(bs, k0 + q, W, bl);
    if (SHIFT)
      cell<MASK>(h[q], hm[q], q + 1 < P ? h[q + 1] : xh, q + 1 < P ? hm[q + 1] : xm,
                 bc[q], acx, ok, match, mismatch, gap, s[q], sm[q]);
    else
      cell<MASK>(q ? h[q - 1] : xh, q ? hm[q - 1] : xm, h[q], hm[q], bc[q], acx, ok,
                 match, mismatch, gap, s[q], sm[q]);
  }
}

// The row's final values to the carry (h, hm) and the row maximum rb (one
// 3-way max a pair of cells); with MASK, cells outside the row carry 0 and
// dead lanes NEG_INF.
template <int P, bool MASK>
__device__ __forceinline__ int finish(const int (&s)[P], const int (&sm)[P], int bs,
                                      int k0, int W, int bl, int (&h)[P],
                                      int (&hm)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int k = k0 + q;
    const int v = !MASK || in_row(bs, k, W, bl) ? s[q] : NEG_INF;
    bool z;
    const int hh = __vibmax_s32(0, v, &z);  // z: v <= 0, the count cleared
    h[q] = !MASK || k < W ? hh : NEG_INF;
    hm[q] = z ? 0 : sm[q];
  }
  int rb = h[0];
#pragma unroll
  for (int q = 1; q < P; q += 2) rb = __vimax3_s32(rb, h[q], q + 1 < P ? h[q + 1] : 0);
  return rb;
}

// One pair's rows first .. last (first <= last) by the whole block of
// warps x 32 threads, P lanes each.  rows: the shared-memory path's two
// rows (H[W] then M[W] each); slot: the two row slots.  Returns the
// thread's best cell.
template <int P, bool UNIT>
__device__ Best sw_pair(const uint8_t* __restrict__ ar, const uint8_t* __restrict__ br,
                        int LB, int W, int bl, int tb, int qb, int slope,
                        int first, int last, int match, int mismatch, int gap,
                        int* rows, Slot (*slot)[MAX_WARPS]) {
  constexpr int WL = 32 * P;  // band lanes a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = tid * P;
  const warpdp::ScanSrc src = warpdp::scan_sources(lane);
  // the carry: every live lane 0, count 0; dead lanes NEG_INF
  int h[P], hm[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    h[q] = k0 + q < W ? 0 : NEG_INF;
    hm[q] = 0;
  }
  // the unit path's carries across warps: the next warp's first lane (for
  // lane 31) and the previous warp's last lane (for lane 0)
  int nxh = WL * (warp + 1) < W ? 0 : NEG_INF, nxm = 0;
  int pvh = warp > 0 && WL * warp - 1 < W ? 0 : NEG_INF, pvm = 0;
  if (!UNIT) {
    for (int k = tid; k < 2 * W; k += blockDim.x) rows[k] = 0;
    __syncthreads();
  }
  Best best = {0, 0, 0, 0};  // row 0's 0 wins every tie at 0
  int cur = 0;
  int bp = base_at(first - 1, tb, qb, slope, bl, W);
  int bs = base_at(first, tb, qb, slope, bl, W);
  int ac = ar[first - 1];
  int bc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) bc[q] = load_code(br, bs + k0 + q - 1, LB);
  // the unit path's one new code a row: column bs + k0 + P - 1 of the next
  // row, its index clipped to [0, LB)
  const uint8_t* __restrict__ bl_new = br + (k0 + P - 2);
  const int lo_new = -(k0 + P - 2), hi_new = LB - 1 - (k0 + P - 2);
  for (int i = first; i <= last; ++i) {
    // row i + 1's band start, `a` code and new `b` codes (clipped; unused
    // after the last row)
    const int bs_n = base_at(i + 1, tb, qb, slope, bl, W);
    const int ac_n = ar[min(i, last - 1)];
    int bc_n[P];
    if (UNIT) {
      bc_n[P - 1] = bl_new[min(max(bs_n, lo_new), hi_new)];
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) bc_n[q] = load_code(br, bs_n + k0 + q - 1, LB);
    }
    const int shift = bs - bp;
    const int acx = ac < 4 ? ac : -1;
    // a warp with every lane inside the row takes the cells without masks
    // (and, where gap <= 0, without the restart's count)
    const bool mask = !UNIT || gap > 0 ||
                      !__all_sync(FULL, in_row(bs, k0, W, bl) &&
                                            in_row(bs, k0 + P - 1, W, bl));
    int s[P], sm[P];
    if (UNIT) {
      if (shift) {
        int xh = __shfl_down_sync(FULL, h[0], 1), xm = __shfl_down_sync(FULL, hm[0], 1);
        if (lane == 31) {
          xh = nxh;
          xm = nxm;
        }
        if (mask)
          cells_unit<P, 1, true>(h, hm, xh, xm, bc, acx, bs, k0, W, bl, match, mismatch,
                                 gap, s, sm);
        else
          cells_unit<P, 1, false>(h, hm, xh, xm, bc, acx, bs, k0, W, bl, match,
                                  mismatch, gap, s, sm);
      } else {
        int xh = __shfl_up_sync(FULL, h[P - 1], 1), xm = __shfl_up_sync(FULL, hm[P - 1], 1);
        if (lane == 0) {
          xh = pvh;
          xm = pvm;
        }
        if (mask)
          cells_unit<P, 0, true>(h, hm, xh, xm, bc, acx, bs, k0, W, bl, match, mismatch,
                                 gap, s, sm);
        else
          cells_unit<P, 0, false>(h, hm, xh, xm, bc, acx, bs, k0, W, bl, match,
                                  mismatch, gap, s, sm);
      }
    } else {
      // the previous row at band lanes k0 + shift - 1 .. k0 + shift + P - 1
      const int* hp = rows + cur * 2 * W;
      const int* mp = hp + W;
      int hv[P + 1], mv[P + 1];
#pragma unroll
      for (int t = 0; t <= P; ++t) {
        const int x = k0 + shift - 1 + t;
        const bool in = (unsigned)x < (unsigned)W;
        const int xc = min(max(x, 0), W - 1);
        hv[t] = in ? hp[xc] : NEG_INF;
        mv[t] = in ? mp[xc] : 0;
      }
#pragma unroll
      for (int q = 0; q < P; ++q)
        cell<true>(hv[q], mv[q], hv[q + 1], mv[q + 1], bc[q], acx,
                   in_row(bs, k0 + q, W, bl), match, mismatch, gap, s[q], sm[q]);
    }
    const int f0 = s[0], fc0 = sm[0];  // the first cell's own value
    // gap scan: along the thread's lanes (the left operand only when
    // strictly higher)
#pragma unroll
    for (int q = 1; q < P; ++q) {
      bool keep;
      s[q] = __vibmax_s32(s[q], s[q - 1] + gap, &keep);
      sm[q] = keep ? sm[q] : sm[q - 1];
    }
    // then across the warp: the carry at the last cell of lane - 1
    int XC;
    int XV = warpdp::warp_carry_payload(s[P - 1], sm[P - 1], gap * P * lane, FLOOR,
                                        lane, src, XC) +
             gap * P * (lane - 1);
    Slot* sl = slot[(i - first) & 1];
    if (lane == 31) {  // the warp's total at its last cell
      int T = s[P - 1], TC = sm[P - 1];
      if (XV + gap * P > T) {
        T = XV + gap * P;
        TC = XC;
      }
      sl[warp].key = (max(T, FLOOR) - gap * WL * warp) * 16 + warp;
      sl[warp].tc = TC;
    }
    if (lane == 0) {
      sl[warp].fv = f0;
      sl[warp].fc = fc0;
    }
    __syncthreads();
    // the warps before: the carry at the last cell of warp - 1 (lane u
    // reads warp u's key, one warp max-reduction)
    int GV = 0, GC = 0;
    if (warp > 0) {
      const int g = __reduce_max_sync(FULL, lane < warp ? sl[lane].key : INT_MIN);
      GV = (g >> 4) + gap * WL * (warp - 1);
      GC = sl[g & 15].tc;
    }
    // the carry into this thread: at the last cell of thread tid - 1
    if (lane == 0) XV = NO_CARRY;
    if (warp > 0) {
      const int c = GV + gap * P * lane;
      if (lane == 0 || c > XV) {
        XV = c;
        XC = GC;
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      bool keep;
      s[q] = __vibmax_s32(s[q], XV + gap * (q + 1), &keep);
      sm[q] = keep ? sm[q] : XC;
    }
    if (UNIT) {
      // the next row's carry across warps, from this row's final values:
      // on a step of 1 its `up` at a warp's last lane, on 0 its diagonal at
      // a warp's first lane
      if (bs_n != bs && lane == 31) {
        nxh = NEG_INF;
        nxm = 0;
        const int kn = WL * (warp + 1);
        if (kn < W) {  // the next warp's first cell: its own value or the carry
          const Slot f = sl[warp + 1];
          int fv = f.fv, fc = f.fc;
          const int c = s[P - 1] + gap;
          if (c > fv) {
            fv = c;
            fc = sm[P - 1];
          }
          nxh = in_row(bs, kn, W, bl) && fv > 0 ? fv : 0;
          nxm = nxh == 0 ? 0 : fc;
        }
      }
      if (bs_n == bs && lane == 0) {
        pvh = NEG_INF;
        pvm = 0;
        const int kp = WL * warp - 1;
        if (warp > 0 && kp < W) {  // the previous warp's last cell: the fold
          pvh = in_row(bs, kp, W, bl) && GV > 0 ? GV : 0;
          pvm = pvh == 0 ? 0 : GC;
        }
      }
    }
    const int rb = mask ? finish<P, true>(s, sm, bs, k0, W, bl, h, hm)
                        : finish<P, false>(s, sm, bs, k0, W, bl, h, hm);
    if (rb > best.v) {  // a new best: its lowest column, the row's first
      bool found = false;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (!found && s[q] == rb && in_row(bs, k0 + q, W, bl)) {
          best = {rb, sm[q], i, bs + k0 + q};
          found = true;
        }
      }
    }
    if (!UNIT) {
      int* hn = rows + (cur ^ 1) * 2 * W;
      int* mn = hn + W;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (k0 + q < W) {
          hn[k0 + q] = h[q];
          mn[k0 + q] = hm[q];
        }
      }
      __syncthreads();  // the new row is written before the next reads it
    }
    cur ^= 1;
    bp = bs;
    bs = bs_n;
    ac = ac_n;
    if (UNIT) {
      // the codes move one lane left on a step of 1
      if (bs_n != bp) {
#pragma unroll
        for (int q = 0; q + 1 < P; ++q) bc[q] = bc[q + 1];
      }
      bc[P - 1] = bc_n[P - 1];
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) bc[q] = bc_n[q];
    }
  }
  return best;
}

// The warps a block of P lanes a thread may have, and its launch bounds:
// 512 threads (128 registers a thread, which no instance spills at) for
// every P but 10, W 1600's, which is held to 2 blocks of 10 warps a SM
// (96 registers): then 4 of W 1600's 5-warp blocks fit on a SM where 121
// registers fit 3, and the kernel runs ~3.5% faster in same-call pairs
// (PERF.md §6).  ops/overlap_dp.py swwide_shape keeps to max_warps.
__host__ __device__ constexpr int max_warps(int P) { return P == 10 ? 10 : MAX_WARPS; }

template <int P>
__global__ void __launch_bounds__(32 * max_warps(P), P == 10 ? 2 : 1)
    swwide_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  const int* __restrict__ blen, const int* __restrict__ tbv,
                  const int* __restrict__ qbv, const int* __restrict__ slv,
                  const int* __restrict__ i0v, const int* __restrict__ i1v,
                  const uint8_t* __restrict__ unit, const int* __restrict__ order,
                  int* __restrict__ counter, int B, int LA, int LB, int W, int match,
                  int mismatch, int gap, int* __restrict__ out) {
  extern __shared__ int rows[];  // the shared-memory path's two rows
  __shared__ Slot slot[2][MAX_WARPS];
  __shared__ Best wbest[MAX_WARPS];
  __shared__ int s_pair;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  for (;;) {
    if (tid == 0) s_pair = atomicAdd(counter, 1);
    __syncthreads();
    const int t = s_pair;
    __syncthreads();  // read by all before thread 0 takes the next
    if (t >= B) break;  // the whole block leaves together
    const int r = order[t];
    const int first = i0v[r], last = i1v[r];
    Best best = {0, 0, 0, 0};
    if (first <= last) {
      const uint8_t* ar = a + (size_t)r * LA;
      const uint8_t* br = b + (size_t)r * LB;
      if (unit[r])
        best = sw_pair<P, true>(ar, br, LB, W, blen[r], tbv[r], qbv[r], slv[r], first,
                                last, match, mismatch, gap, rows, slot);
      else
        best = sw_pair<P, false>(ar, br, LB, W, blen[r], tbv[r], qbv[r], slv[r], first,
                                 last, match, mismatch, gap, rows, slot);
    }
    // the pair's best: the highest value, then the earliest row, then the
    // lowest column, as the JAX scan's strictly-higher update of row maxima
#pragma unroll
    for (int d = 16; d > 0; d /= 2) {
      const Best o = {__shfl_xor_sync(FULL, best.v, d),
                      __shfl_xor_sync(FULL, best.mat, d),
                      __shfl_xor_sync(FULL, best.a, d),
                      __shfl_xor_sync(FULL, best.b, d)};
      if (before(o, best)) best = o;
    }
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (tid == 0) {
      Best bb = wbest[0];
      for (int w = 1; w < warps; ++w)
        if (before(wbest[w], bb)) bb = wbest[w];
      out[r] = bb.v;
      out[B + r] = bb.mat;
      out[2 * B + r] = bb.a;
      out[3 * B + r] = bb.b;
    }
    // wbest, the slots and the rows are read before the next pair writes
    // them: the next turn's first barrier
  }
}

template <int P>
int launch(int warps, const uint8_t* a, const uint8_t* b, const int* blen,
           const int* tb, const int* qb, const int* slope, const int* i0, const int* i1,
           const uint8_t* unit, const int* order, int* counter, int B, int LA, int LB,
           int W, int match, int mismatch, int gap, int* out, cudaStream_t st) {
  if (warps > max_warps(P)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * W * sizeof(int);
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(swwide_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swwide_kernel<P>,
                                                      warps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = std::max(1, std::min(B, nsm * std::max(1, per_sm)));
  swwide_kernel<P><<<blocks, warps * 32, smem, st>>>(a, b, blen, tb, qb, slope, i0, i1, unit, order, counter, B, LA, LB, W, match, mismatch, gap, out);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch(int p, int warps, const uint8_t* a, const uint8_t* b, const int* blen,
             const int* tb, const int* qb, const int* slope, const int* i0,
             const int* i1, const uint8_t* unit, const int* order, int* counter, int B,
             int LA, int LB, int W, int match, int mismatch, int gap, int* out,
             cudaStream_t st) {
  if (p == P)
    return launch<P>(warps, a, b, blen, tb, qb, slope, i0, i1, unit, order, counter, B,
                     LA, LB, W, match, mismatch, gap, out, st);
  if constexpr (P < MAX_P)
    return dispatch<P + 1>(p, warps, a, b, blen, tb, qb, slope, i0, i1, unit, order,
                           counter, B, LA, LB, W, match, mismatch, gap, out, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The arguments of swlocal_dp (csrc/swlocal.cu), with unit [B] u8 after
// i1 (1 where every live row's band start moves 0 or 1 column from the row
// before) and the block shape after W (warps x 32 threads of P lanes, P
// 1 .. 12, warps 1 .. max_warps(P), covering W): a [B, LA] u8, b [B, LB] u8, blen,
// tb, qb, slope [B] i32; i0, i1 [B] i32 each pair's live rows (i0 > i1:
// none), unit, order [B] i32 the pairs longest first, counter one i32 set
// to 0; out [4, B] i32 (best score, its matches, end row, end column).
// W: 1 .. 4096.
extern "C" int swwide_dp(const uint8_t* a, const uint8_t* b, const int* blen,
                         const int* tb, const int* qb, const int* slope,
                         const int* i0, const int* i1, const uint8_t* unit,
                         const int* order, int* counter, int B, int LA, int LB,
                         int W, int P, int warps, int match, int mismatch, int gap,
                         int* out, void* stream) {
  if (W < 1 || W > MAX_W || P < 1 || P > MAX_P || warps < 1 || warps > MAX_WARPS ||
      32 * P * warps < W)
    return (int)cudaErrorInvalidValue;
  return dispatch<1>(P, warps, a, b, blen, tb, qb, slope, i0, i1, unit, order, counter,
                     B, LA, LB, W, match, mismatch, gap, out, (cudaStream_t)stream);
}
