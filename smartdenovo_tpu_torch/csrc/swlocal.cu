// Score-only banded Smith-Waterman along a linear chain diagonal, for
// Hopper: the zmo (SW) engine's alignment DP.
//
// Replaces smartdenovo_tpu/ops/overlap_dp.py:48 banded_local_dp, which is
// `jax.jit` over a `lax.scan` of rows (not Pallas).  For each pair, a local
// DP of `a` (rows) against `b` (columns) over W band lanes whose leftmost
// column in row i is
//     clip(qb + (((i - tb) * slope) >> 12) - W/2, -(W-1), max(0, blen))
// in int32 (the product wraps, the shift floors).  A cell is
//     m = max(dg + sub, up + gap)      (the diagonal wins ties),
// restarted at 0 (with its match count) when negative, masked to NEG_INF
// outside 1 <= j <= blen, then the in-row linear gap
//     s[j] = max over k <= j of m[k] + gap (j - k)
// with the match count of the rightmost k that reaches it.  The row's
// best is its lowest column of the highest s; the pair's best updates only
// on a strictly higher row best (so the earliest row wins).  The carry to
// the next row clamps every s below 0 to 0 (the masked cells too) and
// clears the count where it is 0.  Outputs: best score, its match count,
// its row and column, [4, B] int32.  No direction matrix; the inputs are
// read once.
//
// What bounds it.  The work that can change an output is each pair's live
// rows (ops/overlap_dp.py live_rows: the rows before the band reaches
// column 1 leave the carry at zeros, and, where the gap is not positive,
// once the band is pinned at blen no row can raise the best) x W cells of
// about 12 int32 operations, so the bound is the card's int32 rate on the
// live cells; the bytes (each pair's codes once) are far below it.  What
// holds it back is the pacing SM sub-partition: a pair's rows are a
// dependent chain, pair lengths run from a few thousand to ~19,000 live
// rows on the E. coli zmo batch (2,048 pairs, both passes), and a row is
// a chain of shared-memory reads, a serial and a shuffle scan, so a warp
// alone on its sub-partition spends more cycles a row waiting than
// issuing.
//
// Design.  The wrapper hands the kernel each pair's live rows [i0, i1]
// and the pairs in order of live rows, longest first.  The grid is what
// is resident at once: one block a SM of four warps, one on each of its
// sub-partitions (a second warp on a sub-partition slows the pacing pair
// more than it shortens the rest: 1-4 warps were measured, PERF.md §6).
// Each warp takes the next pair of that order from a counter (one lane's
// atomicAdd, shuffled to the warp) and writes the pair's outputs at the
// pair's own index, so the load balances as longest-processing-time-first
// does and nothing is un-permuted.  A pair starts at row i0 with the zero
// carry and the band start of row i0 - 1.  Lane l owns the P = W / 32
// consecutive band lanes P l .. P l + P - 1.  Row i + 1's band start, its
// `a` code and the lane's P `b` codes are loaded while row i computes, so
// no load from global memory waits on the row's chain.  The previous
// row's H and match counts sit in a double-buffered shared row
// (warpdp.cuh's bank-conflict-free layout), so a band step of any size
// (0-4 on the engine's inputs, anything through the API) is one indexed
// read per cell, and positions outside [0, W) read NEG_INF and 0.  The
// gap scan runs serially over a lane's P cells, then a five-round shuffle
// scan of the lane totals (value, count; the combine of the JAX scan,
// which keeps the right operand on a tie) carries the lanes before, and
// one pass applies it.  Each lane keeps the best of its own cells (only a
// strictly higher value replaces it, so its earliest row and then its
// lowest column win), and one warp reduction after the last row picks
// the highest value, then the earliest row, then the lowest column: the
// JAX scan's first argmax of each row, taken only when strictly higher.
// Every index is clipped before it loads: band values never address
// memory unclipped.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "warpdp.cuh"

namespace {

constexpr int NEG_INF = -(1 << 28);
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // a block: one on each SM sub-partition

// the band's leftmost column of row i, in the JAX function's int32
// arithmetic (wrapping products and sums, an arithmetic shift)
template <int W>
__device__ __forceinline__ int base_at(int i, int tb, int qb, int slope, int bl) {
  const int d = (int)((unsigned)i - (unsigned)tb);
  const int prod = (int)((unsigned)d * (unsigned)slope);
  int c = (int)((unsigned)qb + (unsigned)(prod >> 12));
  c = (int)((unsigned)c - (unsigned)(W / 2));
  return min(max(c, -(W - 1)), max(0, bl));
}

struct Best {
  int v, mat, a, b;  // score, its matches, row, column
};

// One pair's DP over rows first .. last (first <= last), by one warp, with
// buf its 4 W ints of shared memory.  Row i + 1's band start and codes are
// loaded while row i computes; each lane keeps the best of its own cells,
// and one warp reduction at the end picks the pair's.
template <int P>
__device__ Best sw_pair(const uint8_t* __restrict__ ar, const uint8_t* __restrict__ br,
                        int LB, int bl, int tb, int qb, int slope, int first,
                        int last, int match, int mismatch, int gap, int* buf,
                        int lane) {
  constexpr int W = 32 * P;
  const int k0 = lane * P;
#pragma unroll
  for (int q = 0; q < P; ++q) {  // the zero carry
    buf[warpdp::sw<P>(k0 + q)] = 0;
    buf[W + warpdp::sw<P>(k0 + q)] = 0;
  }
  __syncwarp();
  // the lane's best cell: value 0 at row 0, which wins every tie at 0, so
  // a pair with no positive cell gives (0, 0, 0, 0)
  Best best = {0, 0, 0, 0};
  int cur = 0;
  int bp = base_at<W>(first - 1, tb, qb, slope, bl);
  int bs = base_at<W>(first, tb, qb, slope, bl);
  int ac = ar[first - 1];
  int bc[P];
#pragma unroll
  for (int q = 0; q < P; ++q) bc[q] = br[min(max(bs + k0 + q - 1, 0), LB - 1)];
  for (int i = first; i <= last; ++i) {
    // row i + 1's band start and codes (clipped; unused after the last row)
    const int bs_n = base_at<W>(i + 1, tb, qb, slope, bl);
    const int ac_n = ar[min(i, last - 1)];
    int bc_n[P];
#pragma unroll
    for (int q = 0; q < P; ++q)
      bc_n[q] = br[min(max(bs_n + k0 + q - 1, 0), LB - 1)];
    const int shift = bs - bp;
    const int* hp = buf + cur * 2 * W;
    const int* mp = hp + W;
    // the previous row at band lanes k0 + shift - 1 .. k0 + shift + P - 1
    int hv[P + 1], mv[P + 1];
#pragma unroll
    for (int t = 0; t <= P; ++t) {
      const int x = k0 + shift - 1 + t;
      const bool in = (unsigned)x < (unsigned)W;
      const int xc = min(max(x, 0), W - 1);
      const int hx = hp[warpdp::sw<P>(xc)], mx = mp[warpdp::sw<P>(xc)];
      hv[t] = in ? hx : NEG_INF;
      mv[t] = in ? mx : 0;
    }
    int s[P], sm[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int j = bs + k0 + q;
      const bool is_m = ac == bc[q] && ac < 4 && bc[q] < 4;
      const int cd = hv[q] + (is_m ? match : mismatch);
      const int cu = hv[q + 1] + gap;
      const bool td = cd >= cu;
      int m = td ? cd : cu;
      int mm = td ? mv[q] + (int)is_m : mv[q + 1];
      if (m < 0) {
        m = 0;
        mm = 0;
      }
      const bool ok = j >= 1 && j <= bl;
      s[q] = ok ? m : NEG_INF;
      sm[q] = mm;
    }
    // gap scan: along the lane, then the carry from the lanes before
#pragma unroll
    for (int q = 1; q < P; ++q) {
      const int c = s[q - 1] + gap;
      if (!(s[q] >= c)) {
        s[q] = c;
        sm[q] = sm[q - 1];
      }
    }
    int V = s[P - 1], C = sm[P - 1];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int ov = __shfl_up_sync(FULL, V, d), oc = __shfl_up_sync(FULL, C, d);
      const int c = ov + gap * P * d;
      if (lane >= d && c > V) {
        V = c;
        C = oc;
      }
    }
    const int XV = __shfl_up_sync(FULL, V, 1), XC = __shfl_up_sync(FULL, C, 1);
    int* hn = buf + (cur ^ 1) * 2 * W;
    int* mn = hn + W;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (lane > 0) {
        const int c = XV + gap * (q + 1);
        if (c > s[q]) {
          s[q] = c;
          sm[q] = XC;
        }
      }
      const int j = bs + k0 + q;
      const bool ok = j >= 1 && j <= bl;
      const int v = ok ? s[q] : NEG_INF;
      const int vm = ok ? sm[q] : 0;
      // strictly higher: the lane's earliest row, then its lowest column
      if (v > best.v) best = {v, vm, i, j};
      // the carry: below 0 becomes 0, and its count with it
      const int h = v < 0 ? 0 : v;
      hn[warpdp::sw<P>(k0 + q)] = h;
      mn[warpdp::sw<P>(k0 + q)] = h == 0 ? 0 : vm;
    }
    __syncwarp();  // the new row is written before the next reads it
    cur ^= 1;
    bp = bs;
    bs = bs_n;
    ac = ac_n;
#pragma unroll
    for (int q = 0; q < P; ++q) bc[q] = bc_n[q];
  }
  // the pair's best: the highest value, then the earliest row, then the
  // lowest column, as the JAX scan's strictly-higher update of row maxima
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    const int ov = __shfl_xor_sync(FULL, best.v, d),
              om = __shfl_xor_sync(FULL, best.mat, d),
              oa = __shfl_xor_sync(FULL, best.a, d),
              ob = __shfl_xor_sync(FULL, best.b, d);
    if (ov > best.v ||
        (ov == best.v && (oa < best.a || (oa == best.a && ob < best.b))))
      best = {ov, om, oa, ob};
  }
  return best;
}

// The second bound (4 blocks a SM; one is launched) caps a thread at 128
// registers, under which ptxas uses 93 at W 256; with no cap it picks 80
// and the kernel runs ~25% slower (PERF.md §6).
template <int P>
__global__ void __launch_bounds__(WARPS * 32, 4)
    swlocal_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                   const int* __restrict__ blen, const int* __restrict__ tbv,
                   const int* __restrict__ qbv, const int* __restrict__ slv,
                   const int* __restrict__ i0v, const int* __restrict__ i1v,
                   const int* __restrict__ order, int* __restrict__ counter, int B,
                   int LA, int LB, int match, int mismatch, int gap,
                   int* __restrict__ out) {
  // per warp: two buffers, each H[W] then M[W], in warpdp::sw order
  __shared__ int smem[WARPS * 4 * (32 * P)];
  const int lane = threadIdx.x & 31;
  int* buf = smem + (threadIdx.x >> 5) * 4 * (32 * P);
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(counter, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= B) break;  // the whole warp leaves together
    const int r = order[t];
    const int first = i0v[r], last = i1v[r];
    Best best = {0, 0, 0, 0};
    if (first <= last)
      best = sw_pair<P>(a + (size_t)r * LA, b + (size_t)r * LB, LB, blen[r], tbv[r],
                        qbv[r], slv[r], first, last, match, mismatch, gap, buf,
                        lane);
    if (lane == 0) {
      out[r] = best.v;
      out[B + r] = best.mat;
      out[2 * B + r] = best.a;
      out[3 * B + r] = best.b;
    }
  }
}

// The grid: one block a SM (fewer for a small batch), a warp on each of
// its four sub-partitions (fewer when the pairs run out), so that every
// warp of the grid finds a pair at the start.
template <int P>
int launch(const uint8_t* a, const uint8_t* b, const int* blen, const int* tb,
           const int* qb, const int* slope, const int* i0, const int* i1,
           const int* order, int* counter, int B, int LA, int LB, int match,
           int mismatch, int gap, int* out, cudaStream_t st) {
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = std::max(1, std::min(nsm, (B + WARPS - 1) / WARPS));
  const int warps = std::min(WARPS, (B + blocks - 1) / blocks);
  swlocal_kernel<P><<<blocks, warps * 32, 0, st>>>(
      a, b, blen, tb, qb, slope, i0, i1, order, counter, B, LA, LB, match,
      mismatch, gap, out);
  return (int)cudaGetLastError();
}

}  // namespace

// a [B, LA] u8, b [B, LB] u8, blen, tb, qb, slope [B] i32; i0, i1 [B] i32
// each pair's live rows (i0 > i1: none), order [B] i32 the pairs longest
// first, counter one i32 set to 0; out [4, B] i32 (best score, its
// matches, end row, end column).  W: a multiple of 32 up to 256.
extern "C" int swlocal_dp(const uint8_t* a, const uint8_t* b, const int* blen,
                          const int* tb, const int* qb, const int* slope,
                          const int* i0, const int* i1, const int* order,
                          int* counter, int B, int LA, int LB, int W, int match,
                          int mismatch, int gap, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SWLOCAL_ARGS                                                              \
  a, b, blen, tb, qb, slope, i0, i1, order, counter, B, LA, LB, match, mismatch, \
      gap, out, st
  switch (W) {
    case 32: return launch<1>(SWLOCAL_ARGS);
    case 64: return launch<2>(SWLOCAL_ARGS);
    case 96: return launch<3>(SWLOCAL_ARGS);
    case 128: return launch<4>(SWLOCAL_ARGS);
    case 160: return launch<5>(SWLOCAL_ARGS);
    case 192: return launch<6>(SWLOCAL_ARGS);
    case 224: return launch<7>(SWLOCAL_ARGS);
    case 256: return launch<8>(SWLOCAL_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SWLOCAL_ARGS
}
