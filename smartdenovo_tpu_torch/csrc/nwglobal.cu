// Batched global (Needleman-Wunsch) alignment with a direction plane, for
// Hopper.
//
// Replaces smartdenovo_tpu/ops/swdp.py:32 batch_global_align, which is
// `jax.jit` over `lax.scan` (:88), not a Pallas kernel: a linear-gap DP of
// B pairs over the 2L + 1 anti-diagonals of an (L + 1) x (L + 1) grid,
// whose output is the score at (alen, blen) and one move byte for every
// cell of every diagonal, dirs[k, d, i] for cell (i, d - i).
//
// What bounds it on the H100.  The plane is B (2L + 1)(L + 1) bytes, every
// one of which is written (STOP outside i <= alen, j <= blen), and the
// live cells are sum (alen + 1)(blen + 1) at ~12 int32 operations each.
// At chip_smoke.py's B 2,048, L 512 the two bounds are both ~0.3 ms: the
// 1.08 GB plane over 3.35 TB/s, and ~4.3e8 cells over 16.7 T int32 op/s.
// A diagonal depends on the two before it, so a pair is a chain of 2L + 1
// steps: what a step costs is the instructions it issues and the latency
// of its chain (a shuffle, a shared load, ~8 dependent int ops), hidden
// only by the other warps on the scheduler.
//
// Two instances, chosen by shape (ops/swdp.py nw_plan):
//
// The register instance (L up to NW_REG_MAX_L; both callers of the port).
// A pair's L + 1 rows are cut into strips of 32 P rows, one warp a strip
// (`warps` warps a pair; the wrapper's nw_shape picks P, the warps and
// the pairs a block).  Lane l of a strip holds rows base + l + 32 r for
// r < P in registers: its H on the previous diagonal, the `up` it was
// handed then (this diagonal's diagonal neighbour) and its row's `a`
// code, loaded once.  On diagonal d register group r takes
//   up    from lane l - 1's register r (lane 0 from lane 31's r - 1, a
//         select at the source before one __shfl_sync; a strip's first
//         row from the strip before it through a two-slot shared-memory
//         ring, with one named barrier a diagonal over the pair's warps
//         only, and none at all when a pair is one warp),
//   diag  from its own register (the up it took on d - 1),
//   left  from its own H,
// and its `b` code from the pair's b staged once in shared memory (an
// immediate offset from one pointer a diagonal, so no per-cell global
// load).  Each group's byte store is 32 consecutive plane bytes.  The
// live rows [max(0, d - blen), min(alen, d)] are one interval, and the
// groups go by chunks of CH: a chunk with no live row only stores its
// zero bytes; a chunk whose rows are all live interior cells (1 <= i, j)
// runs its cells without any mask; any other adds the masks, row 0,
// column 0 and the origin.  A chunk's groups run without a branch between
// them, so the compiler interleaves their chains (with a branch a group
// each chain ran alone, ~1.4x slower at phase 3's batch).  Past diagonal
// alen + blen nothing is live, so the tail only
// stores zeros, and the lane holding row alen writes the score.  A live
// cell reads only live cells of the two diagonals before it, so no
// register needs initialising and dead lanes may hold anything.  A
// pair's warps all share one SM, so a small batch (the DAG loop's 24
// pairs) runs on few SMs: its floor is its 2L + 1 dependent diagonals.
//
// The wide instance (L past NW_REG_MAX_L).  One block of 256 threads a
// pair; the threads stride the L + 1 rows of a diagonal, compute the live
// rows and store every row's byte.  The three diagonals in flight rotate
// through three (L + 1)-int buffers in shared memory, or past the 227 KB a
// block may take (L >= 19,370) in a global scratch of [B, 3, L + 1] ints,
// with one __syncthreads a diagonal.
//
// Integer semantics are the JAX version's: ties DIAG > UP > LEFT; a match
// needs equal codes below 4; row 0 and column 0 are gap * j (LEFT) and
// gap * i (UP), the origin 0 (STOP); every sum is int32.  Lengths are
// taken in [0, L] (the wrapper's contract; the kernels clamp them).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint8_t STOP = 0, DIAG = 1, UP = 2, LEFT = 3;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;          // the wide instance's block
constexpr size_t SMEM_MAX = 232448;   // shared memory a block can use
// codes >= 4 become bytes that match nothing: 0xFE in a, 0xFF in b
constexpr int A_N = 0xFE, B_N = 0xFF;

// threads a block of the register instance may have at P rows a lane
// (its registers: 3 P and ~30 more a thread); ops/swdp.py nw_max_warps
#define NW_REG_THREADS(P) ((P) <= 8 ? 1024 : ((P) <= 20 ? 512 : 384))

__device__ __forceinline__ void pair_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// register groups a chunk: the unit that is skipped when dead, and whose
// groups' cells are computed together, without a branch between them
constexpr int CH = 4;
constexpr int PAD = 32 * CH;   // b's margin in shared memory

// What one warp of a pair keeps across diagonals.
template <int P>
struct Strip {
  int h[P];    // H on the previous diagonal
  int dg[P];   // the up taken on the previous diagonal: this one's diag
  int ac[P];   // the row's a code (A_N for >= 4)
};

// Per-diagonal values of a strip, the same in every lane but x, y, pb
// and dp.
struct Diag {
  int d, ringv;      // the diagonal; lane 0's up for group 0
  int rl, rh;        // live rows lo, hi less the strip's first row
  int il, ih;        // interior rows max(lo, 1), min(hi, d - 1), the same
  int x, y, span;    // irow - d, irow - lo, hi - lo
  const uint8_t* pb; // sb + PAD - 1 - irow + d: group r's b at pb[-32 r]
  uint8_t* dp;       // the plane at row irow of diagonal d
};

// Group r's cells on one diagonal.  EDGE: the group may hold dead rows,
// row 0 or column 0 (masks and boundary values); else all 32 rows are
// live interior cells.
template <int P, int r, bool EDGE>
__device__ __forceinline__ void cell(Strip<P>& s, const Diag& q, int lane,
                                     bool row0, int lim, int vm, int vx,
                                     int gap) {
  const int src = (r > 0 && lane == 31) ? s.h[r > 0 ? r - 1 : 0] : s.h[r];
  int up = __shfl_sync(FULL, src, (lane + 31) & 31);
  if (r == 0 && lane == 0) up = q.ringv;
  const int bc = q.pb[-32 * r];
  const int dgs = s.dg[r] + (s.ac[r] == bc ? vm : vx);
  s.dg[r] = up;
  const int upg = up + gap, lf = s.h[r] + gap;
  bool pu, pd;
  const int m1 = __vibmax_s32(upg, lf, &pu);
  int hn = __vibmax_s32(dgs, m1, &pd);
  uint8_t mv = pd ? DIAG : (pu ? UP : LEFT);
  if (EDGE) {
    const bool col0 = q.x == -32 * r;   // j == 0
    hn = col0 ? upg : hn;
    mv = col0 ? UP : mv;
    if (r == 0) {                       // row 0, and the origin
      hn = row0 ? (q.d ? lf : 0) : hn;
      mv = row0 ? (q.d ? LEFT : STOP) : mv;
    }
    const bool live = (unsigned)(q.y + 32 * r) <= (unsigned)q.span;
    s.h[r] = hn;
    if (32 * r < lim) q.dp[32 * r] = live ? mv : STOP;
  } else {
    s.h[r] = hn;
    q.dp[32 * r] = mv;
  }
}

// Groups r down to r0 of a chunk, each after the one above it: the next
// lower group's shuffle reads this one's old H from lane 31.
template <int P, int r, int r0, bool EDGE>
__device__ __forceinline__ void cells(Strip<P>& s, const Diag& q, int lane,
                                      bool row0, int lim, int vm, int vx,
                                      int gap) {
  cell<P, r, EDGE>(s, q, lane, row0, lim, vm, vx, gap);
  if constexpr (r > r0)
    cells<P, r - 1, r0, EDGE>(s, q, lane, row0, lim, vm, vx, gap);
}

// Chunk c (groups c CH .. c CH + CH - 1, cut at P), then the chunks
// below: with no live row, only its zero bytes; with all rows live
// interior cells, the cells without masks; else the cells with them.
template <int P, int c>
__device__ __forceinline__ void chunk(Strip<P>& s, const Diag& q, int lane,
                                      bool row0, int lim, int vm, int vx,
                                      int gap) {
  constexpr int r0 = c * CH, r1 = (r0 + CH < P ? r0 + CH : P) - 1;
  constexpr int g0 = 32 * r0, g1 = 32 * r1 + 31;   // its rows from base
  if (q.rh < g0 || q.rl > g1) {
#pragma unroll
    for (int r = r1; r >= r0; --r)
      if (32 * r < lim) q.dp[32 * r] = STOP;
  } else if (q.il <= g0 && q.ih >= g1) {
    cells<P, r1, r0, false>(s, q, lane, row0, lim, vm, vx, gap);
  } else {
    cells<P, r1, r0, true>(s, q, lane, row0, lim, vm, vx, gap);
  }
  if constexpr (c > 0)
    chunk<P, c - 1>(s, q, lane, row0, lim, vm, vx, gap);
}

template <int P>
__global__ void __launch_bounds__(NW_REG_THREADS(P))
nw_reg_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
              const int* __restrict__ alen_p, const int* __restrict__ blen_p,
              int B, int L, int match, int mismatch, int gap, int warps,
              int* __restrict__ score, uint8_t* __restrict__ dirs) {
  extern __shared__ int smem_i[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_i);
  const int pairs = blockDim.x / (32 * warps);
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = wid / warps, strip = wid - slot * warps;
  const int SB = (L + 2 * PAD + 3) & ~3;   // b's bytes a pair
  uint8_t* sb = smem + slot * SB;
  // ring[2 s + (d & 1)]: strip s - 1's last row H on diagonal d
  int* ring = reinterpret_cast<int*>(smem + pairs * SB) + slot * 2 * warps;
  const int k = blockIdx.x * pairs + slot;
  if (k < B) {
    const uint8_t* bk = b + (size_t)k * L;
    for (int t = strip * 32 + lane; t < SB; t += 32 * warps) {
      const int j = t - PAD;
      const int c = (j >= 0 && j < L) ? bk[j] : 4;
      sb[t] = c < 4 ? c : B_N;
    }
  }
  __syncthreads();   // once, before the diagonals
  if (k >= B) return;

  const int alen = min(max(alen_p[k], 0), L);
  const int blen = min(max(blen_p[k], 0), L);
  const int W = L + 1;
  const int base = strip * 32 * P;
  const int irow = base + lane;      // group r's row is irow + 32 r
  const int lim = W - irow;          // group r's row exists iff 32 r < lim
  const bool row0 = irow == 0;
  const int vm = match, vx = mismatch;
  Strip<P> s;
  const uint8_t* ak = a + (size_t)k * L;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int i = irow + 32 * r;
    const int c = (i >= 1 && i <= L) ? ak[i - 1] : 4;
    s.ac[r] = c < 4 ? c : A_N;
    s.h[r] = 0;
    s.dg[r] = 0;
  }
  Diag q;
  q.dp = dirs + (size_t)k * (2 * L + 1) * W + irow;
  // cell (i, d - i) reads b[d - i - 1] at sb[PAD + d - i - 1]
  q.pb = sb + PAD - 1 - irow;
  const bool multi = warps > 1;
  const int dend = alen + blen;
  for (int d = 0; d <= dend; ++d) {
    const int lo = max(0, d - blen), hi = min(alen, d);
    q.d = d;
    q.ringv = multi ? ring[2 * strip + ((d + 1) & 1)] : 0;
    q.rl = lo - base;
    q.rh = hi - base;
    q.il = max(lo, 1) - base;
    q.ih = min(hi, d - 1) - base;
    q.x = irow - d;
    q.y = irow - lo;
    q.span = hi - lo;
    chunk<P, (P - 1) / CH>(s, q, lane, row0, lim, vm, vx, gap);
    if (multi) {
      if (strip + 1 < warps && lane == 31)
        ring[2 * (strip + 1) + (d & 1)] = s.h[P - 1];
      pair_sync(1 + slot, 32 * warps);
    }
    q.dp += W;
    q.pb += 1;
  }
  // nothing is live past dend, so row alen's register still holds its H
#pragma unroll
  for (int r = 0; r < P; ++r)
    if (irow + 32 * r == alen) score[k] = s.h[r];
  for (int d = dend + 1; d <= 2 * L; ++d) {
#pragma unroll
    for (int r = 0; r < P; ++r)
      if (32 * r < lim) q.dp[32 * r] = STOP;
    q.dp += W;
  }
}

__global__ void __launch_bounds__(THREADS)
nw_wide_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               const int* __restrict__ alen_p, const int* __restrict__ blen_p,
               int L, int match, int mismatch, int gap, int in_smem,
               int* __restrict__ scratch, int* __restrict__ score,
               uint8_t* __restrict__ dirs) {
  extern __shared__ int smem[];
  const int k = blockIdx.x;
  const int W = L + 1;
  int* H = in_smem ? smem : scratch + (size_t)k * 3 * W;
  const uint8_t* ak = a + (size_t)k * L;
  const uint8_t* bk = b + (size_t)k * L;
  const int alen = min(max(alen_p[k], 0), L);
  const int blen = min(max(blen_p[k], 0), L);
  uint8_t* dk = dirs + (size_t)k * (2 * L + 1) * W;
  for (int d = 0; d <= 2 * L; ++d) {
    int* hc = H + (d % 3) * W;                // diagonal d
    const int* h1 = H + ((d + 2) % 3) * W;    // d - 1
    const int* h2 = H + ((d + 1) % 3) * W;    // d - 2
    const int lo = max(0, d - blen), hi = min(alen, d);
    uint8_t* drow = dk + (size_t)d * W;
    for (int i = threadIdx.x; i < W; i += THREADS) {
      uint8_t mv = STOP;
      if (i >= lo && i <= hi) {
        const int j = d - i;
        int h;
        if (i == 0) {
          h = gap * j;
          mv = j ? LEFT : STOP;
        } else if (j == 0) {
          h = gap * i;
          mv = UP;
        } else {
          const int ac = __ldg(ak + i - 1), bc = __ldg(bk + j - 1);
          const int dg = h2[i - 1] + ((ac == bc && ac < 4) ? match : mismatch);
          const int up = h1[i - 1] + gap;
          const int left = h1[i] + gap;
          h = max(dg, max(up, left));
          mv = h == dg ? DIAG : (h == up ? UP : LEFT);
        }
        hc[i] = h;
        if (i == alen && j == blen) score[k] = h;
      }
      drow[i] = mv;
    }
    __syncthreads();
  }
}

template <int P>
int launch_reg(const uint8_t* a, const uint8_t* b, const int* alen,
               const int* blen, int B, int L, int match, int mismatch,
               int gap, int warps, int pairs, int* score, uint8_t* dirs,
               cudaStream_t st) {
  const int threads = 32 * warps * pairs;
  if (threads > NW_REG_THREADS(P) || 32 * P * warps < L + 1 ||
      (warps > 1 && pairs > 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)pairs * ((L + 2 * PAD + 3) & ~3) +
                      (size_t)pairs * 2 * warps * sizeof(int);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_reg_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + pairs - 1) / pairs;
  nw_reg_kernel<P><<<blocks, threads, smem, st>>>(
      a, b, alen, blen, B, L, match, mismatch, gap, warps, score, dirs);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b [B, L] u8 codes; alen, blen [B] i32; score [B] i32 and dirs
// [B, 2L + 1, L + 1] u8 out.  P > 0: the register instance with P rows a
// lane (one of ops/swdp.py NW_PS), `warps` warps a pair and `pairs` pairs
// a block.  P == 0: the wide instance; in_smem: its three diagonals in
// shared memory (3 (L + 1) ints must fit), else in scratch [B, 3, L + 1]
// i32.
extern "C" int nwglobal_align(const uint8_t* a, const uint8_t* b,
                              const int* alen, const int* blen, int B, int L,
                              int match, int mismatch, int gap, int P,
                              int warps, int pairs, int in_smem, int* scratch,
                              int* score, uint8_t* dirs, void* stream) {
  if (B <= 0 || L < 1 || P < 0 || (P > 0 && (warps < 1 || pairs < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (P) {
#define NW_REG(p)                                                          \
  case p:                                                                  \
    return launch_reg<p>(a, b, alen, blen, B, L, match, mismatch, gap,     \
                         warps, pairs, score, dirs, st);
    NW_REG(1) NW_REG(2) NW_REG(3) NW_REG(4) NW_REG(6) NW_REG(8) NW_REG(10)
    NW_REG(12) NW_REG(14) NW_REG(17) NW_REG(20) NW_REG(24) NW_REG(28)
    NW_REG(32)
#undef NW_REG
    case 0:
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = in_smem ? (size_t)3 * (L + 1) * sizeof(int) : 0;
  if (smem > SMEM_MAX || (!in_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nw_wide_kernel<<<B, THREADS, smem, st>>>(a, b, alen, blen, L, match,
                                           mismatch, gap, in_smem, scratch,
                                           score, dirs);
  return (int)cudaGetLastError();
}
