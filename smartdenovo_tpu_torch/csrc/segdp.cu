// Segment-parallel consensus DP with traceback, for Hopper.
//
// Replaces smartdenovo_tpu/ops/segdp.py:47 seg_align_tb, which is
// `jax.jit` over `lax.scan` (not a Pallas kernel): an affine banded DP
// (kswx_refine_alignment's recurrence, semiglobal in b) of a SEGR-row read
// segment against an LBW-column consensus window along a W-lane band, then
// the kswx traceback state machine packed into 2-bit moves.
//
// What bounds it on the H100.  The rows of a segment are a dependent chain
// and each row is W cells of at least ~12 int32 operations, so the least
// time is the cells of a call over the card's int32 rate: at Bc = 1024,
// SEGR 2048, W 256, chip_smoke.py's synthetic segments hold 2.66e8 cells,
// 0.19 ms at 16.7 T int32 op/s (132 SMs x 64 lanes x 1.98 GHz); its bytes
// are a few MB.  The block-per-segment kernel it replaces took 3.4 ms
// there: two block barriers every row, 1024 blocks of 256 threads in two
// waves, and a one-thread traceback whose every step waited on HBM.
//
// Design.  One warp per segment, 8 segments a block, every segment of a
// call resident at once (Bc = 1024 is one wave of 128 blocks).  Lane l
// owns the P = W/32 consecutive band lanes k = P l .. P l + P - 1 and keeps
// their H and E values and window codes in registers.  Per row:
//   - a band step base[i] - base[i-1] of 0 or 1 (the common case) shifts
//     H, E and the codes through registers and one shuffle; a larger step
//     reads the previous row from a warp-private, double-buffered shared
//     buffer that holds band lane k at (k % P) * 32 + k / P, so each of the
//     P reads touches 32 consecutive words (no bank conflicts);
//   - the F lane, s_k = max_{k'<=k} v_k' + ext (k - k'), is a max-scan of
//     v_k - ext k: thread-serial over the lane's P cells, then one warp
//     shuffle scan of the 32 lane totals;
//   - the direction bits are the signs of four differences per cell,
//     gathered four cells a word with prmt; a row whose band lies inside
//     the window skips the per-cell masking;
//   - each lane stores its P direction bytes at once, so a row of `dirs`
//     is one coalesced W-byte store; there is no block barrier anywhere.
// What holds it at ~8x its bound is each row's dependent chain (the warp
// shuffle scan of the F lane among it) with only 2 warps per SM
// sub-partition to hide it: ~26 instructions a cell, and a packed 16-bit
// form of the same row was no faster.  The same warp then takes the
// first-maximum end lane (lane tie-break) and walks the traceback: lane 0
// runs the state machine out of a shared ring of RING `dirs` rows that
// the whole warp refills with cp.async one chunk ahead of the walk (the
// path's row index only falls), so each step reads shared memory, not HBM.
//
// Integer semantics are the JAX version's: NEG = -10000 is a number, not
// minus infinity (sums of it decide direction bits); the band base
// interpolation floors negative numerators; every sum is int32.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -10000;
constexpr int MV_M = 0, MV_I = 1, MV_D = 2, MV_NONE = 3;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;          // segments per block at most
constexpr int RING = 32;              // `dirs` rows per traceback chunk
constexpr size_t SMEM_MAX = 232448;   // shared memory a block can use

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Shared memory of one warp: the band bases, then a region that holds the
// DP's buffers (H and E, two rows each, the read and window codes) and,
// once the DP is done, the traceback ring.
__host__ __device__ inline size_t base_bytes(int SEGR) {
  return align16(sizeof(int) * (size_t)(SEGR + 1));
}
__host__ __device__ inline size_t warp_bytes(int SEGR, int LBW, int W) {
  const size_t dp = 16 * (size_t)W + align16(SEGR) + align16(LBW);
  const size_t tb = 2 * (size_t)RING * W;
  return base_bytes(SEGR) + (dp > tb ? dp : tb);
}

// floor(x / 16) for any sign: C++ division truncates toward zero
__device__ __forceinline__ int floordiv16(int x) {
  const int q = x / 16;
  return (x % 16 < 0) ? q - 1 : q;
}

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(FULL, v, s);
    if (lane >= s) v = max(v, u);
  }
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The warp copies n codes, mapping every code >= 4 to `pad`; with pads of
// 6 for the read and 7 for the window, a substitution is one compare:
// (a == b) exactly when both are bases and equal.
__device__ void warp_copy_codes(uint8_t* dst, const uint8_t* src, int n,
                                unsigned pad, int lane) {
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0 && (n & 15) == 0) {
    const unsigned pad4 = pad * 0x01010101u;
    for (int k = lane * 16; k < n; k += 32 * 16) {
      uint4 w = *reinterpret_cast<const uint4*>(src + k);
      unsigned* c = reinterpret_cast<unsigned*>(&w);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned base = __vcmpltu4(c[u], 0x04040404u);  // 0xff: a base
        c[u] = (c[u] & base) | (pad4 & ~base);
      }
      *reinterpret_cast<uint4*>(dst + k) = w;
    }
  } else {
    for (int k = lane; k < n; k += 32) dst[k] = src[k] < 4 ? src[k] : pad;
  }
}

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// 0xff in byte n where the n-th argument is negative: prmt's sign mode
// replicates the top bit of byte 3 (selector 0xb) or byte 7 (0xf)
__device__ __forceinline__ unsigned signs4(int a, int b, int c, int d) {
  return prmt(prmt(a, b, 0xfb), prmt(c, d, 0xfb), 0x5410);
}

// The direction byte of a cell from the signs of four differences:
// m - e < 0 (E beats M), h - f < 0 (F beats max(M, E)), open - ext < 0
// (E extends), f1 - f < 0 (F extends): bits 0-1 are 2 when F wins, else 1
// when E wins; bit 2 E's, bit 5 F's extension.  s0..s3 hold these signs
// as 0xff bytes, four cells a word.
__device__ __forceinline__ unsigned dir_bytes(unsigned s0, unsigned s1,
                                              unsigned s2, unsigned s3) {
  return (s0 & ~s1 & 0x01010101u) | (s1 & 0x02020202u) |
         (s2 & 0x04040404u) | (s3 & 0x20202020u);
}

// One row's cells of a lane's P band lanes k = P lane + q: H, E and the
// direction bytes, given the diagonal hd and vertical e of each cell.
// ALL_OK: every band lane of the row lies inside the window (1 <= j <=
// blen), so no cell is masked to NEG.
template <int P, bool ALL_OK>
__device__ __forceinline__ void row_cells(const int (&hd)[P], const int (&e)[P],
                                          const int (&BC)[P], int (&H)[P],
                                          int (&E)[P], uint8_t* dst, int lane,
                                          int bs, int jmax, int ac, int match,
                                          int mismatch, int od, int oi,
                                          int ext) {
  int m[P], v[P], x[P];
  bool ok[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int k = lane * P + q;
    ok[q] = ALL_OK || (unsigned)(bs + k - 1) < (unsigned)jmax;
    const int sub = ac == BC[q] ? match : mismatch;
    m[q] = ok[q] ? hd[q] + sub : NEG;
    v[q] = m[q] + od;
    x[q] = v[q] - ext * k;
  }
  // F lane: exclusive max-scan of x over the band lanes
  int pre[P];
  pre[0] = INT_MIN;
#pragma unroll
  for (int q = 1; q < P; ++q) pre[q] = max(pre[q - 1], x[q - 1]);
  int lex = __shfl_up_sync(FULL, warp_incl_max(max(pre[P - 1], x[P - 1]),
                                               lane), 1);
  const int vlast = __shfl_up_sync(FULL, v[P - 1], 1);  // v of lane k - 1
  if (lane == 0) lex = INT_MIN;
  int t0[P], t1[P], t2[P], t3[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int k = lane * P + q;
    const int f = (k == 0) ? NEG : max(lex, pre[q]) + ext * (k - 1);
    const int f1 = (k == 0) ? NEG : (q == 0 ? vlast : v[q - 1]);
    const int h = max(m[q], e[q]);
    const int h2 = max(h, f);
    const int eo = m[q] + oi, ee = e[q] + ext;
    E[q] = max(eo, ee);
    H[q] = ok[q] ? h2 : NEG;
    t0[q] = m[q] - e[q];
    t1[q] = h - f;
    t2[q] = eo - ee;
    t3[q] = f1 - f;
  }
  if constexpr (P >= 4) {
    unsigned w[P / 4];
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      const int q = 4 * g;
      w[g] = dir_bytes(signs4(t0[q], t0[q + 1], t0[q + 2], t0[q + 3]),
                       signs4(t1[q], t1[q + 1], t1[q + 2], t1[q + 3]),
                       signs4(t2[q], t2[q + 1], t2[q + 2], t2[q + 3]),
                       signs4(t3[q], t3[q + 1], t3[q + 2], t3[q + 3]));
    }
    if constexpr (P == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<unsigned*>(dst) = w[0];
  } else {
    const unsigned w = dir_bytes(signs4(t0[0], t0[P - 1], 0, 0),
                                 signs4(t1[0], t1[P - 1], 0, 0),
                                 signs4(t2[0], t2[P - 1], 0, 0),
                                 signs4(t3[0], t3[P - 1], 0, 0));
    if constexpr (P == 2)
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)w;
    else
      dst[0] = (uint8_t)w;
  }
}

// P band lanes per thread, W = 32 P; one warp per segment
template <int P, int LOGP>
__global__ void __launch_bounds__(MAX_WARPS * 32)
segdp_warp(const uint8_t* __restrict__ seg_a, const uint8_t* __restrict__ seg_b,
           const int* __restrict__ seg_alen, const int* __restrict__ seg_blen,
           const int16_t* __restrict__ seg_b16, int SEGR, int LBW, int NB,
           int T, int match, int mismatch, int open_i, int open_d, int ext,
           uint8_t* __restrict__ dirs, int* score, int* b_beg, int* b_end,
           uint8_t* mvp, int Bc) {
  constexpr int W = 32 * P;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int seg = blockIdx.x * (blockDim.x >> 5) + wid;
  if (seg >= Bc) return;  // the whole warp: nothing below syncs the block
  uint8_t* mine = smem + (size_t)wid * warp_bytes(SEGR, LBW, W);
  int* base = reinterpret_cast<int*>(mine);
  uint8_t* region = mine + base_bytes(SEGR);
  int* Hs = reinterpret_cast<int*>(region);  // [2][W], band lane k at
                                             // (k % P) * 32 + k / P
  int* Es = Hs + 2 * W;                      // [2][W]
  uint8_t* a_s = reinterpret_cast<uint8_t*>(Es + 2 * W);  // [SEGR]
  uint8_t* b_s = a_s + align16(SEGR);                     // [LBW]
  uint8_t* ring = region;  // [2][RING][W] after the DP

  const int alen = min(max(seg_alen[seg], 0), SEGR);
  const int blen = seg_blen[seg];
  warp_copy_codes(a_s, seg_a + (size_t)seg * SEGR, SEGR, 6, lane);
  warp_copy_codes(b_s, seg_b + (size_t)seg * LBW, LBW, 7, lane);

  // ---- per-row band base: interpolate, clip, running max ----
  {
    const int16_t* b16 = seg_b16 + (size_t)seg * NB;
    const int hiclip = max(blen - 1, 0);
    const int C = (SEGR + 1 + 31) / 32;
    const int k0 = min(lane * C, SEGR + 1), k1 = min(k0 + C, SEGR + 1);
    int run = INT_MIN;
    for (int k = k0; k < k1; ++k) {
      const int ki = k >> 4, kf = k & 15;
      const int lo = b16[ki], hi = b16[min(ki + 1, NB - 1)];
      int v = lo + floordiv16((hi - lo) * kf);
      v = min(max(v, 0), hiclip);
      run = max(run, v);
      base[k] = run;
    }
    const int inc = warp_incl_max(run, lane);
    int exc = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) exc = INT_MIN;
    for (int k = k0; k < k1; ++k) base[k] = max(base[k], exc);
  }
  __syncwarp();

  // Row 0: semiglobal in b, H = 0 across the band.  H, E and the window
  // codes BC of the lane's band lanes stay in registers from row to row;
  // a band step of 0 or 1 shifts them by shuffles, a larger one goes
  // through the shared buffer (written by the row before) and reloads BC.
  const int jmax = max(blen, 0);
  int H[P], E[P], BC[P];
  int bprev = base[0];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int k = lane * P + q;
    const int j = bprev + k;
    H[q] = (j >= 0 && j <= blen) ? 0 : NEG;
    E[q] = NEG;
    BC[q] = b_s[min(max(j - 1, 0), LBW - 1)];
  }
  auto spill = [&](int buf) {  // this row's H and E, for a step >= 2
#pragma unroll
    for (int q = 0; q < P; ++q) {
      Hs[buf * W + (q << 5) + lane] = H[q];
      Es[buf * W + (q << 5) + lane] = E[q];
    }
    __syncwarp();
  };
  int bnext = alen >= 1 ? base[1] : bprev;
  if (bnext - bprev >= 2) spill(0);

  uint8_t* drow = dirs + (size_t)seg * SEGR * W;
  const int od = open_d + ext, oi = open_i + ext;
  for (int i = 1; i <= alen; ++i) {
    const int bs = bnext;
    const int sh = bs - bprev;  // >= 0: the bases are monotone
    bprev = bs;
    bnext = i < alen ? base[i + 1] : bs;
    const int ac = a_s[i - 1];
    int hd[P], e[P];  // the diagonal and the vertical of each band lane
    if (sh == 0) {
      int up = __shfl_up_sync(FULL, H[P - 1], 1);
      if (lane == 0) up = NEG;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        hd[q] = q ? H[q - 1] : up;
        e[q] = E[q];
      }
    } else if (sh == 1) {
      int dn = __shfl_down_sync(FULL, E[0], 1);
      int bd = __shfl_down_sync(FULL, BC[0], 1);
      if (lane == 31) {
        dn = NEG;
        bd = b_s[min(max(bs + W - 2, 0), LBW - 1)];
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        hd[q] = H[q];
        e[q] = q < P - 1 ? E[q + 1] : dn;
        BC[q] = q < P - 1 ? BC[q + 1] : bd;
      }
    } else {
      const int* Hp = Hs + ((i - 1) & 1) * W;
      const int* Ep = Es + ((i - 1) & 1) * W;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int k = lane * P + q;
        const int kd = k + sh - 1, ku = k + sh;  // >= 1 here
        hd[q] = kd < W ? Hp[((kd & (P - 1)) << 5) + (kd >> LOGP)] : NEG;
        e[q] = ku < W ? Ep[((ku & (P - 1)) << 5) + (ku >> LOGP)] : NEG;
        BC[q] = b_s[min(max(bs + k - 1, 0), LBW - 1)];
      }
    }
    uint8_t* dst = drow + (size_t)(i - 1) * W + lane * P;
    if (bs >= 1 && bs + W - 1 <= blen)
      row_cells<P, true>(hd, e, BC, H, E, dst, lane, bs, jmax, ac, match,
                         mismatch, od, oi, ext);
    else
      row_cells<P, false>(hd, e, BC, H, E, dst, lane, bs, jmax, ac, match,
                          mismatch, od, oi, ext);
    if (bnext - bs >= 2) spill(i & 1);
  }

  // ---- best end lane in the last row: first maximum ----
  const int last_base = base[alen];
  int bv = INT_MIN, bi = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int col = last_base + lane * P + q;
    const int hv = (col >= 0 && col <= blen) ? H[q] : NEG;
    if (hv > bv) {
      bv = hv;
      bi = lane * P + q;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int ov = __shfl_down_sync(FULL, bv, s);
    const int oi = __shfl_down_sync(FULL, bi, s);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int best = __shfl_sync(FULL, bv, 0);
  const int end_col = last_base + __shfl_sync(FULL, bi, 0);

  // ---- traceback: kswx state machine, semiglobal stop at row 0 ----
  // `dirs` rows [lo_c, hi_c) of chunk c sit in ring buffer c & 1, with
  // hi_c = alen - c RING; chunk c + 1 is in flight while lane 0 walks c.
  __threadfence();  // the DP's `dirs` stores before the warp's copies
  __syncwarp();     // and every lane is done with the DP's buffers
  auto prefetch = [&](int c) {
    const int hi = max(alen - c * RING, 0), lo = max(hi - RING, 0);
    const int n = (hi - lo) * W;
    const uint8_t* src = drow + (size_t)lo * W;
    uint8_t* dst = ring + (c & 1) * RING * W;
    for (int k = lane * 16; k < n; k += 32 * 16) cp_async16(dst + k, src + k);
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);
  const int Tp = T / 4;
  int i = alen, j = end_col, state = MV_M, s = 0, u = 0;
  unsigned mv4 = 0;
  bool done = i <= 0;
  // base[i] and base[i - 1] ride in registers: i falls by at most one a
  // step, so the load of the next base is off the walk's chain
  int bcur = base[min(max(i, 0), SEGR)], bdown = base[max(i - 1, 0)];
  for (int c = 0;; ++c) {
    cp_async_wait1();  // chunk c has landed (c + 1 may be in flight)
    __syncwarp();
    bool fin = false;
    if (lane == 0) {
      const int lo = max(alen - (c + 1) * RING, 0);
      const uint8_t* rc = ring + (c & 1) * RING * W;
      while (s < Tp) {
        if (!done && i - 1 < lo) break;  // the next chunk's row
        const int ln = j - bcur;
        const bool inband = ln >= 0 && ln < W;
        const int z = (inband && !done) ? rc[(i - 1 - lo) * W + ln] : 0;
        int mv = (z >> (2 * state)) & 3;
        if (j <= 0) mv = MV_I;
        if (i <= 0 || done) mv = MV_NONE;
        if (mv == MV_M || mv == MV_I) {
          --i;
          bcur = bdown;
          bdown = base[max(i - 1, 0)];
        }
        j -= (mv == MV_M || mv == MV_D);
        if (mv != MV_NONE) state = mv;
        done = done || i <= 0;
        mv4 |= (unsigned)mv << (2 * u);
        if (++u == 4) {
          mvp[(size_t)s * Bc + seg] = (uint8_t)mv4;
          ++s;
          u = 0;
          mv4 = 0;
          if (done) break;  // every later byte is all MV_NONE
        }
      }
      fin = s >= Tp || (done && u == 0);
    }
    if (__shfl_sync(FULL, fin, 0)) break;
    prefetch(c + 2);  // into the buffer lane 0 has left
  }
  s = __shfl_sync(FULL, s, 0);
  for (int k = s + lane; k < Tp; k += 32) mvp[(size_t)k * Bc + seg] = 0xFF;
  if (lane == 0) {
    score[seg] = best;
    b_beg[seg] = max(j, 0);
    b_end[seg] = end_col;
  }
}

template <int P, int LOGP>
int launch(const uint8_t* seg_a, const uint8_t* seg_b, const int* seg_alen,
           const int* seg_blen, const int16_t* seg_b16, int Bc, int SEGR,
           int LBW, int NB, int T, int match, int mismatch, int open_i,
           int open_d, int ext, uint8_t* dirs, int* score, int* b_beg,
           int* b_end, uint8_t* mvp, cudaStream_t st) {
  const size_t per = warp_bytes(SEGR, LBW, 32 * P);
  const int wpb = (int)(SMEM_MAX / per < MAX_WARPS ? SMEM_MAX / per : MAX_WARPS);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = per * wpb;
  cudaError_t err = cudaFuncSetAttribute(
      segdp_warp<P, LOGP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Bc + wpb - 1) / wpb;
  segdp_warp<P, LOGP><<<blocks, wpb * 32, smem, st>>>(
      seg_a, seg_b, seg_alen, seg_blen, seg_b16, SEGR, LBW, NB, T, match,
      mismatch, open_i, open_d, ext, dirs, score, b_beg, b_end, mvp, Bc);
  return (int)cudaGetLastError();
}

template <int P, int LOGP>
int occupancy(int SEGR, int LBW, int* wpb, int* blocks_per_sm) {
  const size_t per = warp_bytes(SEGR, LBW, 32 * P);
  *wpb = (int)(SMEM_MAX / per < MAX_WARPS ? SMEM_MAX / per : MAX_WARPS);
  if (*wpb < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      segdp_warp<P, LOGP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(per * *wpb));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, segdp_warp<P, LOGP>, *wpb * 32, per * *wpb);
}

}  // namespace

// W must be 32, 64, 128 or 256 (the wrapper checks)
extern "C" int segdp_align_tb(const uint8_t* seg_a, const uint8_t* seg_b,
                              const int* seg_alen, const int* seg_blen,
                              const int16_t* seg_b16, int Bc, int SEGR,
                              int LBW, int NB, int W, int T, int match,
                              int mismatch, int open_i, int open_d, int ext,
                              uint8_t* dirs, int* score, int* b_beg,
                              int* b_end, uint8_t* mvp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SEGDP_ARGS                                                          \
  seg_a, seg_b, seg_alen, seg_blen, seg_b16, Bc, SEGR, LBW, NB, T, match, \
      mismatch, open_i, open_d, ext, dirs, score, b_beg, b_end, mvp, st
  switch (W) {
    case 32: return launch<1, 0>(SEGDP_ARGS);
    case 64: return launch<2, 1>(SEGDP_ARGS);
    case 128: return launch<4, 2>(SEGDP_ARGS);
    case 256: return launch<8, 3>(SEGDP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEGDP_ARGS
}

// Segments a block holds and blocks an SM can hold at these widths: a
// call of Bc segments is one wave when Bc <= wpb * blocks_per_sm * SMs.
extern "C" int segdp_occupancy(int SEGR, int LBW, int W, int* wpb,
                               int* blocks_per_sm) {
  switch (W) {
    case 32: return occupancy<1, 0>(SEGR, LBW, wpb, blocks_per_sm);
    case 64: return occupancy<2, 1>(SEGR, LBW, wpb, blocks_per_sm);
    case 128: return occupancy<4, 2>(SEGR, LBW, wpb, blocks_per_sm);
    case 256: return occupancy<8, 3>(SEGR, LBW, wpb, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
