// Segment-parallel consensus DP with traceback, for Hopper.
//
// Replaces smartdenovo_tpu/ops/segdp.py:47 seg_align_tb, which is
// `jax.jit` over `lax.scan` (not a Pallas kernel): an affine banded DP
// (kswx_refine_alignment's recurrence, semiglobal in b) of a SEGR-row read
// segment against an LBW-column consensus window along a W-lane band, then
// the kswx traceback state machine packed into 2-bit moves.
//
// Design.  One block per segment, one thread per band lane (blockDim = W).
// The segment's read rows, its consensus window and its per-row band base
// (SEGR + 1 ints, upsampled from the stride-16 samples and made monotone
// by a block max-scan) sit in shared memory, and so do the previous row's
// H and E lanes, double-buffered, so that a lane can read its neighbours
// shifted by base[i] - base[i-1].  Per row each thread computes its lane;
// the F lane (s_k = max_{k'<=k} v_k' + ext (k - k')) is one block max-scan
// of v_k - ext k; each thread writes one direction byte to the global
// `dirs` scratch [Bc, SEGR, W].  Then one thread walks `dirs` back from
// the best end lane and writes the packed moves.
//
// Bound: the two block barriers of every row (the row loop is serial in
// the segment), and the `dirs` write, SEGR * W bytes per segment (512 KiB
// at the main path's widths), which the traceback reads back from L2.
// Every sum is int32 exactly as in the JAX version (NEG = -10000 is a
// number, not minus infinity: sums of it decide direction bits).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -10000;
constexpr int MV_M = 0, MV_I = 1, MV_D = 2, MV_NONE = 3;
constexpr unsigned FULL = 0xffffffffu;

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

__global__ void segdp_kernel(const uint8_t* __restrict__ seg_a,
                             const uint8_t* __restrict__ seg_b,
                             const int* __restrict__ seg_alen,
                             const int* __restrict__ seg_blen,
                             const int16_t* __restrict__ seg_b16, int SEGR,
                             int LBW, int NB, int T, int match, int mismatch,
                             int open_i, int open_d, int ext,
                             uint8_t* __restrict__ dirs, int* score,
                             int* b_beg, int* b_end, uint8_t* mvp, int Bc) {
  extern __shared__ int smem[];
  const int W = blockDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarp = W >> 5;
  const int seg = blockIdx.x;
  int* base = smem;                    // [SEGR + 1]
  int* Hs = base + (SEGR + 1);         // [2][W]
  int* Es = Hs + 2 * W;                // [2][W]
  int* Ms = Es + 2 * W;                // [W]
  int* wt = Ms + W;                    // [32] warp totals
  int* wi = wt + 32;                   // [32] warp argmax lanes
  uint8_t* a_s = reinterpret_cast<uint8_t*>(wi + 32);  // [SEGR]
  uint8_t* b_s = a_s + SEGR;                           // [LBW]

  const int alen = min(max(seg_alen[seg], 0), SEGR);
  const int blen = seg_blen[seg];
  const uint8_t* ga = seg_a + (size_t)seg * SEGR;
  const uint8_t* gb = seg_b + (size_t)seg * LBW;
  for (int k = t; k < SEGR; k += W) a_s[k] = ga[k];
  for (int k = t; k < LBW; k += W) b_s[k] = gb[k];

  // ---- per-row band base: interpolate, clip, running max ----
  const int16_t* b16 = seg_b16 + (size_t)seg * NB;
  const int hiclip = max(blen - 1, 0);
  const int C = (SEGR + 1 + W - 1) / W;
  const int k0 = min(t * C, SEGR + 1), k1 = min(k0 + C, SEGR + 1);
  int run = INT_MIN;
  for (int k = k0; k < k1; ++k) {
    const int ki = k >> 4, kf = k & 15;
    const int lo = b16[ki], hi = b16[min(ki + 1, NB - 1)];
    int v = lo + floordiv16((hi - lo) * kf);
    v = min(max(v, 0), hiclip);
    run = max(run, v);
    base[k] = run;
  }
  {
    const int inc = warp_incl_max(run, lane);
    int exc = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) exc = INT_MIN;
    if (lane == 31) wt[warp] = inc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) exc = max(exc, wt[w]);
    for (int k = k0; k < k1; ++k) base[k] = max(base[k], exc);
  }
  // row 0: semiglobal in b, H = 0 across the band
  __syncthreads();
  {
    const int j = base[0] + t;
    Hs[t] = (j >= 0 && j <= blen) ? 0 : NEG;
    Es[t] = NEG;
  }
  int hold = Hs[t];
  __syncthreads();

  uint8_t* drow = dirs + (size_t)seg * SEGR * W;
  for (int i = 1; i <= alen; ++i) {
    const int p = (i - 1) & 1;
    const int* Hp = Hs + p * W;
    const int* Ep = Es + p * W;
    const int bs = base[i];
    const int j = bs + t;
    const int iu = t + (bs - base[i - 1]);
    const int idg = iu - 1;
    const int hdg = (idg >= 0 && idg < W) ? Hp[idg] : NEG;
    const int e = (iu >= 0 && iu < W) ? Ep[iu] : NEG;
    const int ac = a_s[i - 1];
    const int bc = b_s[min(max(j - 1, 0), LBW - 1)];
    const int sub = (ac == bc && ac < 4 && bc < 4) ? match : mismatch;
    const bool okj = j >= 1 && j <= blen;
    const int m = okj ? hdg + sub : NEG;
    const int v = m + open_d + ext;
    // exclusive max-scan of x_k = v_k - ext k over the lanes
    const int xs = warp_incl_max(v - ext * t, lane);
    int xprev = __shfl_up_sync(FULL, xs, 1);
    Ms[t] = v;
    if (lane == 31) wt[warp] = xs;
    __syncthreads();
    int pre = INT_MIN;
    for (int w = 0; w < warp; ++w) pre = max(pre, wt[w]);
    int f;
    if (t == 0) {
      f = NEG;
    } else {
      const int ex = (lane == 0) ? pre : max(pre, xprev);
      f = ex + ext * (t - 1);
    }
    const int f1 = (t == 0) ? NEG : Ms[t - 1];
    int d = (m >= e) ? 0 : 1;
    int h = max(m, e);
    if (f > h) d = 2;
    h = max(h, f);
    const int e_ext = e + ext;
    const int e_open = m + open_i + ext;
    if (e_ext > e_open) d |= 1 << 2;
    const int e_next = max(e_ext, e_open);
    if (f > f1) d |= 2 << 4;
    h = okj ? h : NEG;
    drow[(size_t)(i - 1) * W + t] = (uint8_t)d;
    Hs[(1 - p) * W + t] = h;
    Es[(1 - p) * W + t] = e_next;
    if (i == alen) hold = h;
    __syncthreads();
  }

  // ---- best end lane in the last row: first maximum ----
  const int last_base = base[alen];
  const int col = last_base + t;
  int bv = (col >= 0 && col <= blen) ? hold : NEG;
  int bi = t;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int ov = __shfl_down_sync(FULL, bv, s);
    const int oi = __shfl_down_sync(FULL, bi, s);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    wt[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (t != 0) return;
  int best = wt[0], lane_end = wi[0];
  for (int w = 1; w < nwarp; ++w) {
    if (wt[w] > best) {
      best = wt[w];
      lane_end = wi[w];
    }
  }
  const int end_col = last_base + lane_end;

  // ---- traceback: kswx state machine, semiglobal stop at row 0 ----
  int i = alen, j = end_col, state = MV_M;
  bool done = i <= 0;
  const int Tp = T / 4;
  for (int s = 0; s < Tp; ++s) {
    unsigned mv4 = 0;
    for (int u = 0; u < 4; ++u) {
      const int ic = min(max(i, 0), SEGR);
      const int ln = j - base[ic];
      const bool inband = ln >= 0 && ln < W;
      const int z = (inband && !done) ? drow[(size_t)(ic - 1) * W + ln] : 0;
      int mv = (z >> (2 * state)) & 3;
      if (j <= 0) mv = MV_I;
      if (i <= 0 || done) mv = MV_NONE;
      i -= (mv == MV_M || mv == MV_I);
      j -= (mv == MV_M || mv == MV_D);
      if (mv != MV_NONE) state = mv;
      done = done || i <= 0;
      mv4 |= (unsigned)mv << (2 * u);
    }
    mvp[(size_t)s * Bc + seg] = (uint8_t)mv4;
  }
  score[seg] = best;
  b_beg[seg] = max(j, 0);
  b_end[seg] = end_col;
}

}  // namespace

extern "C" int segdp_align_tb(const uint8_t* seg_a, const uint8_t* seg_b,
                              const int* seg_alen, const int* seg_blen,
                              const int16_t* seg_b16, int Bc, int SEGR,
                              int LBW, int NB, int W, int T, int match,
                              int mismatch, int open_i, int open_d, int ext,
                              uint8_t* dirs, int* score, int* b_beg,
                              int* b_end, uint8_t* mvp, void* stream) {
  const size_t smem = sizeof(int) * ((size_t)(SEGR + 1) + 5 * (size_t)W + 64) +
                      (size_t)SEGR + (size_t)LBW;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segdp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  segdp_kernel<<<Bc, W, smem, (cudaStream_t)stream>>>(
      seg_a, seg_b, seg_alen, seg_blen, seg_b16, SEGR, LBW, NB, T, match,
      mismatch, open_i, open_d, ext, dirs, score, b_beg, b_end, mvp, Bc);
  return (int)cudaGetLastError();
}
