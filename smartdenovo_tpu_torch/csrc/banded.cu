// Whole-read banded alignment with traceback, for Hopper.
//
// Replaces smartdenovo_tpu/ops/banded.py:33 banded_align and
// smartdenovo_tpu/ops/traceback.py:29 tb_banded_device, which are
// `jax.jit` over `lax.scan` (not Pallas): a linear-gap DP of a read
// (LA rows) against a consensus window along a W-lane band whose leftmost
// column per row is given (base, non-decreasing), semiglobal in b or
// global, then the walk of the direction plane back from (alen, end_col)
// into a move stream.  Only the moves, j_final, score and end_col (and,
// for wtext, each row's best cell) leave the kernel for the host; the
// plane stays in device memory.
//
// What bounds it on the H100.  A read's rows are a dependent chain: the
// time of a call is its longest read's rows times one row's time, plus its
// traceback's ~alen dependent steps.  With one warp on an SM sub-partition
// nothing hides a row's latency and the warp runs its instructions in
// order, so a row costs its chain (a shuffle, the lane's P add-maxes, the
// gap scan's shuffle rounds) plus most of its instruction count: on NVIDIA
// H100 80GB HBM3 at 700 W a row of W 256 takes ~680 cycles here, ~1,100
// with shared row buffers, per-cell code loads and per-cell compares
// (kernel_split.py).  The card's int32 rate bounds
// a call only when enough reads run at once to keep every sub-partition
// busy; at the consensus batch of 64 reads it can reach at most ~64 / 528
// of it.
//
// Design.  One warp a read, up to MAX_WARPS reads a block, one read on
// each SM before a second.  Lane l owns P = W / 32 consecutive band lanes
// and keeps their H and window codes in registers from row to row.  Rows
// go 32 to a chunk, two to a loop turn (the turn's two rows swap the
// roles of two register sets, so no row copies its state).  Per row:
//   - a band step base[i] - base[i-1] of 0 or 1 (nearly every row of a
//     read) takes H and the codes from registers and three shuffles and
//     selects on the step, with no branch; a larger step reads the
//     previous row from a double-buffered, bank-conflict-free shared
//     buffer that the row before wrote only because that step was coming;
//   - the next chunk's bases and read codes sit in registers, one row a
//     lane, loaded (coalesced) a chunk ahead and passed out by shuffles a
//     row ahead of use; the window code of the next row's new column loads
//     a row ahead, so no row waits on global memory;
//   - the substitution score is one prmt of the row's score table by the
//     code's byte selector (sub_sel), with no compare;
//   - the in-row gap lane is the recurrence S[c] = max(m[c], S[c-1] +
//     gap_b): one fused add-max (Hopper's DPX viaddmax) a cell along the
//     lane's P cells, then the carry from the lanes before, an exclusive
//     radix-4 shuffle scan of the lane totals in three rounds (warpdp.cuh
//     warp_carry), and one more add-max a cell;
//   - a "clean" row skips every mask: a warp vote at its chunk's start
//     found every H far enough above NEG_INF, and every row of the chunk
//     so far stepped by 0 or 1 inside the window, so no cell can be masked
//     or STOP; the other rows take the masked form;
//   - a row's direction bytes wait for the next row (Pending), which
//     stores them, one coalesced W-byte row, while its gap scan's
//     shuffles are in flight; with ROWMAX the row's first maximum is a
//     warp reduction, 32 rows stored at once.
// Rows past alen are skipped.  Then the warp walks the traceback out of a
// shared ring of `dirs` rows and their bases that it refills with
// cp.async a chunk ahead (warpdp.cuh walk): a walk step reads only shared
// memory (~131 cycles a step, ~240 for one lane that loads each base from
// global memory; kernel_split.py), and the warp writes the moves a block
// at a time.
//
// Integer semantics are the JAX version's: NEG_INF = -(1 << 28) is a
// number (sums of it decide direction bits), STOP is gated on s >
// NEG_INF / 2, DIAG wins ties over UP, LEFT only where the scan is
// strictly greater, the end lane and each row's best lane are the first
// maximum; every sum is int32 (the recurrence and the max-scan of the
// plain version give the same S: max-plus sums of the same terms).
#include "warpdp.cuh"

namespace {

using namespace warpdp;

constexpr int NEG_INF = -(1 << 28);
constexpr int STOP = 0, DIAG = 1, UP = 2, LEFT = 3;
// bit z set where a byte z leaves its row (DIAG, UP)
constexpr int DIAG_UP_BITS = (1 << DIAG) | (1 << UP);

// A window code as a byte selector of prmt (warpdp.cuh sub_sel): codes >=
// 4 of the window map to 7, whose byte of the row's score table is always
// the mismatch.
__device__ __forceinline__ int wsel(int c) { return sub_sel(c < 4 ? c : 7); }

// A row's direction bytes wait for the next row: its cells leave m (the
// best of DIAG and UP), the DIAG / UP byte of each cell packed four a word
// (dm) and a mask that keeps a cell's byte (keep: 0 for STOP); the next
// row's body turns them into bytes with the row's final H (LEFT where H >
// m) and stores them while its own gap scan's shuffles are in flight.
template <int P>
struct Pending {
  static constexpr int NW = (P + 3) / 4;
  int m[P];
  unsigned dm[NW], keep[NW];
  uint8_t* dst;
};

// Part `lv` (0 .. 5) of the pending row's bytes: the LEFT bits of a fifth
// of its cells, then the mask and the store (warp_carry's fill).
template <int P>
__device__ __forceinline__ void finish_part(const int (&H)[P], const Pending<P>& pd,
                                            unsigned (&wd)[Pending<P>::NW], int lv) {
#pragma unroll
  for (int q = 0; q < P; ++q)
    if (q * 5 / P == lv && H[q] > pd.m[q]) wd[q / 4] |= 3u << (8 * (q % 4));
  if (lv == 5) {
#pragma unroll
    for (int w = 0; w < Pending<P>::NW; ++w) wd[w] &= pd.keep[w];
    store_bytes<P>(pd.dst, wd);
  }
}

template <int P>
__device__ __forceinline__ void finish_row(const int (&H)[P], const Pending<P>& pd) {
  unsigned wd[Pending<P>::NW];
#pragma unroll
  for (int w = 0; w < Pending<P>::NW; ++w) wd[w] = pd.dm[w];
#pragma unroll
  for (int lv = 0; lv < 6; ++lv) finish_part<P>(H, pd, wd, lv);
}

// One row's cells of a lane's P band lanes k = P lane + q, given the
// previous row's H (Hp) above (up) and on the diagonal (dg) of each lane
// and the window codes as selectors of the row's score table (BC, tlo,
// thi).  Writes the row's H (Hn) and its pending bytes (pn), and stores
// the previous row's bytes (pp).  CLEAN: no cell of the row is masked or
// STOP (see the note above).  cq[q] = gap_b (P (lane - 1) + q + 1), plus
// NO_CARRY in lane 0; gPl = gap_b P lane; src: warp_carry's source lanes.
template <int P, bool CLEAN>
__device__ __forceinline__ void row_cells(const int (&up)[P], const int (&dg)[P],
                                          const int (&BC)[P], const int (&Hp)[P],
                                          int (&Hn)[P], const Pending<P>& pp,
                                          Pending<P>& pn, int lane, int i,
                                          int bs, int blen, unsigned tlo,
                                          unsigned thi, int gap_a, int gap_b,
                                          const int (&cq)[P], int gPl,
                                          const ScanSrc& src) {
  constexpr int NW = Pending<P>::NW;
  int S[P];  // the lane's own part of the in-row gap recurrence
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    pn.dm[w] = 0x02020202u;  // UP
    pn.keep[w] = ~0u;
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    bool isdiag;
    int mm = __vibmax_s32(dg[q] + prmt(tlo, thi, BC[q]), up[q] + gap_a, &isdiag);
    if (!CLEAN) {
      const int j = bs + lane * P + q;
      if (j == 0) {
        mm = gap_a * i;
        isdiag = false;
      }
      if (!(j >= 0 && j <= blen)) mm = NEG_INF;
    }
    pn.m[q] = mm;
    if (isdiag) pn.dm[q / 4] ^= 3u << (8 * (q % 4));  // UP -> DIAG
    S[q] = q ? __viaddmax_s32(S[q - 1], gap_b, mm) : mm;
  }
  // the previous row's bytes go out while the scan's shuffles are in flight
  unsigned wd[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) wd[w] = pp.dm[w];
  const int X = warp_carry(S[P - 1], gPl, src,
                           [&](int lv) { finish_part<P>(Hp, pp, wd, lv); });
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int s = __viaddmax_s32(X, cq[q], S[q]);
    if (CLEAN) {
      Hn[q] = s;
    } else {
      const int j = bs + lane * P + q;
      const bool okj = j >= 0 && j <= blen;
      if (!(okj && s > NEG_INF / 2)) pn.keep[q / 4] &= ~(0xffu << (8 * (q % 4)));
      Hn[q] = okj ? s : NEG_INF;
    }
  }
}

// The first maximum of a row's H over the W band lanes (the masked lanes
// hold NEG_INF) and its band lane, in every lane.
template <int P>
__device__ __forceinline__ void row_best(const int (&H)[P], int lane, int& bv,
                                         int& bk) {
  int v = H[0], kq = 0;
#pragma unroll
  for (int q = 1; q < P; ++q)
    if (H[q] > v) {
      v = H[q];
      kq = q;
    }
  bv = __reduce_max_sync(FULL, v);
  const int src = __ffs(__ballot_sync(FULL, v == bv)) - 1;
  bk = __shfl_sync(FULL, lane * P + kq, src);
}

template <int P, bool ROWMAX>
__global__ void __launch_bounds__(MAX_WARPS * 32)
banded_warp(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bw,
            const int* __restrict__ alen_, const int* __restrict__ blen_,
            const int* __restrict__ base_, int B, int LA, int LB, int T,
            int match, int mismatch, int gap_a, int gap_b, int semi,
            uint8_t* __restrict__ dirs, int* score_, int* end_col_,
            int8_t* __restrict__ mvs, int* j_final_, int* rmax_, int* rcol_) {
  constexpr int W = 32 * P;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + wid;
  if (r >= B) return;  // the whole warp: nothing below syncs the block
  uint8_t* mine = smem + (size_t)wid * warp_bytes(W, 8 * W);
  int* Hs = reinterpret_cast<int*>(mine);  // [2][W], band lane k at sw<P>(k)
  const int alen = min(max(alen_[r], 0), LA);
  const int blen = blen_[r];
  const uint8_t* a = A + (size_t)r * LA;
  const uint8_t* bw = Bw + (size_t)r * LB;
  const int* base = base_ + (size_t)r * (LA + 1);
  uint8_t* drow = dirs + (size_t)r * (LA + 1) * W;
  int* rmax = rmax_ + (size_t)r * (LA + 1);
  int* rcol = rcol_ + (size_t)r * (LA + 1);

  // the gap recurrence's per-cell constants
  int cq[P];
#pragma unroll
  for (int q = 0; q < P; ++q)
    cq[q] = gap_b * (P * (lane - 1) + q + 1) + (lane == 0 ? NO_CARRY : 0);
  const int gPl = gap_b * P * lane;
  const ScanSrc src = scan_sources(lane);
  // a clean row's guarantee: at its chunk's start every H was above thrK,
  // and every row of the chunk so far stepped by 0 or 1 inside the window,
  // which adds at least cmin to every cell's lower bound (costs are small
  // ints; larger ones never take the clean form)
  const int cmin = min(min(match, mismatch), min(gap_a, 0));
  const int thrK = cmin > -(1 << 20) ? NEG_INF / 2 - 34 * cmin : INT_MAX;
  // the row's score table (sub_table) and the match byte
  const unsigned mis4 = 0x01010101u * (uint8_t)mismatch;

  // the window code of column j (b[j - 1], clamped), unmapped
  auto wraw = [&](int j) { return (int)bw[min(max(j - 1, 0), LB - 1)]; };
  // chunk ch (rows 32 ch + 1 .. 32 ch + 32): lane l holds the read code
  // of row 32 ch + l + 2 and the base of the row after that, the scalars
  // that row 32 ch + l + 1 fetches for the rows ahead of it
  auto stage = [&](int ch, int& sb, int& sa) {
    const int x = 32 * ch + lane + 2;
    sb = base[min(x + 1, LA)];
    sa = a[min(x, max(alen, 1)) - 1];
  };
  // ROWMAX: lane i % 32 keeps row i's best; rows 32 n .. 32 n + 31 go out
  // together once row 32 n + 31 (or the last row) is done
  int rm_v = 0, rm_c = 0;
  auto row_max = [&](const int (&H)[P], int i, int bs) {
    int bv, bk;
    row_best<P>(H, lane, bv, bk);
    if (lane == (i & 31)) {
      rm_v = bv;
      rm_c = bs + bk;
    }
    if ((i & 31) == 31 || i == alen) {
      const int i0 = i & ~31;
      if (lane <= (i & 31)) {
        rmax[i0 + lane] = rm_v;
        rcol[i0 + lane] = rm_c;
      }
    }
  };

  // ---- row 0: H and the window codes into registers; its bytes pend ----
  int H[P], H2[P], BC[P];
  Pending<P> pend, pend2;
  int bprev = base[0];
#pragma unroll
  for (int w = 0; w < Pending<P>::NW; ++w) {
    pend.dm[w] = 0x03030303u;  // LEFT
    pend.keep[w] = ~0u;
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = bprev + lane * P + q;
    const bool ok = j >= 0 && j <= blen;
    H[q] = ok ? (semi ? 0 : gap_b * j) : NEG_INF;
    BC[q] = wsel(wraw(j));
    pend.m[q] = INT_MAX;  // no LEFT bit from the final H
    if (semi || !ok || j == 0) pend.keep[q / 4] &= ~(0xffu << (8 * (q % 4)));
  }
  pend.dst = drow + lane * P;
  if constexpr (ROWMAX) row_max(H, 0, bprev);
  auto spill = [&](const int (&Hc)[P], int buf) {  // a row's H, for a step >= 2
    __syncwarp();
#pragma unroll
    for (int q = 0; q < P; ++q) Hs[buf * W + (q << 5) + lane] = Hc[q];
    __syncwarp();
  };

  // ---- rows 1 .. alen, 32 to a chunk ----
  // carried into row i: its base (b0) and the next row's (b1), its read
  // code (a0) and the window code of its new column for a step of 1 (c0),
  // each fetched at least a row before its first use
  int sb0, sa0, sb1, sa1;  // chunks 0 and 1
  stage(0, sb0, sa0);
  stage(1, sb1, sa1);
  int b0 = alen >= 1 ? base[1] : bprev, b1 = alen >= 2 ? base[2] : b0;
  int a0 = alen >= 1 ? a[0] : 4, c0 = wraw(b0 + W - 1);
  if (alen >= 1 && b0 - bprev >= 2) spill(H, 0);
  bool cl = false;  // this chunk's rows so far are clean
  // row i from Hi / pi into Ho / po
  auto row = [&](int i, int (&Hi)[P], Pending<P>& pi, int (&Ho)[P],
                 Pending<P>& po) {
    const int t = (i - 1) & 31, bs = b0, sh = bs - bprev, ac = a0;
    const int snew = wsel(c0);
    bprev = bs;
    // row i + 1's code and the base of row i + 2 from the stage, and the
    // new window code of row i + 1
    const int b2 = __shfl_sync(FULL, sb0, t);
    a0 = __shfl_sync(FULL, sa0, t);
    c0 = wraw(b1 + W - 1);
    b0 = b1;
    b1 = b2;
    int up[P], dg[P];  // the previous row's H above and on the diagonal
    if (sh <= 1) {
      const int lf0 = __shfl_up_sync(FULL, Hi[P - 1], 1);
      const int rt0 = __shfl_down_sync(FULL, Hi[0], 1);
      const int bd0 = __shfl_down_sync(FULL, BC[0], 1);
      const int lf = lane == 0 ? NEG_INF : lf0;
      const int rt = lane == 31 ? NEG_INF : rt0;
      const int bd = lane == 31 ? snew : bd0;
      const bool s1 = sh == 1;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int hu = q < P - 1 ? Hi[q + 1] : rt;
        const int hd = q ? Hi[q - 1] : lf;
        up[q] = s1 ? hu : Hi[q];
        dg[q] = s1 ? Hi[q] : hd;
        BC[q] = s1 ? (q < P - 1 ? BC[q + 1] : bd) : BC[q];
      }
    } else {
      const int* Hp = Hs + ((i - 1) & 1) * W;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int k = lane * P + q;
        const int ku = k + sh, kd = ku - 1;  // kd >= 1 here
        up[q] = ku < W ? Hp[sw<P>(ku)] : NEG_INF;
        dg[q] = kd < W ? Hp[sw<P>(kd)] : NEG_INF;
        BC[q] = wsel(wraw(bs + k));
      }
    }
    // the row's score table: byte c the score of window code c against
    // the read code (codes 4 .. 7 of the window never match)
    const unsigned tlo = ac < 4 ? (mis4 & ~(0xffu << (8 * ac))) |
                                      ((unsigned)(uint8_t)match << (8 * ac))
                                : mis4;
    po.dst = drow + (size_t)i * W + lane * P;
    cl = cl && sh <= 1 && bs >= 1 && bs + W - 1 <= blen;
    if (cl)
      row_cells<P, true>(up, dg, BC, Hi, Ho, pi, po, lane, i, bs, blen, tlo,
                         mis4, gap_a, gap_b, cq, gPl, src);
    else
      row_cells<P, false>(up, dg, BC, Hi, Ho, pi, po, lane, i, bs, blen, tlo,
                          mis4, gap_a, gap_b, cq, gPl, src);
    if constexpr (ROWMAX) row_max(Ho, i, bs);
    if (b0 - bs >= 2) spill(Ho, i & 1);
  };
  for (int i0 = 1; i0 <= alen; i0 += 32) {
    if (i0 > 1) {  // the next chunk of the stage
      sb0 = sb1;
      sa0 = sa1;
      stage((i0 - 1) / 32 + 1, sb1, sa1);
    }
    int hmin = H[0];
#pragma unroll
    for (int q = 1; q < P; ++q) hmin = min(hmin, H[q]);
    cl = __all_sync(FULL, hmin > thrK);
    const int n = min(32, alen - i0 + 1);
    for (int t = 0; t < n; t += 2) {  // two rows a turn: H and H2 swap roles
      row(i0 + t, H, pend, H2, pend2);
      if (t + 1 < n) {
        row(i0 + t + 1, H2, pend2, H, pend);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) H[q] = H2[q];
        pend = pend2;
      }
    }
  }
  finish_row<P>(H, pend);  // row alen's bytes
  if constexpr (ROWMAX) {  // rows past alen: every lane masked
    for (int i = alen + 1 + lane; i <= LA; i += 32) {
      rmax[i] = NEG_INF;
      rcol[i] = base[i];
    }
  }

  // ---- score and end column from row alen (bprev = base[alen]) ----
  int best, end_col;
  if (semi) {  // first maximum over the in-window lanes
    int hm[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int col = bprev + lane * P + q;
      hm[q] = (col >= 0 && col <= blen) ? H[q] : NEG_INF;
    }
    int bk;
    row_best<P>(hm, lane, best, bk);
    end_col = bprev + bk;
  } else {
    const int le = blen - bprev;
    int hv = NEG_INF;
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (lane * P + q == le) hv = H[q];
    best = (le >= 0 && le < W) ? __shfl_sync(FULL, hv, le / P) : NEG_INF;
    end_col = blen;
  }

  // ---- traceback: rows alen .. 0 through the shared ring ----
  // a byte of 0 (STOP or off the band) stops at row 0 and is UP above it;
  // the row and column moves come from bit tables indexed by the byte, so
  // the chain from the byte to the next address holds no compare
  auto step = [](int z, int i, int, int& di, int& dj) {
    const bool above = i > 0;
    di = ((DIAG_UP_BITS | (int)above) >> z) & 1;
    dj = z & 1;  // DIAG and LEFT
    return z == STOP && above ? UP : z;
  };
  const int jf = walk(mine, drow, base, alen + 1, W, T, B, r, mvs, 0, lane,
                      end_col, step);
  if (lane == 0) {
    score_[r] = best;
    end_col_[r] = end_col;
    j_final_[r] = jf;
  }
}

template <int P>
int launch(const uint8_t* a, const uint8_t* b, const int* alen,
           const int* blen, const int* base, int B, int LA, int LB, int T,
           int match, int mismatch, int gap_a, int gap_b, int semi,
           uint8_t* dirs, int* score, int* end_col, int8_t* mvs, int* j_final,
           int* rmax, int* rcol, cudaStream_t st) {
  constexpr int W = 32 * P;
  if (rmax)
    return launch_reads(banded_warp<P, true>, B, warp_bytes(W, 8 * W), st, a,
                        b, alen, blen, base, B, LA, LB, T, match, mismatch,
                        gap_a, gap_b, semi, dirs, score, end_col, mvs, j_final,
                        rmax, rcol);
  return launch_reads(banded_warp<P, false>, B, warp_bytes(W, 8 * W), st, a, b,
                      alen, blen, base, B, LA, LB, T, match, mismatch, gap_a,
                      gap_b, semi, dirs, score, end_col, mvs, j_final, rmax,
                      rcol);
}

}  // namespace

// W a multiple of 32 up to 256, LA >= 1, LB >= 1 (the wrapper checks).
// rmax and rcol ([B, LA + 1] each) are written when rmax is not null.
extern "C" int banded_align_tb(const uint8_t* a, const uint8_t* b,
                               const int* alen, const int* blen,
                               const int* base, int B, int LA, int LB, int W,
                               int T, int match, int mismatch, int gap_a,
                               int gap_b, int semi, uint8_t* dirs, int* score,
                               int* end_col, int8_t* mvs, int* j_final,
                               int* rmax, int* rcol, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define BANDED_ARGS                                                           \
  a, b, alen, blen, base, B, LA, LB, T, match, mismatch, gap_a, gap_b, semi, \
      dirs, score, end_col, mvs, j_final, rmax, rcol, st
  switch (W) {
    case 32: return launch<1>(BANDED_ARGS);
    case 64: return launch<2>(BANDED_ARGS);
    case 96: return launch<3>(BANDED_ARGS);
    case 128: return launch<4>(BANDED_ARGS);
    case 160: return launch<5>(BANDED_ARGS);
    case 192: return launch<6>(BANDED_ARGS);
    case 224: return launch<7>(BANDED_ARGS);
    case 256: return launch<8>(BANDED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BANDED_ARGS
}
