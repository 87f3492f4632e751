// CIGAR-guided refine alignment with traceback, for Hopper: one kernel
// template, two cost models.
//
// Replaces smartdenovo_tpu/ops/refine.py:49 refine_banded_affine (the
// affine costs: match / mismatch, open_i, open_d, ext), :refine5q.py:47
// refine5q_banded (the quality-aware costs from five per-base tracks,
// negated) and their shared traceback smartdenovo_tpu/ops/traceback.py:58
// tb_refine_device, all `jax.jit` over `lax.scan` (not Pallas): a global
// affine DP from (0, 0) to (alen, blen) inside a W-lane band around a
// prior CIGAR path (kswx_refine_alignment's recurrences, kswx.h:602-631;
// the 5q variant kswx.h:871-1075), then the kswx two-bit state machine
// walked back from (alen, blen) into a move stream.
//
// What bounds it on the H100: as banded.cu, each read's rows are a
// dependent chain, so the time is the longest read's rows times one row's
// time plus its traceback's dependent steps; with one warp on an SM
// sub-partition a row costs its chain (the F scan's shuffle rounds among
// it) plus most of its instruction count (on NVIDIA H100 80GB HBM3 at 700
// W, ~620 cycles a row of W 128 affine and ~670 in the 5q model, ~720
// and ~850 with shared row buffers and per-cell loads; kernel_split.py).
// The int32 rate bounds it only when enough reads run at once to fill the
// SM sub-partitions.
//
// Design: banded.cu's.  One warp a read, up to MAX_WARPS reads a block;
// lane l owns P = W / 32 band lanes.  For W <= 512 (P <= REG_MAX_P) H, E
// and the window codes stay in registers from row to row: a band step of
// 0 or 1 takes them from registers, three shuffles and selects on the
// step, a larger one reads the previous row from double-buffered,
// bank-conflict-free shared buffers that the row before wrote because
// that step was coming.  The widest tier (W 1024, which band_tier picks
// only around long indels) keeps the shared form: every row goes through
// the buffers (16 W bytes) and nothing of a row stays in registers from
// row to row; even so P = 32 takes 255 registers and a 16-byte stack in
// the 5q model (ptxas), where P = 16 takes 229 and none.  Rows go 32 to
// a chunk: the next chunk's bases, read codes and (5q) row costs sit in
// registers, one row a lane, loaded a chunk ahead and passed out by
// shuffles a row ahead of use; the one new window code of a step of 1
// loads a row ahead.  The affine substitution is one prmt of the row's
// score table (banded.cu's).  The F lane, F[c] = max(v[c-1], F[c-1] + x)
// with x the extension, is one fused add-max (DPX viaddmax) a cell along
// the lane, then the carry of the lanes before from a three-round shuffle
// scan (warpdp.cuh warp_carry), whose shuffles overlap the direction bits and
// the next row's E that do not wait on F; a row inside the window skips
// the per-cell masking; direction bytes go out a coalesced row at a time;
// the warp walks the traceback out of the shared ring of `dirs` rows and
// bases (warpdp.cuh walk).
//
// Integer semantics are the JAX versions': NEG is a number (-10000 affine,
// -(1 << 24) 5q); m beats E on ties, F only where strictly greater; E's
// extension bit on >, F's on f > f1 (the one-step open); affine
// substitutions need both codes < 4, 5q compares raw codes with no guard;
// 5q's column 0 is a clip entry h = -i qclp with direction byte 1.
#include "warpdp.cuh"

namespace {

using namespace warpdp;

constexpr int REG_MAX_P = 16;  // widest band (32 P lanes) held in registers

struct Costs {
  int match, mismatch, open_i, open_d, ext;  // affine
  int qclp, qmis, qdel, qext;                // 5q
};

struct Tracks {
  const int *subqv, *insqv, *delqv, *subtag, *deltag;  // [B, LA] each
};

// the per-row scalars: the row's base and read code, and the 5q costs
// (the read's SubTag and SubQV at row i - 1; InsQV, DelQV and DelTag at
// row i, or the clip cost on the last row)
struct RowQ {
  int b, qb, st, sq, iq, dq, dt;
};

template <bool Q5>
__device__ __forceinline__ RowQ shfl_row(const RowQ& s, int src) {
  RowQ q;
  q.b = __shfl_sync(FULL, s.b, src);
  q.qb = __shfl_sync(FULL, s.qb, src);
  if constexpr (Q5) {
    q.st = __shfl_sync(FULL, s.st, src);
    q.sq = __shfl_sync(FULL, s.sq, src);
    q.iq = __shfl_sync(FULL, s.iq, src);
    q.dq = __shfl_sync(FULL, s.dq, src);
    q.dt = __shfl_sync(FULL, s.dt, src);
  } else {
    q.st = q.sq = q.iq = q.dq = q.dt = 0;
  }
  return q;
}

// One row's cells of a lane's P band lanes k = P lane + q, given the
// previous row's H on the diagonal (hd) and E above (ev) and the window
// codes BC.  Writes H, E and the row's direction bytes.  ALL_OK: every
// band lane lies inside the window (1 <= j <= blen) and the row is not the
// last (the caller checks both).  The F lane is the recurrence F[c] =
// max(v[c-1], F[c-1] + x), one fused add-max (DPX viaddmax) a cell along
// the lane, then the lanes before it through warp_carry: cq[q] = x (P
// (lane - 1) + q), plus NO_CARRY in lane 0; xPl = x P lane; src:
// warp_carry's source lanes.
template <int P, bool Q5, bool ALL_OK>
__device__ __forceinline__ void row_cells(const int (&hd)[P], const int (&ev)[P],
                                          const int (&BC)[P], int (&H)[P],
                                          int (&E)[P], uint8_t* dst, int lane,
                                          int i, int bs, int blen, bool last,
                                          const RowQ& rq, const Costs& cs,
                                          int fext, int od, int oi,
                                          const int (&cq)[P], int xPl,
                                          unsigned tlo, unsigned thi,
                                          const ScanSrc& src) {
  constexpr int NEG = Q5 ? -(1 << 24) : -10000;
  int M[P], V[P], F[P];  // F: the lane's own part of the F recurrence
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = bs + lane * P + q;
    const bool okj = ALL_OK || (j >= 1 && j <= blen);
    const int bc = BC[q];
    if constexpr (Q5) {
      const int sub = bc == rq.qb ? 0 : (bc == rq.st ? rq.sq : cs.qmis);
      const int delc = (!ALL_OK && last) ? cs.qclp
                                         : (bc == rq.dt ? rq.dq : cs.qdel);
      M[q] = okj ? hd[q] - sub : NEG;
      V[q] = okj ? M[q] - delc : NEG;
    } else {
      M[q] = okj ? hd[q] + prmt(tlo, thi, bc) : NEG;
      V[q] = M[q] + od;
    }
    F[q] = q ? __viaddmax_s32(F[q - 1], fext, V[q - 1]) : NO_CARRY;
  }
  const int vlast = __shfl_up_sync(FULL, V[P - 1], 1);  // v of lane k - 1
  // the bits that do not wait on F (m against E, E's extension) and the
  // next row's E are worked out while the F scan's shuffles are in flight
  unsigned dq[P];
  int hme[P];
  const int X = warp_carry(__viaddmax_s32(F[P - 1], fext, V[P - 1]), xPl, src,
                           [&](int lv) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q * 5 / P != lv) continue;
      const int m = M[q], e = ev[q];
      dq[q] = m >= e ? 0 : 1;
      hme[q] = max(m, e);
      int eo, ee;
      if constexpr (Q5) {
        eo = m - rq.iq;
        ee = e - rq.iq;
      } else {
        eo = m + oi;
        ee = e + cs.ext;
      }
      if (ee > eo) dq[q] |= 4;
      E[q] = max(ee, eo);
    }
  });
  unsigned wd[(P + 3) / 4] = {};
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = bs + lane * P + q;
    int f = __viaddmax_s32(X, cq[q], F[q]);
    int f1 = q ? V[q - 1] : vlast;
    if (q == 0 && lane == 0) f = f1 = NEG;  // band lane 0: no F
    unsigned d = dq[q];
    if (f > hme[q]) d = (d & ~3u) | 2;
    int h = max(hme[q], f);
    if (f > f1) d |= 32;
    bool keep = ALL_OK || (j >= 1 && j <= blen);
    if constexpr (Q5 && !ALL_OK) {
      if (j == 0) {  // query-clip entry (reference h1 = i QCLP)
        h = -i * cs.qclp;
        d = 1;
        keep = true;
      }
    }
    H[q] = keep ? h : NEG;
    wd[q / 4] |= d << (8 * (q % 4));
  }
  store_bytes<P>(dst, wd);
}

template <int P, bool Q5>
__global__ void __launch_bounds__(MAX_WARPS * 32)
refine_warp(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bw,
            const int* __restrict__ alen_, const int* __restrict__ blen_,
            const int* __restrict__ base_, Tracks tk, int B, int LA, int LB,
            int T, Costs cs, uint8_t* __restrict__ dirs, int* score_,
            int8_t* __restrict__ mvs) {
  constexpr int W = 32 * P;
  constexpr int NEG = Q5 ? -(1 << 24) : -10000;
  constexpr bool REGS = P <= REG_MAX_P;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + wid;
  if (r >= B) return;  // the whole warp: nothing below syncs the block
  uint8_t* mine = smem + (size_t)wid * warp_bytes(W, 16 * W);
  int* Hs = reinterpret_cast<int*>(mine);  // [2][W], band lane k at sw<P>(k)
  int* Es = Hs + 2 * W;                    // [2][W]
  const int alen = min(max(alen_[r], 0), LA);
  const int blen = blen_[r];
  const size_t ro = (size_t)r * LA;
  const uint8_t* a = A + ro;
  const uint8_t* bw = Bw + (size_t)r * LB;
  const int* base = base_ + (size_t)r * (LA + 1);
  uint8_t* drow = dirs + (size_t)r * (LA + 1) * W;
  // the F lane's extension, per column
  const int fext = Q5 ? -cs.qext : cs.ext;
  const int od = cs.open_d + cs.ext, oi = cs.open_i + cs.ext;
  // the F recurrence's per-cell constants (row_cells)
  int cq[P];
#pragma unroll
  for (int q = 0; q < P; ++q)
    cq[q] = fext * (P * (lane - 1) + q) + (lane == 0 ? NO_CARRY : 0);
  const int xPl = fext * P * lane;
  const ScanSrc src = scan_sources(lane);

  // the window code of column j (b[j - 1], clamped), and its form in the
  // registers: the raw code (5q), or the prmt selector of the row's score
  // table (affine: codes >= 4 map to 7, whose byte is always the
  // mismatch); the mapping is applied where a code is used, so that no
  // load's consumer waits for it in the row that loads it
  auto wraw = [&](int j) { return (int)bw[min(max(j - 1, 0), LB - 1)]; };
  auto wmap = [](int c) { return Q5 ? c : sub_sel(c < 4 ? c : 7); };
  const unsigned mis4 = 0x01010101u * (uint8_t)cs.mismatch;
  auto wc = [&](int j) { return wmap(wraw(j)); };
  // chunk ch (rows 32 ch + 1 .. 32 ch + 32): lane l holds the scalars of
  // row 32 ch + l + 2 and the base of the row after it (in b), which row
  // 32 ch + l + 1 fetches for the rows ahead of it
  auto stage = [&](int ch, RowQ& s) {
    const int i = max(min(32 * ch + lane + 2, max(alen, 1)), 1);
    s.b = base[max(min(32 * ch + lane + 3, LA), 0)];
    const int c = a[i - 1];
    if constexpr (Q5) {
      const int nx = min(i, LA - 1);
      s.qb = c;
      s.st = tk.subtag[ro + i - 1];
      s.sq = tk.subqv[ro + i - 1];
      s.iq = tk.insqv[ro + nx];  // the last row's clip cost is set per row
      s.dq = tk.delqv[ro + nx];
      s.dt = tk.deltag[ro + nx];
    } else {
      s.qb = c;
      s.st = s.sq = s.iq = s.dq = s.dt = 0;
    }
  };

  // ---- row 0: H = 0 at column 0 (affine) or -j qclp (5q); E = NEG ----
  int H[P], E[P], BC[P];
  int bprev = base[0];
  {
    const unsigned wd[(P + 3) / 4] = {};
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int j = bprev + lane * P + q;
      if constexpr (Q5)
        H[q] = (j >= 0 && j <= blen) ? -j * cs.qclp : NEG;
      else
        H[q] = (j == 0 && j <= blen) ? 0 : NEG;
      E[q] = NEG;
      if constexpr (REGS) BC[q] = wc(j);
    }
    store_bytes<P>(drow + lane * P, wd);
  }
  auto spill = [&](int buf) {  // this row's H and E, for the next row
    // the register form may have read this buffer in the row before; the
    // shared form's last read of it was before its last spill's barrier
    if constexpr (REGS) __syncwarp();
#pragma unroll
    for (int q = 0; q < P; ++q) {
      Hs[buf * W + (q << 5) + lane] = H[q];
      Es[buf * W + (q << 5) + lane] = E[q];
    }
    __syncwarp();
  };

  // carried into row i: its base (b0) and the next row's (b1), its
  // scalars (q0) and the window code of its new column for a step of 1
  // (c0), each fetched at least a row before its first use
  RowQ s0, s1;  // chunks 0 and 1
  stage(0, s0);
  stage(1, s1);
  RowQ q0;
  {
    RowQ f;  // row 1's scalars, straight from global memory
    stage(-1, f);
    q0 = shfl_row<Q5>(f, 31);
  }
  int b0 = alen >= 1 ? base[1] : bprev, b1 = q0.b;
  int c0 = REGS ? wraw(b0 + W - 1) : 0;
  if (!REGS || (alen >= 1 && b0 - bprev >= 2)) spill(0);
  auto row = [&](int i) {
    const bool last = i >= alen;
    RowQ rq = q0;
    if constexpr (Q5) {
      if (last) rq.iq = cs.qclp;
    }
    const int bs = b0, sh = bs - bprev, cnew = wmap(c0);
    bprev = bs;
    // row i + 1's scalars and the base of row i + 2 from the stage, and the
    // new window code of row i + 1
    q0 = shfl_row<Q5>(s0, (i - 1) & 31);
    c0 = REGS ? wraw(b1 + W - 1) : 0;
    b0 = b1;
    b1 = q0.b;
    int hd[P], ev[P];  // the diagonal H and the vertical E of each lane
    if (REGS && sh <= 1) {
      const int lf0 = __shfl_up_sync(FULL, H[P - 1], 1);
      const int dn0 = __shfl_down_sync(FULL, E[0], 1);
      const int bd0 = __shfl_down_sync(FULL, BC[0], 1);
      const int lf = lane == 0 ? NEG : lf0;
      const int dn = lane == 31 ? NEG : dn0;
      const int bd = lane == 31 ? cnew : bd0;
      const bool one = sh == 1;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int hl = q ? H[q - 1] : lf;
        const int eu = q < P - 1 ? E[q + 1] : dn;
        hd[q] = one ? H[q] : hl;
        ev[q] = one ? eu : E[q];
        BC[q] = one ? (q < P - 1 ? BC[q + 1] : bd) : BC[q];
      }
    } else {
      const int* Hp = Hs + ((i - 1) & 1) * W;
      const int* Ep = Es + ((i - 1) & 1) * W;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int k = lane * P + q;
        const int ku = k + sh, kd = ku - 1;  // sh >= 0: the bases are monotone
        hd[q] = (kd >= 0 && kd < W) ? Hp[sw<P>(kd)] : NEG;
        ev[q] = ku < W ? Ep[sw<P>(ku)] : NEG;
        BC[q] = wc(bs + k);
      }
    }
    // affine: the row's score table, byte c the score of window code c
    // against the read code (codes 4 .. 7 of the window never match)
    unsigned tlo = mis4;
    if (!Q5 && rq.qb < 4)
      tlo = (mis4 & ~(0xffu << (8 * rq.qb))) |
            ((unsigned)(uint8_t)cs.match << (8 * rq.qb));
    uint8_t* dst = drow + (size_t)i * W + lane * P;
    if (bs >= 1 && bs + W - 1 <= blen && !last)
      row_cells<P, Q5, true>(hd, ev, BC, H, E, dst, lane, i, bs, blen, last,
                             rq, cs, fext, od, oi, cq, xPl, tlo, mis4, src);
    else
      row_cells<P, Q5, false>(hd, ev, BC, H, E, dst, lane, i, bs, blen, last,
                              rq, cs, fext, od, oi, cq, xPl, tlo, mis4, src);
    if (!REGS || b0 - bs >= 2) spill(i & 1);
  };
  for (int i0 = 1; i0 <= alen; i0 += 32) {
    if (i0 > 1) {  // the next chunk of the stage
      s0 = s1;
      stage((i0 - 1) / 32 + 1, s1);
    }
    const int n = min(32, alen - i0 + 1);
    for (int t = 0; t < n; ++t) row(i0 + t);
  }

  // ---- score: H at (alen, blen), NEG off the band (bprev = base[alen]) ----
  const int le = blen - bprev;
  int best = NEG;
  if constexpr (REGS) {
    int hv = NEG;
#pragma unroll
    for (int q = 0; q < P; ++q)
      if (lane * P + q == le) hv = H[q];
    if (le >= 0 && le < W) best = __shfl_sync(FULL, hv, le / P);
  } else if (le >= 0 && le < W) {
    best = Hs[(alen & 1) * W + sw<P>(le)];
  }

  // ---- traceback: the kswx state machine through the shared ring ----
  // move m (0 M, 1 I, 2 D, 3 none) leaves its row for M and I (bits 0-1
  // of 3) and its column for M and D (bits 0 and 2 of 5); the edge
  // overrides are known before the byte arrives
  int state = 0;
  auto step = [&state](int z, int i, int j, int& di, int& dj) {
    const int edge = i <= 0 ? 2 : 1;
    const int mv = (i <= 0 || j <= 0) ? edge : (z >> (2 * state)) & 3;
    di = (3 >> mv) & 1;
    dj = (5 >> mv) & 1;
    state = mv != 3 ? mv : state;
    return mv;
  };
  walk(mine, drow, base, alen + 1, W, T, B, r, mvs, 3, lane, blen, step);
  if (lane == 0) score_[r] = best;
}

template <int P>
int launch(bool q5, const uint8_t* a, const uint8_t* b, const int* alen,
           const int* blen, const int* base, Tracks tk, int B, int LA, int LB,
           int T, Costs cs, uint8_t* dirs, int* score, int8_t* mvs,
           cudaStream_t st) {
  constexpr int W = 32 * P;
  if (q5)
    return launch_reads(refine_warp<P, true>, B, warp_bytes(W, 16 * W), st, a,
                        b, alen, blen, base, tk, B, LA, LB, T, cs, dirs, score,
                        mvs);
  return launch_reads(refine_warp<P, false>, B, warp_bytes(W, 16 * W), st, a, b,
                      alen, blen, base, tk, B, LA, LB, T, cs, dirs, score, mvs);
}

}  // namespace

// q5 = 0: c0..c4 = match, mismatch, open_i, open_d, ext and the track
// pointers are unused; q5 = 1: c0..c3 = qclp, qmis, qdel, qext.  W in
// {64, 128, 256, 512, 1024}, LA >= 1, LB >= 1 (the wrapper checks).
extern "C" int refine_align_tb(const uint8_t* a, const uint8_t* b,
                               const int* alen, const int* blen,
                               const int* base, const int* subqv,
                               const int* insqv, const int* delqv,
                               const int* subtag, const int* deltag, int B,
                               int LA, int LB, int W, int T, int q5, int c0,
                               int c1, int c2, int c3, int c4, uint8_t* dirs,
                               int* score, int8_t* mvs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Tracks tk{subqv, insqv, delqv, subtag, deltag};
  Costs cs{};
  if (q5) {
    cs.qclp = c0;
    cs.qmis = c1;
    cs.qdel = c2;
    cs.qext = c3;
  } else {
    cs.match = c0;
    cs.mismatch = c1;
    cs.open_i = c2;
    cs.open_d = c3;
    cs.ext = c4;
  }
#define REFINE_ARGS \
  q5 != 0, a, b, alen, blen, base, tk, B, LA, LB, T, cs, dirs, score, mvs, st
  switch (W) {
    case 64: return launch<2>(REFINE_ARGS);
    case 128: return launch<4>(REFINE_ARGS);
    case 256: return launch<8>(REFINE_ARGS);
    case 512: return launch<16>(REFINE_ARGS);
    case 1024: return launch<32>(REFINE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REFINE_ARGS
}
