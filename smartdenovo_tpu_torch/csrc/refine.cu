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
// dependent chain and a batch holds at most 64 reads, one warp each, so
// the time is the longest read's rows times one row's latency plus its
// traceback's dependent steps; the card's int32 and HBM rates are far off.
//
// Design: banded.cu's.  One warp a read, lane l owning P = W / 32 band
// lanes; H and E of the previous row come from double-buffered,
// bank-conflict-free shared buffers (16 W bytes: 16 KB at W = 1024, so
// nothing of a row is kept in registers across rows and P = 32 does not
// spill H or E); the F lane, F[c] = max_{k<c} v[k] + x (c - 1 - k) with x
// the extension, is x (c - 1) + an exclusive max-scan of v[k] - x k
// (thread-serial, then one warp shuffle scan); direction bytes go out a
// coalesced row at a time; lane 0 walks the traceback out of the cp.async
// ring.  The 5q row costs (the read's base, SubTag and SubQV at row i - 1;
// InsQV, DelQV and DelTag at row i, or the clip cost on the last row) are
// loaded a row ahead.
//
// Integer semantics are the JAX versions': NEG is a number (-10000 affine,
// -(1 << 24) 5q); m beats E on ties, F only where strictly greater; E's
// extension bit on >, F's on f > f1 (the one-step open); affine
// substitutions need both codes < 4, 5q compares raw codes with no guard;
// 5q's column 0 is a clip entry h = -i qclp with direction byte 1.
#include "warpdp.cuh"

namespace {

using namespace warpdp;

struct Costs {
  int match, mismatch, open_i, open_d, ext;  // affine
  int qclp, qmis, qdel, qext;                // 5q
};

struct Tracks {
  const int *subqv, *insqv, *delqv, *subtag, *deltag;  // [B, LA] each
};

// the per-row scalars of the 5q costs (the affine model reads only qb)
struct RowQ {
  int qb, st, sq, iq, dq, dt;
};

template <bool Q5>
__device__ __forceinline__ RowQ row_q(const uint8_t* a, const Tracks& tk,
                                      size_t ro, int i, int LA, int alen,
                                      int qclp) {
  RowQ q;
  q.qb = a[i - 1];
  if constexpr (Q5) {
    const int nx = min(i, LA - 1);
    q.st = tk.subtag[ro + i - 1];
    q.sq = tk.subqv[ro + i - 1];
    q.iq = i >= alen ? qclp : tk.insqv[ro + nx];
    q.dq = tk.delqv[ro + nx];
    q.dt = tk.deltag[ro + nx];
  } else {
    q.st = q.sq = q.iq = q.dq = q.dt = 0;
  }
  return q;
}

template <int P, bool Q5>
__global__ void __launch_bounds__(32)
refine_warp(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bw,
            const int* __restrict__ alen_, const int* __restrict__ blen_,
            const int* __restrict__ base_, Tracks tk, int B, int LA, int LB,
            int T, Costs cs, uint8_t* __restrict__ dirs, int* score_,
            int8_t* __restrict__ mvs) {
  constexpr int W = 32 * P;
  constexpr int NEG = Q5 ? -(1 << 24) : -10000;
  __shared__ __align__(16) uint8_t smem[2 * RING_BYTES];
  int* Hs = reinterpret_cast<int*>(smem);  // [2][W], band lane k at sw<P>(k)
  int* Es = Hs + 2 * W;                    // [2][W]
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
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

  // ---- row 0: H = 0 at column 0 (affine) or -j qclp (5q); E = NEG ----
  int bprev = base[0];
  {
    const unsigned wd[(P + 3) / 4] = {};
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = lane * P + q;
      const int j = bprev + k;
      int h;
      if constexpr (Q5)
        h = (j >= 0 && j <= blen) ? -j * cs.qclp : NEG;
      else
        h = (j == 0 && j <= blen) ? 0 : NEG;
      Hs[sw<P>(k)] = h;
      Es[sw<P>(k)] = NEG;
    }
    store_bytes<P>(drow + lane * P, wd);
  }
  __syncwarp();

  int bnext = alen >= 1 ? base[1] : bprev;
  RowQ qn{};
  if (alen >= 1) qn = row_q<Q5>(a, tk, ro, 1, LA, alen, cs.qclp);
  for (int i = 1; i <= alen; ++i) {
    const int bs = bnext, sh = bs - bprev;
    const RowQ rq = qn;
    bprev = bs;
    if (i < alen) {
      bnext = base[i + 1];
      qn = row_q<Q5>(a, tk, ro, i + 1, LA, alen, cs.qclp);
    }
    const bool last = i >= alen;
    const int* Hp = Hs + ((i - 1) & 1) * W;
    const int* Ep = Es + ((i - 1) & 1) * W;
    int* Hc = Hs + (i & 1) * W;
    int* Ec = Es + (i & 1) * W;
    int M[P], Ev[P], V[P];
    int run = INT_MIN;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = lane * P + q;
      const int j = bs + k;
      const int ku = k + sh, kd = ku - 1;  // sh >= 0: the bases are monotone
      const int hd = (kd >= 0 && kd < W) ? Hp[sw<P>(kd)] : NEG;
      Ev[q] = ku < W ? Ep[sw<P>(ku)] : NEG;
      const int bc = bw[min(max(j - 1, 0), LB - 1)];
      const bool okj = j >= 1 && j <= blen;
      if constexpr (Q5) {
        const int sub = bc == rq.qb ? 0 : (bc == rq.st ? rq.sq : cs.qmis);
        const int delc = last ? cs.qclp : (bc == rq.dt ? rq.dq : cs.qdel);
        M[q] = okj ? hd - sub : NEG;
        V[q] = okj ? M[q] - delc : NEG;
      } else {
        const bool eq = rq.qb < 4 && bc < 4 && rq.qb == bc;
        M[q] = okj ? hd + (eq ? cs.match : cs.mismatch) : NEG;
        V[q] = M[q] + od;
      }
      run = max(run, V[q] - fext * k);
    }
    int pre = warp_excl_max(run, lane);
    const int vlast = __shfl_up_sync(FULL, V[P - 1], 1);  // v of lane k - 1
    unsigned wd[(P + 3) / 4] = {};
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = lane * P + q;
      const int j = bs + k;
      const int f = k == 0 ? NEG : fext * (k - 1) + pre;
      const int f1 = k == 0 ? NEG : (q == 0 ? vlast : V[q - 1]);
      pre = max(pre, V[q] - fext * k);
      const int m = M[q], e = Ev[q];
      unsigned d = m >= e ? 0 : 1;
      int h = max(m, e);
      if (f > h) d = 2;
      h = max(h, f);
      int eo, ee;
      if constexpr (Q5) {
        eo = m - rq.iq;
        ee = e - rq.iq;
      } else {
        eo = m + oi;
        ee = e + cs.ext;
      }
      if (ee > eo) d |= 4;
      if (f > f1) d |= 32;
      const bool okj = j >= 1 && j <= blen;
      bool keep = okj;
      if constexpr (Q5) {
        if (j == 0) {  // query-clip entry (reference h1 = i QCLP)
          h = -i * cs.qclp;
          d = 1;
          keep = true;
        }
      }
      Hc[sw<P>(k)] = keep ? h : NEG;
      Ec[sw<P>(k)] = max(ee, eo);
      wd[q / 4] |= d << (8 * (q % 4));
    }
    store_bytes<P>(drow + (size_t)i * W + lane * P, wd);
    __syncwarp();
  }

  // ---- score: H at (alen, blen), NEG off the band ----
  const int le = blen - base[alen];
  const int best = (le >= 0 && le < W) ? Hs[(alen & 1) * W + sw<P>(le)] : NEG;

  // ---- traceback: the kswx state machine through the shared ring ----
  __threadfence();  // the DP's `dirs` stores before the warp's copies
  __syncwarp();     // and every lane is done with the row buffers
  uint8_t* ring = smem;
  const int rows = alen + 1, R = RING_BYTES / W;
  ring_prefetch(ring, drow, rows, W, 0, lane);
  ring_prefetch(ring, drow, rows, W, 1, lane);
  int i = alen, j = blen, state = 0, s = 0;
  bool done = i <= 0 && j <= 0;
  int bcur = base[i], bdown = base[max(i - 1, 0)];
  for (int c = 0;; ++c) {
    cp_async_wait1();  // chunk c has landed (c + 1 may be in flight)
    __syncwarp();
    bool fin = false;
    if (lane == 0) {
      const int lo = max(rows - (c + 1) * R, 0);
      const uint8_t* rc = ring + (c & 1) * RING_BYTES;
      while (s < T && !done && i >= lo) {
        const int ln = j - bcur;
        const int z = (ln >= 0 && ln < W) ? rc[(i - lo) * W + ln] : 0;
        int mv = (z >> (2 * state)) & 3;
        if (i <= 0) mv = 2;
        if (j <= 0 && i > 0) mv = 1;
        if (mv == 0 || mv == 1) {
          --i;
          bcur = bdown;
          bdown = base[max(i - 1, 0)];
        }
        if (mv == 0 || mv == 2) --j;
        if (mv != 3) state = mv;
        done = i <= 0 && j <= 0;
        mvs[(size_t)s * B + r] = (int8_t)mv;
        ++s;
      }
      fin = done || s >= T;
    }
    if (__shfl_sync(FULL, fin, 0)) break;
    ring_prefetch(ring, drow, rows, W, c + 2, lane);  // into the buffer left
  }
  s = __shfl_sync(FULL, s, 0);
  for (int k = s + lane; k < T; k += 32) mvs[(size_t)k * B + r] = 3;
  if (lane == 0) score_[r] = best;
}

template <int P>
int launch(bool q5, const uint8_t* a, const uint8_t* b, const int* alen,
           const int* blen, const int* base, Tracks tk, int B, int LA, int LB,
           int T, Costs cs, uint8_t* dirs, int* score, int8_t* mvs,
           cudaStream_t st) {
  if (q5)
    refine_warp<P, true><<<B, 32, 0, st>>>(a, b, alen, blen, base, tk, B, LA,
                                            LB, T, cs, dirs, score, mvs);
  else
    refine_warp<P, false><<<B, 32, 0, st>>>(a, b, alen, blen, base, tk, B, LA,
                                             LB, T, cs, dirs, score, mvs);
  return (int)cudaGetLastError();
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
