// Whole-read banded alignment with traceback, for Hopper.
//
// Replaces smartdenovo_tpu/ops/banded.py:33 banded_align and
// smartdenovo_tpu/ops/traceback.py:29 tb_banded_device, which are
// `jax.jit` over `lax.scan` (not Pallas): a linear-gap DP of a read
// (LA rows) against a consensus window along a W-lane band whose leftmost
// column per row is given (base, non-decreasing), semiglobal in b or
// global, then the walk of the direction plane back from (alen, end_col)
// into a move stream.  Only the moves, j_final, score and end_col leave
// the kernel for the host; the plane stays in device memory.
//
// What bounds it on the H100.  A read's rows are a dependent chain, and
// the consensus batch is small (at most 64 reads, one warp each, on 64
// of the 132 SMs), so the card's int32 rate and HBM rate are both far
// off: the time is the rows of the longest read times one row's latency
// (shared-memory loads, a warp shuffle scan, the stores), plus the
// traceback's ~2 alen dependent steps of one thread.
//
// Design (segdp.cu's, without its register-shift fast path).  One warp a
// read, one read a block.  Lane l owns P = W / 32 consecutive band lanes.
// Each row reads the previous row's H at the band shift from a
// double-buffered, bank-conflict-free shared buffer, takes the in-row gap
// lane S[c] = max_{k<=c} m[k] + gap_b (c - k) as gap_b c + a max-scan of
// m[k] - gap_b k (thread-serial over the lane's P cells, then one warp
// shuffle scan), writes H back and stores its P direction bytes at once,
// so a row of `dirs` is one coalesced W-byte store.  Rows past alen are
// skipped.  Then lane 0 walks the traceback out of a shared ring of
// `dirs` rows that the warp refills with cp.async a chunk ahead.
//
// Integer semantics are the JAX version's: NEG_INF = -(1 << 28) is a
// number (sums of it decide direction bits), STOP is gated on s >
// NEG_INF / 2, DIAG wins ties over UP, LEFT only where the scan is
// strictly greater, the end lane is the first maximum; every sum is int32.
#include "warpdp.cuh"

namespace {

using namespace warpdp;

constexpr int NEG_INF = -(1 << 28);
constexpr int STOP = 0, DIAG = 1, UP = 2, LEFT = 3;

template <int P>
__global__ void __launch_bounds__(32)
banded_warp(const uint8_t* __restrict__ A, const uint8_t* __restrict__ Bw,
            const int* __restrict__ alen_, const int* __restrict__ blen_,
            const int* __restrict__ base_, int B, int LA, int LB, int T,
            int match, int mismatch, int gap_a, int gap_b, int semi,
            uint8_t* __restrict__ dirs, int* score_, int* end_col_,
            int8_t* __restrict__ mvs, int* j_final_) {
  constexpr int W = 32 * P;
  __shared__ __align__(16) uint8_t smem[2 * RING_BYTES];
  int* Hs = reinterpret_cast<int*>(smem);  // [2][W], band lane k at sw<P>(k)
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  const int alen = min(max(alen_[r], 0), LA);
  const int blen = blen_[r];
  const uint8_t* a = A + (size_t)r * LA;
  const uint8_t* bw = Bw + (size_t)r * LB;
  const int* base = base_ + (size_t)r * (LA + 1);
  uint8_t* drow = dirs + (size_t)r * (LA + 1) * W;

  // ---- row 0 ----
  int bprev = base[0];
  {
    unsigned wd[(P + 3) / 4] = {};
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = lane * P + q;
      const int j = bprev + k;
      const bool ok = j >= 0 && j <= blen;
      Hs[sw<P>(k)] = ok ? (semi ? 0 : gap_b * j) : NEG_INF;
      const unsigned d = (semi || !ok || j == 0) ? STOP : LEFT;
      wd[q / 4] |= d << (8 * (q % 4));
    }
    store_bytes<P>(drow + lane * P, wd);
  }
  __syncwarp();

  // ---- rows 1 .. alen; the next row's base and read code load ahead ----
  int bnext = alen >= 1 ? base[1] : bprev;
  int ac_next = alen >= 1 ? a[0] : 4;
  for (int i = 1; i <= alen; ++i) {
    const int bs = bnext, sh = bs - bprev, ac = ac_next;
    bprev = bs;
    if (i < alen) {
      bnext = base[i + 1];
      ac_next = a[i];
    }
    const int* Hp = Hs + ((i - 1) & 1) * W;
    int* Hc = Hs + (i & 1) * W;
    int m[P];
    unsigned diag = 0;
    int run = INT_MIN;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = lane * P + q;
      const int j = bs + k;
      const int ku = k + sh, kd = ku - 1;  // sh >= 0: the bases are monotone
      const int up = ku < W ? Hp[sw<P>(ku)] : NEG_INF;
      const int dg = (kd >= 0 && kd < W) ? Hp[sw<P>(kd)] : NEG_INF;
      const int bc = bw[min(max(j - 1, 0), LB - 1)];
      const int t_dg = dg + ((ac < 4 && ac == bc) ? match : mismatch);
      const int t_up = up + gap_a;
      int mm = max(t_dg, t_up);
      bool isdiag = t_dg >= t_up;
      if (j == 0) {
        mm = gap_a * i;
        isdiag = false;
      }
      m[q] = (j >= 0 && j <= blen) ? mm : NEG_INF;
      diag |= (unsigned)isdiag << q;
      run = max(run, m[q] - gap_b * k);
    }
    int pre = warp_excl_max(run, lane);
    unsigned wd[(P + 3) / 4] = {};
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = lane * P + q;
      const int j = bs + k;
      const bool okj = j >= 0 && j <= blen;
      pre = max(pre, m[q] - gap_b * k);
      const int s = gap_b * k + pre;  // inclusive in-row gap scan
      unsigned d = s > m[q] ? LEFT : (((diag >> q) & 1) ? DIAG : UP);
      if (!(okj && s > NEG_INF / 2)) d = STOP;
      Hc[sw<P>(k)] = okj ? s : NEG_INF;
      wd[q / 4] |= d << (8 * (q % 4));
    }
    store_bytes<P>(drow + (size_t)i * W + lane * P, wd);
    __syncwarp();
  }

  // ---- score and end column from row alen ----
  const int last_base = base[alen];
  const int* Hl = Hs + (alen & 1) * W;
  int best, end_col;
  if (semi) {  // first maximum over the in-window lanes
    int bv = INT_MIN, bi = 0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int k = lane * P + q;
      const int col = last_base + k;
      const int hv = (col >= 0 && col <= blen) ? Hl[sw<P>(k)] : NEG_INF;
      if (hv > bv) {
        bv = hv;
        bi = k;
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
    best = __shfl_sync(FULL, bv, 0);
    end_col = last_base + __shfl_sync(FULL, bi, 0);
  } else {
    const int le = blen - last_base;
    best = (le >= 0 && le < W) ? Hl[sw<P>(le)] : NEG_INF;
    end_col = blen;
  }

  // ---- traceback: rows alen .. 0 through the shared ring ----
  __threadfence();  // the DP's `dirs` stores before the warp's copies
  __syncwarp();     // and every lane is done with the row buffers
  uint8_t* ring = smem;
  const int rows = alen + 1, R = RING_BYTES / W;
  ring_prefetch(ring, drow, rows, W, 0, lane);
  ring_prefetch(ring, drow, rows, W, 1, lane);
  int i = alen, j = end_col, s = 0;
  bool done = i <= 0 && j <= 0;
  // base[i] and base[i - 1] ride in registers: i falls by at most one a
  // step, so the load of the next base is off the walk's chain
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
        int mv = (ln >= 0 && ln < W) ? rc[(i - lo) * W + ln] : STOP;
        if (mv == STOP) {  // stuck: stop at row 0, else fall back to UP
          if (i <= 0)
            done = true;
          else
            mv = UP;
        }
        if (mv == DIAG || mv == UP) {
          --i;
          bcur = bdown;
          bdown = base[max(i - 1, 0)];
        }
        if (mv == DIAG || mv == LEFT) --j;
        done = done || (i <= 0 && j <= 0);
        mvs[(size_t)s * B + r] = (int8_t)mv;
        ++s;
      }
      fin = done || s >= T;
    }
    if (__shfl_sync(FULL, fin, 0)) break;
    ring_prefetch(ring, drow, rows, W, c + 2, lane);  // into the buffer left
  }
  s = __shfl_sync(FULL, s, 0);
  for (int k = s + lane; k < T; k += 32) mvs[(size_t)k * B + r] = 0;
  if (lane == 0) {
    score_[r] = best;
    end_col_[r] = end_col;
    j_final_[r] = j;
  }
}

template <int P>
int launch(const uint8_t* a, const uint8_t* b, const int* alen,
           const int* blen, const int* base, int B, int LA, int LB, int T,
           int match, int mismatch, int gap_a, int gap_b, int semi,
           uint8_t* dirs, int* score, int* end_col, int8_t* mvs, int* j_final,
           cudaStream_t st) {
  banded_warp<P><<<B, 32, 0, st>>>(a, b, alen, blen, base, B, LA, LB, T,
                                    match, mismatch, gap_a, gap_b, semi, dirs,
                                    score, end_col, mvs, j_final);
  return (int)cudaGetLastError();
}

}  // namespace

// W a multiple of 32 up to 256, LA >= 1, LB >= 1 (the wrapper checks)
extern "C" int banded_align_tb(const uint8_t* a, const uint8_t* b,
                               const int* alen, const int* blen,
                               const int* base, int B, int LA, int LB, int W,
                               int T, int match, int mismatch, int gap_a,
                               int gap_b, int semi, uint8_t* dirs, int* score,
                               int* end_col, int8_t* mvs, int* j_final,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define BANDED_ARGS                                                           \
  a, b, alen, blen, base, B, LA, LB, T, match, mismatch, gap_a, gap_b, semi, \
      dirs, score, end_col, mvs, j_final, st
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
