// Join-matcher emitter extraction, for Hopper.
//
// Replaces the Pallas kernel smartdenovo_tpu/ops/jpost.py join_emitters
// (kernel body _make_kernel).  Input: the sorted join stream (key, pay,
// aux), key = q<<(zb+1) | zmer<<1 | side, INT32_MAX past the live prefix.
// Per entry: pre0 = number of query entries (side 0) before it; rs = pre0
// at the start of its (q, zmer) run; qcnt = pre0 - rs.  Emitters are
// candidate entries (side 1) with 1 <= qcnt < max_per_read.  Output: the
// emitters' records [qcnt, pay, aux, rs - ost2] in stream order (ost2 =
// exclusive sum of qcnt over earlier emitters) as [4, out_budget], the
// emitter count and the total sum of qcnt.  The TPU kernel's rows 4-7
// (its 8-sublane padding) are not written: no caller reads them.
//
// What bounds it on the H100: HBM bandwidth.  The least traffic is the key
// (4 bytes an entry), pay and aux of the emitters only (8 bytes each) and
// their records (16 bytes): 4 N + 24 n.  At N = 2^23 with 3.0 M emitters
// that is 0.032 ms at 3.35 TB/s.  The five-launch kernel this replaces
// took 0.335 ms there: three passes over the stream, each with 4-5
// barrier-heavy block scans at one entry a thread, and two one-block
// carry launches between them.
//
// Design: one pass with a two-stage decoupled look-back (Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), as csrc/sseg.cu.
//   - A block takes its tile ID from an atomic counter, so it waits only on
//     tiles that have already started.  A tile is 256 threads x 8
//     consecutive entries; the keys come in with 16-byte loads where the
//     pointer allows, and each warp's first key reads the one before it.
//   - Stage 1, state S1 = (c0, open, has): query entries in the span, query
//     entries since its last run start (all of them if none), and whether
//     it holds a run start.  (a) + (b) = (a.c0 + b.c0, b.has ? b.open :
//     a.open + b.open, a.has | b.has) is associative.  From the exclusive
//     S1 of an entry: pre0 = c0, qcnt = run start here ? 0 : open.
//   - Stage 2, state S2 = (sum of cnt2, emitters): wrapping int32 sums.  A
//     tile's S2 depends on its S1 prefix (through the run open at its
//     head), so a tile publishes S1 (aggregate, then inclusive prefix)
//     before S2, and its S2 look-back starts once its S1 prefix is known.
//     Every wait is on an earlier tile, so nothing deadlocks.  An open run
//     over thousands of tiles costs no walk: the tile before already holds
//     it in its S1 prefix.
//   - A tile publishes each stage's state with its status in one 64-bit
//     word that one relaxed store and load move whole (csrc/lookback.cuh);
//     S1's counts take 30 bits each, so N < 2^30.
//   - Output: while warp 0 looks back for S2, every thread puts its
//     emitters' (qcnt, entry, rs - ost2 within the tile) into shared
//     memory at their rank in the tile; then the block writes the records
//     with consecutive threads on consecutive columns, reading pay and aux
//     of the emitters only.  Records at or past out_budget are dropped
//     (the count still holds them); the last tile writes the two totals.
// Scratch: a tile counter and two 64-bit words a tile (stage 1, stage 2),
// all zeroed before the launch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                  // consecutive entries a thread
constexpr int TILE_N = THREADS * ITEMS;   // entries a tile (jpost_tile)
constexpr int WARPS = THREADS / 32;
constexpr unsigned M30 = 0x3fffffffu;

// Stage 1: query entries; query entries since the last run start; run start
struct S1 {
  unsigned c0, open;
  int has;
  __device__ static S1 id() { return {0u, 0u, 0}; }
  __device__ static S1 combine(const S1& a, const S1& b) {  // a precedes b
    return {a.c0 + b.c0, b.has ? b.open : a.open + b.open, a.has | b.has};
  }
  __device__ S1 shfl_up(int d) const {
    return {__shfl_up_sync(FULL, c0, d), __shfl_up_sync(FULL, open, d),
            __shfl_up_sync(FULL, has, d)};
  }
  __device__ S1 shfl_down(int d) const {
    return {__shfl_down_sync(FULL, c0, d), __shfl_down_sync(FULL, open, d),
            __shfl_down_sync(FULL, has, d)};
  }
  __device__ S1 bcast() const {
    return {__shfl_sync(FULL, c0, 0), __shfl_sync(FULL, open, 0),
            __shfl_sync(FULL, has, 0)};
  }
  // status 2 bits, has 1, open 30, c0 30 (both at most N < 2^30)
  __device__ u64 word(int st) const {
    return (u64)st | (u64)has << 2 |
           (u64)(open & M30) << 3 |
           (u64)(c0 & M30) << 33;
  }
  __device__ static S1 of(u64 w) {
    return {(unsigned)(w >> 33) & M30, (unsigned)(w >> 3) & M30,
            (int)(w >> 2) & 1};
  }
};

// Stage 2: sum of cnt2 (the output slots), emitters
struct S2 {
  unsigned sum, cnt;
  __device__ static S2 id() { return {0u, 0u}; }
  __device__ static S2 combine(const S2& a, const S2& b) {
    return {a.sum + b.sum, a.cnt + b.cnt};
  }
  __device__ S2 shfl_up(int d) const {
    return {__shfl_up_sync(FULL, sum, d), __shfl_up_sync(FULL, cnt, d)};
  }
  __device__ S2 shfl_down(int d) const {
    return {__shfl_down_sync(FULL, sum, d), __shfl_down_sync(FULL, cnt, d)};
  }
  __device__ S2 bcast() const {
    return {__shfl_sync(FULL, sum, 0), __shfl_sync(FULL, cnt, 0)};
  }
  // status 2 bits, cnt 30 (at most N < 2^30), sum 32
  __device__ u64 word(int st) const {
    return (u64)st | (u64)(cnt & M30) << 2 |
           (u64)sum << 32;
  }
  __device__ static S2 of(u64 w) {
    return {(unsigned)(w >> 32), (unsigned)(w >> 2) & M30};
  }
};

// Inclusive warp scan; the exclusive one is its shfl_up by 1
template <class S>
__device__ __forceinline__ S warp_incl(S v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S o = v.shfl_up(d);
    if (lane >= d) v = S::combine(o, v);
  }
  return v;
}

// 6 tiles an SM (at most 40 registers a thread): more registers cost
// resident tiles, fewer spill
__global__ void __launch_bounds__(THREADS, 6)
jpost_onepass(const int* __restrict__ key, const int* __restrict__ pay,
              const int* __restrict__ aux, long long N, int mpr,
              int out_budget, int* __restrict__ out, int* totals,
              int* counter, u64* w1, u64* w2, int vec) {
  __shared__ int s_tile;
  __shared__ S1 s_w1[WARPS];
  __shared__ S2 s_w2[WARPS];
  __shared__ S1 s_x1;
  __shared__ S2 s_x2, s_agg2;
  // the tile's emitters at their rank in it: qcnt, entry in the tile, and
  // rs minus the sum of qcnt over the tile's earlier emitters
  __shared__ int s_q[TILE_N], s_j[TILE_N], s_b[TILE_N];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int t = s_tile;
  const long long nt = (N + TILE_N - 1) / TILE_N;
  const long long tbase = (long long)t * TILE_N;
  const long long e0 = tbase + (long long)tid * ITEMS;

  // ---- keys: 8 consecutive entries and the one before ----
  int k[ITEMS];
  if (vec && e0 + ITEMS <= N) {
#pragma unroll
    for (int u = 0; u < ITEMS / 4; ++u) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(key + e0) + u);
      k[4 * u] = a.x; k[4 * u + 1] = a.y; k[4 * u + 2] = a.z; k[4 * u + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) k[i] = e0 + i < N ? key[e0 + i] : INT_MAX;
  }
  int prev = __shfl_up_sync(FULL, k[ITEMS - 1], 1);
  if (lane == 0) prev = (e0 > 0 && e0 <= N) ? key[e0 - 1] : 0;
  // entries past N are neither side and open no run: they change nothing
  unsigned t0 = 0, t1 = 0, rn = 0;  // bit i: query entry, candidate, run start
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long j = e0 + i;
    if (j < N) {
      const int kk = k[i];
      const int pk = i ? k[i - 1] : prev;
      if (kk != INT_MAX) {
        t0 |= (unsigned)!(kk & 1) << i;
        t1 |= (unsigned)(kk & 1) << i;
      }
      rn |= (unsigned)(j == 0 || (pk >> 1) != (kk >> 1)) << i;
    }
  }

  // ---- stage 1: thread fold, warp scan, scan over the warps ----
  S1 me = S1::id();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if ((rn >> i) & 1) { me.open = 0; me.has = 1; }
    me.c0 += (t0 >> i) & 1;
    me.open += (t0 >> i) & 1;
  }
  const S1 inc1 = warp_incl(me, lane);
  S1 texc1 = inc1.shfl_up(1);
  if (lane == 0) texc1 = S1::id();
  if (lane == 31) s_w1[warp] = inc1;
  __syncthreads();
  if (warp == 0) {
    S1 agg = s_w1[0];
    for (int w = 1; w < WARPS; ++w) agg = S1::combine(agg, s_w1[w]);
    S1 excl = S1::id();
    if (t > 0) {
      if (lane == 0) publish(w1 + t, agg, ST_AGG);
      excl = look_back<S1>(t, w1, lane);
    }
    if (lane == 0) {
      publish(w1 + t, S1::combine(excl, agg), ST_PRE);
      s_x1 = excl;
    }
  }
  __syncthreads();

  // ---- qcnt of each entry, and stage 2 of this thread ----
  S1 run = s_x1;
  for (int w = 0; w < warp; ++w) run = S1::combine(run, s_w1[w]);
  run = S1::combine(run, texc1);
  int cnt2[ITEMS];
  unsigned rs[ITEMS];
  S2 me2 = S2::id();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if ((rn >> i) & 1) run.open = 0;
    const unsigned q = run.open;  // < 2^31: a count of entries
    rs[i] = run.c0 - q;
    cnt2[i] = (((t1 >> i) & 1) && q > 0 && (int)q < mpr) ? (int)q : 0;
    me2.sum += (unsigned)cnt2[i];
    me2.cnt += cnt2[i] > 0;
    run.c0 += (t0 >> i) & 1;
    run.open += (t0 >> i) & 1;
  }
  const S2 inc2 = warp_incl(me2, lane);
  S2 texc2 = inc2.shfl_up(1);
  if (lane == 0) texc2 = S2::id();
  if (lane == 31) s_w2[warp] = inc2;
  __syncthreads();

  // ---- this thread's emitters into shared memory, at their tile rank ----
  S2 pos = S2::id();
  for (int w = 0; w < warp; ++w) pos = S2::combine(pos, s_w2[w]);
  pos = S2::combine(pos, texc2);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (cnt2[i] > 0) {
      s_q[pos.cnt] = cnt2[i];
      s_j[pos.cnt] = tid * ITEMS + i;
      s_b[pos.cnt] = (int)(rs[i] - pos.sum);
      pos.sum += (unsigned)cnt2[i];
      pos.cnt += 1;
    }
  }

  // ---- stage 2 across tiles: publish, look back, publish the prefix ----
  if (warp == 0) {
    S2 agg = s_w2[0];
    for (int w = 1; w < WARPS; ++w) agg = S2::combine(agg, s_w2[w]);
    S2 excl = S2::id();
    if (t > 0) {
      if (lane == 0) publish(w2 + t, agg, ST_AGG);
      excl = look_back<S2>(t, w2, lane);
    }
    if (lane == 0) {
      const S2 incl = S2::combine(excl, agg);
      publish(w2 + t, incl, ST_PRE);
      s_x2 = excl;
      s_agg2 = agg;
      if (t == nt - 1) {
        totals[0] = (int)incl.cnt;
        totals[1] = (int)incl.sum;
      }
    }
  }
  __syncthreads();

  // ---- the tile's records, consecutive threads on consecutive columns ----
  const long long r0 = s_x2.cnt;
  const int n = (int)min((long long)s_agg2.cnt, out_budget - r0);
  const unsigned ost = s_x2.sum;
  const long long ob = out_budget;
  for (int r = tid; r < n; r += THREADS) {
    const long long c = r0 + r;
    const long long j = tbase + s_j[r];
    out[c] = s_q[r];
    out[ob + c] = pay[j];
    out[2 * ob + c] = aux[j];
    out[3 * ob + c] = (int)((unsigned)s_b[r] - ost);
  }
}

constexpr long long ntiles(long long N) {
  return (N + TILE_N - 1) / TILE_N;
}

}  // namespace

extern "C" int jpost_tile() { return TILE_N; }

// the ints of scratch: the tile counter (padded to 8 bytes) and two
// 64-bit words a tile
extern "C" long long jpost_scratch_ints(long long N) {
  return 2 + 4 * ntiles(N);
}

// N < 2^30; out: [4, out_budget]; totals: [n_emitters, total_slots];
// scratch: jpost_scratch_ints(N) ints, all zeroed here
extern "C" int jpost_join_emitters(const int* key, const int* pay,
                                   const int* aux, long long N, int mpr,
                                   int out_budget, int* out, int* totals,
                                   int* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = ntiles(N);
  if (N >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  u64* w1 = reinterpret_cast<u64*>(scratch + 2);  // [0] is the tile counter
  u64* w2 = w1 + nt;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(int) * jpost_scratch_ints(N), st);
  if (err != cudaSuccess) return (int)err;
  const int vec = (uintptr_t)key % 16 == 0;
  jpost_onepass<<<(unsigned)nt, THREADS, 0, st>>>(
      key, pay, aux, N, mpr, out_budget, out, totals, scratch, w1, w2, vec);
  return (int)cudaGetLastError();
}
