// Sorted-segment reduce + compact, for Hopper.
//
// Replaces the Pallas kernel smartdenovo_tpu/ops/sseg.py
// seg_reduce_compact (kernel body _make_kernel).  A stream of N entries
// carries a 0/1 segment-start flag and 8 int32 lanes (lane-major [8, N]);
// every segment becomes one record [8] in stream order, each lane reduced
// by its own op (sum, min, max, or "first value that is not INT32_MAX").
// Entry 0 always opens a segment; the open tail segment is the last
// record; count = number of segments, and records at or past out_budget
// are dropped (count still reports them, so the caller can redispatch).
//
// What bounds it on the H100: HBM bandwidth.  Each entry is 36 bytes read
// and a few integer operations; the records written are fewer.  At
// N = 2^24 (chip_smoke.py's block stream) the stream and its records are
// 652 MB, 0.195 ms at 3.35 TB/s.  The three-launch kernel it replaces took
// 1.8 ms there: it read the stream twice, with a one-block carry pass
// between, through 4-byte loads and barrier-heavy shared-memory scans.
//
// Design: one pass with a decoupled look-back (Merrill & Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", 2016).
//   - A block takes its tile ID from an atomic counter, so it waits only
//     on tiles that have already started.  A tile is 256 threads x 8
//     consecutive entries; each thread reads its flags and each lane with
//     16-byte loads where N and the pointers allow.
//   - Scan state (c, v[8]): c segment starts, v the reduction of the
//     entries since the last start.  (c1, a) (+) (c2, b) = (c1 + c2,
//     c2 > 0 ? b : a op b) is associative because every lane op is
//     (wrapping add, min, max, first non-INT32_MAX), so any grouping gives
//     the plain version's bits.
//   - In the tile: a thread-serial reduce of its 8 entries, a warp-shuffle
//     scan of the states, then a scan over the 8 warp totals.
//   - Across tiles: the tile publishes its aggregate (9 ints, then a status
//     word after a __threadfence), and warp 0 looks back over 32
//     predecessors at a time until one has published its inclusive
//     prefix.  A segment that spans thousands of tiles (the dead tail of a
//     budget-wide stream) costs nothing extra: the inclusive prefix of the
//     tile before already holds it.
//   - Output: the thread that holds a segment's last entry writes its
//     record at (inclusive start count - 1) when that is below out_budget;
//     the thread that holds entry N - 1 flushes the open tail and writes
//     the count.
//   - The main path's three lane-op sets are compiled with their ops
//     known; any other set reads them at run time.  Two tiles of 2048
//     entries sit on an SM at once (128 registers a thread); the tile's
//     serial chain (load, scans, look-back, emit) is what keeps it under
//     half of HBM's rate.
// Scratch: a tile counter and ntiles status words, zeroed before the
// launch, and two 9-int payloads per tile (aggregate, inclusive prefix).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                   // consecutive entries a thread
constexpr int TILE_N = THREADS * ITEMS;    // entries a tile (sseg_tile)
constexpr int ST_AGG = 1, ST_PREFIX = 2;   // status words; 0 = not yet
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int op_of(int ops, int l) {
  return (ops >> (2 * l)) & 3;
}

// 0 = sum, 1 = min, 2 = max, 3 = first non-INT32_MAX; true identities
__device__ __forceinline__ int neutral(int op) {
  return op == 0 ? 0 : (op == 2 ? INT_MIN : INT_MAX);
}

// a precedes b in the stream
__device__ __forceinline__ int comb(int op, int a, int b) {
  switch (op) {
    case 0: return (int)((unsigned)a + (unsigned)b);
    case 1: return a < b ? a : b;
    case 2: return a > b ? a : b;
    default: return a != INT_MAX ? a : b;
  }
}

struct State {
  int c;     // segment starts
  int v[8];  // reduction since the last start
};

__device__ __forceinline__ State identity(int ops) {
  State s;
  s.c = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l) s.v[l] = neutral(op_of(ops, l));
  return s;
}

// a precedes b
__device__ __forceinline__ State combine(int ops, const State& a,
                                         const State& b) {
  State r;
  r.c = a.c + b.c;
#pragma unroll
  for (int l = 0; l < 8; ++l)
    r.v[l] = b.c > 0 ? b.v[l] : comb(op_of(ops, l), a.v[l], b.v[l]);
  return r;
}

__device__ __forceinline__ State shfl_up(const State& s, int d) {
  State r;
  r.c = __shfl_up_sync(FULL, s.c, d);
#pragma unroll
  for (int l = 0; l < 8; ++l) r.v[l] = __shfl_up_sync(FULL, s.v[l], d);
  return r;
}

__device__ __forceinline__ State shfl_down(const State& s, int d) {
  State r;
  r.c = __shfl_down_sync(FULL, s.c, d);
#pragma unroll
  for (int l = 0; l < 8; ++l) r.v[l] = __shfl_down_sync(FULL, s.v[l], d);
  return r;
}

__device__ __forceinline__ State bcast(const State& s) {
  State r;
  r.c = __shfl_sync(FULL, s.c, 0);
#pragma unroll
  for (int l = 0; l < 8; ++l) r.v[l] = __shfl_sync(FULL, s.v[l], 0);
  return r;
}

__device__ __forceinline__ void publish(int* pay, int* status, const State& s,
                                        int st) {
  pay[0] = s.c;
#pragma unroll
  for (int l = 0; l < 8; ++l) pay[1 + l] = s.v[l];
  __threadfence();
  *(volatile int*)status = st;
}

// The exclusive prefix of tile t > 0, by warp 0 of the tile: lane k waits
// on tile (hi - k) and reads its aggregate or inclusive prefix; the window
// up to the nearest inclusive prefix is reduced in stream order (higher
// lanes hold earlier tiles) and folded in front of what came before.
__device__ State look_back(int ops, int t, const int* status,
                           const int* agg, const int* pre, int lane) {
  State acc = identity(ops);
  for (int hi = t - 1;; hi -= 32) {
    const int k = hi - lane;
    int st = ST_PREFIX;
    State w = identity(ops);  // before the stream: an empty prefix
    if (k >= 0) {
      const volatile int* sp = status + k;
      while ((st = *sp) == 0) __nanosleep(32);
      __threadfence();
      const int* src = (st == ST_PREFIX ? pre : agg) + 9 * (size_t)k;
      w.c = __ldcg(src);
#pragma unroll
      for (int l = 0; l < 8; ++l) w.v[l] = __ldcg(src + 1 + l);
    }
    const unsigned pm = __ballot_sync(FULL, st == ST_PREFIX);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    if (lane > stop) w = identity(ops);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const State o = shfl_down(w, d);
      if (lane + d < 32) w = combine(ops, o, w);
    }
    acc = combine(ops, bcast(w), acc);
    if (pm) return acc;
  }
}

// The lane ops packed 2 bits a lane, as the wrapper passes them
constexpr int opcode(int a, int b, int c, int d, int e, int f, int g, int h) {
  return a | b << 2 | c << 4 | d << 6 | e << 8 | f << 10 | g << 12 | h << 14;
}
// the main path's three op sets (ops/sseg.py CAND_OPS, BLOCK_OPS and
// DEFAULT_OPS: candidate scan, dot-matrix blocks and windows), compiled with
// their ops known; OPS < 0 reads them at run time
constexpr int OPS_CAND = opcode(0, 3, 3, 3, 3, 3, 3, 3);
constexpr int OPS_BLOCK = opcode(0, 1, 1, 2, 2, 3, 0, 3);
constexpr int OPS_WINDOW = opcode(0, 1, 1, 2, 2, 3, 3, 3);

template <int OPS>
__global__ void __launch_bounds__(THREADS, 2)
sseg_onepass(const int* __restrict__ seg_new, const int* __restrict__ v8,
             long long N, int ops_rt, int out_budget, int* __restrict__ out,
             int* count, int* status, int* agg, int* pre, int vec) {
  const int ops = OPS >= 0 ? OPS : ops_rt;
  __shared__ int s_tile;
  __shared__ State s_warp[THREADS / 32];
  __shared__ State s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(status, 1);
  __syncthreads();
  const int t = s_tile;
  int* tstat = status + 1;
  const long long e0 = (long long)t * TILE_N + (long long)tid * ITEMS;

  // ---- load 8 consecutive entries: flags and 8 lanes ----
  const long long enext = e0 + ITEMS;
  const int fnext = enext < N ? seg_new[enext] : 1;
  int f[ITEMS], x[8][ITEMS];
  if (vec && e0 + ITEMS <= N) {
#pragma unroll
    for (int u = 0; u < ITEMS / 4; ++u) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(seg_new + e0) + u);
      f[4 * u] = a.x; f[4 * u + 1] = a.y; f[4 * u + 2] = a.z; f[4 * u + 3] = a.w;
    }
#pragma unroll
    for (int l = 0; l < 8; ++l) {
#pragma unroll
      for (int u = 0; u < ITEMS / 4; ++u) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(v8 + l * N + e0) + u);
        x[l][4 * u] = a.x; x[l][4 * u + 1] = a.y;
        x[l][4 * u + 2] = a.z; x[l][4 * u + 3] = a.w;
      }
    }
  } else {
    // entries past N are unflagged and neutral: they fold into the last
    // segment without changing it
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool in = e0 + k < N;
      f[k] = in ? seg_new[e0 + k] : 0;
#pragma unroll
      for (int l = 0; l < 8; ++l)
        x[l][k] = in ? v8[l * N + e0 + k] : neutral(op_of(ops, l));
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) f[k] = (e0 + k < N) && (e0 + k == 0 || f[k]);

  // ---- thread reduce, warp scan, scan over the warps ----
  State me = identity(ops);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    me.c += f[k];
#pragma unroll
    for (int l = 0; l < 8; ++l)
      me.v[l] = f[k] ? x[l][k] : comb(op_of(ops, l), me.v[l], x[l][k]);
  }
  State inc = me;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const State o = shfl_up(inc, d);
    if (lane >= d) inc = combine(ops, o, inc);
  }
  State texc = shfl_up(inc, 1);
  if (lane == 0) texc = identity(ops);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  State wexc = identity(ops);
  for (int w = 0; w < warp; ++w) wexc = combine(ops, wexc, s_warp[w]);

  // ---- across tiles: publish, look back, publish the prefix ----
  if (warp == 0) {
    State tagg = s_warp[0];
    for (int w = 1; w < THREADS / 32; ++w) tagg = combine(ops, tagg, s_warp[w]);
    State excl = identity(ops);
    if (t > 0) {
      if (lane == 0) publish(agg + 9 * (size_t)t, tstat + t, tagg, ST_AGG);
      excl = look_back(ops, t, tstat, agg, pre, lane);
    }
    if (lane == 0) {
      publish(pre + 9 * (size_t)t, tstat + t, combine(ops, excl, tagg),
              ST_PREFIX);
      s_excl = excl;
    }
  }
  __syncthreads();

  // ---- emit every segment whose last entry is here ----
  State run = combine(ops, combine(ops, s_excl, wexc), texc);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long e = e0 + k;
    if (e >= N) break;
    run.c += f[k];
#pragma unroll
    for (int l = 0; l < 8; ++l)
      run.v[l] = f[k] ? x[l][k] : comb(op_of(ops, l), run.v[l], x[l][k]);
    const bool last = e == N - 1;
    const bool ends = last || (k + 1 < ITEMS ? f[k + 1] != 0 : fnext != 0);
    if (ends) {
      const int r = run.c - 1;
      if (r < out_budget) {
#pragma unroll
        for (int l = 0; l < 8; ++l) out[(long long)l * out_budget + r] = run.v[l];
      }
    }
    if (last) count[0] = run.c;
  }
}

constexpr long long ntiles(long long N) {
  return (N + TILE_N - 1) / TILE_N;
}

}  // namespace

extern "C" int sseg_tile() { return TILE_N; }

// 1 + 19 * ntiles ints: tile counter, status words, aggregates, inclusive
// prefixes
extern "C" long long sseg_scratch_ints(long long N) {
  return 1 + 19 * ntiles(N);
}

// 1 when the lane-op set `ops` runs a specialised instantiation
extern "C" int sseg_specialized(int ops) {
  return ops == OPS_CAND || ops == OPS_BLOCK || ops == OPS_WINDOW;
}

// scratch: sseg_scratch_ints(N) ints; the counter and status words are
// zeroed here
extern "C" int sseg_reduce_compact(const int* seg_new, const int* v8,
                                   long long N, int ops, int out_budget,
                                   int* out, int* count, int* scratch,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = ntiles(N);
  int* status = scratch;  // [0] tile counter, [1 + t] status of tile t
  int* agg = status + 1 + nt;
  int* pre = agg + 9 * nt;
  cudaError_t err = cudaMemsetAsync(status, 0, sizeof(int) * (1 + nt), st);
  if (err != cudaSuccess) return (int)err;
  const int vec = (N % 4 == 0) && ((uintptr_t)seg_new % 16 == 0) &&
                  ((uintptr_t)v8 % 16 == 0);
  auto kernel = ops == OPS_CAND     ? sseg_onepass<OPS_CAND>
                : ops == OPS_BLOCK  ? sseg_onepass<OPS_BLOCK>
                : ops == OPS_WINDOW ? sseg_onepass<OPS_WINDOW>
                                    : sseg_onepass<-1>;
  kernel<<<(unsigned)nt, THREADS, 0, st>>>(seg_new, v8, N, ops, out_budget,
                                           out, count, status, agg, pre, vec);
  return (int)cudaGetLastError();
}
