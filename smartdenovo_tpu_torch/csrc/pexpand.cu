// Segmented broadcast of emitter payloads, for Hopper.
//
// Replaces the Pallas kernel smartdenovo_tpu/ops/pexpand.py expand_emit
// (kernel body _make_kernel).  Emitter e owns the cnt[e] contiguous output
// slots starting at the exclusive cumsum of cnt; each of its three
// payloads (pay, aux, base) is written into all of them.  Slots at or past
// the total (and up to pair_budget) are written as 0.
//
// What bounds it on the H100: HBM bandwidth.  The least traffic is the
// counts of every emitter (4 bytes; the cumsum reads them once), the three
// payloads of the emitters that own a slot (12 bytes) and the three output
// rows (12 bytes a slot): at NE = PB = 2^23 with 3.0 M owners, 0.051 ms at
// 3.35 TB/s.  The kernel this replaces gave every slot a thread that
// binary-searched its emitter in a global cumsum (~23 dependent loads a
// slot), after a separate torch.cumsum: 0.199 ms there.
//
// Design: a merge-path load-balancing search (Green, McColl & Bader, "GPU
// Merge Path", 2012; ModernGPU's load-balancing search) in two launches.
//   - The merged sequence of the emitters' ends (the inclusive cumsum) and
//     the slot indices 0..pair_budget-1, an end going before the slots at
//     or past it, is cut into pieces of PATH = 2048, one a block.  A piece
//     holds at most 2048 emitters and slots together however the counts
//     fall: runs of zeros, one emitter over 100,000 slots, slots past the
//     total.  End i sits at position i + min(end_i, pair_budget) of the
//     merged sequence, so the emitters before cut d are those whose
//     position is below d.
//   - pexpand_scan: the cumsum, one pass with a decoupled look-back over
//     tiles of 4096 counts (csrc/lookback.cuh, as csrc/jpost.cu).  It
//     writes no cumsum: each emitter whose end position passes a cut
//     writes that cut (its index, and the cumsum before it), and the last
//     tile writes the cuts past the last end.
//   - pexpand_expand: a block without slots returns at once.  Otherwise it
//     rebuilds its emitters' ends from their counts (a block scan from the
//     cut's cumsum), each thread walks 8 items of the block's piece of the
//     merge path (one binary search in shared memory to find its start)
//     and notes each slot's emitter in shared memory, and then consecutive
//     threads write aligned groups of 4 slots, three rows of 16-byte
//     stores where pair_budget and the output allow, gathering the
//     payloads.  A block wholly past the total only writes zeros.
//   - Each block's life is a chain of dependent steps (cuts, counts, scan,
//     walk, stores); at 2048 items a block and 6 blocks an SM that chain,
//     not HBM, sets the time.  Twice the items a block, or the payloads
//     staged in shared memory, measured slower.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_ITEMS = 16;                  // counts a scan thread
constexpr int TILE_N = THREADS * SCAN_ITEMS;    // counts a scan tile
constexpr int ITEMS = 8;                        // merge-path items a thread
constexpr int PATH = THREADS * ITEMS;           // merge-path items a block

__host__ __device__ constexpr long long ntiles(long long NE) {
  return (NE + TILE_N - 1) / TILE_N;
}
__host__ __device__ constexpr long long nblocks(long long NE, long long PB) {
  return (NE + PB + PATH - 1) / PATH;
}

// A scan tile's sum of counts; its word: status 2 bits, the sum the high 32
struct Sum {
  unsigned v;
  __device__ static Sum id() { return {0u}; }
  __device__ static Sum combine(const Sum& a, const Sum& b) {
    return {a.v + b.v};
  }
  __device__ Sum shfl_down(int d) const {
    return {__shfl_down_sync(FULL, v, d)};
  }
  __device__ Sum bcast() const { return {__shfl_sync(FULL, v, 0)}; }
  __device__ u64 word(int st) const { return (u64)st | (u64)v << 32; }
  __device__ static Sum of(u64 w) { return {(unsigned)(w >> 32)}; }
};

// Exclusive block scan of one sum a thread (all threads call it); the
// block's total goes to *total.
__device__ __forceinline__ unsigned block_excl(unsigned v, unsigned* s_warp,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned wex = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wex += w < warp ? s_warp[w] : 0u;
    tot += s_warp[w];
  }
  *total = tot;
  return wex + inc - v;
}

__global__ void __launch_bounds__(THREADS)
pexpand_scan(const int* __restrict__ cnt, long long NE, long long PB,
             int* counter, u64* words, int* __restrict__ cut_e,
             int* __restrict__ cut_c, int vec) {
  __shared__ int s_tile;
  __shared__ unsigned s_warp[WARPS];
  __shared__ unsigned s_excl;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int t = s_tile;
  const long long e0 = (long long)t * TILE_N + (long long)tid * SCAN_ITEMS;
  int c[SCAN_ITEMS];
  if (vec && e0 + SCAN_ITEMS <= NE) {
#pragma unroll
    for (int u = 0; u < SCAN_ITEMS / 4; ++u) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(cnt + e0) + u);
      c[4 * u] = a.x; c[4 * u + 1] = a.y; c[4 * u + 2] = a.z; c[4 * u + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) c[i] = e0 + i < NE ? cnt[e0 + i] : 0;
  }
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) mine += (unsigned)c[i];
  unsigned agg;
  const unsigned texc = block_excl(mine, s_warp, &agg);
  if (tid < 32) {
    unsigned excl = 0;
    if (t > 0) {
      if (lane == 0) publish(words + t, Sum{agg}, ST_AGG);
      excl = look_back<Sum>(t, words, lane).v;
    }
    if (lane == 0) {
      publish(words + t, Sum{excl + agg}, ST_PRE);
      s_excl = excl;
    }
  }
  __syncthreads();
  // the cuts d = k * PATH with pos(e - 1) < d <= pos(e) lie before e
  unsigned before = s_excl + texc;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long e = e0 + i;
    if (e >= NE) break;
    const unsigned after = before + (unsigned)c[i];
    const long long pprev = e - 1 + (before < PB ? (long long)before : PB);
    const long long pos = e + (after < PB ? (long long)after : PB);
    for (long long k = (pprev + PATH) / PATH; k <= pos / PATH; ++k) {
      cut_e[k] = (int)e;
      cut_c[k] = (int)before;
    }
    before = after;
  }
  if (t == ntiles(NE) - 1) {  // the cuts past the last end, to the last
    const unsigned total = s_excl + agg;
    const long long plast = NE - 1 + (total < PB ? (long long)total : PB);
    for (long long k = (plast + PATH) / PATH + tid; k <= nblocks(NE, PB);
         k += THREADS) {
      cut_e[k] = (int)NE;
      cut_c[k] = (int)total;
    }
  }
}

// 6 blocks an SM (at most 40 registers a thread): fewer registers spill
__global__ void __launch_bounds__(THREADS, 6)
pexpand_expand(const int* __restrict__ cnt, const int* __restrict__ pay,
               const int* __restrict__ aux, const int* __restrict__ base,
               long long NE, long long PB, const int* __restrict__ cut_e,
               const int* __restrict__ cut_c, int* __restrict__ out,
               int vec) {
  __shared__ int s_end[PATH];  // ends of the emitters the block passes
  __shared__ int s_own[PATH];  // each slot's emitter (from ea), -1: none
  __shared__ unsigned s_warp[WARPS];
  const int tid = threadIdx.x;
  const long long L = NE + PB;
  const long long d0 = (long long)blockIdx.x * PATH;
  const long long d1 = d0 + PATH < L ? d0 + PATH : L;
  const long long ea = cut_e[blockIdx.x], eb = cut_e[blockIdx.x + 1];
  const unsigned cbase = (unsigned)cut_c[blockIdx.x];  // cumsum before ea
  const long long s0 = d0 - ea, s1 = d1 - eb;  // the block's slots [s0, s1)
  if (s0 >= s1) return;
  const int na = (int)(eb - ea), ns = (int)(s1 - s0);
  const bool past = ea == NE;  // every slot here is past the total

  // ---- the ends of emitters ea..eb-1: the cut's cumsum + a block scan ----
  if (!past) {
    int c[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = tid * ITEMS + i;
      c[i] = j < na ? __ldg(cnt + ea + j) : 0;
    }
    unsigned mine = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) mine += (unsigned)c[i];
    unsigned tot;
    unsigned run = cbase + block_excl(mine, s_warp, &tot);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      run += (unsigned)c[i];
      if (tid * ITEMS + i < na) s_end[tid * ITEMS + i] = (int)run;
    }
  }
  __syncthreads();

  // ---- each thread's 8 items of the block's piece of the merge path ----
  const int dd = tid * ITEMS;
  if (!past && dd < na + ns) {
    int lo = dd - ns > 0 ? dd - ns : 0, hi = dd < na ? dd : na;
    while (lo < hi) {  // ends taken before item dd
      const int mid = (lo + hi) >> 1;
      if ((long long)s_end[mid] <= s0 + dd - 1 - mid) lo = mid + 1;
      else hi = mid;
    }
    int a = lo, b = dd - lo;
    const int own_last = eb < NE ? na : -1;  // the open emitter, if any
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (a + b >= na + ns) break;
      if (a < na && (b >= ns || (long long)s_end[a] <= s0 + b)) {
        ++a;
      } else {
        s_own[b++] = a < na ? a : own_last;
      }
    }
  }
  __syncthreads();

  // ---- the three rows, aligned groups of 4 slots a thread ----
  int* o0 = out;
  int* o1 = out + PB;
  int* o2 = out + 2 * PB;
  for (long long g = (s0 >> 2) + tid; g <= (s1 - 1) >> 2; g += THREADS) {
    int v0[4], v1[4], v2[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long s = 4 * g + u;
      const int o = (!past && s >= s0 && s < s1) ? s_own[s - s0] : -1;
      v0[u] = o >= 0 ? __ldg(pay + ea + o) : 0;
      v1[u] = o >= 0 ? __ldg(aux + ea + o) : 0;
      v2[u] = o >= 0 ? __ldg(base + ea + o) : 0;
    }
    if (vec && 4 * g >= s0 && 4 * g + 4 <= s1) {
      *reinterpret_cast<int4*>(o0 + 4 * g) = make_int4(v0[0], v0[1], v0[2], v0[3]);
      *reinterpret_cast<int4*>(o1 + 4 * g) = make_int4(v1[0], v1[1], v1[2], v1[3]);
      *reinterpret_cast<int4*>(o2 + 4 * g) = make_int4(v2[0], v2[1], v2[2], v2[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long s = 4 * g + u;
        if (s < s0 || s >= s1) continue;
        o0[s] = v0[u];
        o1[s] = v1[u];
        o2[s] = v2[u];
      }
    }
  }
}

}  // namespace

// ints of scratch that pexpand_expand_emit needs: the tile counter (padded
// to 16 bytes), a word a scan tile, and two ints a cut
extern "C" long long pexpand_scratch_ints(long long NE, long long PB) {
  return 4 + 2 * ntiles(NE) + 2 * (nblocks(NE, PB) + 1);
}

// cnt: [NE] counts >= 0 (their total below 2^31); out: [3, PB]; scratch:
// pexpand_scratch_ints(NE, PB) ints, whose counter and tile words are
// zeroed here
extern "C" int pexpand_expand_emit(const int* cnt, const int* pay,
                                   const int* aux, const int* base,
                                   long long NE, long long PB, int* out,
                                   int* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = ntiles(NE), nb = nblocks(NE, PB);
  u64* words = reinterpret_cast<u64*>(scratch + 4);
  int* cut_e = scratch + 4 + 2 * nt;
  int* cut_c = cut_e + nb + 1;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(int) * (4 + 2 * nt), st);
  if (err != cudaSuccess) return (int)err;
  pexpand_scan<<<(unsigned)nt, THREADS, 0, st>>>(
      cnt, NE, PB, scratch, words, cut_e, cut_c, (uintptr_t)cnt % 16 == 0);
  const int vec = PB % 4 == 0 && (uintptr_t)out % 16 == 0;
  pexpand_expand<<<(unsigned)nb, THREADS, 0, st>>>(
      cnt, pay, aux, base, NE, PB, cut_e, cut_c, out, vec);
  return (int)cudaGetLastError();
}
