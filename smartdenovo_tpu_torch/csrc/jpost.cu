// Join-matcher emitter extraction, for Hopper.
//
// Replaces the Pallas kernel smartdenovo_tpu/ops/jpost.py join_emitters
// (kernel body _make_kernel).  Input: the sorted join stream (key, pay,
// aux), key = q<<(zb+1) | zmer<<1 | side, INT32_MAX past the live prefix.
// Per entry: pre0 = number of query entries (side 0) before it; rs = pre0
// at the start of its (q, zmer) run; qcnt = pre0 - rs.  Emitters are
// candidate entries (side 1) with 1 <= qcnt < max_per_read.  Output: the
// emitters' records [qcnt, pay, aux, rs - ost2] in stream order (ost2 =
// exclusive sum of qcnt over earlier emitters; rows 4-7 zero), the
// emitter count and the total sum of qcnt.
//
// Bound: HBM bandwidth — 12 bytes per entry per pass, a few integer ops.
//
// Design.  The TPU kernel ran the three scans (pre0, the run-start
// cummax, the output prefix ost2) tile after tile with scalar carries in
// SMEM.  Here each scan's carry across tiles comes from a one-block scan
// of per-tile totals, in five launches:
//   A  per tile: query-entry count, and the local pre0 at its last run
//      start;
//   cA one block: pre0 offset per tile (exclusive sum), run-start carry
//      per tile (exclusive max of the tiles' last run-start pre0 — pre0
//      is monotone, so a max is the latest value);
//   B  per tile: qcnt of every entry, tile sums of qcnt and emitters;
//   cB one block: output-slot and record offsets per tile, and the two
//      totals;
//   C  per tile: recompute, and write each emitter's record at its
//      global rank (the compaction).
// Passes A, B and C each read the stream once (3x the minimum traffic);
// a decoupled look-back would fuse them — later work.
#include "common.cuh"

using namespace sdk;

namespace {

struct Entry {
  int tag0, tag1, run_new;
};

__device__ __forceinline__ Entry entry_at(const int* key, long long N,
                                          long long j) {
  Entry e{0, 0, 0};
  if (j >= N) return e;
  const int k = key[j];
  const bool sv = k != INT_MAX;
  e.tag0 = sv && !(k & 1);
  e.tag1 = sv && (k & 1);
  e.run_new = j == 0 || (key[j - 1] >> 1) != (k >> 1);
  return e;
}

__global__ void __launch_bounds__(TILE)
jpost_tile_a(const int* key, long long N, int* c0t, int* lrst) {
  __shared__ int wt[32];
  __shared__ int last_rs;
  const int i = threadIdx.x;
  const long long t = blockIdx.x;
  const Entry e = entry_at(key, N, t * TILE + i);
  if (i == 0) last_rs = -1;
  const int incl = block_incl_scan<SumOp>(e.tag0, wt);
  if (e.run_new) atomicMax(&last_rs, i);
  __syncthreads();
  const int lr = last_rs;
  if (i == TILE - 1) c0t[t] = incl;
  if (i == lr) lrst[t] = incl - e.tag0;
  if (i == 0 && lr < 0) lrst[t] = -1;
}

__global__ void __launch_bounds__(TILE)
jpost_carry_a(const int* c0t, const int* lrst, long long nt, int* pre0_off,
              int* rs_carry, int* rsv) {
  __shared__ int sh[TILE];
  __shared__ int wt[32];
  block_excl_scan_array<SumOp>(c0t, pre0_off, nt, sh, wt);
  long long lo, hi;
  chunk_of(nt, &lo, &hi);
  for (long long u = lo; u < hi; ++u)
    rsv[u] = lrst[u] >= 0 ? pre0_off[u] + lrst[u] : -1;
  __syncthreads();
  block_excl_scan_array<MaxOp>(rsv, rs_carry, nt, sh, wt);
}

struct State {
  Entry e;
  int rs, cnt2;
};

// qcnt bookkeeping of this thread's entry (all threads must call it)
__device__ State state_at(const int* key, long long N, long long t,
                          const int* pre0_off, const int* rs_carry, int mpr,
                          int* wt) {
  State s;
  s.e = entry_at(key, N, t * TILE + threadIdx.x);
  const int pre0 =
      pre0_off[t] + block_incl_scan<SumOp>(s.e.tag0, wt) - s.e.tag0;
  const int rl = block_incl_scan<MaxOp>(s.e.run_new ? pre0 : -1, wt);
  s.rs = max(rl, rs_carry[t]);
  const int qcnt = pre0 - s.rs;
  s.cnt2 = (s.e.tag1 && qcnt > 0 && qcnt < mpr) ? qcnt : 0;
  return s;
}

__global__ void __launch_bounds__(TILE)
jpost_tile_b(const int* key, long long N, const int* pre0_off,
             const int* rs_carry, int mpr, int* s2t, int* et) {
  __shared__ int wt[32];
  const long long t = blockIdx.x;
  const State s = state_at(key, N, t, pre0_off, rs_carry, mpr, wt);
  const int c2 = block_incl_scan<SumOp>(s.cnt2, wt);
  const int ce = block_incl_scan<SumOp>(s.cnt2 > 0, wt);
  if (threadIdx.x == TILE - 1) {
    s2t[t] = c2;
    et[t] = ce;
  }
}

__global__ void __launch_bounds__(TILE)
jpost_carry_b(const int* s2t, const int* et, long long nt, int* ost_off,
              int* eoff, int* totals) {
  __shared__ int sh[TILE];
  __shared__ int wt[32];
  const int total2 = block_excl_scan_array<SumOp>(s2t, ost_off, nt, sh, wt);
  const int nem = block_excl_scan_array<SumOp>(et, eoff, nt, sh, wt);
  if (threadIdx.x == 0) {
    totals[0] = nem;
    totals[1] = total2;
  }
}

__global__ void __launch_bounds__(TILE)
jpost_emit(const int* key, const int* pay, const int* aux, long long N,
           const int* pre0_off, const int* rs_carry, const int* ost_off,
           const int* eoff, int mpr, int out_budget, int* out) {
  __shared__ int wt[32];
  const long long t = blockIdx.x;
  const State s = state_at(key, N, t, pre0_off, rs_carry, mpr, wt);
  const int em = s.cnt2 > 0;
  const int ost2 = ost_off[t] + block_incl_scan<SumOp>(s.cnt2, wt) - s.cnt2;
  const int rank = block_incl_scan<SumOp>(em, wt) - em;
  if (em) {
    const long long r = (long long)eoff[t] + rank;
    if (r < out_budget) {
      const long long j = t * TILE + threadIdx.x;
      const long long ob = out_budget;
      out[r] = s.cnt2;
      out[ob + r] = pay[j];
      out[2 * ob + r] = aux[j];
      out[3 * ob + r] = s.rs - ost2;
      out[4 * ob + r] = 0;
      out[5 * ob + r] = 0;
      out[6 * ob + r] = 0;
      out[7 * ob + r] = 0;
    }
  }
}

}  // namespace

// scratch: 9 * ntiles ints; totals: [n_emitters, total_slots]
extern "C" int jpost_join_emitters(const int* key, const int* pay,
                                   const int* aux, long long N, int mpr,
                                   int out_budget, int* out, int* totals,
                                   int* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (N + TILE - 1) / TILE;
  int* c0t = scratch;
  int* lrst = c0t + nt;
  int* pre0_off = lrst + nt;
  int* rs_carry = pre0_off + nt;
  int* rsv = rs_carry + nt;
  int* s2t = rsv + nt;
  int* et = s2t + nt;
  int* ost_off = et + nt;
  int* eoff = ost_off + nt;
  const unsigned g = (unsigned)nt;
  jpost_tile_a<<<g, TILE, 0, st>>>(key, N, c0t, lrst);
  jpost_carry_a<<<1, TILE, 0, st>>>(c0t, lrst, nt, pre0_off, rs_carry, rsv);
  jpost_tile_b<<<g, TILE, 0, st>>>(key, N, pre0_off, rs_carry, mpr, s2t, et);
  jpost_carry_b<<<1, TILE, 0, st>>>(s2t, et, nt, ost_off, eoff, totals);
  jpost_emit<<<g, TILE, 0, st>>>(key, pay, aux, N, pre0_off, rs_carry,
                                 ost_off, eoff, mpr, out_budget, out);
  return (int)cudaGetLastError();
}
