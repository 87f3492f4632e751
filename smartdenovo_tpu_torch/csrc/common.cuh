// Shared pieces of the streaming kernels: one entry per thread, TILE
// threads per block, block-wide scans built from warp shuffles, and a
// one-block scan over the per-tile totals that carries values across
// tiles (Hopper blocks run in no particular order, so nothing is carried
// from one block to the next inside a kernel).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace sdk {

constexpr int TILE = 1024;  // entries per block == threads per block

struct SumOp {
  __device__ static int id() { return 0; }
  // int32 sums wrap like the JAX int32 arithmetic they replace
  __device__ static int op(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
  }
};

struct MaxOp {
  __device__ static int id() { return INT_MIN; }
  __device__ static int op(int a, int b) { return a > b ? a : b; }
};

// Inclusive scan of one value per thread over a block of exactly TILE
// threads.  `warp_tot` is 32 ints of shared scratch.  Contains barriers:
// every thread of the block must call it.
template <class Op>
__device__ int block_incl_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, s);
    if (lane >= s) v = Op::op(u, v);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w = Op::op(u, w);
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = Op::op(warp_tot[warp - 1], v);
  __syncthreads();
  return v;
}

// Thread k of a one-block launch owns the tiles [chunk_lo, chunk_hi).
__device__ inline void chunk_of(long long n, long long* lo, long long* hi) {
  const long long c = (n + TILE - 1) / TILE;
  *lo = min(n, (long long)threadIdx.x * c);
  *hi = min(n, *lo + c);
}

// Exclusive scan of in[0, n) into out[0, n) by one block of TILE
// threads; returns the total.  `sh` is TILE ints and `warp_tot` 32 ints
// of shared scratch.  `in` and `out` must not alias.
template <class Op>
__device__ int block_excl_scan_array(const int* in, int* out, long long n,
                                     int* sh, int* warp_tot) {
  long long lo, hi;
  chunk_of(n, &lo, &hi);
  int agg = Op::id();
  for (long long u = lo; u < hi; ++u) agg = Op::op(agg, in[u]);
  sh[threadIdx.x] = block_incl_scan<Op>(agg, warp_tot);
  __syncthreads();
  int run = threadIdx.x ? sh[threadIdx.x - 1] : Op::id();
  const int total = sh[TILE - 1];
  for (long long u = lo; u < hi; ++u) {
    out[u] = run;
    run = Op::op(run, in[u]);
  }
  __syncthreads();
  return total;
}

}  // namespace sdk
