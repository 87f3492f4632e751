// Sorted-segment reduce + compact, for Hopper.
//
// Replaces the Pallas kernel smartdenovo_tpu/ops/sseg.py
// seg_reduce_compact (kernel body _make_kernel).  A stream of N entries
// carries a 0/1 segment-start flag and 8 int32 lanes; every segment
// becomes one record [8] in stream order, each lane reduced by its own op
// (sum, min, max, or "first value that is not INT32_MAX").  Entry 0 always
// opens a segment; the open tail segment is the last record;
// count = number of segments, and records at or past out_budget are
// dropped (count still reports them, so the caller can redispatch).
//
// Bound: HBM bandwidth.  Each entry is 36 bytes read per pass and the
// work per entry is a few integer ops; the records written are few.  At
// N = 2^24 a pass reads 600 MB, ~0.2 ms at the H100's 3.35 TB/s.
//
// Design.  The TPU kernel carried the open segment from tile to tile in
// scratch memory because its grid runs in order.  Hopper blocks run in
// any order, so the carry is computed explicitly in three launches:
//   1. tile summary: per 1024-entry tile, the number of segment starts
//      and the ordered reduction of the entries before its first start
//      (the part of a segment that began in an earlier tile);
//   2. carry (one block): the exclusive scan of the start counts gives
//      each tile's first record index; a reverse segmented scan of the
//      tile heads gives, for each tile, the reduction of everything after
//      it that still belongs to its last open segment — so a segment that
//      spans thousands of tiles (the dead tail of a budget-wide stream)
//      costs one value per tile, not one thread walking millions;
//   3. emit: per tile, a segmented inclusive scan in shared memory; the
//      thread at the end of each piece writes its record at
//      tile offset + in-tile rank, adding the carry at the tile's end.
// Passes 1 and 3 both read the stream (2x the minimum traffic); fusing
// them with a decoupled look-back is later work.
#include "common.cuh"

using namespace sdk;

namespace {

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

// Entries past N are unflagged and neutral, so they fold into the last
// segment without changing it.
__device__ void load_tile(const int* seg_new, const int* v8, long long N,
                          int ops, long long t, int* sf, int (*sx)[TILE]) {
  const int i = threadIdx.x;
  const long long j = t * TILE + i;
  const bool in = j < N;
  sf[i] = in && (j == 0 || seg_new[j] != 0);
#pragma unroll
  for (int l = 0; l < 8; ++l)
    sx[l][i] = in ? v8[l * N + j] : neutral(op_of(ops, l));
}

__global__ void __launch_bounds__(TILE)
sseg_tile_summary(const int* seg_new, const int* v8, long long N, int ops,
                  long long nt, int* tcnt, int* thead) {
  __shared__ int sx[8][TILE];
  __shared__ int sf[TILE];
  __shared__ int first;
  const int i = threadIdx.x;
  const long long t = blockIdx.x;
  if (i == 0) first = TILE;
  load_tile(seg_new, v8, N, ops, t, sf, sx);
  __syncthreads();
  if (sf[i]) atomicMin(&first, i);
  const int cnt = __syncthreads_count(sf[i]);
  const int f = first;
  if (i >= f) {
#pragma unroll
    for (int l = 0; l < 8; ++l) sx[l][i] = neutral(op_of(ops, l));
  }
  // ordered tree reduction: the left operand always precedes the right
  for (int s = 1; s < TILE; s <<= 1) {
    __syncthreads();
    if ((i & (2 * s - 1)) == 0) {
#pragma unroll
      for (int l = 0; l < 8; ++l)
        sx[l][i] = comb(op_of(ops, l), sx[l][i], sx[l][i + s]);
    }
  }
  __syncthreads();
  if (i < 8) thead[i * nt + t] = sx[i][0];
  if (i == 0) tcnt[t] = cnt;
}

__global__ void __launch_bounds__(TILE)
sseg_carry(const int* tcnt, const int* thead, long long nt, int ops,
           int* toff, int* tcont, int* count) {
  __shared__ int sh[TILE];
  __shared__ int wt[32];
  __shared__ int agg[8][TILE];
  __shared__ int aflag[TILE];
  const int k = threadIdx.x;
  const int total = block_excl_scan_array<SumOp>(tcnt, toff, nt, sh, wt);
  if (k == 0) count[0] = total;
  // R[u] = head[u] if tile u holds a start, else head[u] (+) R[u+1];
  // tcont[u] = R[u + 1], R[nt] = neutral.  Each thread folds its chunk of
  // tiles right to left, thread 0 chains the chunk aggregates, then each
  // chunk is folded again with its true incoming value.
  long long lo, hi;
  chunk_of(nt, &lo, &hi);
  int a[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = neutral(op_of(ops, l));
  int anyf = 0;
  for (long long u = hi - 1; u >= lo; --u) {
    const bool st = tcnt[u] > 0;
    anyf |= st;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int h = thead[l * nt + u];
      a[l] = st ? h : comb(op_of(ops, l), h, a[l]);
    }
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) agg[l][k] = a[l];
  aflag[k] = anyf;
  __syncthreads();
  if (k == 0) {
    int c[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) c[l] = neutral(op_of(ops, l));
    for (int m = TILE - 1; m >= 0; --m) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const int x = agg[l][m];
        agg[l][m] = c[l];  // incoming value of chunk m
        c[l] = aflag[m] ? x : comb(op_of(ops, l), x, c[l]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = agg[l][k];
  for (long long u = hi - 1; u >= lo; --u) {
    const bool st = tcnt[u] > 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      tcont[l * nt + u] = a[l];
      const int h = thead[l * nt + u];
      a[l] = st ? h : comb(op_of(ops, l), h, a[l]);
    }
  }
}

__global__ void __launch_bounds__(TILE)
sseg_emit(const int* seg_new, const int* v8, long long N, int ops,
          long long nt, const int* toff, const int* tcont, int out_budget,
          int* out) {
  __shared__ int sx[8][TILE];
  __shared__ int sf[TILE];
  __shared__ int sflag[TILE];
  __shared__ int wt[32];
  const int i = threadIdx.x;
  const long long t = blockIdx.x;
  load_tile(seg_new, v8, N, ops, t, sf, sx);
  const int flag = sf[i];
  sflag[i] = flag;
  const int rank = block_incl_scan<SumOp>(flag, wt);  // barriers inside
  // segmented inclusive scan (Hillis-Steele) over (flag, 8 lanes)
  for (int s = 1; s < TILE; s <<= 1) {
    const int f = sf[i];
    int fs = 0;
    int y[8];
    if (i >= s) {
      fs = sf[i - s];
      if (!f) {
#pragma unroll
        for (int l = 0; l < 8; ++l)
          y[l] = comb(op_of(ops, l), sx[l][i - s], sx[l][i]);
      }
    }
    __syncthreads();
    if (i >= s) {
      sf[i] = f | fs;
      if (!f) {
#pragma unroll
        for (int l = 0; l < 8; ++l) sx[l][i] = y[l];
      }
    }
    __syncthreads();
  }
  const bool last = i == TILE - 1;
  // the end of a piece that began with a start inside this tile
  if (sf[i] && (last || sflag[i + 1])) {
    const long long k = (long long)toff[t] + rank - 1;
    if (k < out_budget) {
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        int v = sx[l][i];
        if (last) v = comb(op_of(ops, l), v, tcont[l * nt + t]);
        out[l * (long long)out_budget + k] = v;
      }
    }
  }
}

}  // namespace

// scratch: 18 * ntiles ints (tcnt, toff, thead[8], tcont[8])
extern "C" int sseg_reduce_compact(const int* seg_new, const int* v8,
                                   long long N, int ops, int out_budget,
                                   int* out, int* count, int* scratch,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (N + TILE - 1) / TILE;
  int* tcnt = scratch;
  int* toff = tcnt + nt;
  int* thead = toff + nt;
  int* tcont = thead + 8 * nt;
  sseg_tile_summary<<<(unsigned)nt, TILE, 0, st>>>(seg_new, v8, N, ops, nt,
                                                   tcnt, thead);
  sseg_carry<<<1, TILE, 0, st>>>(tcnt, thead, nt, ops, toff, tcont, count);
  sseg_emit<<<(unsigned)nt, TILE, 0, st>>>(seg_new, v8, N, ops, nt, toff,
                                           tcont, out_budget, out);
  return (int)cudaGetLastError();
}
