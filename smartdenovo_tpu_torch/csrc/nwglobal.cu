// Batched global (Needleman-Wunsch) alignment with a direction plane, for
// Hopper.
//
// Replaces smartdenovo_tpu/ops/swdp.py:32 batch_global_align, which is
// `jax.jit` over `lax.scan` (:88), not a Pallas kernel: a linear-gap DP of
// B pairs over the 2L + 1 anti-diagonals of an (L + 1) x (L + 1) grid,
// whose output is the score at (alen, blen) and one move byte for every
// cell of every diagonal, dirs[k, d, i] for cell (i, d - i).
//
// What bounds it on the H100.  The plane is B (2L + 1)(L + 1) bytes, every
// one of which is written (STOP outside i <= alen, j <= blen), and the
// live cells are sum (alen + 1)(blen + 1) at ~12 int32 operations each.
// At chip_smoke.py's B 2,048, L 512 the two bounds are both ~0.3 ms: the
// 1.08 GB plane over 3.35 TB/s, and ~4e8 cells over 16.7 T int32 op/s.
//
// Design (simple first).  One block of 256 threads a pair; the threads
// stride the L + 1 rows of a diagonal, compute the live rows
// [max(0, d - blen), min(alen, d)] and store every row's byte, so a warp
// stores 32 consecutive bytes of the plane (coalesced along i).  The
// three diagonals in flight (d - 2, d - 1, d) rotate through three
// (L + 1)-int buffers in shared memory, 24.6 KB at L 2,048; past the
// 227 KB a block may take (L >= 19,370) the same kernel keeps them in a
// global scratch of [B, 3, L + 1] ints.  One __syncthreads a diagonal
// orders the writes of diagonal d before the reads of d + 1 and d + 2.
// A live interior cell reads only live cells of the two earlier
// diagonals, so the buffers need no initialisation and stale values
// outside the live rows are never read.  Codes come from the read-only
// cache (each row's a[i - 1] is the same for every diagonal).
//
// Integer semantics are the JAX version's: ties DIAG > UP > LEFT; a match
// needs equal codes below 4; row 0 and column 0 are gap * j (LEFT) and
// gap * i (UP), the origin 0 (STOP); every sum is int32.  Lengths are
// taken in [0, L] (the wrapper's contract; the kernel clamps them).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint8_t STOP = 0, DIAG = 1, UP = 2, LEFT = 3;
constexpr int THREADS = 256;
constexpr size_t SMEM_MAX = 232448;   // shared memory a block can use

__global__ void __launch_bounds__(THREADS)
nw_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
          const int* __restrict__ alen_p, const int* __restrict__ blen_p,
          int L, int match, int mismatch, int gap, int in_smem,
          int* __restrict__ scratch, int* __restrict__ score,
          uint8_t* __restrict__ dirs) {
  extern __shared__ int smem[];
  const int k = blockIdx.x;
  const int W = L + 1;
  int* H = in_smem ? smem : scratch + (size_t)k * 3 * W;
  const uint8_t* ak = a + (size_t)k * L;
  const uint8_t* bk = b + (size_t)k * L;
  const int alen = min(max(alen_p[k], 0), L);
  const int blen = min(max(blen_p[k], 0), L);
  uint8_t* dk = dirs + (size_t)k * (2 * L + 1) * W;
  for (int d = 0; d <= 2 * L; ++d) {
    int* hc = H + (d % 3) * W;                // diagonal d
    const int* h1 = H + ((d + 2) % 3) * W;    // d - 1
    const int* h2 = H + ((d + 1) % 3) * W;    // d - 2
    const int lo = max(0, d - blen), hi = min(alen, d);
    uint8_t* drow = dk + (size_t)d * W;
    for (int i = threadIdx.x; i < W; i += THREADS) {
      uint8_t mv = STOP;
      if (i >= lo && i <= hi) {
        const int j = d - i;
        int h;
        if (i == 0) {
          h = gap * j;
          mv = j ? LEFT : STOP;
        } else if (j == 0) {
          h = gap * i;
          mv = UP;
        } else {
          const int ac = __ldg(ak + i - 1), bc = __ldg(bk + j - 1);
          const int dg = h2[i - 1] + ((ac == bc && ac < 4) ? match : mismatch);
          const int up = h1[i - 1] + gap;
          const int left = h1[i] + gap;
          h = max(dg, max(up, left));
          mv = h == dg ? DIAG : (h == up ? UP : LEFT);
        }
        hc[i] = h;
        if (i == alen && j == blen) score[k] = h;
      }
      drow[i] = mv;
    }
    __syncthreads();
  }
}

}  // namespace

// a, b [B, L] u8 codes; alen, blen [B] i32; in_smem: the three diagonals
// in shared memory (3 (L + 1) ints must fit), else in scratch [B, 3, L + 1]
// i32; score [B] i32 and dirs [B, 2L + 1, L + 1] u8 out.
extern "C" int nwglobal_align(const uint8_t* a, const uint8_t* b,
                              const int* alen, const int* blen, int B, int L,
                              int match, int mismatch, int gap, int in_smem,
                              int* scratch, int* score, uint8_t* dirs,
                              void* stream) {
  if (B <= 0 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? (size_t)3 * (L + 1) * sizeof(int) : 0;
  if (smem > SMEM_MAX || (!in_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nw_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      a, b, alen, blen, L, match, mismatch, gap, in_smem, scratch, score,
      dirs);
  return (int)cudaGetLastError();
}
