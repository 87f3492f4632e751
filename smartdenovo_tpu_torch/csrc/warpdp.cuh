// Pieces shared by the one-warp-per-read DP kernels of banded.cu and
// refine.cu: the band-lane layout of a warp's row buffers in shared memory,
// the warp max-scan, the direction-byte stores, the launch shape, and the
// traceback walk with its cp.async ring.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace warpdp {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RING_BYTES = 8192;  // `dirs` bytes of one traceback ring buffer
constexpr int MV_BYTES = 256;     // moves a walk gathers before the warp writes them
constexpr int MAX_WARPS = 4;      // reads a block, one per SM sub-partition
// Added to the carry into lane 0 of a row's gap scan, which has none: far
// below any score (scores stay above -2^29), far above int32's floor.
constexpr int NO_CARRY = -(1 << 30);

// One ring buffer: R = RING_BYTES / W `dirs` rows [lo, hi), then the R + 1
// bases of rows lo - 1 .. hi - 1, so a walk step reads nothing but shared
// memory.
__host__ __device__ constexpr int ring_buf(int W) {
  return RING_BYTES + ((4 * (RING_BYTES / W + 1) + 15) & ~15);
}

// A warp's shared memory: the DP's row buffers (dp_bytes), which the ring's
// two buffers and the move buffer reuse once the DP is done.
__host__ __device__ constexpr int warp_bytes(int W, int dp_bytes) {
  return dp_bytes > 2 * ring_buf(W) + MV_BYTES ? dp_bytes
                                               : 2 * ring_buf(W) + MV_BYTES;
}

// Lane l of the warp owns the P band lanes k = P l .. P l + P - 1.  A row
// buffer holds band lane k at (k % P) * 32 + k / P: the P reads of a
// thread at k + s each touch 32 consecutive words across the warp, for
// any shift s, so no read or write has a bank conflict.
template <int P>
__device__ __forceinline__ int sw(int k) {
  return (k % P) * 32 + k / P;
}

// The carry of a max-plus gap scan into each lane: with O the lane's last
// local value, the lane's gap per band lane g and P band lanes a lane,
// returns X such that X + g (P (lane - 1) + q + 1) is the best that the
// lanes before this one reach at its cell q (lane 0 has none and gets an
// arbitrary score: the caller adds NO_CARRY there).  An exclusive max-scan
// of O - g P lane in three radix-4 rounds: lane l takes the lanes l - 1 ..
// l - 4, then l - 4, l - 8, l - 12 of that, then l - 16 (a source below
// lane 0 reads lane 0, whose value lies before every lane but itself), so
// three rounds of shuffle latency where a radix-2 scan and its shift take
// six.  src holds the seven source lanes (scan_sources).  fill(level)
// (level 0 .. 5) places the caller's work that does not wait on the scan
// between the rounds, where it runs while the shuffles are in flight.
struct ScanSrc {
  int s[7];  // lane - 1, - 2, - 3, - 4, - 8, - 12, - 16, each at least 0
};
__device__ __forceinline__ ScanSrc scan_sources(int lane) {
  constexpr int d[7] = {1, 2, 3, 4, 8, 12, 16};
  ScanSrc src;
#pragma unroll
  for (int k = 0; k < 7; ++k) src.s[k] = max(lane - d[k], 0);
  return src;
}
template <class Fill>
__device__ __forceinline__ int warp_carry(int O, int gP_lane, const ScanSrc& src,
                                         Fill&& fill) {
  const int v = O - gP_lane;
  int w;
  {
    const int u1 = __shfl_sync(FULL, v, src.s[0]), u2 = __shfl_sync(FULL, v, src.s[1]),
              u3 = __shfl_sync(FULL, v, src.s[2]), u4 = __shfl_sync(FULL, v, src.s[3]);
    fill(0);
    fill(1);
    w = __vimax3_s32(u1, u2, max(u3, u4));
  }
  {
    const int u1 = __shfl_sync(FULL, w, src.s[3]), u2 = __shfl_sync(FULL, w, src.s[4]),
              u3 = __shfl_sync(FULL, w, src.s[5]);
    fill(2);
    fill(3);
    w = __vimax3_s32(w, u1, max(u2, u3));
  }
  const int u = __shfl_sync(FULL, w, src.s[6]);
  fill(4);
  fill(5);
  return max(w, u);
}

// warp_carry with a payload, for a scan that keeps the count of the source
// that reaches each carry (csrc/swwide.cu): with (O, OC) the lane's last
// value and its count, returns X' such that X' + g P (lane - 1) is the
// carry at the lane's cell before its first (as warp_carry's X; lane 0
// gets its own value: the caller has no carry there) and sets XC to the
// count of its source lane, the nearest one on a tie (the JAX scan keeps
// the right operand).  The three radix-4 rounds run on keys
// (max(O, floor) - g P lane) 32 + lane, so a tie of value goes to the
// higher lane, and the count comes with one shuffle from the winning lane.
// The caller picks floor so that a value clamped there can win no carry it
// would have lost, and the keys fit in 32 bits.
__device__ __forceinline__ int warp_carry_payload(int O, int OC, int gP_lane, int floor,
                                                  int lane, const ScanSrc& src,
                                                  int& XC) {
  const int key = (max(O, floor) - gP_lane) * 32 + lane;
  int w;
  {
    const int u1 = __shfl_sync(FULL, key, src.s[0]), u2 = __shfl_sync(FULL, key, src.s[1]),
              u3 = __shfl_sync(FULL, key, src.s[2]), u4 = __shfl_sync(FULL, key, src.s[3]);
    w = __vimax3_s32(u1, u2, max(u3, u4));
  }
  {
    const int u1 = __shfl_sync(FULL, w, src.s[3]), u2 = __shfl_sync(FULL, w, src.s[4]),
              u3 = __shfl_sync(FULL, w, src.s[5]);
    w = __vimax3_s32(w, u1, max(u2, u3));
  }
  w = max(w, __shfl_sync(FULL, w, src.s[6]));
  XC = __shfl_sync(FULL, OC, w & 31);
  return w >> 5;
}

// The P direction bytes of a thread, packed four a word, to dst (the
// thread's P bytes of a row of W = 32 P bytes): one store where the
// alignment allows it.
template <int P>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const unsigned (&wd)[(P + 3) / 4]) {
  if constexpr (P % 16 == 0) {
#pragma unroll
    for (int g = 0; g < P / 16; ++g)
      reinterpret_cast<uint4*>(dst)[g] =
          make_uint4(wd[4 * g], wd[4 * g + 1], wd[4 * g + 2], wd[4 * g + 3]);
  } else if constexpr (P % 8 == 0) {
#pragma unroll
    for (int g = 0; g < P / 8; ++g)
      reinterpret_cast<uint2*>(dst)[g] = make_uint2(wd[2 * g], wd[2 * g + 1]);
  } else if constexpr (P % 4 == 0) {
#pragma unroll
    for (int g = 0; g < P / 4; ++g) reinterpret_cast<unsigned*>(dst)[g] = wd[g];
  } else if constexpr (P == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)wd[0];
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) dst[q] = (uint8_t)(wd[q / 4] >> (8 * (q % 4)));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// d = the byte of the table {lo, hi} (bytes 0 .. 7) that sel picks,
// sign-extended: a row's score table looked up by a code's selector
__device__ __forceinline__ int prmt(unsigned lo, unsigned hi, int sel) {
  int d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}
// the prmt selector of table byte c (0 .. 7) that copies the byte into
// the low byte and its sign into the other three
__host__ __device__ constexpr int sub_sel(int c) { return c | ((c | 8) * 0x1110); }
// shared-memory loads at 32-bit shared addresses (the walk's address
// arithmetic stays in 32 bits)
__device__ __forceinline__ int lds_u8(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return (int)v;
}
__device__ __forceinline__ int lds_s32(unsigned a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// Chunk c of the ring holds the `dirs` rows [lo, hi) with hi = rows - c R
// and their bases, in ring buffer c & 1.  The whole warp copies it (W is a
// multiple of 32, so every row and chunk is 16-byte aligned; the bases go
// four bytes at a time); a walk's row index only falls, so chunk c + 1 can
// be in flight while the warp walks chunk c.
__device__ __forceinline__ void ring_prefetch(uint8_t* ring, const uint8_t* drow,
                                              const int* base, int rows, int W,
                                              int c, int lane) {
  const int R = RING_BYTES / W;
  const int hi = max(rows - c * R, 0), lo = max(hi - R, 0);
  const int n = (hi - lo) * W;
  const uint8_t* src = drow + (size_t)lo * W;
  uint8_t* dst = ring + (c & 1) * ring_buf(W);
  for (int k = lane * 16; k < n; k += 32 * 16) cp_async16(dst + k, src + k);
  int* bs = reinterpret_cast<int*>(dst + RING_BYTES);
  for (int t = lane; t <= hi - lo; t += 32) cp_async4(bs + t, base + max(lo - 1 + t, 0));
  cp_async_commit();
}

// The traceback walk of read r from (i, j) = (rows - 1, j).  Every lane
// takes the same steps out of the ring (its shared loads are broadcasts),
// so the loop is uniform: no divergence, no broadcast of the state.
// `step(z, i, j, di, dj)` turns the direction byte z of the cell (0 off
// the band) into the move code it returns, with di / dj 1 where the move
// leaves the row / column; a move of `noop` ends the walk (it would repeat
// in place, and the moves past the end are `noop`), as does reaching (0,
// 0).  A step's chain is the load of its byte and the few operations from
// it to the next cell's address: the byte loads from a clamped lane and is
// dropped off the band (no predicate before the load), the base of the
// row below loads beside it, and no value loaded in one step is carried
// into the next (a loop-carried load result costs a register move that
// waits for it).  The moves gather in a shared buffer that the warp writes
// to mvs[s * B + r] a block at a time.  Returns the final j.
template <class Step>
__device__ __forceinline__ int walk(uint8_t* ring, const uint8_t* drow,
                                    const int* base, int rows, int W, int T,
                                    int B, int r, int8_t* __restrict__ mvs,
                                    int8_t noop, int lane, int j, Step step) {
  const int R = RING_BYTES / W, BUF = ring_buf(W);
  int8_t* mv = reinterpret_cast<int8_t*>(ring + 2 * BUF);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  __threadfence();  // the DP's `dirs` stores before the warp's copies
  __syncwarp();     // and every lane is done with the row buffers
  ring_prefetch(ring, drow, base, rows, W, 0, lane);
  ring_prefetch(ring, drow, base, rows, W, 1, lane);
  int c = 0, lo = max(rows - R, 0), i = rows - 1, s = 0, s0 = 0;
  bool done = i <= 0 && j <= 0;
  // chunk c's row x at rrow + x W, the base of row x - 1 at rbb + 4 x
  unsigned rrow = 0, rbb = 0;
  int bcur = 0;
  auto enter = [&]() {
    cp_async_wait1();  // chunk c has landed (c + 1 may be in flight)
    __syncwarp();
    const unsigned rs = ring_s + (c & 1) * BUF;
    rrow = rs - lo * W;
    rbb = rs + RING_BYTES - 4 * lo;
    bcur = lds_s32(rbb + 4 * (i + 1));
  };
  enter();
  for (;;) {
    const int smax = min(T, s0 + MV_BYTES);
    while (s < smax && !done && i >= lo) {
      const int bd = lds_s32(rbb + 4 * i);  // base[i - 1]
      const int ln = j - bcur;
      const int zr = lds_u8(rrow + i * W + min(max(ln, 0), W - 1));
      const int z = (unsigned)ln < (unsigned)W ? zr : 0;
      int di, dj;
      const int code = step(z, i, j, di, dj);
      i -= di;
      j -= dj;
      bcur += di * (bd - bcur);
      done = code == noop || (i <= 0 && j <= 0);
      mv[s - s0] = (int8_t)code;  // every lane the same byte
      ++s;
    }
    __syncwarp();  // the moves before the warp reads them
    for (int t = lane; t < s - s0; t += 32) mvs[(size_t)(s0 + t) * B + r] = mv[t];
    __syncwarp();  // and the reads before the buffer is written again
    s0 = s;
    if (done || s >= T) break;
    if (i < lo) {  // chunk c is walked: c + 2 into its buffer, on to c + 1
      ring_prefetch(ring, drow, base, rows, W, c + 2, lane);
      ++c;
      lo = max(rows - (c + 1) * R, 0);
      enter();
    }
  }
  for (int k = s + lane; k < T; k += 32) mvs[(size_t)k * B + r] = noop;
  return j;
}

// Reads a block: one read on each SM first, then up to MAX_WARPS on the
// SM's four schedulers, so that a batch of B reads spreads over the card.
inline int warps_per_block(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int w = (B + sms - 1) / sms;
  return w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
}

// Launch kernel over B reads, wpb a block, each warp with per_warp bytes of
// dynamic shared memory.
template <class Kernel, class... Args>
int launch_reads(Kernel kernel, int B, int per_warp, cudaStream_t st, Args... args) {
  const int wpb = warps_per_block(B);
  const int smem = wpb * per_warp;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + wpb - 1) / wpb, wpb * 32, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace warpdp
