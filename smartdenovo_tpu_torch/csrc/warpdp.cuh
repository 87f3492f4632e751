// Pieces shared by the one-warp-per-alignment DP kernels of banded.cu and
// refine.cu: the band-lane layout of the warp's row buffers in shared
// memory, the warp max-scan, the direction-byte stores and the cp.async
// ring that the traceback reads.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace warpdp {

constexpr unsigned FULL = 0xffffffffu;
// One traceback ring buffer; the ring is two of them, and the DP's row
// buffers (at most 16 W bytes, W <= 1024) share the same 16 KB.
constexpr int RING_BYTES = 8192;

// Lane l of the warp owns the P band lanes k = P l .. P l + P - 1.  A row
// buffer holds band lane k at (k % P) * 32 + k / P: the P reads of a
// thread at k + s each touch 32 consecutive words across the warp, for
// any shift s, so no read or write has a bank conflict.
template <int P>
__device__ __forceinline__ int sw(int k) {
  return (k % P) * 32 + k / P;
}

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(FULL, v, s);
    if (lane >= s) v = max(v, u);
  }
  return v;
}

// max over the lanes before this one; INT_MIN in lane 0
__device__ __forceinline__ int warp_excl_max(int v, int lane) {
  const int x = __shfl_up_sync(FULL, warp_incl_max(v, lane), 1);
  return lane == 0 ? INT_MIN : x;
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The traceback's ring: chunk c holds the `dirs` rows [lo, hi) with hi =
// rows - c R and R = RING_BYTES / W, in ring buffer c & 1.  The whole warp
// copies a chunk (W is a multiple of 32, so every row and chunk is
// 16-byte aligned); a walk's row index only falls, so chunk c + 1 can be
// in flight while lane 0 walks chunk c.
__device__ __forceinline__ void ring_prefetch(uint8_t* ring, const uint8_t* drow,
                                              int rows, int W, int c, int lane) {
  const int R = RING_BYTES / W;
  const int hi = max(rows - c * R, 0), lo = max(hi - R, 0);
  const int n = (hi - lo) * W;
  const uint8_t* src = drow + (size_t)lo * W;
  uint8_t* dst = ring + (c & 1) * RING_BYTES;
  for (int k = lane * 16; k < n; k += 32 * 16) cp_async16(dst + k, src + k);
  cp_async_commit();
}

}  // namespace warpdp
