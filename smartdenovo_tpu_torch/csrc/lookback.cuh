// Decoupled look-back across tiles (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016), shared by
// csrc/jpost.cu and csrc/pexpand.cu.
//
// A tile publishes its state with its status in one 64-bit word: status in
// the low 2 bits (0 not yet, ST_AGG its aggregate, ST_PRE its inclusive
// prefix), the state in the rest.  One relaxed 64-bit store and load move
// the word whole (single-copy atomic), so no fence orders a state against
// its status.  16-byte words would need vector accesses, which the PTX
// memory model does not make single-copy atomic.
//
// A state S provides: static id() and combine(a, b) (a precedes b;
// associative), shfl_down(d) and bcast() (lane 0's) across a warp,
// word(st) packing it with a status, and static of(w) unpacking it.
#pragma once

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;
constexpr int ST_AGG = 1, ST_PRE = 2;  // a tile word's status; 0 = not yet
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ u64 ld_word(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

template <class S>
__device__ __forceinline__ void publish(u64* word, const S& s, int st) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word),
               "l"(s.word(st)) : "memory");
}

// The exclusive prefix of tile t > 0, by warp 0 of the tile: lane k waits
// until tile (hi - k) has published at least its aggregate and reads its
// aggregate or inclusive prefix; the window up to the nearest inclusive
// prefix is reduced in stream order (higher lanes hold earlier tiles) and
// folded in front of what came before.  Every tile waited on started
// earlier, so nothing deadlocks when tiles take their IDs in launch order.
template <class S>
__device__ S look_back(int t, const u64* words, int lane) {
  S acc = S::id();
  for (int hi = t - 1;; hi -= 32) {
    const int k = hi - lane;
    int st = ST_PRE;
    S w = S::id();  // before the stream: an empty prefix
    if (k >= 0) {
      u64 v;
      while (((v = ld_word(words + k)) & 3) == 0) __nanosleep(32);
      st = (int)(v & 3);
      w = S::of(v);
    }
    const unsigned pm = __ballot_sync(FULL, st == ST_PRE);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    if (lane > stop) w = S::id();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const S o = w.shfl_down(d);
      if (lane + d < 32) w = S::combine(o, w);
    }
    acc = S::combine(w.bcast(), acc);
    if (pm) return acc;
  }
}

}  // namespace
