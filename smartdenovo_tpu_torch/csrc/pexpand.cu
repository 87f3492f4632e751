// Segmented broadcast of emitter payloads, for Hopper.
//
// Replaces the Pallas kernel smartdenovo_tpu/ops/pexpand.py expand_emit
// (kernel body _make_kernel).  Emitter e owns the cnt[e] contiguous output
// slots starting at the exclusive cumsum of cnt; each of its three
// payloads (pay, aux, base) is written into all of them.  Slots at or past
// the total (and up to pair_budget) are written as 0.
//
// Bound: HBM bandwidth on the output — 12 bytes written per slot; the
// binary search reads the inclusive cumsum (4 bytes x NE), which stays in
// the 50 MB L2 for the emitter counts of the main path.
//
// Design.  The TPU kernel built a one-hot selection matrix per output tile
// and replicated the payloads with an MXU contraction.  Here every output
// slot is one thread that binary-searches its emitter in the inclusive
// cumsum (computed by the caller, as the JAX wrapper computed it outside
// its kernel) and copies three words; neighbouring threads hit the same
// or neighbouring emitters, so the loads coalesce.
#include "common.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
pexpand_kernel(const int* cum, const int* pay, const int* aux,
               const int* base, long long NE, long long PB, int* out) {
  const long long j = blockIdx.x * (long long)BLOCK + threadIdx.x;
  if (j >= PB) return;
  const long long total = cum[NE - 1];
  int a = 0, b = 0, c = 0;
  if (j < total) {
    long long lo = 0, hi = NE;  // first e with cum[e] > j
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (cum[mid] > j) hi = mid;
      else lo = mid + 1;
    }
    a = pay[lo];
    b = aux[lo];
    c = base[lo];
  }
  out[j] = a;
  out[PB + j] = b;
  out[2 * PB + j] = c;
}

}  // namespace

extern "C" int pexpand_expand_emit(const int* cum, const int* pay,
                                   const int* aux, const int* base,
                                   long long NE, long long PB, int* out,
                                   void* stream) {
  const unsigned grid = (unsigned)((PB + BLOCK - 1) / BLOCK);
  pexpand_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(cum, pay, aux, base,
                                                           NE, PB, out);
  return (int)cudaGetLastError();
}
