// MVCC version selection (Cond R1 slot pick + Cond R2 lock check) for
// NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mvcc_version_select.py, `mvcc_version_select`
// (Pallas body `_kernel`), reached from repro.kernels.ops.version_select.
//
// Computes, per op row m over its S version slots (signed int32 words,
// pairs compared lexicographically):
//   found[m] = exists s: (0,0) != wts[m,s] < ctts[m]
//   slot[m]  = the first s whose wts[m,s] is the largest such pair, else 0
//   ok[m]    = lock[m] == (0,0) || ctts[m] < lock[m]
//
// What bounds it on this card: the bytes.  Each row reads 2S + 4 words and
// writes 6 bytes; the compares are a handful of integer operations per slot.
// At the engine's shape (M = N*K = 2400 ops, S = 4) that is 130 KB, tens of
// nanoseconds at 3.35 TB/s, so the launch (a few microseconds) is the whole
// cost, and the engine launches it three times per MVCC tick.
//
// Design: one thread per op row, a loop over the S slots, where S comes from
// the input shape (the slot-count ablation uses 2 to 16).  A strictly-greater
// update keeps the first index among tied winners, as the reference's argmax
// does.  The TPU kernel padded M to a multiple of its 256-row block and laid
// the slots along the lanes; here the last block masks its ragged edge and
// nothing is padded.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ bool lex_lt(int32_t ah, int32_t al, int32_t bh, int32_t bl) {
  return ah < bh || (ah == bh && al < bl);
}

__global__ void __launch_bounds__(kBlock)
mvcc_version_select_kernel(const int32_t* __restrict__ wts_hi, const int32_t* __restrict__ wts_lo,
                           const int32_t* __restrict__ ctts_hi, const int32_t* __restrict__ ctts_lo,
                           const int32_t* __restrict__ lock_hi, const int32_t* __restrict__ lock_lo,
                           uint8_t* __restrict__ found, int32_t* __restrict__ slot,
                           uint8_t* __restrict__ ok, int64_t M, int S) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (m >= M) return;
  const int32_t ch = ctts_hi[m], cl = ctts_lo[m];
  const int32_t* wh = wts_hi + m * S;
  const int32_t* wl = wts_lo + m * S;
  bool any = false;
  int32_t bh = 0, bl = 0;
  int best = 0;
  for (int s = 0; s < S; ++s) {
    const int32_t h = wh[s], l = wl[s];
    const bool cand = lex_lt(h, l, ch, cl) && (h != 0 || l != 0);
    if (cand && (!any || lex_lt(bh, bl, h, l))) {
      any = true;
      bh = h;
      bl = l;
      best = s;
    }
  }
  found[m] = any;
  slot[m] = best;
  const int32_t lh = lock_hi[m], ll = lock_lo[m];
  ok[m] = (lh == 0 && ll == 0) || lex_lt(ch, cl, lh, ll);
}

}  // namespace

extern "C" int rt_mvcc_version_select(const void* wts_hi, const void* wts_lo, const void* ctts_hi,
                                      const void* ctts_lo, const void* lock_hi, const void* lock_lo,
                                      void* found, void* slot, void* ok, long long M, int S,
                                      void* stream) {
  if (M <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((M + kBlock - 1) / kBlock);
  mvcc_version_select_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wts_hi), static_cast<const int32_t*>(wts_lo),
      static_cast<const int32_t*>(ctts_hi), static_cast<const int32_t*>(ctts_lo),
      static_cast<const int32_t*>(lock_hi), static_cast<const int32_t*>(lock_lo),
      static_cast<uint8_t*>(found), static_cast<int32_t*>(slot), static_cast<uint8_t*>(ok), M, S);
  return static_cast<int>(cudaGetLastError());
}
