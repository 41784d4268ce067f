// Lock-CAS arbitration for NVIDIA Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lock_arbiter.py, `lock_arbiter` (Pallas body
// `_kernel`), reached from repro.kernels.ops.cas_arbitrate.
//
// Computes, per group g and request i:
//   won[g,i] = active[g,i] && !exists j: active[g,j] && keys[g,j] == keys[g,i]
//                                      && (hi[g,j], lo[g,j]) < (hi[g,i], lo[g,i])
// with signed int32 words compared lexicographically and no index tiebreak:
// exact ties leave several winners, as repro.core.arbiter.scatter_min_winner.
//
// What bounds it on this card: nothing of the card's.  On the engine's path
// (G = 1, M = 480) the kernel reads 6.2 KB and does M^2 = 230k pair tests,
// nanoseconds of work at 3.35 TB/s or at the CUDA cores' rate; the launch
// (a few microseconds) is the whole cost, and the engine launches it once
// per tick.
//
// Design: one thread per request i, a grid of (ceil(M / 256), G) blocks.
// Each block stages its group's requests through shared memory in 256-wide
// chunks (key, hi, lo, active) and every thread scans the chunk against its
// own request.  Unlike the Pallas version, which pads M into one all-pairs
// tile and asserts that it fits, any M works.  An O(M) arbiter (a 64-bit
// atomicMin per record on the sign-biased (hi, lo) packing) is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
lock_arbiter_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ hi,
                    const int32_t* __restrict__ lo, const uint8_t* __restrict__ active,
                    uint8_t* __restrict__ won, int M) {
  __shared__ int32_t s_key[kBlock];
  __shared__ int32_t s_hi[kBlock];
  __shared__ int32_t s_lo[kBlock];
  __shared__ uint8_t s_act[kBlock];

  const int64_t base = static_cast<int64_t>(blockIdx.y) * M;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool mine = i < M;
  int32_t k = 0, h = 0, l = 0;
  bool act = false;
  if (mine) {
    k = keys[base + i];
    h = hi[base + i];
    l = lo[base + i];
    act = active[base + i] != 0;
  }
  bool beaten = false;
  for (int j0 = 0; j0 < M; j0 += kBlock) {
    const int j = j0 + threadIdx.x;
    if (j < M) {
      s_key[threadIdx.x] = keys[base + j];
      s_hi[threadIdx.x] = hi[base + j];
      s_lo[threadIdx.x] = lo[base + j];
      s_act[threadIdx.x] = active[base + j];
    }
    __syncthreads();
    const int n = min(kBlock, M - j0);
    if (act) {
      for (int t = 0; t < n; ++t) {
        const int32_t hj = s_hi[t];
        beaten |= s_act[t] && s_key[t] == k && (hj < h || (hj == h && s_lo[t] < l));
      }
    }
    __syncthreads();
  }
  if (mine) won[base + i] = act && !beaten;
}

}  // namespace

extern "C" int rt_lock_arbiter(const void* keys, const void* prio_hi, const void* prio_lo,
                               const void* active, void* won, int G, int M, void* stream) {
  if (G <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((M + kBlock - 1) / kBlock, G);
  lock_arbiter_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(prio_hi),
      static_cast<const int32_t*>(prio_lo), static_cast<const uint8_t*>(active),
      static_cast<uint8_t*>(won), M);
  return static_cast<int>(cudaGetLastError());
}
